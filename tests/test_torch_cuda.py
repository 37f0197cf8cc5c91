"""The port's CUDA kernels on the card, held to their plain versions.

Every test here is marked ``cuda`` and skips where there is no card.
The file imports neither ``jax`` nor ``repro``, so it runs on the GPU
machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import make_pi_cluster
from repro_torch import configs
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.conv2d import ops, ref
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.moe_gemm import ref as moe_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models.cnn import params_from_numpy, zoo
from repro_torch.models.transformer import model as M
from repro_torch.serving import lm

from _torch_cases import (CONV_CASE_PLANS, CONV_CASES, CONV_PLAN_CASES,
                          DECODE_CASES, DECODE_SPLIT_CASES, MOE_GEMM_CASES,
                          MOE_GEMM_VARIANTS, PREFILL_CASES,
                          PREFILL_FULL_SHAPES, SSD_CASES,
                          SSD_EDGE_CASES,
                          conv_inputs,
                          decode_inputs, image, lm_config, lm_tokens,
                          moe_gemm_inputs, np_params, prefill_inputs,
                          ssd_inputs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, device):
    return None if a is None else torch.tensor(a, device=device)


def _conv_case(x_shape, w_shape, stride, pool, relu, bias, want_plan, dev):
    """fp32 kernel vs the plain version on the card: 1e-4 x max(1,
    max|ref|), for sums taken in another order than cuBLAS's; one launch
    through the planned variant; the same bits on a second call (the
    split-K sum runs in rank order)."""
    x, w, b = (_t(a, dev) for a in conv_inputs(x_shape, w_shape, bias))
    kw = dict(stride=stride, relu=relu, pool=pool)
    kh, kwd, _, co = w_shape
    assert tuple(ops.plan(*x_shape, kh, kwd, co, stride, pool)) == want_plan
    before = ops.launch_count()
    variants = dict(ops.variant_counts)
    got = ops.conv2d_fused(x, w, b, **kw)
    torch.cuda.synchronize()
    assert ops.launch_count() == before + 1
    variants[want_plan[0]] += 1
    assert ops.variant_counts == variants
    want = ref.conv2d_fused_ref(x, w, b, **kw)
    assert got.shape == want.shape
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    again = ops.conv2d_fused(x, w, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_kernel_matches_plain_version(case, cuda):
    _conv_case(*CONV_CASES[case], CONV_CASE_PLANS[case], cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CONV_PLAN_CASES))
def test_kernel_plan_edges_match_plain_version(case, cuda):
    """The plan's edges at full size: split K up to 8 ways across a
    cluster, K no multiple of S BK, CI = 12, the general variant, a 3x3
    pool in 128-row tiles, a batch of 8 frames."""
    _conv_case(*CONV_PLAN_CASES[case], cuda)


@pytest.mark.cuda
def test_kernel_bf16_and_empty_output(cuda):
    x, w, b = (_t(a, cuda).bfloat16()
               for a in conv_inputs((1, 18, 18, 40), (3, 3, 40, 72), True))
    got = ops.conv2d_fused(x, w, b, relu=True, pool=(2, 2))
    want = ref.conv2d_fused_ref(x, w, b, relu=True, pool=(2, 2))
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item()
    before = ops.launch_count()
    empty = ops.conv2d_fused(x[:, :2].contiguous(), w, b)
    assert tuple(empty.shape) == (1, 0, 16, 72)
    assert ops.launch_count() == before


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    w = torch.zeros(3, 3, 4, 6, device=cuda)
    for args, kw in [((x.double(), w.double()), {}),
                     ((x.transpose(1, 2), w), {}),
                     ((x, w.cpu()), {}),
                     ((x, w), {"pool": (9, 9)})]:
        with pytest.raises(ValueError):
            ops.conv2d_fused(*args, **kw)


@pytest.mark.cuda
def test_deployment_runs_through_the_kernel(cuda):
    """Tiny VGG16 with its head on a 4-Pi plan: the ``cuda`` deployment
    launches the kernel and agrees with the same deployment on the CPU
    (plain version) to rtol 1e-4 / atol 1e-5."""
    m = zoo.vgg16(input_size=(40, 40), scale=0.1, head=True)
    p = np_params(m)
    cluster = make_pi_cluster([1.5, 1.2, 1.0, 0.8])
    dep = repro_torch.compile(m, cluster, params=params_from_numpy(p, cuda))
    x = image(m)
    ops.reset_launches()
    got = dep.run(x)
    assert ops.launch_count() > 0
    want = repro_torch.compile(m, cluster, params=params_from_numpy(p, "cpu"),
                               device="cpu").run(x)
    for k in want:
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5)


def _assert_attn_close(got, want, dtype):
    """fp32: |error| <= 1e-4 x max(1, max|ref|), sums in another order.
    bf16, per element: |error| <= 2^-6 x (|ref| + rms(ref)): the output's
    own rounding (one bf16 ulp, at most 2^-7 relative, on each side) and
    the probabilities rounded against another running max, noise of a
    fraction of the output's scale that does not shrink with |ref|."""
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    if dtype == torch.float32:
        limit = 1e-4 * max(1.0, ref.max().item())
    else:
        limit = 2 ** -6 * (ref + ref.square().mean().sqrt())
    assert bool((err <= limit).all()), (err / limit).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PREFILL_CASES) + ["s130_d128"])
def test_flash_prefill_kernel_matches_plain_version(case, dtype, cuda):
    b, s, k, g, d, w = PREFILL_CASES.get(case, (1, 130, 2, 2, 128, 0))
    q, kk, vv = (_t(a, cuda).to(dtype) for a in prefill_inputs(b, s, k, g, d))
    before = attn_ops.launch_count("flash_prefill")
    got = attn_ops.flash_prefill(q, kk, vv, sliding_window=w)
    torch.cuda.synchronize()
    assert attn_ops.launch_count("flash_prefill") == before + 1
    want = attn_ref.flash_prefill_ref(q, kk, vv, w)
    assert got.shape == want.shape and got.dtype == dtype
    _assert_attn_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PREFILL_CASES)
                         + sorted(PREFILL_FULL_SHAPES) + ["s256_g1_k16"])
def test_prefill_plan_is_the_kernels(case, dtype, cuda):
    """``ops.prefill_plan``'s rows, padded D, threads, shared memory and
    grid are what the C side computes for the same shape
    (``flash_prefill_query``)."""
    shape = (PREFILL_FULL_SHAPES[case] if case in PREFILL_FULL_SHAPES
             else PREFILL_CASES[case][:5] if case in PREFILL_CASES
             else (2, 256, 16, 1, 64))
    pl = attn_ops.prefill_plan(*shape, dtype)
    assert attn_ops.prefill_layout(*shape, dtype) == (
        pl.rows, pl.dp, pl.threads, pl.smem, pl.grid)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PREFILL_FULL_SHAPES))
def test_flash_prefill_fp32_kernel_at_the_full_prefill_shapes(case, cuda):
    """The fp32 kernel at the LM paths' own prefill shapes (B 4, S 511:
    Llama's, granite's G = 3, qwen's G = 1), against the plain version,
    and the same bits on a second call."""
    shape = PREFILL_FULL_SHAPES[case]
    q, kk, vv = (_t(a, cuda) for a in prefill_inputs(*shape))
    got = attn_ops.flash_prefill(q, kk, vv)
    again = attn_ops.flash_prefill(q, kk, vv)
    torch.cuda.synchronize()
    _assert_attn_close(got, attn_ref.flash_prefill_ref(q, kk, vv, 0),
                       torch.float32)
    assert torch.equal(got, again)


def _decode_case(b, k, g, d, w, vl, dtype, dev):
    """decode_attention vs its plain version, one launch, and the same
    bits on a second call (the splits combine in rank order)."""
    q, kk, vv = (_t(a, dev).to(dtype) for a in decode_inputs(b, k, g, d, w))
    vl = torch.tensor(vl, dtype=torch.int32, device=dev)
    before = attn_ops.launch_count("decode_attention")
    got = attn_ops.decode_attention(q, kk, vv, vl)
    torch.cuda.synchronize()
    assert attn_ops.launch_count("decode_attention") == before + 1
    want = attn_ref.decode_attention_ref(q, kk, vv, vl)
    assert got.shape == want.shape and got.dtype == dtype
    _assert_attn_close(got, want, dtype)
    again = attn_ops.decode_attention(q, kk, vv, vl)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(DECODE_CASES) + ["vl_0", "vl_past_w"])
def test_decode_kernel_matches_plain_version(case, dtype, cuda):
    _decode_case(*DECODE_CASES.get(
        case, (2, 2, 4, 64, 70, 0 if case == "vl_0" else 100)), dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(DECODE_SPLIT_CASES))
def test_decode_split_edges_match_plain_version(case, dtype, cuda):
    """The split-KV kernel at the LM decode shapes and its edges
    (valid_len on a split boundary, 1, 0, past W; one split; G = 64,
    D = 8 and 128; B K = 1024), with the splits each must take."""
    b, k, g, d, w, vl, splits = DECODE_SPLIT_CASES[case]
    assert attn_ops.decode_splits(b, k, w) == splits
    _decode_case(b, k, g, d, w, vl, dtype, cuda)


@pytest.mark.cuda
def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    q, kk, vv = (_t(a, cuda) for a in prefill_inputs(1, 8, 2, 2, 16))
    off = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    off.copy_(q)                                            # 4-byte aligned
    for args in [(q.double(), kk.double(), vv.double()),
                 (q.transpose(1, 2), kk, vv), (q, kk.cpu(), vv),
                 (q[..., :12].contiguous(), kk[..., :12].contiguous(),
                  vv[..., :12].contiguous()), (off, kk, vv)]:
        with pytest.raises(ValueError):
            attn_ops.flash_prefill(*args)
    q, kk, vv = (_t(a, cuda) for a in decode_inputs(1, 2, 2, 16, 8))
    for vl in (torch.tensor(3, dtype=torch.int32),          # on the CPU
               torch.tensor(3, device=cuda)):               # int64
        with pytest.raises(ValueError):
            attn_ops.decode_attention(q, kk, vv, vl)
    vl = torch.tensor(3, dtype=torch.int32, device=cuda)
    off = torch.empty(kk.numel() + 1, device=cuda)[1:].view(kk.shape)
    off.copy_(kk)                                           # 4-byte aligned
    with pytest.raises(ValueError):
        attn_ops.decode_attention(q, off, vv, vl)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gqa_bias", "llama_swa16"])
def test_generate_runs_through_the_attention_kernels(case, cuda):
    """A reduced LM on the card: one flash_prefill per layer, one
    decode_attention per layer and token, and logits along the same
    tokens within 1e-4 x max|logit| of the plain path on the CPU."""
    cfg = lm_config(configs, case)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = M.init_params(cfg, torch.Generator().manual_seed(0), device=cuda)
    prompt = torch.tensor(lm_tokens(cfg))
    n_new = 5
    attn_ops.reset_launches()
    toks = lm.generate(cfg, gpu, prompt.to(cuda), n_new)
    torch.cuda.synchronize()
    assert attn_ops.launch_count("flash_prefill") == cfg.n_layers
    assert attn_ops.launch_count("decode_attention") == cfg.n_layers * n_new
    caches = [lm.prefill_prompt(cfg, p, prompt.to(p["embed"].device),
                                n_new)[1] for p in (gpu, cpu)]
    tok = prompt[:, -1]
    for i in range(n_new):
        (lg, caches[0]), (lc, caches[1]) = (
            M.decode_step(cfg, p, c, {"token": tok.to(p["embed"].device)})
            for p, c in zip((gpu, cpu), caches))
        lg, lc = lg[:, :cfg.vocab_size].cpu(), lc[:, :cfg.vocab_size]
        err = (lg - lc).abs().max().item()
        assert err <= 1e-4 * lc.abs().max().item(), i
        tok = toks[:, i].cpu()


def _ssd_shape(case):
    return SSD_CASES.get(case) or {"q511_h32": (2, 511, 32, 64, 128),
                                   "q256_p128": (1, 256, 2, 128, 64)
                                   }.get(case) or SSD_EDGE_CASES[case][0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(SSD_CASES) + ["q511_h32", "q256_p128"]
                         + sorted(SSD_EDGE_CASES))
def test_ssd_chunk_kernel_matches_plain_version(case, dtype, cuda):
    """The sweep, a full-width mamba2-370m chunk of 511 positions (no tile
    divides it), P = 128 and the kernel's edges (each through the head
    group its plan names), under the attention kernels' limits."""
    shape = _ssd_shape(case)
    if case in SSD_EDGE_CASES:
        want = SSD_EDGE_CASES[case][1]
        assert ssd_ops.plan(*shape, dtype).g == \
            want[[torch.float32, torch.bfloat16].index(dtype)]
    x, dt, A, Bm, Cm = (_t(a, cuda).to(dtype) for a in ssd_inputs(*shape))
    before = ssd_ops.launch_count("ssd_chunk")
    y, st = ssd_ops.ssd_chunk(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert ssd_ops.launch_count("ssd_chunk") == before + 1
    want_y, want_st = ssd_ref.ssd_chunk_ref(x, dt, A, Bm, Cm)
    for got, want in ((y, want_y), (st, want_st)):
        assert got.shape == want.shape and got.dtype == dtype
        _assert_attn_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mamba2_prefill", "h3", "q1030",
                                  "p128_n8", "h5_p20_n12"])
def test_ssd_chunk_kernel_gives_the_same_bits_twice(case, dtype, cuda):
    """No atomics: every output is summed by one thread in a fixed order,
    so two calls agree bit for bit."""
    x, dt, A, Bm, Cm = (_t(a, cuda).to(dtype)
                        for a in ssd_inputs(*_ssd_shape(case)))
    first = ssd_ops.ssd_chunk(x, dt, A, Bm, Cm)
    second = ssd_ops.ssd_chunk(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("g", [8, 3, 1, 0])
def test_ssd_chunk_kernel_refuses_other_plans(g, cuda):
    """The C side takes only the G that ``ops.plan`` may choose; the
    wrapper raises on its error code (past the Python check, which
    refuses the same plans first)."""
    x, dt, A, Bm, Cm = (_t(a, cuda) for a in ssd_inputs(*SSD_CASES["q64"]))
    BC, Q, H, P = x.shape
    y, st = torch.empty_like(x), x.new_empty((BC, H, P, Bm.shape[-1]))
    with pytest.raises(RuntimeError, match="CUDA error"):
        ssd_ops._KERNELS.launch(
            "ssd_chunk", x, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), st.data_ptr(), BC,
            Q, H, P, Bm.shape[-1], g)
    with pytest.raises(RuntimeError, match="refused"):
        ssd_ops.kernel_layout(BC, Q, H, P, Bm.shape[-1], g, x.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", ssd_ops.GROUPS)
@pytest.mark.parametrize("case", sorted(SSD_CASES) + sorted(SSD_EDGE_CASES))
def test_ssd_plan_grid_and_smem_are_the_kernels(case, g, dtype, cuda):
    """The Python plan's grid and shared memory (which choose G) are
    what the C side computes for the same launch."""
    shape = _ssd_shape(case)
    esz = torch.empty((), dtype=dtype).element_size()
    assert ssd_ops.kernel_layout(*shape, g, dtype) == (
        ssd_ops.smem_bytes(g, shape[-1], esz), ssd_ops._grid(*shape, g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(MOE_GEMM_CASES) + ["granite_decode"])
def test_moe_gemm_kernel_matches_plain_version(case, dtype, cuda):
    """Each case through the variant it is meant to reach (the counts
    show it); granite_decode is the w2 twin of granite_c4."""
    shape = MOE_GEMM_CASES.get(case, (40, 4, 512, 1536))
    want_variant = MOE_GEMM_VARIANTS.get(case, ("stream", "stream"))[
        dtype == torch.bfloat16]
    x, w = (_t(a, cuda).to(dtype) for a in moe_gemm_inputs(*shape))
    before = moe_ops.launch_count("moe_gemm")
    variants = dict(moe_ops.variant_counts)
    got = moe_ops.moe_gemm(x, w)
    torch.cuda.synchronize()
    assert moe_ops.launch_count("moe_gemm") == before + 1
    variants[want_variant] += 1
    assert moe_ops.variant_counts == variants
    want = moe_ref.moe_gemm_ref(x, w)
    assert got.shape == want.shape and got.dtype == dtype
    _assert_attn_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["c508_d1536", "granite_c4", "c12_d1024"])
def test_moe_gemm_kernel_gives_the_same_bits_twice(case, dtype, cuda):
    """No atomics on values: the split decode sums its partials in a
    fixed order, so two calls agree bit for bit (and the counters are
    back at zero for the second)."""
    x, w = (_t(a, cuda).to(dtype) for a in moe_gemm_inputs(
        *MOE_GEMM_CASES[case]))
    first, second = moe_ops.moe_gemm(x, w), moe_ops.moe_gemm(x, w)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["s511_g3", "s96_d128"])
def test_flash_prefill_bf16_kernel_gives_the_same_bits_twice(case, dtype,
                                                             cuda):
    """Both dtypes (the name is older than the fp32 case): no atomics, a
    fixed order of sums, so two calls agree bit for bit."""
    b, s, k, g, d, w = PREFILL_CASES[case]
    q, kk, vv = (_t(a, cuda).to(dtype) for a in prefill_inputs(b, s, k, g, d))
    first = attn_ops.flash_prefill(q, kk, vv, sliding_window=w)
    second = attn_ops.flash_prefill(q, kk, vv, sliding_window=w)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_ssd_and_moe_kernels_refuse_what_they_do_not_take(cuda):
    x, dt, A, Bm, Cm = (_t(a, cuda) for a in ssd_inputs(*SSD_CASES["q16"]))
    for args in [(x.double(), dt.double(), A.double(), Bm.double(),
                  Cm.double()),
                 (x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm,
                  Cm),
                 (x, dt, A.cpu(), Bm, Cm)]:
        with pytest.raises(ValueError):
            ssd_ops.ssd_chunk(*args)
    x, w = (_t(a, cuda) for a in moe_gemm_inputs(*MOE_GEMM_CASES["e4"]))
    for args in [(x.double(), w.double()), (x, w.cpu()),
                 (x, w.transpose(1, 2).contiguous().transpose(1, 2))]:
        with pytest.raises(ValueError):
            moe_ops.moe_gemm(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mamba2", "granite_moe"])
def test_generate_runs_through_the_ssd_and_moe_kernels(case, cuda):
    """A reduced Mamba2 / MoE LM on the card: one ssd_chunk per layer of
    the prefill; three moe_gemm per layer of the prefill and of every
    decode step; logits along the same tokens within 1e-4 x max|logit|
    of the plain path on the CPU."""
    cfg = lm_config(configs, case)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = M.init_params(cfg, torch.Generator().manual_seed(0), device=cuda)
    prompt = torch.tensor(lm_tokens(cfg))
    n_new = 5
    ssd_ops.reset_launches()
    moe_ops.reset_launches()
    toks = lm.generate(cfg, gpu, prompt.to(cuda), n_new)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert ssd_ops.launch_count("ssd_chunk") == (L if cfg.is_ssm else 0)
    assert moe_ops.launch_count("moe_gemm") == \
        (3 * L * (1 + n_new) if cfg.is_moe else 0)
    caches = [lm.prefill_prompt(cfg, p, prompt.to(p["embed"].device),
                                n_new)[1] for p in (gpu, cpu)]
    tok = prompt[:, -1]
    for i in range(n_new):
        (lg, caches[0]), (lc, caches[1]) = (
            M.decode_step(cfg, p, c, {"token": tok.to(p["embed"].device)})
            for p, c in zip((gpu, cpu), caches))
        lg, lc = lg[:, :cfg.vocab_size].cpu(), lc[:, :cfg.vocab_size]
        err = (lg - lc).abs().max().item()
        assert err <= 1e-4 * lc.abs().max().item(), i
        tok = toks[:, i].cpu()
