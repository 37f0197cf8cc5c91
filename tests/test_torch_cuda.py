"""The port's CUDA kernels on the card, held to their plain versions.

Every test here but one is marked ``cuda`` and skips where there is no
card; the runtime's refusal to run on a missing card runs anywhere.
The file imports neither ``jax`` nor ``repro``, so it runs on the GPU
machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)
"""

import contextlib
import weakref

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import make_pi_cluster
from repro_torch import configs
from repro_torch.exec import autotune, graph
from repro_torch.exec.cache import clear_cache, set_cache_size
from repro_torch.kernels import _build
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.conv2d import ops, ref
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.moe_gemm import ref as moe_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models.cnn import params_from_numpy, zoo
from repro_torch.models.transformer import model as M
from repro_torch.pipeline import StageExecutor
from repro_torch.runtime import PipelineRuntime, RuntimeConfig
from repro_torch.serving import lm
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import train as train_launcher
from repro_torch.training import loss_and_grads, tree

from _torch_cases import (CONV_CASE_PLANS, CONV_CASES, CONV_PLAN_CASES,
                          DECODE_CASES, DECODE_SPLIT_CASES, MOE_GEMM_CASES,
                          MOE_GEMM_VARIANTS, PREFILL_CASES,
                          PREFILL_FULL_SHAPES, SSD_CASES,
                          SSD_EDGE_CASES, ZOO_TINY,
                          conv_inputs,
                          decode_inputs, image, lm_config, lm_tokens,
                          moe_gemm_inputs, np_params, prefill_inputs,
                          ssd_inputs)
from _torch_mesh_ranks import (body_cuda_ring, body_cuda_sdecode,
                               body_cuda_shard, body_cuda_two, run_ranks)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, device):
    return None if a is None else torch.tensor(a, device=device)


def _conv_case(x_shape, w_shape, stride, pool, relu, bias, want_plan, dev,
               tile=None, split=None):
    """fp32 kernel vs the plain version on the card: 1e-4 x max(1,
    max|ref|), for sums taken in another order than cuBLAS's; one launch
    through the planned variant; the same bits on a second call (the
    split-K sum runs in rank order).  ``tile`` and ``split`` override the
    plan."""
    x, w, b = (_t(a, dev) for a in conv_inputs(x_shape, w_shape, bias))
    kw = dict(stride=stride, relu=relu, pool=pool, tile=tile, split=split)
    kh, kwd, _, co = w_shape
    assert tuple(ops.plan(*x_shape, kh, kwd, co, stride, pool, True, tile,
                          split)) == want_plan
    before = ops.launch_count()
    variants = dict(ops.variant_counts)
    got = ops.conv2d_fused(x, w, b, **kw)
    torch.cuda.synchronize()
    assert ops.launch_count() == before + 1
    variants[want_plan[0]] += 1
    assert ops.variant_counts == variants
    want = ref.conv2d_fused_ref(x, w, b, stride=stride, relu=relu, pool=pool)
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
@pytest.mark.parametrize("candidate", autotune.DEFAULT_CANDIDATES,
                         ids=lambda c: f"{c[0][0]}x{c[0][1]}_s{c[1]}")
@pytest.mark.parametrize("case", ["vgg_launch15", "k1800", "ci12", "ci13",
                                  "pool3_bm128"])
def test_every_candidate_plan_matches_plain_version(case, candidate, cuda):
    """Each plan autotune times, as the shape resolves it (the tile where
    the variant takes it, the split as deep as K allows), held to the
    plain version like the heuristic's."""
    x_shape, w_shape, stride, pool, relu, bias, _ = CONV_PLAN_CASES[case]
    tile, split = candidate
    kh, kw, _, co = w_shape
    want_plan = tuple(ops.plan(*x_shape, kh, kw, co, stride, pool, True,
                               tile, split))
    _conv_case(x_shape, w_shape, stride, pool, relu, bias, want_plan, cuda,
               tile=tile, split=split)


@pytest.mark.cuda
def test_kernel_refuses_an_override_no_plan_takes(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    w = torch.zeros(3, 3, 4, 8, device=cuda)
    before = ops.launch_count()
    for kw in ({"tile": (32, 32)}, {"tile": (128, 128)}, {"split": 3},
               {"split": 16}):
        with pytest.raises(ValueError):
            ops.conv2d_fused(x, w, **kw)
    assert ops.launch_count() == before


@pytest.mark.cuda
def test_autotune_conv_times_the_kernel_on_the_card(cuda):
    """The search launches the kernel under each distinct plan (the
    heuristic's among them), a warm-up call and ``ROUNDS`` rounds of
    ``iters`` calls each, and picks the fastest median by device time
    where it beats the heuristic's by more than the spread."""
    before = ops.launch_count()
    res = autotune.autotune_conv((1, 58, 33, 256), (3, 3, 256, 256),
                                 relu=True, iters=2, device=cuda)
    plans = [p for p, _ in res.trials]
    assert res.heuristic in plans and len(plans) == len(set(plans)) > 1
    assert ops.launch_count() - before \
        == (1 + autotune.ROUNDS * 2) * len(plans)
    best = min(t for _, t in res.trials) * 1e6
    if (res.tile, res.split) == (res.heuristic.tile, res.heuristic.split):
        assert res.best_us == res.heuristic_us > 0
        assert res.heuristic_us - best <= res.spread_us
    else:
        assert res.best_us == best > 0
        assert res.heuristic_us - best > res.spread_us


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


# the backward's shapes beyond SSD_CASES: mamba2-370m's and zamba2-2.7b's
# training folds (two 256-position chunks of a 512-token sequence, batch
# 4), the forward's Q = 511 edge at one chunk, H not a multiple of G, P
# past 64 (two P columns of 64, G = 2) and the widths past Q's tiles
SSD_BWD_SHAPES = {"mamba2_fold": (8, 256, 32, 64, 128),
                  "zamba2_fold": (8, 256, 80, 64, 64),
                  "q511": (1, 511, 8, 64, 128),
                  "h6_p96": (2, 130, 6, 96, 40)}


def _ssd_bwd_shape(case):
    return SSD_CASES.get(case) or SSD_BWD_SHAPES[case]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SSD_CASES) + sorted(SSD_BWD_SHAPES))
def test_ssd_bwd_plan_grid_smem_and_g_are_the_kernels(case, cuda):
    """``ops.bwd_plan``'s shared memory, grid and G are what the C side
    computes for the same launch (``ssd_chunk_bwd_query``)."""
    shape = _ssd_bwd_shape(case)
    pl = ssd_ops.bwd_plan(*shape)
    assert ssd_ops.bwd_layout(*shape) == (pl.smem, pl.grid, pl.g)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SSD_CASES) + sorted(SSD_BWD_SHAPES))
def test_ssd_chunk_function_differentiates_through_the_kernel(case, cuda):
    """``SsdChunk.apply`` on the card: one ssd_chunk launch forward, one
    ssd_chunk_bwd launch backward; dx, ddt, dA, dB and dC within 1e-4 x
    max(1, max|g|) of autograd of ``ssd_chunk_ref`` on the same inputs
    and output gradients (fp32 sums in another order), and the same
    bits on a second backward (no atomics)."""
    shape = _ssd_bwd_shape(case)
    bc, q, h, p, n = shape
    args = [_t(a, cuda) for a in ssd_inputs(*shape)]
    rng = np.random.default_rng(5)
    dy = _t(rng.standard_normal((bc, q, h, p)).astype(np.float32), cuda)
    dst = _t(rng.standard_normal((bc, h, p, n)).astype(np.float32), cuda)
    leaves = [t.clone().requires_grad_() for t in args]
    before = (ssd_ops.launch_count("ssd_chunk"),
              ssd_ops.launch_count("ssd_chunk_bwd"))
    y, st = ssd_ops.SsdChunk.apply(*leaves)
    got = torch.autograd.grad((y, st), leaves, (dy, dst), retain_graph=True)
    again = torch.autograd.grad((y, st), leaves, (dy, dst))
    torch.cuda.synchronize()
    assert (ssd_ops.launch_count("ssd_chunk"),
            ssd_ops.launch_count("ssd_chunk_bwd")) == \
        (before[0] + 1, before[1] + 2)
    plain = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(ssd_ref.ssd_chunk_ref(*plain), plain,
                               (dy, dst))
    for g, g2, w in zip(got, again, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.equal(g, g2)
        assert torch.isfinite(g).all()
        limit = 1e-4 * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= limit


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


# -- compiled execution: CUDA graphs of the decode step and of a stage ------

GRAPH_LM_CASES = ["llama", "mamba2", "granite_moe", "zamba2"]


def _kernel_counts():
    """Every launch and variant count of the port's kernels."""
    return [dict(t) for t in _build.COUNT_TABLES]


def _reset_all():
    for mod in (ops, attn_ops, moe_ops, ssd_ops):
        mod.reset_launches()


def _lm_on(cfg, dtype, dev):
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev, dtype=dtype)
    return params, torch.tensor(lm_tokens(cfg)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GRAPH_LM_CASES)
def test_decode_graph_replays_equal_eager_decode_steps(case, dtype, cuda):
    """A reduced LM: the Decoder's eager first step and its graph's
    replays give the logits of eager ``decode_step`` from the same cache
    bit for bit over 6 teacher-forced steps; one graph, captured once."""
    cfg = lm_config(configs, case)
    params, prompt = _lm_on(cfg, dtype, cuda)
    _, cache = lm.prefill_prompt(cfg, params, prompt, 6)
    eager_cache = {k: v.clone() for k, v in cache.items()}
    decoder = lm.Decoder(cfg, params, {k: v.clone() for k, v in
                                       cache.items()})
    tok = prompt[:, -1].long()
    for i in range(6):
        want, eager_cache = M.decode_step(cfg, params, eager_cache,
                                          {"token": tok})
        got = decoder(tok)
        torch.cuda.synchronize()
        assert torch.equal(got, want), i
        assert (decoder.graph is not None) and (i == 0 or got is
                                                decoder.graph.outputs)
        tok = want.argmax(dim=-1)
    for key in cache:
        if key != "len":
            assert torch.equal(decoder.cache[key], eager_cache[key]), key
    assert int(decoder.cache["len"]) == int(eager_cache["len"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GRAPH_LM_CASES)
def test_graphed_generate_equals_the_eager_loop(case, dtype, cuda):
    """``generate`` graphed and under ``graph.eager()``: the same greedy
    tokens, the same seeded temperature draws, and the same launch and
    variant counts of every kernel."""
    cfg = lm_config(configs, case)
    params, prompt = _lm_on(cfg, dtype, cuda)
    n_new = 8
    runs = {}
    for mode in ("eager", "graph", "eager", "graph"):
        _reset_all()
        with graph.eager() if mode == "eager" else contextlib.nullcontext():
            greedy = lm.generate(cfg, params, prompt, n_new)
            drawn = lm.generate(
                cfg, params, prompt, n_new, temperature=0.8,
                generator=torch.Generator(device=cuda).manual_seed(5))
        torch.cuda.synchronize()
        got = (greedy, drawn, _kernel_counts())
        if mode in runs:
            assert torch.equal(got[0], runs[mode][0])
            assert torch.equal(got[1], runs[mode][1])
        runs[mode] = got
    assert torch.equal(runs["graph"][0], runs["eager"][0])
    assert torch.equal(runs["graph"][1], runs["eager"][1])
    assert runs["graph"][2] == runs["eager"][2]
    L = cfg.n_layers
    if cfg.layer_pattern == "attn":
        assert attn_ops.launch_count("decode_attention") == 2 * L * n_new
    else:     # one a shared-block site and token
        assert attn_ops.launch_count("decode_attention") == \
            2 * M.n_shared_apps(cfg) * n_new


def _tiny_stage(dev, name="vgg16"):
    m = zoo.build(name, **ZOO_TINY[name])
    ex = StageExecutor(m, frozenset(m.graph.layers), [0.4, 0.35, 0.25])
    frames = [torch.tensor(image(m, seed=s)).to(dev) for s in (1, 2, 3)]
    params = [params_from_numpy(np_params(m, seed=s), dev) for s in (0, 1)]
    return m, ex, frames, params


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vgg16", "resnet34", "inceptionv3"])
def test_stage_graph_equals_its_body(name, cuda):
    """Tiny-zoo model as one stage split three ways: each replay equals the
    eager body bit for bit, in both forms; params A, B, A each give their
    own outputs; an output handed out is not overwritten by the next call;
    the conv launches of a replay are credited as the body's."""
    clear_cache()
    m, ex, frames, (pa, pb) = _tiny_stage(cuda, name)
    boundary = [ex.boundary_inputs({}, x) for x in frames]
    cs = ex._executable(boundary[0])
    outs = []
    for params, bnd in [(pa, boundary[0]), (pa, boundary[1]),
                        (pb, boundary[0]), (pa, boundary[2]),
                        (pb, boundary[1]), (pa, boundary[0])]:
        ops.reset_launches()
        got = cs(params, bnd)
        torch.cuda.synchronize()
        n_graph = ops.launch_count()
        ops.reset_launches()
        with graph.eager():
            want = cs(params, bnd)
        torch.cuda.synchronize()
        assert n_graph == ops.launch_count() > 0
        for s in want:
            assert torch.equal(got[s], want[s]), s
        outs.append((got, {s: y.clone() for s, y in got.items()}))
    for got, kept in outs:                     # nothing handed out moved
        for s in kept:
            assert torch.equal(got[s], kept[s])
    assert len(cs._graphs) == 2                # one per parameter set
    for s in outs[0][0]:
        assert not torch.equal(outs[0][0][s], outs[2][0][s])
        assert torch.equal(outs[0][0][s], outs[5][0][s])
    stack = {k: torch.stack([b[k] for b in boundary]) for k in boundary[0]}
    cs_f = ex._executable(stack)
    for _ in range(2):
        got = cs_f.run_frames(pa, stack)
        with graph.eager():
            want = cs_f.run_frames(pa, stack)
        for s in want:
            assert torch.equal(got[s], want[s])


@pytest.mark.cuda
def test_deployment_outputs_survive_the_next_run(cuda):
    """``Deployment.run`` on graphs: a returned output is unchanged after
    the next run (one frame and a list of frames), and equals the run
    with every body eager."""
    m = zoo.vgg16(input_size=(40, 40), scale=0.1, head=True)
    dep = repro_torch.compile(m, make_pi_cluster([1.5, 1.2, 1.0, 0.8]),
                              params=params_from_numpy(np_params(m), cuda))
    xs = [torch.tensor(image(m, seed=s)).to(cuda) for s in range(4)]
    first = dep.run(xs[0])
    kept = {k: v.clone() for k, v in first.items()}
    many = dep.run(xs[1:])
    kept_many = [{k: v.clone() for k, v in o.items()} for o in many]
    dep.run(xs[3])
    dep.run(xs[:3])
    with graph.eager():
        want = dep.run(xs[0])
        want_many = dep.run(xs[1:])
    for k in kept:
        assert torch.equal(first[k], kept[k]) and torch.equal(first[k],
                                                                want[k])
    for o, ko, w in zip(many, kept_many, want_many):
        for k in ko:
            assert torch.equal(o[k], ko[k]) and torch.equal(o[k], w[k])


@pytest.mark.cuda
def test_stage_graphs_go_with_the_cache_entry(cuda):
    """A stage's graphs are freed with its cache entry: on clear_cache
    and on eviction past set_cache_size."""
    _, ex, frames, (pa, _) = _tiny_stage(cuda)
    bnd = ex.boundary_inputs({}, frames[0])
    for evict in ("clear", "bound"):
        clear_cache()
        prev = set_cache_size(1)
        try:
            cs = ex._executable(bnd)
            cs(pa, bnd)
            held = weakref.ref(next(iter(cs._graphs.values())))
            del cs
            if evict == "clear":
                clear_cache()
            else:       # another boundary shape, another entry
                ex._executable({k: torch.cat([v, v]) for k, v in
                                bnd.items()})
            assert held() is None, evict
        finally:
            set_cache_size(prev)


@pytest.mark.cuda
def test_flash_prefill_fp32_takes_more_than_65535_batch_kv_heads(cuda):
    """B K = 65600: fp32's grid is one-dimensional and takes it, within
    1e-4 x max(1, max|ref|) of the plain version; bf16's (tiles, B K)
    grid does not, and the wrapper refuses it."""
    b, s, k, g, d = 8200, 16, 8, 1, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, s, k, g, d), generator=gen, device=cuda)
    kk = torch.randn((b, s, k, d), generator=gen, device=cuda)
    vv = torch.randn((b, s, k, d), generator=gen, device=cuda)
    assert attn_ops.prefill_plan(b, s, k, g, d).grid[1] == 1
    got = attn_ops.flash_prefill(q, kk, vv)
    want = attn_ref.flash_prefill_ref(q, kk, vv)
    torch.cuda.synchronize()
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    del got, want
    with pytest.raises(ValueError, match="launch limits"):
        attn_ops.flash_prefill(q.bfloat16(), kk.bfloat16(), vv.bfloat16())


@pytest.mark.cuda
def test_a_failed_capture_raises_and_keeps_no_graph(cuda, monkeypatch):
    """A body that reads a device value on the host cannot be captured:
    the stage raises, names the capture, keeps no graph, and runs no
    eager fallback; the card stays usable."""
    clear_cache()
    m, ex, frames, (pa, _) = _tiny_stage(cuda)
    bnd = ex.boundary_inputs({}, frames[0])
    cs = ex._executable(bnd)
    real = cs._run
    calls = []

    def reading(params, boundary):
        calls.append(len(calls))
        float(next(iter(boundary.values())).sum())      # a host read
        return real(params, boundary)

    monkeypatch.setattr(cs, "_run", reading)
    with pytest.raises(RuntimeError, match="capture"):
        cs(pa, bnd)
    assert calls == [0, 1] and not cs._graphs   # warm-up, then the capture
    torch.cuda.synchronize()
    assert float((torch.ones(4, device=cuda) * 2).sum()) == 8.0


@pytest.mark.cuda
def test_stage_graph_follows_an_installed_plan(cuda):
    """Graphs captured under the heuristic plans are not replayed after
    ``install`` changes the plans: the stage re-captures, and each replay
    equals its eager body under the plans installed at the time, bit for
    bit; the same after ``clear_installed``.  The launches a replay
    credits stay the body's."""
    clear_cache()
    autotune.clear_installed()
    m, ex, frames, (pa, _) = _tiny_stage(cuda)
    bnd = ex.boundary_inputs({}, frames[0])
    cs = ex._executable(bnd)
    heuristic = cs(pa, bnd)
    old = next(iter(cs._graphs.values()))
    # every conv shape of the stage: a plan other than the heuristic's
    # (the deepest split K allows on the other tile)
    tuned = {}
    for d in autotune.conv_shapes(m):
        (n, h, w, ci), (kh, kw, _, co) = d["x_shape"], d["w_shape"]
        p = ops.plan(n, h, w, ci, kh, kw, co, d["stride"], d["pool"])
        tile = ops.TILES[0] if p.tile == ops.TILES[1] else ops.TILES[1]
        tuned[autotune.shape_key(d["x_shape"], d["w_shape"], d["stride"],
                                 d["relu"], d["pool"])] = {
            "tile": list(tile), "split": 8 if p.split != 8 else 1,
            "best_us": 1.0, "backend": "cuda"}
    try:
        for step in ("install", "clear"):
            if step == "install":
                autotune.install(tuned)
            else:
                autotune.clear_installed()
            for _ in range(2):
                ops.reset_launches()
                got = cs(pa, bnd)
                torch.cuda.synchronize()
                n_graph = ops.launch_count()
                ops.reset_launches()
                with graph.eager():
                    want = cs(pa, bnd)
                torch.cuda.synchronize()
                assert n_graph == ops.launch_count() > 0
                for s in want:
                    assert torch.equal(got[s], want[s]), (step, s)
            assert len(cs._graphs) == 1
            assert next(iter(cs._graphs.values())) is not old
            old = next(iter(cs._graphs.values()))
        for s in heuristic:             # the heuristic plans are back
            assert torch.equal(got[s], heuristic[s])
    finally:
        autotune.clear_installed()


def _runtime_deployment(dev):
    m = zoo.vgg16(input_size=(40, 40), scale=0.1, head=True)
    dep = repro_torch.compile(m, make_pi_cluster([1.5, 1.2, 1.0, 0.8]),
                              params=params_from_numpy(np_params(m), dev),
                              device=dev)
    xs = [image(m, seed=s) for s in range(6)]
    return m, dep, xs


@pytest.mark.cuda
@pytest.mark.parametrize("max_batch", [1, 3])
def test_runtime_runs_the_stage_graphs_and_the_conv_kernel(max_batch, cuda):
    """The event-driven runtime with real compute on the card, frames
    arriving at half the plan's period: every frame completes; the conv
    kernel's launches are counted (with single-frame batches, as many as
    ``Deployment.run`` takes for the same frames); single-frame batches
    equal ``dep.run(frame)`` bit for bit, and the rest its outputs
    within 1e-4 x max|logit| (a batch folds frames into one pass); each
    frame's outputs, saved right after its stage ran, are unchanged by
    the replays of the frames after it.  The run captures the stages'
    graphs; a second runtime over the same frames captures none and
    launches as many kernels."""
    clear_cache()
    m, dep, xs = _runtime_deployment(cuda)
    rt = dep.runtime(repro_torch.DeploySpec(seed=0, max_batch=max_batch))
    assert rt.device == cuda and rt.model is m
    saved, batches = {}, {}
    run_batch = rt._exec_batch

    def spy(t, st, batch):
        run_batch(t, st, batch)
        for fr in batch.frames:
            batches.setdefault(fr.fid, set()).add(len(batch))
            saved.update({(fr.fid, k): v.clone()
                          for k, v in fr.produced.items()})

    rt._exec_batch = spy
    captured = graph.captures()
    ops.reset_launches()
    rep = rt.run(inputs=xs, interarrival=dep.period / 2)
    torch.cuda.synchronize()
    launches = ops.launch_count()
    assert rep.completed == len(xs) and rep.dropped == 0
    assert launches > 0 and graph.captures() > captured
    captured = graph.captures()
    ops.reset_launches()
    again = dep.runtime(repro_torch.DeploySpec(
        seed=0, max_batch=max_batch)).run(inputs=xs,
                                          interarrival=dep.period / 2)
    torch.cuda.synchronize()
    assert graph.captures() == captured
    assert ops.launch_count() == launches
    for i in range(len(xs)):
        for k, v in again.outputs[i].items():
            assert torch.equal(v, rep.outputs[i][k])
    for fr in rt._all_frames:
        for k, v in fr.produced.items():
            assert v.device.type == "cuda"
            assert torch.equal(v, saved[(fr.fid, k)])
    ops.reset_launches()
    want = [dep.run(x) for x in xs]
    torch.cuda.synchronize()
    if max_batch == 1:
        assert launches == ops.launch_count()
    else:
        assert any(max(b) > 1 for b in batches.values())
    for i, w in enumerate(want):
        got = rep.outputs[i]
        assert got.keys() == w.keys()
        for k in w:
            if batches[i] == {1}:
                assert torch.equal(got[k], w[k])
            else:
                tol = 1e-4 * w[k].abs().max().item()
                assert (got[k] - w[k]).abs().max().item() <= tol


def test_runtime_refuses_a_missing_card(monkeypatch):
    """With no CUDA device, a real-compute runtime on the default device
    raises at construction rather than running on the CPU; timing-only
    and ``device="cpu"`` runtimes build."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m, dep, _ = _runtime_deployment("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineRuntime(model=m, params=dep.params, cluster=dep.cluster)
    PipelineRuntime(g=m.graph, input_size=m.input_size, cluster=dep.cluster,
                    config=RuntimeConfig())
    rt = PipelineRuntime(model=m, params=dep.params, cluster=dep.cluster,
                         device="cpu")
    assert rt.device.type == "cpu"


# -- training: the prefill's backward kernel and the grad guard ------------

def _bwd_inputs(case, dev):
    b, s, k, g, d, w = PREFILL_CASES[case]
    q, kk, vv = (_t(a, dev) for a in prefill_inputs(b, s, k, g, d))
    do = torch.tensor(np.random.default_rng(9).standard_normal(q.shape),
                      dtype=torch.float32, device=dev)
    return q, kk, vv, do, w


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_flash_prefill_bwd_kernel_matches_plain_version(case, cuda):
    """dq, dk, dv of the backward kernel (one counted launch: its stats
    kernel, then its dK/dV and dQ blocks)
    within 1e-4 x max|ref| of ``flash_prefill_bwd_ref``, and the same
    bits on a second call (no atomics)."""
    q, kk, vv, do, w = _bwd_inputs(case, cuda)
    o = attn_ops.flash_prefill(q, kk, vv, sliding_window=w)
    before = attn_ops.launch_count("flash_prefill_bwd")
    got = attn_ops.flash_prefill_bwd(q, kk, vv, o, do, sliding_window=w)
    again = attn_ops.flash_prefill_bwd(q, kk, vv, o, do, sliding_window=w)
    torch.cuda.synchronize()
    assert attn_ops.launch_count("flash_prefill_bwd") == before + 2
    want = attn_ref.flash_prefill_bwd_ref(q, kk, vv, o, do, w)
    for x, y, z in zip(got, again, want):
        assert x.shape == z.shape and x.dtype == torch.float32
        assert torch.equal(x, y)
        assert (x - z).abs().max().item() <= 1e-4 * z.abs().max().item()


@pytest.mark.cuda
def test_flash_prefill_function_differentiates_through_the_kernels(cuda):
    """``FlashPrefill.apply`` on the card: the forward kernel, and in the
    backward the backward kernel (its gradients bit-equal to a direct
    call), within 1e-4 x max|g| of plain autograd."""
    q, kk, vv, do, w = _bwd_inputs("s200_g4_w32", cuda)
    leaves = [t.clone().requires_grad_() for t in (q, kk, vv)]
    before = (attn_ops.launch_count("flash_prefill"),
              attn_ops.launch_count("flash_prefill_bwd"))
    out = attn_ops.FlashPrefill.apply(*leaves, w)
    got = torch.autograd.grad(out, leaves, do)
    assert (attn_ops.launch_count("flash_prefill"),
            attn_ops.launch_count("flash_prefill_bwd")) == \
        (before[0] + 1, before[1] + 1)
    direct = attn_ops.flash_prefill_bwd(q, kk, vv, out.detach(), do,
                                        sliding_window=w)
    plain = [t.clone().requires_grad_() for t in (q, kk, vv)]
    want = torch.autograd.grad(attn_ref.flash_prefill_ref(*plain, w),
                               plain, do)
    for g, d, p in zip(got, direct, want):
        assert torch.equal(g, d)
        assert (g - p).abs().max().item() <= 1e-4 * p.abs().max().item()


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_inputs_that_require_grad(cuda):
    """On the card a kernel's output has no grad_fn, so each wrapper
    raises on an input that requires grad while grad mode is on (the
    message names the kernel and where its backward stands), and runs
    under ``torch.no_grad``; ``moe_gemm``'s message points to
    ``MoeGemm``, the way to differentiate it; a bf16 prefill or expert
    product that needs a gradient is refused too (fp32 training only)."""
    q, kk, vv, _, _ = _bwd_inputs("s64", cuda)
    x, dt, A, Bm, Cm = (_t(a, cuda) for a in ssd_inputs(2, 64, 2, 16, 16))
    xe, we = (_t(a, cuda) for a in moe_gemm_inputs(2, 8, 16, 16))
    xc, wc, bc = (_t(a, cuda) for a in conv_inputs((1, 9, 11, 8),
                                                   (3, 3, 8, 16), True))
    vl = torch.tensor(8, dtype=torch.int32, device=cuda)
    calls = {
        "flash_prefill": lambda g: attn_ops.flash_prefill(g, kk, vv),
        "decode_attention": lambda g: attn_ops.decode_attention(
            g[:, 0].contiguous(), kk, vv, vl),
        "ssd_chunk.*SsdChunk": lambda g: ssd_ops.ssd_chunk(x, dt, A, g, Cm),
        "moe_gemm.*MoeGemm": lambda g: moe_ops.moe_gemm(xe, g),
        "conv2d_fused": lambda g: ops.conv2d_fused(xc, g, bc),
    }
    marked = {"flash_prefill": q, "decode_attention": q,
              "ssd_chunk.*SsdChunk": Bm, "moe_gemm.*MoeGemm": we,
              "conv2d_fused": wc}
    for name, call in calls.items():
        g = marked[name].clone().requires_grad_()
        with pytest.raises(NotImplementedError, match=name):
            call(g)
        with torch.no_grad():
            call(g)
    with pytest.raises(NotImplementedError, match="item 11"):
        attn_ops.FlashPrefill.apply(q.bfloat16().requires_grad_(),
                                    kk.bfloat16(), vv.bfloat16(), 0)
    with pytest.raises(NotImplementedError, match="moe_gemm.*bf16"):
        moe_ops.MoeGemm.apply(xe.bfloat16(), we.bfloat16().requires_grad_())
    with pytest.raises(NotImplementedError, match="ssd_chunk.*bf16"):
        ssd_ops.SsdChunk.apply(x.bfloat16(), dt.bfloat16(), A.bfloat16(),
                               Bm.bfloat16().requires_grad_(), Cm.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 512, 1536, 512), (40, 512, 512, 1536),
                                   (4, 10, 1024, 256)])
def test_moe_gemm_function_differentiates_through_the_kernel(shape, cuda):
    """``MoeGemm.apply`` on the card at granite's training shapes (the
    w1/w3 product and its w2 twin, C = 4 x 128 slots) and at a C that is
    no multiple of 4 (dx's 64-row tile; dw's depth, with a k tail): one
    ``moe_gemm`` launch forward,
    two ``moe_gemm_bwd`` launches backward, each on the plan of its own
    shape; dx and dw bit-equal to direct ``moe_gemm_nt(dy, w)`` and
    ``moe_gemm_tn(x, dy)`` calls, and within 1e-4 x max(1, max|g|) of
    autograd of the plain version."""
    e, c, d, f = shape
    x, w = (_t(a, cuda) for a in moe_gemm_inputs(e, c, d, f))
    dy = torch.tensor(np.random.default_rng(9).standard_normal((e, c, f)),
                      dtype=torch.float32, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (x, w)]
    y = moe_ops.MoeGemm.apply(*leaves)
    before = (moe_ops.launch_count("moe_gemm"),
              moe_ops.launch_count("moe_gemm_bwd"))
    plans = dict(moe_ops.bwd_plan_counts)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (moe_ops.launch_count("moe_gemm"),
            moe_ops.launch_count("moe_gemm_bwd")) == (before[0],
                                                      before[1] + 2)
    for plan in (moe_ops.bwd_plan("nt", e, c, d, f),
                 moe_ops.bwd_plan("tn", e, d, f, c)):
        plans[plan.name] += 1
    assert moe_ops.bwd_plan_counts == plans
    direct = (moe_ops.moe_gemm_nt(dy, w), moe_ops.moe_gemm_tn(x, dy))
    plain = [t.clone().requires_grad_() for t in (x, w)]
    want = torch.autograd.grad(moe_ref.moe_gemm_ref(*plain), plain, dy)
    for g, dg, p in zip(got, direct, want):
        assert torch.equal(g, dg)
        limit = 1e-4 * max(1.0, p.abs().max().item())
        assert (g - p).abs().max().item() <= limit


MOE_BWD_SHAPES = sorted(MOE_GEMM_CASES) + ["granite", "granite_w2"]


def _moe_bwd_shape(case):
    return {"granite": (40, 512, 1536, 512),
            "granite_w2": (40, 512, 512, 1536)}.get(case) \
        or MOE_GEMM_CASES[case]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nt", "tn"])
@pytest.mark.parametrize("case", MOE_BWD_SHAPES)
def test_moe_gemm_bwd_kernel_matches_plain_version(case, layout, cuda):
    """``moe_gemm_nt(dy, w)`` (dx) and ``moe_gemm_tn(x, dy)`` (dw) at each
    ``MOE_GEMM_CASES`` shape (64- and 128-row tiles, rows that are no
    multiple of 4) and granite's training products: one launch on the
    plan of its shape, within 1e-4 x max(1, max|ref|) of the plain
    version, and the same bits twice (no atomics, no split across
    blocks)."""
    e, c, d, f = _moe_bwd_shape(case)
    x, w = (_t(a, cuda) for a in moe_gemm_inputs(e, c, d, f))
    dy = torch.tensor(np.random.default_rng(3).standard_normal((e, c, f)),
                      dtype=torch.float32, device=cuda)
    if layout == "nt":
        call, plain, args, plan = (moe_ops.moe_gemm_nt, moe_ref.moe_gemm_nt_ref,
                                   (dy, w), moe_ops.bwd_plan("nt", e, c, d, f))
    else:
        call, plain, args, plan = (moe_ops.moe_gemm_tn, moe_ref.moe_gemm_tn_ref,
                                   (x, dy), moe_ops.bwd_plan("tn", e, d, f, c))
    before = moe_ops.launch_count("moe_gemm_bwd")
    plans = dict(moe_ops.bwd_plan_counts)
    got = call(*args)
    torch.cuda.synchronize()
    assert moe_ops.launch_count("moe_gemm_bwd") == before + 1
    plans[plan.name] += 1
    assert moe_ops.bwd_plan_counts == plans
    want = plain(*args)
    assert got.shape == want.shape and got.dtype == torch.float32
    limit = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= limit
    assert torch.equal(got, call(*args))


@pytest.mark.cuda
def test_moe_gemm_bwd_refuses_a_misaligned_pointer(cuda):
    """A view 4 bytes off 16-byte alignment: the wrapper plans 4-byte
    loads and runs right; the C side refuses a 16-byte plan on it (the
    launch raises)."""
    e, c, d, f = 2, 24, 32, 16
    dy = torch.randn(e * c * f + 1, device=cuda)[1:].view(e, c, f)
    w = torch.randn(e, d, f, device=cuda)
    assert dy.data_ptr() % 16 and dy.is_contiguous()
    got = moe_ops.moe_gemm_nt(dy, w)
    want = moe_ref.moe_gemm_nt_ref(dy, w)
    assert (got - want).abs().max().item() <= 1e-4 * max(
        1.0, want.abs().max().item())
    plan = moe_ops.bwd_plan("nt", e, c, d, f, True)
    assert plan.vec and not moe_ops.bwd_plan("nt", e, c, d, f, False).vec
    with pytest.raises(RuntimeError, match="moe_gemm_bwd launch failed"):
        moe_ops._launch_bwd(dy, w, torch.empty(e, c, d, device=cuda),
                            (e, c, d, f), plan)


@pytest.mark.cuda
def test_moe_gemm_bwd_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    """bf16 (no bf16 backward), operands on two devices, a strided
    operand, and a product that needs a gradient (no double backward):
    ``ValueError`` and ``NotImplementedError``; nothing launches."""
    x, w = (_t(a, cuda) for a in moe_gemm_inputs(*MOE_GEMM_CASES["e4"]))
    dy = torch.ones(x.shape[0], x.shape[1], w.shape[2], device=cuda)
    before = moe_ops.launch_count("moe_gemm_bwd")
    for call, args in [(moe_ops.moe_gemm_nt, (dy.bfloat16(), w.bfloat16())),
                       (moe_ops.moe_gemm_nt, (dy, w.cpu())),
                       (moe_ops.moe_gemm_tn, (x.transpose(1, 2).contiguous()
                                              .transpose(1, 2), dy))]:
        with pytest.raises(ValueError):
            call(*args)
    with pytest.raises(NotImplementedError, match="moe_gemm_bwd"):
        moe_ops.moe_gemm_tn(x.clone().requires_grad_(), dy)
    assert moe_ops.launch_count("moe_gemm_bwd") == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "musicgen-medium",
                                  "granite-moe-3b-a800m", "mixtral-8x7b",
                                  "mamba2-370m", "zamba2-2.7b"])
def test_loss_gradients_on_the_card_match_the_torch_backend(arch, cuda):
    """Reduced Llama (tokens), musicgen (the ``embeds`` mode), granite and
    mixtral (MoE), mamba2 (SSM) and zamba2 (hybrid) on the card:
    ``loss_and_grads`` through the kernels (remat: two flash_prefill an
    attention, one flash_prefill_bwd; MoE: 6 moe_gemm a layer, 3
    forward and 3 in the recompute, and 6 moe_gemm_bwd; Mamba2: two ssd_chunk a
    layer, one ssd_chunk_bwd) against ``backend="torch"``: loss within
    1e-5 relative, each leaf within 1e-3 x max|g| of its leaf."""
    cfg = configs.get(arch).reduced(n_layers=2, d_model=128)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device=cuda)
    batch = TokenStream(cfg.vocab_size, 2, 96, device=str(cuda)).batches(1)[0]
    if cfg.input_mode == "embeds":
        rng = np.random.default_rng(4)
        batch = {"embeds": _t(rng.standard_normal(
            (2, 96, cfg.d_model)).astype(np.float32), cuda),
            "labels": batch["labels"]}
    attn_ops.reset_launches()
    moe_ops.reset_launches()
    ssd_ops.reset_launches()
    loss, grads = loss_and_grads(cfg, params, batch)
    L = cfg.n_layers
    attn = M.n_shared_apps(cfg) if cfg.shared_attn_every \
        else 0 if cfg.is_ssm else L
    assert (attn_ops.launch_count("flash_prefill"),
            attn_ops.launch_count("flash_prefill_bwd")) == (2 * attn, attn)
    assert (moe_ops.launch_count("moe_gemm"),
            moe_ops.launch_count("moe_gemm_bwd")) == \
        ((6 * L, 6 * L) if cfg.is_moe else (0, 0))
    mamba = L if cfg.is_ssm else 0
    assert (ssd_ops.launch_count("ssd_chunk"),
            ssd_ops.launch_count("ssd_chunk_bwd")) == (2 * mamba, mamba)
    loss_t, grads_t = loss_and_grads(cfg, params, batch, backend="torch")
    assert abs(loss.item() - loss_t.item()) <= 1e-5 * abs(loss_t.item())
    for g, gt in zip(tree.leaves(grads), tree.leaves(grads_t)):
        assert torch.isfinite(g).all()
        assert (g - gt).abs().max().item() <= 1e-3 * gt.abs().max().item()


@pytest.mark.cuda
def test_train_launcher_trains_on_the_card(cuda):
    attn_ops.reset_launches()
    rep = train_launcher.main(["--reduced", "--steps", "2", "--batch", "2",
                               "--seq", "64"])
    assert len(rep.losses) == 2 and all(np.isfinite(rep.losses))
    assert (attn_ops.launch_count("flash_prefill"),
            attn_ops.launch_count("flash_prefill_bwd")) == (8, 4)


@pytest.mark.cuda
def test_microbatch_pipeline_two_gloo_ranks_on_one_card(cuda):
    """Two gloo ranks on cuda:0, a reduced Llama (4 layers, d 128) as two
    stages of two layers through the flash_prefill kernel, 6 microbatches
    of (2, 64) tokens: both ranks return the same bits as the one-process
    run of the same stages; (2 + 6 - 1) ticks x 2 layers launches a rank,
    every hand-off staged through the host (gloo)."""
    cfg = configs.get("llama3.2-1b").reduced(n_layers=4, d_model=128)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (6, 2, 64))
    res = run_ranks(body_cuda_two, 2, cfg, toks)
    for r in res:
        assert np.array_equal(r["out"], res[0]["sequential"])
        assert r["launches"] == 7 * 2
        assert r["hand_offs"] == {"direct": 0, "host": 7}


@pytest.mark.cuda
def test_ring_attention_two_gloo_ranks_on_one_card(cuda):
    """Two gloo ranks on cuda:0, ``ring_attention`` at (2, 128, 2, 4, 64)
    with windows 0 and 48, forward and backward: both ranks return the
    same bits, within 2e-4 of the one-process ``FlashPrefill`` (the
    flash_prefill kernel and its backward kernel); one forward hand-off
    and two backward ones a call, each staged through the host (gloo)."""
    rng = np.random.default_rng(0)
    shape, kv = (2, 128, 2, 4, 64), (2, 128, 2, 64)
    inputs = {t: rng.standard_normal(kv if t in "kv" else shape)
              .astype(np.float32) for t in ("q", "k", "v", "do")}
    res = run_ranks(body_cuda_ring, 2, inputs, (0, 48))
    for w in (0, 48):
        one = res[0][("one", w)]
        for r in res:
            got = r[("ring", w)]
            assert got["hand_offs"] == {"direct": 0, "host": 3}
            for key in ("o", "dq", "dk", "dv"):
                assert np.array_equal(got[key], res[0][("ring", w)][key])
                np.testing.assert_allclose(got[key], one[key], rtol=2e-4,
                                           atol=2e-4)


@pytest.mark.cuda
def test_sharded_loss_and_grads_two_gloo_ranks_on_one_card(cuda):
    """Two gloo ranks on cuda:0, a (1, 2) ("data", "model") mesh, the
    reduced Llama (2 layers, d 128) placed by ``param_pspecs``, tokens
    (2, 64), ``act_pspec=P(("data",), "model", None)``: ``loss_and_grads``
    through the flash_prefill kernel and its backward on each rank's kv
    heads (4 forward launches with remat's recompute, 2 backward), every
    DTensor collective direct on the CUDA tensors.  Both ranks hold the
    same loss and gradients, within 1e-6 relative and 5e-5 x max|leaf|
    (``tests/test_torch_training.py``'s LOSS_REL and GRAD_REL) of the
    one-process kernel path."""
    cfg = configs.get("llama3.2-1b").reduced(n_layers=2, d_model=128)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))
    res = run_ranks(body_cuda_shard, 2, cfg, toks)
    loss1, grads1 = res[0]["one"]
    for r in res:
        assert r["launches"] == {"flash_prefill": 4, "flash_prefill_bwd": 2}
        assert abs(r["loss"] - loss1) <= 1e-6 * abs(loss1)
        assert len(r["grads"]) == len(grads1)
        for g, g0, w in zip(r["grads"], res[0]["grads"], grads1):
            assert np.array_equal(g, g0)
            err = np.abs(g - w).max()
            assert err <= 5e-5 * np.abs(w).max(), (err, np.abs(w).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid_len", [0, 1, 240, 272])
def test_decode_lse_matches_plain_version(valid_len, dtype, cuda):
    """``decode_attention(..., with_lse=True)`` at a sharded decode's local
    shard (q (2, 4, 4, 64), 272 entries): one launch, the output within
    the attention band and each row's lse within 1e-5 x max(1, |ref|) of
    the plain version's (about -1e30 with no valid entry), the same bits
    on a second call."""
    q, kk, vv = (_t(a, cuda).to(dtype)
                 for a in decode_inputs(2, 4, 4, 64, 272))
    vl = torch.tensor(valid_len, dtype=torch.int32, device=cuda)
    before = attn_ops.launch_count("decode_attention")
    got, lse = attn_ops.decode_attention(q, kk, vv, vl, with_lse=True)
    torch.cuda.synchronize()
    assert attn_ops.launch_count("decode_attention") == before + 1
    want, want_lse = attn_ref.decode_attention_ref(q, kk, vv, vl,
                                                   with_lse=True)
    _assert_attn_close(got, want, dtype)
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 4)
    assert ((lse - want_lse).abs()
            <= 1e-5 * want_lse.abs().clamp_min(1)).all()
    again, lse2 = attn_ops.decode_attention(q, kk, vv, vl, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_sharded_decode_two_gloo_ranks_on_one_card(cuda):
    """Two gloo ranks on cuda:0, a (1, 2) ("data", "model") mesh, the
    reduced Llama (2 layers, d 128): the kernel path's prefill cache
    placed by ``cache_pspecs`` in feature mode (head dim split; an
    all-to-all to the kernel's kv heads) and in sequence mode (W split;
    each rank's kernel with the lse output, the halves combined), 3
    decode steps: two ``decode_attention`` launches a step a rank, the
    logits on both ranks bit-equal and within 1e-4 x max|ref| of the
    one-process kernel path."""
    cfg = configs.get("llama3.2-1b").reduced(n_layers=2, d_model=128)
    # 8 prefilled tokens and room for 4: W 12, shards of 6
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9))
    res = run_ranks(body_cuda_sdecode, 2, cfg, toks, 3)
    want = res[0]["one"]["logits"]
    for mode, split in (("feature", "S(4)"), ("sequence", "S(2)")):
        for r in res:
            got = r[mode]
            assert got["places"][1] == split       # the model axis's
            assert got["launches"] == [cfg.n_layers] * 3
            for a, b, w in zip(got["logits"], res[0][mode]["logits"], want):
                assert np.array_equal(a, b)
                assert np.abs(a - w).max() <= 1e-4 * np.abs(w).max()
