"""The port's MoE path against the JAX package's, on the same inputs: the
plain version of the grouped expert GEMM against the Pallas kernel (in
interpret mode), and the ``moe`` layer (output and aux loss) against the
reference's, with and without dropped tokens; and the wrapper's CPU
path and checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm.moe_gemm import moe_gemm as ref_moe_gemm
from repro.models.transformer import layers as RL
from repro_torch.kernels.moe_gemm import ops, ref
from repro_torch.models.transformer import layers as L

from _torch_cases import (MOE_GEMM_CASES, MOE_GEMM_VARIANTS, c_argtypes,
                          moe_gemm_inputs)

# tests/test_kernels.py's bands.  fp32: sums in another order than XLA's;
# bf16: the output rounded once, after sums that may differ in the last
# fp32 bit.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# the layer in fp32: the expert GEMMs and the k-way combine sum in
# another order than XLA's einsums and scatter-add
MOE_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MOE_GEMM_CASES))
def test_moe_gemm_ref_matches_the_reference(case, dtype):
    e, c, d, f = MOE_GEMM_CASES[case]
    x, w = moe_gemm_inputs(e, c, d, f)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = ref.moe_gemm_ref(torch.tensor(x).to(tdt), torch.tensor(w).to(tdt))
    assert got.shape == (e, c, f) and got.dtype == tdt
    want = ref_moe_gemm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                        interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _moe_inputs(skew: float, B=2, S=24, d=32, E=6, ff=16, seed=0):
    """Reference-layout MoE weights and an input.  ``skew`` > 0 adds a
    shared direction to every token and aims expert 0's router column at
    it, so most tokens rank expert 0 first and it overflows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d))
    router = rng.standard_normal((d, E)) / np.sqrt(d)
    if skew:
        u = rng.standard_normal(d)
        u /= np.linalg.norm(u)
        x += 2.0 * u
        router[:, 0] += skew * u
    w1 = rng.standard_normal((E, d, ff)) / np.sqrt(d)
    w3 = rng.standard_normal((E, d, ff)) / np.sqrt(d)
    w2 = rng.standard_normal((E, ff, d)) / np.sqrt(ff)
    return [a.astype(np.float32) for a in (x, router, w1, w3, w2)]


def _most_assigned(x, router, top_k):
    """Largest number of (token, k) assignments one sample gives one
    expert, from the reference's own routing."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    idx = np.asarray(idx).reshape(x.shape[0], -1)
    return max(np.bincount(row, minlength=router.shape[1]).max()
               for row in idx)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("skew,top_k", [(0.0, 2), (0.0, 3), (6.0, 2)])
def test_moe_matches_the_reference(skew, top_k, backend):
    x, router, w1, w3, w2 = _moe_inputs(skew)
    B, S, _ = x.shape
    E = router.shape[1]
    cap = max(1, int(1.25 * top_k * S / E))
    if skew:    # the case that drops tokens does drop some
        assert _most_assigned(x, router, top_k) > cap
    want, want_aux = RL.moe(RL.MoeParams(*map(jnp.asarray,
                                              (router, w1, w3, w2))),
                            jnp.asarray(x), top_k)
    ops.reset_launches()
    got, aux = L.moe(L.MoeParams(*map(torch.tensor, (router, w1, w3, w2))),
                     torch.tensor(x), top_k, backend=backend)
    assert ops.launch_count("moe_gemm") == 0      # CPU: the plain version
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_moe_decode_capacity_is_one_slot_per_sample():
    """One token per sample (decode): ``cap`` is 1 and every one of the
    token's k distinct experts keeps it."""
    x, router, w1, w3, w2 = _moe_inputs(0.0, B=3, S=1)
    want, _ = RL.moe(RL.MoeParams(*map(jnp.asarray, (router, w1, w3, w2))),
                     jnp.asarray(x), 2)
    got, _ = L.moe(L.MoeParams(*map(torch.tensor, (router, w1, w3, w2))),
                   torch.tensor(x), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)


def test_wrapper_on_cpu_runs_the_plain_version_and_launches_nothing():
    ops.reset_launches()
    x, w = map(torch.tensor, moe_gemm_inputs(*MOE_GEMM_CASES["c4"]))
    torch.testing.assert_close(ops.moe_gemm(x, w), ref.moe_gemm_ref(x, w),
                               rtol=0, atol=0)
    assert ops.launch_count("moe_gemm") == 0


def test_wrapper_refuses_bad_shapes():
    x, w = map(torch.tensor, moe_gemm_inputs(*MOE_GEMM_CASES["e4"]))
    for args in [(x[0], w),                 # x not 3-d
                 (x, w[:2]),                # another expert count
                 (x, w[:, :8])]:            # another depth
        with pytest.raises(ValueError):
            ops.moe_gemm(*args)


def test_cuda_checks_refuse_what_the_kernel_does_not_take():
    x, w = map(torch.tensor, moe_gemm_inputs(*MOE_GEMM_CASES["e4"]))
    ops._check_cuda(x, w)                                # accepted
    for args in [(x.double(), w.double()),               # dtype
                 (x, w.bfloat16()),                      # mixed
                 (x.transpose(1, 2), w),                 # strided x
                 (x, w.transpose(1, 2))]:                # strided w
        with pytest.raises(ValueError):
            ops._check_cuda(*args)


@pytest.mark.parametrize("name", sorted(ops.SOURCES))
def test_ctypes_signature_matches_the_c_prototype(name):
    assert ops.ARGTYPES[name] == c_argtypes(ops.SOURCES[name], name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(MOE_GEMM_CASES))
def test_variant_choice_follows_shape_and_dtype(case, dtype):
    e, c, d, f = MOE_GEMM_CASES[case]
    want = MOE_GEMM_VARIANTS[case][dtype == torch.bfloat16]
    assert ops.variant(e, c, d, f, dtype) == want
    # a pointer off the 16-byte grid takes the general variant
    assert ops.variant(e, c, d, f, dtype, aligned=False) == "general"


@pytest.mark.parametrize("shape", [(40, 1536, 512), (40, 512, 1536),
                                   (8, 4096, 14336), (3, 24, 8), (1, 0, 8),
                                   (4, 1024, 256), (2, 3000, 64)])
def test_stream_split_stays_in_one_wave_within_its_limits(shape):
    """fp32 decode: granite's w1/w2, mixtral-sized experts, a tiny D, an
    empty one, a narrow wide-D case and a D past one split's limit: the
    rows of D a block takes are a multiple of 8 up to MAX_SPLIT_ROWS,
    every split has rows, D is split only while the blocks fit one wave
    (or its length forces it), and a split keeps 64 rows where D has
    them."""
    e, d, f = shape
    rows = ops.split_rows(e, d, f)
    assert rows % 8 == 0 and 8 <= rows <= ops.MAX_SPLIT_ROWS
    splits = max(1, -(-d // rows))
    assert (splits - 1) * rows < max(d, 1)
    base = e * -(-f // ops.STREAM_SLAB)
    if splits > -(-d // ops.MAX_SPLIT_ROWS):
        assert base * splits <= ops.STREAM_BLOCKS
        assert rows >= 64 or rows >= d


def test_granite_decode_plan():
    """granite-moe-3b-a800m's decode GEMMs: bf16 streams w through the
    TMA ring (no split, no scratch); fp32 w1 (D 1536, F 512) in one
    split of 1536 rows over 160 slabs, and a 16-way split where D is long
    and the slabs few."""
    assert ops._plan(40, 4, 1536, 512, torch.bfloat16, True) == \
        ("stream", 0, 0, 0)
    assert ops._plan(40, 4, 1536, 512, torch.float32, True) == \
        ("stream", 1536, 0, 160)
    assert ops._plan(4, 12, 1024, 256, torch.float32, True) == \
        ("stream", 64, 16 * 4 * 12 * 256, 8)
    # bf16 with a D that TMA cannot address: the general variant
    assert ops._plan(3, 4, 36, 16, torch.bfloat16, True) == \
        ("general", 0, 0, 0)
    assert ops._plan(40, 508, 1536, 512, torch.bfloat16, True) == \
        ("wgmma", 0, 0, 0)


@pytest.mark.parametrize("d,rows", [(0, 128), (3, 64)])
def test_grid_limit_follows_the_variant(d, rows):
    """C tiles of 128 rows for simt (D a multiple of 4), 64 for general
    (D = 3): one row more than 65535 tiles is refused."""
    f = 4
    ok = torch.empty((1, rows * ops.MAX_GRID_Y, d))
    too_many = torch.empty((1, rows * ops.MAX_GRID_Y + 1, d))
    w = torch.empty((1, d, f))
    ops._check_cuda(ok, w)
    with pytest.raises(ValueError):
        ops._check_cuda(too_many, w)


def test_reset_clears_the_variant_counts():
    ops.variant_counts["stream"] += 3
    ops.reset_launches()
    assert set(ops.variant_counts.values()) == {0}
    assert tuple(ops.variant_counts) == ops.VARIANTS
