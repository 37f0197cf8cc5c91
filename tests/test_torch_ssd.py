"""The port's SSD path against the JAX package's, on the same inputs: the
plain version of the intra-chunk kernel against the Pallas kernel (in
interpret mode) and its jnp oracle, ``ssd_chunked`` and the Mamba2
prefill/decode layers against the reference's; and the wrapper's CPU
path and checks."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels.ssd.ref import ssd_chunk_ref as ref_ssd_chunk_ref
from repro.kernels.ssd.ssd_chunk import ssd_chunk as ref_ssd_chunk
from repro.models.transformer import layers as RL
from repro.models.transformer import model as RM
from repro_torch import configs
from repro_torch.kernels.ssd import ops, ref
from repro_torch.models.transformer import layers as L

from _torch_cases import SSD_CASES, SSD_EDGE_CASES, c_argtypes, ssd_inputs

# tests/test_kernels.py's bands.  fp32: sums (and the cumsum) in another
# order than XLA's.  bf16: M and x·w rounded to bf16, where a different
# fp32 sum can round one ulp apart.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# layers, against the reference in fp32: the band tests/test_kernels.py's
# kernel-plus-scan composition test and tests/test_transformer.py use
LAYER_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_chunk_ref_matches_the_reference(case, dtype):
    bc, q, h, p, n = SSD_CASES[case]
    arrays = ssd_inputs(bc, q, h, p, n)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y, st = ref.ssd_chunk_ref(*(torch.tensor(a).to(tdt) for a in arrays))
    assert y.shape == (bc, q, h, p) and st.shape == (bc, h, p, n)
    assert y.dtype == st.dtype == tdt
    jargs = [jnp.asarray(a, jdt) for a in arrays]
    wants = [ref_ssd_chunk(*jargs, interpret=True)]
    if dtype == "float32":    # the jnp oracle rounds elsewhere in bf16
        wants.append(ref_ssd_chunk_ref(*jargs))
    for wy, wst in wants:
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(wy, np.float32), **TOL[dtype])
        np.testing.assert_allclose(st.float().numpy(),
                                   np.asarray(wst, np.float32), **TOL[dtype])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("S,chunk,with_h0", [(32, 8, False), (32, 8, True),
                                             (37, 8, False)])
def test_ssd_chunked_matches_the_reference(S, chunk, with_h0, backend):
    """Four chunks of 8 (with and without an entering state), and S = 37,
    which no tile of 64 or more divides, so the chunk is all of S."""
    B, H, P, N = 2, 3, 8, 16
    x, dt, A, Bm, Cm = ssd_inputs(B, S, H, P, N, seed=1)
    Dskip = np.linspace(0.5, 1.5, H).astype(np.float32)
    h0 = (0.1 * np.random.default_rng(2).standard_normal((B, H, P, N))
          ).astype(np.float32) if with_h0 else None
    want_y, want_h = RL.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, Bm, Cm, Dskip)), chunk=chunk,
        h0=None if h0 is None else jnp.asarray(h0))
    ops.reset_launches()
    y, h = L.ssd_chunked(*map(torch.tensor, (x, dt, A, Bm, Cm, Dskip)),
                         chunk=chunk,
                         h0=None if h0 is None else torch.tensor(h0),
                         backend=backend)
    assert ops.launch_count("ssd_chunk") == 0     # CPU: the plain version
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **LAYER_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **LAYER_TOL)


def _mamba_layer():
    """(reference cfg, its layer-0 MambaParams, the port's, as torch)."""
    rcfg = ref_configs.get("mamba2-370m").reduced(n_layers=2, d_model=128)
    tree = RM.init_params(rcfg, jax.random.PRNGKey(0))
    rp = jax.tree.map(lambda a: a[0], tree["layers"]["mamba"])
    port = L.MambaParams(*(torch.tensor(np.asarray(a)) for a in rp))
    return rcfg, rp, port


def test_mamba2_prefill_and_decode_match_the_reference():
    rcfg, rp, port = _mamba_layer()
    cfg = configs.get("mamba2-370m").reduced(n_layers=2, d_model=128)
    dims = dict(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                n_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim,
                norm_eps=cfg.norm_eps)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    want, rcache = RL.mamba2_prefill(rp, jnp.asarray(x), **dims)
    got, cache = L.mamba2_prefill(port, torch.tensor(x), **dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(rcache[key]), **LAYER_TOL)
    for step in range(4):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, rcache = RL.mamba2_decode(rp, jnp.asarray(xt), rcache, **dims)
        before = {k: t.clone() for k, t in cache.items()}
        got, cache_new = L.mamba2_decode(port, torch.tensor(xt), cache,
                                         **dims)
        assert all(torch.equal(before[k], cache[k]) for k in cache)
        cache = cache_new
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LAYER_TOL)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(rcache[key]), **LAYER_TOL)


def test_causal_conv_matches_the_reference_with_a_state():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for st in (None, state):
        want = RL._causal_conv(*map(jnp.asarray, (x, w, b)),
                               state=None if st is None else jnp.asarray(st))
        got = L._causal_conv(*map(torch.tensor, (x, w, b)),
                             state=None if st is None else torch.tensor(st))
        for g, wv in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wv),
                                       rtol=1e-6, atol=1e-6)


def test_wrapper_on_cpu_runs_the_plain_version_and_launches_nothing():
    ops.reset_launches()
    args = [torch.tensor(a) for a in ssd_inputs(*SSD_CASES["q37"])]
    for got, want in zip(ops.ssd_chunk(*args), ref.ssd_chunk_ref(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ops.launch_count("ssd_chunk") == 0


def test_wrapper_refuses_bad_shapes():
    x, dt, A, Bm, Cm = (torch.tensor(a)
                        for a in ssd_inputs(*SSD_CASES["q16"]))
    for args in [(x[0], dt, A, Bm, Cm),             # x not 4-d
                 (x, dt[:, :8], A, Bm, Cm),         # dt shorter
                 (x, dt, A[:1], Bm, Cm),            # A of another H
                 (x, dt, A, Bm, Cm[..., :4]),       # C of another N
                 (x, dt, A, Bm[:1], Cm[:1])]:       # B/C of another BC
        with pytest.raises(ValueError):
            ops.ssd_chunk(*args)


def test_cuda_checks_refuse_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm = (torch.tensor(a)
                        for a in ssd_inputs(*SSD_CASES["q16"]))
    ops._check_cuda(x, dt, A, Bm, Cm)                          # accepted
    wide = torch.zeros(2, 16, 2, 136)
    bad = [(x.double(), dt.double(), A.double(), Bm.double(),
            Cm.double()),                                      # dtype
           (x, dt.bfloat16(), A, Bm, Cm),                      # mixed
           (x.transpose(1, 2), dt, A, Bm, Cm),                 # strided
           (wide, dt, A, Bm, Cm),                              # P > 128
           (x, dt, A, torch.zeros(2, 16, 130),
            torch.zeros(2, 16, 130))]                          # N > 128
    for args in bad:
        with pytest.raises(ValueError):
            ops._check_cuda(*args)


@pytest.mark.parametrize("name", sorted(ops.SOURCES))
def test_ctypes_signature_matches_the_c_prototype(name):
    assert ops.ARGTYPES[name] == c_argtypes(ops.SOURCES[name], name)


# -- the launch plan (plain Python; the kernel refuses any other) ----------

_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("case", sorted(SSD_EDGE_CASES))
def test_plan_at_the_paths_shapes_and_edges(case, dtype):
    """G = 4 heads a y block at mamba2's prefill shapes and wherever the
    grid fills the card, G = 2 where G = 4's grid is short of one wave
    and G = 2's runs in one, or for two heads; G′ = G / 2 heads a state
    block; the grid, one block an item, within CUDA's limits and the
    shared memory within a block's 227 KB."""
    shape, want = SSD_EDGE_CASES[case]
    want_g = want[_DTYPES.index(dtype)]
    bc, q, h, p, n = shape
    pl = ops.plan(*shape, dtype)
    assert pl.g == want_g and pl.gs == want_g // 2
    assert (ops.TQ, ops.TJ, ops.NS) == (64, 32, 64)
    pairs = -(-(-(-q // 64)) // 2)      # row-tile pairs (odd middle alone)
    p_tiles, n_tiles = -(-p // 64), -(-n // 64)
    assert pl.grid == (-(-h // want_g), bc,
                       pairs * p_tiles + 2 * p_tiles * n_tiles)
    assert max(pl.grid) <= 65535
    assert 0 < pl.smem <= ops.SMEM_MAX
    ops.check_plan(pl)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_plan_at_mamba2_prefill_is_one_wave_of_pairs(dtype):
    """(4, 511, 32, 64, 128): eight row tiles in four pairs of nine column
    tiles each, eight head groups of four, four chunks: 128 y blocks and
    128 state blocks (64 P rows x 64 N columns of two heads)."""
    pl = ops.plan(4, 511, 32, 64, 128, dtype)
    assert pl.g == 4 and pl.gs == 2
    assert pl.grid == (8, 4, 4 + 2 * 2) and math.prod(pl.grid) == 256
    assert pl.smem == {torch.float32: 224016, torch.bfloat16: 142096}[dtype]


@pytest.mark.parametrize("h,g,groups", [(1, 2, 1), (2, 2, 1), (3, 4, 1),
                                        (5, 4, 2), (6, 4, 2), (32, 4, 8),
                                        (33, 4, 9)])
def test_plan_covers_every_head_with_a_tail_group(h, g, groups):
    """ceil(H / G) head groups; the last holds the H % G live heads (the
    kernel stores nothing for the rest).  At a grid that fills the card,
    G = 4, except for one or two heads, where a group of 2 wastes
    nothing."""
    pl = ops.plan(128, 256, h, 64, 128)
    assert pl.g == g and pl.grid[0] == groups
    assert (pl.grid[0] - 1) * pl.g < h <= pl.grid[0] * pl.g


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("bc,q,h,blocks4,want", [
    (1, 511, 32, 64, (2, 2)),   # G = 2: 128 blocks, one wave
    (2, 511, 16, 64, (2, 2)),
    # G = 2: 256 blocks, two waves at one an SM (fp32), one at two (bf16)
    (2, 511, 32, 128, (4, 2)),
    (3, 511, 32, 192, (4, 4)),  # G = 4 fills the card
    (1, 64, 32, 40, (2, 2))])   # one row tile: 1 + 2 x 2 items
def test_plan_takes_g2_only_when_g4_is_short_of_a_wave(bc, q, h, blocks4,
                                                       want, dtype):
    """G = 2 where G = 4's grid has fewer blocks than the card has SMs
    and G = 2's whole grid runs at once (as many blocks as SMs times the
    blocks an SM holds)."""
    four = ops._grid(bc, q, h, 64, 128, 4)
    assert math.prod(four) == blocks4
    assert ops.plan(bc, q, h, 64, 128, dtype).g == want[_DTYPES.index(dtype)]


@pytest.mark.parametrize("g,smem,blocks", [
    (4, 224016, 1), (2, 171024, 1),      # mamba2, fp32
    (4, 142096, 1), (2, 105488, 2),      # mamba2, bf16 (G = 4: registers)
    (2, 20000, 2)])                      # registers: 128 x 255 a block
def test_blocks_per_sm_by_shared_memory_and_registers(g, smem, blocks):
    assert ops.blocks_per_sm(g, smem) == blocks


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("g", ops.GROUPS)
@pytest.mark.parametrize("n", [1, 8, 12, 64, 100, 128])
def test_every_plan_fits_a_blocks_shared_memory(n, g, dtype):
    esz = torch.empty((), dtype=dtype).element_size()
    assert ops.smem_bytes(g, n, esz) <= ops.SMEM_MAX


def test_plan_refuses_a_grid_past_cudas_limits():
    with pytest.raises(ValueError, match="plan refused"):
        ops.plan(70000, 64, 4, 64, 128)


@pytest.mark.parametrize("change", [dict(g=8), dict(g=3), dict(g=1),
                                    dict(grid=(1, 1, 70000)),
                                    dict(grid=(1, 70000, 8)),
                                    dict(smem=1 << 20)])
def test_plan_check_refuses_what_the_kernel_refuses(change):
    """The wrapper's plan check refuses what ``ssd_chunk_launch`` refuses
    with cudaErrorInvalidValue (held on the card by
    tests/test_torch_cuda.py, where the wrapper raises on that code)."""
    good = ops.plan(*SSD_CASES["q64"])
    ops.check_plan(good)                                        # accepted
    with pytest.raises(ValueError, match="plan refused"):
        ops.check_plan(good._replace(**change))
