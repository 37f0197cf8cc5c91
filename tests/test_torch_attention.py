"""The port's attention kernels' plain versions against the JAX package's
kernels (Pallas in interpret mode) and its blockwise attention, on the
same inputs; and the wrappers' CPU path and checks."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.decode_attn import (
    decode_attention as ref_decode_attention)
from repro.kernels.attention.flash_prefill import (
    flash_prefill as ref_flash_prefill)
from repro.models.transformer import layers as RL
from repro_torch import configs
from repro_torch.kernels._build import split_ranges
from repro_torch.kernels.attention import ops, ref

from _torch_cases import (DECODE_CASES, DECODE_SPLIT_CASES, PREFILL_CASES,
                          PREFILL_FULL_SHAPES, c_argtypes, decode_inputs,
                          prefill_inputs)

# fp32: sums in another order than XLA's (the band of
# tests/test_kernels.py's flash-prefill sweep); bf16: the `TOL` band of
# tests/test_kernels.py (a few bf16 roundings of p and of the output)
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_flash_prefill_ref_matches_the_reference(case):
    b, s, k, g, d, w = PREFILL_CASES[case]
    q, kk, vv = prefill_inputs(b, s, k, g, d)
    got = ref.flash_prefill_ref(torch.tensor(q), torch.tensor(kk),
                                torch.tensor(vv), sliding_window=w)
    assert got.shape == (b, s, k, g, d) and got.dtype == torch.float32
    jq, jk, jv = map(jnp.asarray, (q, kk, vv))
    kernel = ref_flash_prefill(jq, jk, jv, sliding_window=w, interpret=True)
    blockwise = RL.blockwise_causal_attention(jq, jk, jv, sliding_window=w,
                                              q_block=64, kv_block=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel),
                               **TOL["float32"])
    np.testing.assert_allclose(got.numpy(), np.asarray(blockwise),
                               **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_ref_matches_the_reference(case, dtype):
    b, k, g, d, w, vl = DECODE_CASES[case]
    q, kk, vv = decode_inputs(b, k, g, d, w)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = ref.decode_attention_ref(
        *(torch.tensor(a).to(tdt) for a in (q, kk, vv)),
        torch.tensor(vl, dtype=torch.int32))
    assert got.shape == (b, k, g, d) and got.dtype == tdt
    want = ref_decode_attention(*(jnp.asarray(a, jdt) for a in (q, kk, vv)),
                                jnp.int32(vl), interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_decode_attention_ref_masks_everything_past_valid_len():
    """Entries at or past ``valid_len`` do not change the output, and
    ``valid_len`` 0 weighs all entries equally, as in the reference."""
    q, kk, vv = (torch.tensor(a) for a in decode_inputs(1, 2, 2, 16, 40))
    vl = torch.tensor(9, dtype=torch.int32)
    a = ref.decode_attention_ref(q, kk, vv, vl)
    kk2, vv2 = kk.clone(), vv.clone()
    kk2[:, 9:] = 7.0
    vv2[:, 9:] = -3.0
    torch.testing.assert_close(ref.decode_attention_ref(q, kk2, vv2, vl), a,
                               rtol=0, atol=0)
    zero = ref.decode_attention_ref(q, kk, vv, torch.tensor(0))
    want = vv.mean(dim=1)[:, :, None, :].expand_as(zero)
    torch.testing.assert_close(zero, want, rtol=1e-5, atol=1e-6)


def test_wrappers_on_cpu_run_the_plain_versions_and_launch_nothing():
    ops.reset_launches()
    q, kk, vv = (torch.tensor(a) for a in prefill_inputs(1, 37, 2, 2, 16))
    torch.testing.assert_close(ops.flash_prefill(q, kk, vv, sliding_window=8),
                               ref.flash_prefill_ref(q, kk, vv, 8),
                               rtol=0, atol=0)
    q, kk, vv = (torch.tensor(a) for a in decode_inputs(2, 2, 4, 16, 37))
    vl = torch.tensor(5, dtype=torch.int32)
    torch.testing.assert_close(ops.decode_attention(q, kk, vv, vl),
                               ref.decode_attention_ref(q, kk, vv, vl),
                               rtol=0, atol=0)
    assert ops.launch_count("flash_prefill") == 0
    assert ops.launch_count("decode_attention") == 0


def test_wrappers_refuse_bad_shapes_and_lengths():
    q, kk, vv = (torch.tensor(a) for a in prefill_inputs(1, 8, 2, 2, 16))
    for args in [(q[..., 0, :], kk, vv),          # q not 5-d
                 (q, kk[:, :4], vv),              # k shorter than q
                 (q, kk, vv[..., :8])]:           # v head dim differs
        with pytest.raises(ValueError):
            ops.flash_prefill(*args)
    with pytest.raises(ValueError):
        ops.flash_prefill(q, kk, vv, sliding_window=-1)
    q, kk, vv = (torch.tensor(a) for a in decode_inputs(1, 2, 2, 16, 8))
    for vl in (3, torch.tensor(3), torch.tensor([3, 3], dtype=torch.int32)):
        with pytest.raises(ValueError):             # int, int64, two lengths
            ops.decode_attention(q, kk, vv, vl)
    with pytest.raises(ValueError):
        ops.decode_attention(q, kk[:, :, :1], vv[:, :, :1],
                             torch.tensor(3, dtype=torch.int32))


def test_cuda_checks_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 2, 2, 16)
    kv = torch.zeros(1, 8, 2, 16)
    ops._check_cuda("flash_prefill", q, kv, kv)               # accepted
    bad = [(q.double(), kv.double(), kv.double()),            # dtype
           (q, kv.bfloat16(), kv),                            # mixed dtype
           (q.transpose(1, 2), kv, kv),                       # strided q
           (torch.zeros(1, 8, 2, 2, 12), kv, kv),             # D % 8
           (torch.zeros(1, 8, 2, 2, 136), kv, kv),            # D > 128
           (torch.zeros(1, 8, 2, 65, 16), kv, kv)]            # G > 64
    for args in bad:
        with pytest.raises(ValueError):
            ops._check_cuda("flash_prefill", *args)


@pytest.mark.parametrize("name", sorted(ops.SOURCES))
def test_ctypes_signature_matches_the_c_prototype(name):
    assert ops.ARGTYPES[name] == c_argtypes(ops.SOURCES[name], name)


@pytest.mark.parametrize("case", sorted(DECODE_SPLIT_CASES))
def test_decode_splits_of_each_case(case):
    """The splits S of the cache at each case's shapes, and the entries
    the splits walk: S ranges, balanced, in order, together [0, W)
    once."""
    b, k, _, _, w, _, want = DECODE_SPLIT_CASES[case]
    assert ops.decode_splits(b, k, w) == want
    ranges = split_ranges(w, want)
    assert ranges[0][0] == 0 and ranges[-1][1] == w
    assert all(x[1] == y[0] for x, y in zip(ranges, ranges[1:]))
    sizes = [y - x for x, y in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_decode_splits_depend_on_shapes_only():
    """S is a function of B, K and W: valid_len never reaches the host.
    It stays within the cluster limit and one block a SM, keeps
    MIN_SPLIT_ENTRIES entries a split, and is 1 for a short cache or a
    grid that already fills the card."""
    assert list(inspect.signature(ops.decode_splits).parameters) == \
        ["b", "k", "w"]
    for b, k in [(1, 1), (1, 8), (4, 8), (2, 16), (8, 8), (64, 32)]:
        for w in (1, 8, 37, 63, 64, 128, 544, 4096):
            s = ops.decode_splits(b, k, w)
            assert 1 <= s <= ops.MAX_SPLITS and s & (s - 1) == 0
            assert s == 1 or (w // s >= ops.MIN_SPLIT_ENTRIES
                              and b * k * s <= ops.DECODE_BLOCKS)
            if w < 2 * ops.MIN_SPLIT_ENTRIES or b * k * 2 > \
                    ops.DECODE_BLOCKS:
                assert s == 1


@pytest.mark.parametrize("n,parts", [(1, 1), (7, 3), (544, 4), (544, 8),
                                     (37, 8), (4608 // 16, 8)])
def test_split_ranges_cover_once_in_order(n, parts):
    ranges = split_ranges(n, parts)
    assert len(ranges) == parts
    covered = [i for a, b in ranges for i in range(a, b)]
    assert covered == list(range(n))


def _blocks(pl, b, k, g, s):
    """(b K index, first position, positions) of every block of plan
    ``pl`` in launch order, as the kernels map their block index: fp32
    block i at query tile order[i // BK], (b, kv head) i % BK; bf16
    block (x, y) at query tile order[x], (b, kv head) y, x fastest."""
    bq, bk = pl.rows // g, b * k
    ids = ([(t, i) for t in pl.order for i in range(bk)] if pl.tile_outer
           else [(t, i) for i in range(bk) for t in pl.order])
    assert len(ids) == pl.grid[0] * pl.grid[1]
    return [(i, t * bq, min(bq, s - t * bq)) for t, i in ids]


def _plan_shape(case):
    if case in PREFILL_FULL_SHAPES:
        return PREFILL_FULL_SHAPES[case]
    return PREFILL_CASES[case][:5]


@pytest.mark.parametrize("arch", sorted(PREFILL_FULL_SHAPES))
def test_prefill_full_shapes_are_the_configs(arch):
    cfg = configs.get(arch)
    b, s, k, g, d = PREFILL_FULL_SHAPES[arch]
    assert (k, g, d) == (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                         cfg.hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PREFILL_CASES)
                         + sorted(PREFILL_FULL_SHAPES))
def test_prefill_plan_covers_every_row_once(case, dtype):
    """The blocks of ``ops.prefill_plan``, mapped as the kernel maps its
    block index, hold every (b K, position, head) row exactly once, and
    no block more rows than the plan's."""
    b, s, k, g, d = _plan_shape(case)
    pl = ops.prefill_plan(b, s, k, g, d, dtype)
    seen = np.zeros((b * k, s), np.int64)
    for bk, q0, n in _blocks(pl, b, k, g, s):
        assert 1 <= n and n * g <= pl.rows and q0 + n <= s
        seen[bk, q0:q0 + n] += 1
    assert (seen == 1).all()
    assert pl.dp >= d and pl.dp in ops.PADDED_D
    assert (pl.bkv, pl.stages) == (ops.BKV, ops.STAGES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PREFILL_CASES)
                         + sorted(PREFILL_FULL_SHAPES))
def test_prefill_plan_walks_the_heaviest_query_tiles_first(case, dtype):
    """The tile order is a permutation of the query tiles, the last
    first: without a window, by live kv tiles from most to fewest; in
    fp32 over the whole grid (every (b, kv head) of a tile before the
    next), so the short blocks come last.  (With a window every tile
    past the first few walks about as many.)"""
    b, s, k, g, d = _plan_shape(case)
    pl = ops.prefill_plan(b, s, k, g, d, dtype)
    bq = pl.rows // g
    assert list(pl.order) == list(range(-(-s // bq)))[::-1]
    work = [(min(s, (t + 1) * bq) - 1) // pl.bkv + 1 for t in pl.order]
    assert work == sorted(work, reverse=True)
    blocks = _blocks(pl, b, k, g, s)
    if dtype == torch.float32:
        assert pl.tile_outer and pl.grid[1] == 1
        assert [q0 for _, q0, _ in blocks] == sorted(
            (q0 for _, q0, _ in blocks), reverse=True)


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 64])
def test_prefill_plan_fits_shared_memory_at_every_head_dim(g):
    for d in range(8, 129, 8):
        for b, s, k in [(1, 37, 1), (4, 511, 8), (2, 256, 16)]:
            for dtype in (torch.float32, torch.bfloat16):
                pl = ops.prefill_plan(b, s, k, g, d, dtype)
                assert pl.smem <= ops.SMEM_MAX, (d, g, dtype)


@pytest.mark.parametrize("shape,dp,blocks", [
    ((4, 511, 8, 4, 64), 64, 32 * 8 * 4),    # Llama-3.2-1B
    ((4, 511, 8, 3, 64), 64, 25 * 8 * 4),    # granite: 21 positions a block
    ((2, 256, 16, 1, 64), 64, 4 * 16 * 2),   # G = 1
    ((1, 256, 8, 8, 128), 128, 32 * 8),      # D = 128
    ((2, 300, 8, 4, 40), 64, 19 * 8 * 2),    # D padded to 64
    ((1, 130, 2, 64, 32), 32, 130 * 2),      # G = 64: one position a block
    ((1, 37, 2, 3, 8), 16, 2 * 2)])
def test_prefill_plan_grid_threads_and_smem(shape, dp, blocks):
    """64 rows a block in both dtypes; fp32 in 128 threads and a
    one-dimensional grid, bf16 in one warpgroup and a (query tiles, B K)
    grid."""
    b, s, k, g, d = shape
    f32, bf16 = (ops.prefill_plan(*shape, dt)
                 for dt in (torch.float32, torch.bfloat16))
    assert f32.rows == bf16.rows == 64 and f32.dp == bf16.dp == dp
    assert (f32.threads, f32.grid) == (128, (blocks, 1))
    assert (bf16.threads, bf16.grid) == (128, (blocks // (b * k), b * k))
    assert f32.smem == 4 * ((64 + 4 * 64) * (dp + 4) + 64 * 80)
    assert bf16.smem == 64 * dp * 2 + 4 * 64 * dp * 2 + 1024 + 16


def test_cuda_checks_refuse_unaligned_inputs():
    """The kernels copy q, k and v in 16-byte chunks: a view that starts
    off that grid is refused, in either dtype."""
    base = torch.zeros(1 + 8 * 2 * 16)
    ops.check_aligned("flash_prefill", base[:8 * 2 * 16])      # accepted
    for dtype in (torch.float32, torch.bfloat16):
        off = base.to(dtype)[1:].view(1, 8, 2, 16)
        with pytest.raises(ValueError, match="16-byte"):
            ops.check_aligned("flash_prefill", off)
