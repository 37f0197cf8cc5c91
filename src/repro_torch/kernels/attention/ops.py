"""Public wrappers of the Hopper attention kernels (``csrc/*.cu``).

Counterpart of ``src/repro/kernels/attention/``.  For tensors on the
GPU a wrapper launches its kernel or raises; for tensors on the CPU it
runs the plain version (:mod:`.ref`).  There is no fallback: a dtype,
layout or head dim the kernel does not take is an error.

:class:`FlashPrefill` is ``flash_prefill`` with a backward,
``flash_prefill_bwd`` (fp32): the autograd path of the LM's attention.
On the card the kernels' outputs carry no ``grad_fn``, so each wrapper
refuses inputs that require grad while grad mode is on
(``_build.refuse_grad``): ``flash_prefill`` is differentiated through
:class:`FlashPrefill` only, and ``decode_attention`` serves decoding.

:func:`prefill_plan` is how ``flash_prefill`` runs a shape (rows a
block, padded head dim, grid, tile order, shared memory), in plain
Python; the C side derives the same from the shape, and its
``flash_prefill_query`` (:func:`prefill_layout`) reports it.

:func:`launch_count` counts each kernel's launches since the last
:func:`reset_launches`, so a run can show that it went through them.

Each wrapper's work, the FLOPs and the bytes of one call
(:func:`flash_prefill_work`, :func:`flash_prefill_bwd_work`,
:func:`decode_attention_work`), is what ``chip_smoke.py`` bounds it by
and what a census (``launch/hlo_analysis.py``) counts for it.  On fake
tensors (``torch._subclasses.fake_tensor``) a wrapper refuses what the
kernel refuses, launches nothing and returns empty outputs of the
kernel's shapes and dtypes, its work recorded (``_build.fake_call``).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from torch._subclasses.fake_tensor import is_fake

from .._build import (DTYPE_CODES, Launchers, fake_call, library,
                      record_work, refuse_grad)
from .ref import decode_attention_ref, flash_prefill_bwd_ref, flash_prefill_ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"flash_prefill": CSRC / "flash_prefill.cu",
           "flash_prefill_bwd": CSRC / "flash_prefill_bwd.cu",
           "decode_attention": CSRC / "decode_attn.cu"}
#: largest query-group size G (query heads per kv head) a block holds
MAX_GROUP = 64
#: prefill: (position, head) query rows a block, key positions a kv
#: tile, K/V tiles in flight, the head dims the kernels are written for
#: (D is padded up to one with zeros) and the shared memory one block may
#: opt into
ROWS, BKV, STAGES, PADDED_D, SMEM_MAX = 64, 64, 2, (16, 32, 64, 128), 232448
#: a grid's x and y extents at most: bf16's y is B K, and fp32's grid is
#: one-dimensional, its x (query tiles x B K) checked so on the C side too
MAX_GRID_X, MAX_GRID_Y = 2 ** 31 - 1, 65535
#: ctypes signatures of the ``extern "C"`` launchers, one for one
ARGTYPES = {
    # dtype; q, k, v, o; b, s, kh, g, d, window; stream
    "flash_prefill": ([ctypes.c_int] + [ctypes.c_void_p] * 4
                      + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
    # dtype; q, k, v, o, do, dq, dk, dv, lse2, delta; b, s, kh, g, d,
    # window; stream
    "flash_prefill_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 10
                          + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
    # dtype; q, k, v, valid_len, o, lse (or null); b, w, kh, g, d,
    # splits; stream
    "decode_attention": ([ctypes.c_int] + [ctypes.c_void_p] * 6
                         + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
}
#: what the card says to a differentiated bf16 attention
BF16_GRAD = ("flash_prefill: no bf16 backward yet (ROADMAP Queue 1, item "
             "11: training runs in fp32, as the reference's; bf16 training "
             "is later kernel work)")
#: decode: the blocks a launch may reach (one on each of an H100's 132
#: SMs: the S blocks of a cluster must find room in one GPC together, and
#: grids past one a SM waited for it), the most splits of a (batch, kv
#: head) (the blocks of one cluster, the portable limit), and the cache
#: entries a split keeps at least
DECODE_BLOCKS = 132
MAX_SPLITS = 8
MIN_SPLIT_ENTRIES = 32

_KERNELS = Launchers(SOURCES, ARGTYPES)
#: launches of kernel ``name`` (a key of :data:`SOURCES`) since process
#: start or :func:`reset_launches`; one ``flash_prefill_bwd`` launch is
#: its two kernel launches (the rows' stats, then the dK/dV and dQ
#: blocks) on one stream
launch_count = _KERNELS.launch_count
reset_launches = _KERNELS.reset


@functools.lru_cache(maxsize=1024)
def decode_splits(b: int, k: int, w: int) -> int:
    """Splits S of the cache per (batch, kv head) for B = ``b``, K = ``k``
    and a cache of ``w`` entries: doubled from 1 while the B K 2S blocks
    stay within :data:`DECODE_BLOCKS` and every split keeps at least
    :data:`MIN_SPLIT_ENTRIES` entries, up to :data:`MAX_SPLITS`.
    From shapes only: ``valid_len`` stays on the device.  Split r walks
    the entries below ``valid_len`` of ``_build.split_ranges(w, S)[r]``.
    """
    s = 1
    while s < MAX_SPLITS and 2 * b * k * s <= DECODE_BLOCKS \
            and w // (2 * s) >= MIN_SPLIT_ENTRIES:
        s *= 2
    return s


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class PrefillPlan(NamedTuple):
    """How one ``flash_prefill`` launch runs: ``rows`` (position, head)
    query rows a block (``rows // G`` positions, all G heads of each),
    kv tiles of ``bkv`` positions through a ring of ``stages``, the head
    dim padded to ``dp``, ``threads`` a block, the ``grid`` (x, y), the
    query tiles in ``order`` (heaviest first) and the block's dynamic
    shared memory in bytes.  ``tile_outer``: fp32's one-dimensional grid
    walks every (b, kv head) of one query tile before the next; bf16's
    (query tiles, B K) grid walks the query tiles of one (b, kv head)
    first."""
    rows: int
    bkv: int
    stages: int
    dp: int
    threads: int
    grid: tuple[int, int]
    order: tuple[int, ...]
    smem: int
    tile_outer: bool


def prefill_smem(dtype: torch.dtype, dp: int) -> int:
    """A block's dynamic shared memory, as the kernels size it.  fp32:
    Q, two stages of K and V (rows of DP + 4 floats) and P (rows of
    BKV + 16); bf16: Q and two stages of K and V in bf16, 1 KB for the
    swizzle's alignment and an mbarrier a stage."""
    if dtype == torch.bfloat16:
        return ROWS * dp * 2 + STAGES * 2 * BKV * dp * 2 + 1024 + 8 * STAGES
    return 4 * ((ROWS + 2 * STAGES * BKV) * (dp + 4) + ROWS * (BKV + 16))


@functools.lru_cache(maxsize=1024)
def prefill_plan(b: int, s: int, k: int, g: int, d: int,
                 dtype: torch.dtype = torch.float32) -> PrefillPlan:
    """The launch plan of q (b, s, k, g, d) from the shape alone: 64 rows
    a block in both dtypes (``64 // g`` positions).  fp32: 128 threads
    of 8 x 4 scores, a one-dimensional grid, heaviest query tiles first
    across the whole grid.  bf16: one warpgroup, a (query tiles, B K)
    grid, heaviest first within each (b, kv head)."""
    dp = next(p for p in PADDED_D if d <= p)
    n = _cdiv(s, ROWS // g)
    order = tuple(range(n - 1, -1, -1))
    smem = prefill_smem(dtype, dp)
    if dtype == torch.bfloat16:
        return PrefillPlan(ROWS, BKV, STAGES, dp, 128, (n, b * k), order,
                           smem, False)
    return PrefillPlan(ROWS, BKV, STAGES, dp, 2 * ROWS, (n * b * k, 1),
                       order, smem, True)


def prefill_layout(b: int, s: int, k: int, g: int, d: int,
                   dtype: torch.dtype) -> tuple[int, int, int, int,
                                                tuple[int, int]]:
    """(rows, padded D, threads, shared memory, grid) that the C side
    computes for a launch (``flash_prefill_query``), to hold
    :func:`prefill_plan`'s against.  Builds the kernel, so it needs the
    CUDA toolkit; raises where the C side refuses the shape."""
    fn = library(SOURCES["flash_prefill"]).flash_prefill_query
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    err = fn(DTYPE_CODES[dtype], b, s, k, g, d, out)
    if err != 0:
        raise RuntimeError(f"flash_prefill_query refused {(b, s, k, g, d)}"
                           f" {dtype}: CUDA error {err}")
    return out[0], out[1], out[2], out[3], (out[4], out[5])


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary: the
    kernels copy them in 16-byte chunks (cp.async, TMA, vector loads)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: inputs must be 16-byte aligned (the "
                         f"kernel loads them in 16-byte chunks)")


def causal_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs a causal attention over ``s`` positions scores:
    each position sees itself and the ones before it, the last
    ``window`` of them with a sliding window (0: all)."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_prefill_work(q_shape, window: int, esz: int
                       ) -> tuple[float, int]:
    """(FLOPs, bytes) of one ``flash_prefill`` call at q (B, S, K, G, D)
    of ``esz``-byte elements: two products of 2 D FLOPs a causal pair
    and (query, head) row; q, k, v read once and o written once."""
    b, s, k, g, d = q_shape
    return (4.0 * b * k * g * d * causal_pairs(s, window),
            2 * (b * s * k * g * d + b * s * k * d) * esz)


def flash_prefill_bwd_work(q_shape, window: int, esz: int = 4
                           ) -> tuple[float, int]:
    """(FLOPs, bytes) of one ``flash_prefill_bwd`` call (fp32): five
    products a causal pair (the scores again, dP, dV, dK, dQ); q, o, do
    and k, v read once, dq, dk, dv written once."""
    b, s, k, g, d = q_shape
    return (10.0 * b * k * g * d * causal_pairs(s, window),
            4 * (b * s * k * g * d + b * s * k * d) * esz)


def decode_attention_work(q_shape, w: int, esz: int,
                          valid_len: int | None = None,
                          with_lse: bool = False) -> tuple[float, int]:
    """(FLOPs, bytes) of one ``decode_attention`` call at q (B, K, G, D)
    over a cache of ``w`` entries: two products over the entries the
    kernel reads, ``min(valid_len, w)`` of them, or all ``w`` where
    ``valid_len`` is not given or at most 0.  The wrappers never read
    ``valid_len`` on the host, so a census (on fake tensors, where it is
    unknown, and on real ones alike) counts all ``w``, as the reference's
    XLA decode computes every entry."""
    b, k, g, d = q_shape
    live = min(valid_len, w) if valid_len is not None and valid_len > 0 \
        else w
    return (4.0 * b * k * g * d * live,
            (2 * b * k * g * d + 2 * b * live * k * d) * esz + 4
            + (4 * b * k * g if with_lse else 0))


def _check_cuda(name: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (kernel "
                         f"takes {sorted(map(str, DTYPE_CODES))})")
    for t in (q, *others):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: dtypes {t.dtype} and {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    d, g = q.shape[-1], q.shape[-2]
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"{name}: head dim {d} not supported (a multiple "
                         f"of 8 up to 128)")
    if g > MAX_GROUP:
        raise ValueError(f"{name}: {g} query heads per kv head, kernel "
                         f"takes at most {MAX_GROUP}")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sliding_window: int = 0) -> torch.Tensor:
    """Causal GQA attention.  q: (B, S, K, G, D); k/v: (B, S, K, D).

    Returns (B, S, K, G, D) in q's dtype (fp32 or bf16 on the GPU; fp32
    scores, softmax and accumulation either way).
    """
    if q.dim() != 5 or k.dim() != 4 or k.shape != v.shape \
            or tuple(k.shape) != (*q.shape[:3], q.shape[4]):
        raise ValueError(f"flash_prefill: want q (B,S,K,G,D), k/v "
                         f"(B,S,K,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    sliding_window = int(sliding_window)
    if sliding_window < 0:
        raise ValueError(f"flash_prefill: sliding_window {sliding_window}")
    if is_fake(q):
        refuse_grad("flash_prefill", "differentiate it through "
                    "FlashPrefill.apply", q, k, v)
        _check_cuda("flash_prefill", q, k, v)
        return fake_call("flash_prefill", flash_prefill_work(
            q.shape, sliding_window, q.element_size()), torch.empty_like(q))
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: no kernel for device {q.device}")
    refuse_grad("flash_prefill", "differentiate it through "
                "FlashPrefill.apply", q, k, v)
    _check_cuda("flash_prefill", q, k, v)
    B, S, K, G, D = q.shape
    grid = prefill_plan(B, S, K, G, D, q.dtype).grid
    if grid[0] > MAX_GRID_X or grid[1] > MAX_GRID_Y:
        raise ValueError(f"flash_prefill: grid {grid} for {tuple(q.shape)} "
                         f"{q.dtype} is past the launch limits (x <= "
                         f"{MAX_GRID_X}, y <= {MAX_GRID_Y})")
    check_aligned("flash_prefill", q, k, v)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    _KERNELS.launch("flash_prefill", q, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), B, S, K, G, D,
                    sliding_window)
    record_work("flash_prefill", flash_prefill_work(
        q.shape, sliding_window, q.element_size()))
    return o


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *,
                      sliding_window: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of :func:`flash_prefill` at (q, k, v) for
    the output gradient ``do``; ``o`` is the forward's output.  q, o, do:
    (B, S, K, G, D); k/v: (B, S, K, D).  fp32 on the GPU (the rows' LSE
    and Delta, then the dK/dV and dQ blocks in one launch; no atomics, so
    two calls give the same bits); :func:`.ref.flash_prefill_bwd_ref` on the CPU."""
    if q.dim() != 5 or k.dim() != 4 or k.shape != v.shape \
            or tuple(k.shape) != (*q.shape[:3], q.shape[4]) \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_prefill_bwd: want q, o, do (B,S,K,G,D), "
                         f"k/v (B,S,K,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(o.shape)}, {tuple(do.shape)}")
    sliding_window = int(sliding_window)
    if sliding_window < 0:
        raise ValueError(f"flash_prefill_bwd: sliding_window "
                         f"{sliding_window}")
    if is_fake(q):
        if q.dtype != torch.float32:
            raise NotImplementedError(BF16_GRAD)
        refuse_grad("flash_prefill_bwd", "no double backward", q, k, v, o,
                    do)
        _check_cuda("flash_prefill_bwd", q, k, v, o, do)
        return fake_call("flash_prefill_bwd", flash_prefill_bwd_work(
            q.shape, sliding_window), (torch.empty_like(q),
                                       torch.empty_like(k),
                                       torch.empty_like(v)))
    if q.device.type == "cpu":
        return flash_prefill_bwd_ref(q, k, v, o, do, sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_bwd: no kernel for device "
                         f"{q.device}")
    if q.dtype != torch.float32:
        raise NotImplementedError(BF16_GRAD)
    refuse_grad("flash_prefill_bwd", "no double backward", q, k, v, o, do)
    _check_cuda("flash_prefill_bwd", q, k, v, o, do)
    check_aligned("flash_prefill_bwd", q, k, v, o, do)
    B, S, K, G, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    lse2 = q.new_empty((B, S, K, G))     # the rows' log-sum-exp, log2 units
    delta = q.new_empty((B, S, K, G))    # rowsum(do o o)
    _KERNELS.launch("flash_prefill_bwd", q, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), do.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), lse2.data_ptr(),
                    delta.data_ptr(), B, S, K, G, D, sliding_window)
    record_work("flash_prefill_bwd",
                flash_prefill_bwd_work(q.shape, sliding_window))
    return dq, dk, dv


class FlashPrefill(torch.autograd.Function):
    """:func:`flash_prefill` with its backward, :func:`flash_prefill_bwd`:
    ``FlashPrefill.apply(q, k, v, sliding_window)``.  Saves q, k, v and
    the output.  Kernels on CUDA tensors, the plain versions on CPU
    tensors.  A bf16 input that needs a gradient raises
    ``NotImplementedError`` (fp32 training only)."""

    @staticmethod
    def forward(ctx, q, k, v, sliding_window=0):
        if any(ctx.needs_input_grad[:3]) and q.dtype != torch.float32:
            raise NotImplementedError(BF16_GRAD)
        o = flash_prefill(q, k, v, sliding_window=sliding_window)
        ctx.sliding_window = sliding_window
        ctx.save_for_backward(q, k, v, o)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_prefill_bwd(q, k, v, o, do.contiguous(),
                                       sliding_window=ctx.sliding_window)
        return dq, dk, dv, None


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor, *, with_lse: bool = False):
    """One query token per (batch, kv head) against a cache.

    q: (B, K, G, D); k/v: (B, W, K, D); ``valid_len``: a one-element
    int32 tensor on q's device (on the GPU the kernel reads it there:
    the host never waits for it).  Entries at or past ``valid_len`` are
    masked.  Returns (B, K, G, D) in q's dtype; with ``with_lse``,
    (that, lse): each row's natural-log log-sum-exp of its scaled scores,
    (B, K, G) fp32, from the same launch (about -1e30 where
    ``valid_len`` <= 0).
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or (k.shape[0], k.shape[2], k.shape[3]) != \
            (q.shape[0], q.shape[1], q.shape[3]):
        raise ValueError(f"decode_attention: want q (B,K,G,D), k/v "
                         f"(B,W,K,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not isinstance(valid_len, torch.Tensor) or valid_len.numel() != 1 \
            or valid_len.dtype != torch.int32:
        raise ValueError("decode_attention: valid_len must be a "
                         "one-element int32 tensor")
    if is_fake(q):
        refuse_grad("decode_attention", "it serves decoding; training runs "
                    "through flash_prefill", q, k, v)
        _check_cuda("decode_attention", q, k, v)
        if k.shape[1] == 0:
            raise ValueError("decode_attention: empty cache")
        o = torch.empty_like(q)
        return fake_call("decode_attention", decode_attention_work(
            q.shape, k.shape[1], q.element_size(), with_lse=with_lse),
            (o, q.new_empty(q.shape[:3], dtype=torch.float32))
            if with_lse else o)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid_len.reshape(()),
                                    with_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device "
                         f"{q.device}")
    refuse_grad("decode_attention", "it serves decoding; training runs "
                "through flash_prefill", q, k, v)
    _check_cuda("decode_attention", q, k, v)
    if valid_len.device != q.device:
        raise ValueError(f"decode_attention: valid_len on "
                         f"{valid_len.device}, q on {q.device}")
    if k.shape[1] == 0:
        raise ValueError("decode_attention: empty cache")
    check_aligned("decode_attention", q, k, v)
    B, K, G, D = q.shape
    W = k.shape[1]
    o = torch.empty_like(q)
    lse = q.new_empty((B, K, G), dtype=torch.float32) if with_lse else None
    if o.numel():
        _KERNELS.launch("decode_attention", q, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), valid_len.data_ptr(), o.data_ptr(),
                        None if lse is None else lse.data_ptr(), B, W, K, G,
                        D, decode_splits(B, K, W))
        record_work("decode_attention", decode_attention_work(
            q.shape, W, q.element_size(), with_lse=with_lse))
    return (o, lse) if with_lse else o
