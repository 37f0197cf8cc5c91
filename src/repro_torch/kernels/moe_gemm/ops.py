"""Public wrappers of the Hopper grouped expert GEMM (``csrc/moe_gemm.cu``)
and of its backward's two products (``csrc/moe_gemm_bwd.cu``).

Counterpart of ``src/repro/kernels/moe_gemm/``.  For tensors on the GPU
the wrapper launches the kernel or raises; for tensors on the CPU it
runs the plain version (:mod:`.ref`).  There is no fallback: a dtype or
layout the kernel does not take is an error.

:func:`launch_count` counts the kernel's launches since the last
:func:`reset_launches`, so a run can show that it went through it, and
:data:`variant_counts` how many of them took each of its variants.

The kernel has four variants behind its one entry point (see the source
note of ``csrc/moe_gemm.cu``); :func:`variant` chooses one from the shape
and dtype alone (and 16-byte alignment, which every tensor the model
makes has), and the C side refuses a variant that the shape does not fit.

:class:`MoeGemm` is the product under autograd.  Its backward is the
``moe_gemm_bwd`` kernel, one launch for each input that needs a
gradient: :func:`moe_gemm_nt` (dx = dy wᵀ) and :func:`moe_gemm_tn`
(dw = xᵀ dy), each reading its operands where they lie, no transposed
copies.  Their tile, chosen from the shape in :func:`bwd_plan`, is
counted in :data:`bwd_plan_counts`.

:func:`work` is one call's FLOPs and bytes (and :func:`bwd_work` the
backward pair's), what ``chip_smoke.py`` bounds the kernels by and what
a census (``launch/hlo_analysis.py``) counts for each call.  On fake
tensors the wrappers refuse what the kernels refuse, launch nothing and
return an empty output of the kernel's shape and dtype, its work
recorded (``_build.fake_call``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from torch._subclasses.fake_tensor import is_fake

from .._build import (DTYPE_CODES, Launchers, bump, count_table, fake_call,
                      quiet, record_work, refuse_grad, scratch)
from .ref import moe_gemm_nt_ref, moe_gemm_ref, moe_gemm_tn_ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"moe_gemm": CSRC / "moe_gemm.cu",
           "moe_gemm_bwd": CSRC / "moe_gemm_bwd.cu"}
#: ctypes signatures of the ``extern "C"`` launchers, one for one
ARGTYPES = {
    # dtype; x, w, y; e, c, d, f, variant, split_rows; workspace,
    # counters; stream
    "moe_gemm": ([ctypes.c_int] + [ctypes.c_void_p] * 3
                 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3),
    # dtype; a, b, out; e, m, n, k, layout, rows, vec; stream
    "moe_gemm_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 3
                     + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
}
#: the variants, in the order of the code ``moe_gemm_launch`` takes
VARIANTS = ("general", "wgmma", "simt", "stream")
#: rows of C one block of each variant covers: a grid has ceil(C / rows)
#: of them in its y dimension, at most 65535 (general covers 16 rows
#: when C <= 16)
VARIANT_ROWS = {"general": 64, "wgmma": 128, "simt": 128, "stream": 16}
MAX_GRID_Y = 65535
#: fp32 stream: rows of D a block stages at most (csrc MAX_SPLIT_ROWS),
#: the blocks that one wave holds (two on each of an H100's 132 SMs), and
#: the columns of w a block reads (32 lanes of 16 bytes)
MAX_SPLIT_ROWS = 2048
STREAM_BLOCKS = 2 * 132
STREAM_SLAB = 32 * 4
BF16_GRAD = ("moe_gemm: no bf16 backward (training runs in fp32, as the "
             "reference's; bf16 training is later kernel work)")
#: the backward kernel's layouts, in the order of the code
#: ``moe_gemm_bwd_launch`` takes: NT out = a bᵀ (dx), TN out = aᵀ b (dw)
BWD_LAYOUTS = ("nt", "tn")
#: the output rows of its block tiles; the smaller where the output has
#: at most that many rows
BWD_ROWS = (64, 128)


class BwdPlan(NamedTuple):
    """One launch of ``moe_gemm_bwd``: layout, output rows a block (64 or
    128, by 128 columns) and 16-byte (``vec``) or 4-byte loads."""
    layout: str
    rows: int
    vec: bool

    @property
    def name(self) -> str:
        """Its key in :data:`bwd_plan_counts`: ``nt128``, ``tn64_b4``..."""
        return f"{self.layout}{self.rows}" + ("" if self.vec else "_b4")

_KERNELS = Launchers(SOURCES, ARGTYPES)
#: launches of kernel ``name`` (a key of :data:`SOURCES`) since process
#: start or :func:`reset_launches`
launch_count = _KERNELS.launch_count
#: launches of each variant (a key of :data:`VARIANTS`) since process
#: start or :func:`reset_launches`
variant_counts = count_table(dict.fromkeys(VARIANTS, 0))
#: launches of ``moe_gemm_bwd`` by plan (:attr:`BwdPlan.name`) since
#: process start or :func:`reset_launches`
bwd_plan_counts = count_table(dict.fromkeys(
    (BwdPlan(lay, r, v).name for lay in BWD_LAYOUTS for r in BWD_ROWS
     for v in (True, False)), 0))


def reset_launches() -> None:
    _KERNELS.reset()
    for table in (variant_counts, bwd_plan_counts):
        for name in table:
            table[name] = 0


def work(e: int, c: int, d: int, f: int, esz: int) -> tuple[float, int]:
    """(FLOPs, bytes) of one call at x (E, C, D), w (E, D, F) of
    ``esz``-byte elements: x and w read once, y written once."""
    return 2.0 * e * c * d * f, (e * c * d + e * d * f + e * c * f) * esz


def bwd_work(e: int, c: int, d: int, f: int) -> tuple[float, int]:
    """(FLOPs, bytes) of :class:`MoeGemm`'s backward pair (fp32) at the
    forward's x (E, C, D), w (E, D, F): dx and dw, each 2 E C D F; x, w
    and dy read where they lie (no transposed copies) and dx, dw
    written, dy counted once (each launch's :func:`work` counts it)."""
    return 4.0 * e * c * d * f, 4 * (2 * e * c * d + 2 * e * d * f
                                     + e * c * f)


def variant(e: int, c: int, d: int, f: int, dtype: torch.dtype,
            aligned: bool = True) -> str:
    """The kernel variant for x (e, c, d), w (e, d, f) of ``dtype``:
    ``stream`` for C <= 16 (decode), ``wgmma`` (bf16) or ``simt`` (fp32)
    for larger C, each where its 16-byte loads (and, in bf16, TMA's rows)
    fit the row lengths and the pointers are 16-byte aligned; ``general``
    for the rest."""
    if not aligned:
        return "general"
    if dtype == torch.bfloat16 and d >= 8 and d % 8 == 0 and f % 8 == 0:
        return "stream" if c <= 16 else "wgmma"
    if dtype == torch.float32 and f % 4 == 0:
        if c <= 16:
            return "stream"
        if d % 4 == 0:
            return "simt"
    return "general"


def split_rows(e: int, d: int, f: int) -> int:
    """Rows of D one fp32 stream block takes (bf16 streams through TMA,
    unsplit): D split as far as one wave of :data:`STREAM_BLOCKS` blocks
    allows (every block then runs from the start, each thread with rows
    in flight), each split with at least 64 rows (when D has them) and
    at most :data:`MAX_SPLIT_ROWS`; a multiple of 8."""
    base = e * math.ceil(f / STREAM_SLAB)
    splits = max(1, min(STREAM_BLOCKS // base, math.ceil(d / 64)))
    splits = max(splits, math.ceil(d / MAX_SPLIT_ROWS))
    return max(8, 8 * math.ceil(math.ceil(d / splits) / 8))


def _scratch(x: torch.Tensor, n_part: int, n_count: int):
    """The stream variant's workspace (``n_part`` floats, or None) and
    zeroed counters (``n_count`` ints) for x's device and current stream,
    or for the CUDA graph being built (``_build.scratch``).  The kernel
    leaves the counters at zero, so the launches of one stream, or of
    one graph's replays, share them in stream order."""
    counters = scratch(x.device, "moe_gemm.counters", n_count, torch.int32,
                       zero=True)
    ws = scratch(x.device, "moe_gemm.ws", n_part, torch.float32) \
        if n_part else None
    return (None if ws is None else ws.data_ptr()), counters.data_ptr()


@functools.lru_cache(maxsize=1024)
def _plan(e: int, c: int, d: int, f: int, dtype: torch.dtype,
          aligned: bool) -> tuple:
    """(variant, split rows, workspace floats, counters) of one call
    shape (the last three only for the fp32 stream kernel), kept: the
    decode path calls the same few shapes thousands of times, and its
    host time is the step's."""
    v = variant(e, c, d, f, dtype, aligned)
    if e > MAX_GRID_Y or -(-c // VARIANT_ROWS[v]) > MAX_GRID_Y:
        raise ValueError(f"moe_gemm: {e} experts x {c} rows is past the "
                         f"grid of variant {v}")
    if v != "stream" or dtype != torch.float32:
        return v, 0, 0, 0
    rows = split_rows(e, d, f)
    splits = max(1, math.ceil(d / rows))
    return (v, rows, splits * e * c * f if splits > 1 else 0,
            e * math.ceil(f / STREAM_SLAB))


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_cuda(x: torch.Tensor, w: torch.Tensor, aligned=None) -> tuple:
    """Raise on what no variant takes; return the call's :func:`_plan`
    (``aligned`` None: read from the pointers)."""
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"moe_gemm: dtype {x.dtype} not supported (kernel "
                         f"takes {sorted(map(str, DTYPE_CODES))})")
    if w.device != x.device:
        raise ValueError(f"moe_gemm: w on {w.device}, x on {x.device}")
    if w.dtype != x.dtype:
        raise ValueError(f"moe_gemm: w is {w.dtype}, x is {x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gemm: inputs must be contiguous")
    E, C, D = x.shape
    return _plan(E, C, D, w.shape[2], x.dtype,
                 _aligned(x, w) if aligned is None else aligned)


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in x's dtype: y[e] =
    x[e] @ w[e], summed in fp32 (fp32 or bf16 on the GPU)."""
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"moe_gemm: want x (E,C,D), w (E,D,F); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if is_fake(x):
        refuse_grad("moe_gemm", "differentiate through MoeGemm.apply, "
                    "whose backward launches this kernel twice", x, w)
        _check_cuda(x, w, aligned=True)   # as every tensor the model makes
        E, C, D = x.shape
        return fake_call("moe_gemm", work(E, C, D, w.shape[2],
                                          x.element_size()),
                         x.new_empty((E, C, w.shape[2])))
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemm: no kernel for device {x.device}")
    refuse_grad("moe_gemm", "differentiate through MoeGemm.apply, whose "
                "backward launches this kernel twice", x, w)
    v, rows, n_part, n_count = _check_cuda(x, w)
    E, C, D = x.shape
    F = w.shape[2]
    y = x.new_empty((E, C, F))
    if y.numel() == 0:
        return y
    ws = counters = None
    if n_count:                      # the stream variant's 16-byte loads
        with quiet():
            ws, counters = _scratch(x, n_part, n_count)
    _KERNELS.launch("moe_gemm", x, x.data_ptr(), w.data_ptr(), y.data_ptr(),
                    E, C, D, F, VARIANTS.index(v), rows, ws, counters)
    bump(variant_counts, v)
    record_work("moe_gemm", work(E, C, D, F, x.element_size()))
    return y


@functools.lru_cache(maxsize=1024)
def bwd_plan(layout: str, e: int, m: int, n: int, k: int,
             aligned: bool = True) -> BwdPlan:
    """The ``moe_gemm_bwd`` launch of one product, out (e, m, n) summed
    over k, in ``layout`` (:data:`BWD_LAYOUTS`): 64-row tiles where
    m <= 64 (dx at C <= 64: a 128-row tile would be half empty), else
    128; 16-byte loads where every row length (a's, b's and out's: k, k,
    n for NT; m, n, n for TN) is a multiple of 4 and the pointers are
    16-byte ``aligned``, else 4-byte ones.  Raises ``ValueError`` past
    the kernel's grid (at most 65535 experts and 65535 row tiles).
    Kept: the same few shapes come back every step."""
    if layout not in BWD_LAYOUTS:
        raise ValueError(f"moe_gemm_bwd: layout {layout!r} not in "
                         f"{BWD_LAYOUTS}")
    rows = BWD_ROWS[0] if m <= BWD_ROWS[0] else BWD_ROWS[1]
    if e > MAX_GRID_Y or -(-m // rows) > MAX_GRID_Y:
        raise ValueError(f"moe_gemm_bwd: {e} experts x {m} rows is past "
                         f"the grid of {rows}-row tiles")
    lengths = (k, k, n) if layout == "nt" else (m, n, n)
    vec = aligned and all(r % 4 == 0 for r in lengths)
    return BwdPlan(layout, rows, vec)


def _bwd_shapes(layout: str, a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(e, m, n, k) of ``layout``'s product of a and b; raises on shapes
    that do not meet."""
    nt = layout == "nt"
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2 if nt else 1] != b.shape[2 if nt else 1]:
        want = "a (E,M,K), b (E,N,K)" if nt else "a (E,K,M), b (E,K,N)"
        raise ValueError(f"moe_gemm_{layout}: want {want}; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    e = a.shape[0]
    return (e, a.shape[1], b.shape[1], a.shape[2]) if nt \
        else (e, a.shape[2], b.shape[2], a.shape[1])


def _check_bwd(layout: str, a: torch.Tensor, b: torch.Tensor,
               shape: tuple, aligned=None) -> BwdPlan:
    """Raise on what the backward kernel does not take; return the
    call's :func:`bwd_plan` (``aligned`` None: read from the pointers)."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"moe_gemm_{layout}: the kernel takes float32 "
                         f"(got {a.dtype}, {b.dtype}); {BF16_GRAD}")
    if b.device != a.device:
        raise ValueError(f"moe_gemm_{layout}: b on {b.device}, a on "
                         f"{a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"moe_gemm_{layout}: inputs must be contiguous")
    return bwd_plan(layout, *shape,
                    _aligned(a, b) if aligned is None else aligned)


def _launch_bwd(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                shape: tuple, plan: BwdPlan) -> None:
    """One ``moe_gemm_bwd`` launch of ``plan`` into ``out``, counted."""
    _KERNELS.launch("moe_gemm_bwd", a, a.data_ptr(), b.data_ptr(),
                    out.data_ptr(), *shape, BWD_LAYOUTS.index(plan.layout),
                    plan.rows, int(plan.vec))
    bump(bwd_plan_counts, plan.name)
    e, m, n, k = shape
    record_work("moe_gemm_bwd", work(e, m, k, n, 4))


def _bwd(layout: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    shape = _bwd_shapes(layout, a, b)
    e, m, n, k = shape
    why = "no double backward through MoeGemm"
    if is_fake(a):
        refuse_grad("moe_gemm_bwd", why, a, b)
        _check_bwd(layout, a, b, shape, aligned=True)
        return fake_call("moe_gemm_bwd", work(e, m, k, n, 4),
                         a.new_empty((e, m, n)))
    if a.device.type == "cpu":
        return (moe_gemm_nt_ref if layout == "nt" else moe_gemm_tn_ref)(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"moe_gemm_{layout}: no kernel for device "
                         f"{a.device}")
    refuse_grad("moe_gemm_bwd", why, a, b)
    plan = _check_bwd(layout, a, b, shape)
    out = a.new_empty((e, m, n))
    if out.numel() == 0 or k == 0:
        return out.zero_()
    _launch_bwd(a, b, out, shape, plan)
    return out


def moe_gemm_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (E, M, K); b: (E, N, K) -> (E, M, N): out[e] = a[e] @ b[e]ᵀ,
    b read in place.  :class:`MoeGemm`'s dx = ``moe_gemm_nt(dy, w)``:
    dy (E, C, F) against w (E, D, F).  fp32 on the GPU."""
    return _bwd("nt", a, b)


def moe_gemm_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (E, K, M); b: (E, K, N) -> (E, M, N): out[e] = a[e]ᵀ @ b[e],
    a read in place.  :class:`MoeGemm`'s dw = ``moe_gemm_tn(x, dy)``:
    x (E, C, D) against dy (E, C, F).  fp32 on the GPU."""
    return _bwd("tn", a, b)


class MoeGemm(torch.autograd.Function):
    """:func:`moe_gemm` with its backward: ``MoeGemm.apply(x, w)``.  Saves
    x and w.  The backward is one call for each input that
    ``ctx.needs_input_grad`` asks for, on x, w and dy as saved:
    dx = :func:`moe_gemm_nt` (dy, w) = dy wᵀ and dw = :func:`moe_gemm_tn`
    (x, dy) = xᵀ dy, each one ``moe_gemm_bwd`` launch that reads its
    operands where they lie (no transposed copies).  Kernels on CUDA
    tensors, the plain versions on CPU tensors.  A bf16 input that needs
    a gradient raises ``NotImplementedError`` (fp32 training only); under
    ``torch.no_grad`` it runs."""

    @classmethod
    def apply(cls, x, w):
        # here, not in forward: forward runs with grad mode off, and its
        # ctx.needs_input_grad is set under torch.no_grad too
        if x.dtype != torch.float32 and torch.is_grad_enabled() \
                and (x.requires_grad or w.requires_grad):
            raise NotImplementedError(BF16_GRAD)
        return super().apply(x, w)

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return moe_gemm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()       # a copy only for a dy that comes strided
        dx = moe_gemm_nt(dy, w) if ctx.needs_input_grad[0] else None
        dw = moe_gemm_tn(x, dy) if ctx.needs_input_grad[1] else None
        return dx, dw
