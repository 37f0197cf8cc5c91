"""Public wrapper of the Hopper grouped expert GEMM (``csrc/moe_gemm.cu``).

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

:class:`MoeGemm` is the product under autograd: its backward is two more
launches of the same kernel, on transposed operands.

:func:`work` is one call's FLOPs and bytes (and :func:`bwd_work` the
backward pair's), what ``chip_smoke.py`` bounds the kernel by and what a
census (``launch/hlo_analysis.py``) counts for each call.  On fake
tensors the wrapper refuses what the kernel refuses, launches nothing
and returns an empty output of the kernel's shape and dtype, its work
recorded (``_build.fake_call``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from torch._subclasses.fake_tensor import is_fake

from .._build import (DTYPE_CODES, Launchers, bump, count_table, fake_call,
                      quiet, record_work, refuse_grad, scratch)
from .ref import moe_gemm_ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"moe_gemm": CSRC / "moe_gemm.cu"}
#: ctypes signatures of the ``extern "C"`` launchers, one for one
ARGTYPES = {
    # dtype; x, w, y; e, c, d, f, variant, split_rows; workspace,
    # counters; stream
    "moe_gemm": ([ctypes.c_int] + [ctypes.c_void_p] * 3
                 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3),
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

_KERNELS = Launchers(SOURCES, ARGTYPES)
#: launches of kernel ``name`` (a key of :data:`SOURCES`) since process
#: start or :func:`reset_launches`
launch_count = _KERNELS.launch_count
#: launches of each variant (a key of :data:`VARIANTS`) since process
#: start or :func:`reset_launches`
variant_counts = count_table(dict.fromkeys(VARIANTS, 0))


def reset_launches() -> None:
    _KERNELS.reset()
    for name in variant_counts:
        variant_counts[name] = 0


def work(e: int, c: int, d: int, f: int, esz: int) -> tuple[float, int]:
    """(FLOPs, bytes) of one call at x (E, C, D), w (E, D, F) of
    ``esz``-byte elements: x and w read once, y written once."""
    return 2.0 * e * c * d * f, (e * c * d + e * d * f + e * c * f) * esz


def bwd_work(e: int, c: int, d: int, f: int) -> tuple[float, int]:
    """(FLOPs, bytes) of :class:`MoeGemm`'s backward pair (fp32) at the
    forward's x (E, C, D), w (E, D, F): dx and dw, each 2 E C D F; x, w
    (and the transposed copies the launches read), dy read and dx, dw
    written, dy counted once."""
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


class MoeGemm(torch.autograd.Function):
    """:func:`moe_gemm` with its backward: ``MoeGemm.apply(x, w)``.  Saves
    x and w.  The backward is two more calls of :func:`moe_gemm`, each
    only where ``ctx.needs_input_grad`` asks for it: dx = dy wᵀ (dy
    (E, C, F) against wᵀ (E, F, D)) and dw = xᵀ dy (xᵀ (E, D, C) against
    dy (E, C, F)), each call's variant chosen from its own shape
    (:func:`variant`).  The transposes are contiguous copies: layout
    only, the products are the kernel's.  Kernels on CUDA tensors, the
    plain version on CPU tensors.  A bf16 input that needs a gradient
    raises ``NotImplementedError`` (fp32 training only); under
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
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = moe_gemm(dy, w.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            dw = moe_gemm(x.transpose(1, 2).contiguous(), dy)
        return dx, dw
