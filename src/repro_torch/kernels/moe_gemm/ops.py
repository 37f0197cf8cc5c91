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
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .._build import DTYPE_CODES, Launchers
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

_KERNELS = Launchers(SOURCES, ARGTYPES)
#: launches of kernel ``name`` (a key of :data:`SOURCES`) since process
#: start or :func:`reset_launches`
launch_count = _KERNELS.launch_count
#: launches of each variant (a key of :data:`VARIANTS`) since process
#: start or :func:`reset_launches`
variant_counts = dict.fromkeys(VARIANTS, 0)
#: the stream variant's workspace and counters, per (device, stream)
_SCRATCH: dict[tuple, dict[str, torch.Tensor]] = {}


def reset_launches() -> None:
    _KERNELS.reset()
    for name in variant_counts:
        variant_counts[name] = 0


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
    kept and grown as needed.  The kernel leaves the counters at zero."""
    key = (x.device, torch.cuda.current_stream(x.device).cuda_stream)
    held = _SCRATCH.setdefault(key, {})
    if "counters" not in held or held["counters"].numel() < n_count:
        held["counters"] = torch.zeros(n_count, dtype=torch.int32,
                                       device=x.device)
    if n_part and ("ws" not in held or held["ws"].numel() < n_part):
        held["ws"] = torch.empty(n_part, dtype=torch.float32,
                                 device=x.device)
    return (held["ws"].data_ptr() if n_part else None,
            held["counters"].data_ptr())


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


def _check_cuda(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """Raise on what no variant takes; return the call's :func:`_plan`."""
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
    return _plan(E, C, D, w.shape[2], x.dtype, _aligned(x, w))


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in x's dtype: y[e] =
    x[e] @ w[e], summed in fp32 (fp32 or bf16 on the GPU)."""
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"moe_gemm: want x (E,C,D), w (E,D,F); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemm: no kernel for device {x.device}")
    v, rows, n_part, n_count = _check_cuda(x, w)
    E, C, D = x.shape
    F = w.shape[2]
    y = x.new_empty((E, C, F))
    if y.numel() == 0:
        return y
    ws = counters = None
    if n_count:                      # the stream variant's 16-byte loads
        ws, counters = _scratch(x, n_part, n_count)
    _KERNELS.launch("moe_gemm", x, x.data_ptr(), w.data_ptr(), y.data_ptr(),
                    E, C, D, F, VARIANTS.index(v), rows, ws, counters)
    variant_counts[v] += 1
    return y
