"""Public wrapper of the Hopper grouped expert GEMM (``csrc/moe_gemm.cu``).

Counterpart of ``src/repro/kernels/moe_gemm/``.  For tensors on the GPU
the wrapper launches the kernel or raises; for tensors on the CPU it
runs the plain version (:mod:`.ref`).  There is no fallback: a dtype or
layout the kernel does not take is an error.

:func:`launch_count` counts the kernel's launches since the last
:func:`reset_launches`, so a run can show that it went through it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import DTYPE_CODES, Launchers
from .ref import moe_gemm_ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"moe_gemm": CSRC / "moe_gemm.cu"}
#: ctypes signatures of the ``extern "C"`` launchers, one for one
ARGTYPES = {
    # dtype; x, w, y; e, c, d, f; stream
    "moe_gemm": ([ctypes.c_int] + [ctypes.c_void_p] * 3
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}

_KERNELS = Launchers(SOURCES, ARGTYPES)
#: launches of kernel ``name`` (a key of :data:`SOURCES`) since process
#: start or :func:`reset_launches`
launch_count = _KERNELS.launch_count
reset_launches = _KERNELS.reset


def _check_cuda(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"moe_gemm: dtype {x.dtype} not supported (kernel "
                         f"takes {sorted(map(str, DTYPE_CODES))})")
    if w.device != x.device:
        raise ValueError(f"moe_gemm: w on {w.device}, x on {x.device}")
    if w.dtype != x.dtype:
        raise ValueError(f"moe_gemm: w is {w.dtype}, x is {x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gemm: inputs must be contiguous")
    E, C, _ = x.shape
    if E > 65535 or -(-C // 64) > 65535:
        raise ValueError(f"moe_gemm: {E} experts x {C} rows is past the "
                         f"kernel's grid")


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
    _check_cuda(x, w)
    E, C, D = x.shape
    F = w.shape[2]
    y = x.new_empty((E, C, F))
    if y.numel() == 0:
        return y
    _KERNELS.launch("moe_gemm", x, x.data_ptr(), w.data_ptr(), y.data_ptr(),
                    E, C, D, F)
    return y
