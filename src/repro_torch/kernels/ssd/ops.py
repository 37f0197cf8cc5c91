"""Public wrapper of the Hopper SSD intra-chunk kernel (``csrc/ssd_chunk.cu``).

Counterpart of ``src/repro/kernels/ssd/``.  For tensors on the GPU the
wrapper launches the kernel or raises; for tensors on the CPU it runs
the plain version (:mod:`.ref`).  There is no fallback: a dtype, layout
or width the kernel does not take is an error.

:func:`launch_count` counts the kernel's launches since the last
:func:`reset_launches`, so a run can show that it went through it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import DTYPE_CODES, Launchers
from .ref import ssd_chunk_ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"ssd_chunk": CSRC / "ssd_chunk.cu"}
#: largest head dim P and state size N the kernel takes
MAX_P = MAX_N = 128
#: ctypes signatures of the ``extern "C"`` launchers, one for one
ARGTYPES = {
    # dtype; x, dt, A, B, C, y, st; bc, q, h, p, n; stream
    "ssd_chunk": ([ctypes.c_int] + [ctypes.c_void_p] * 7
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
}

_KERNELS = Launchers(SOURCES, ARGTYPES)
#: launches of kernel ``name`` (a key of :data:`SOURCES`) since process
#: start or :func:`reset_launches`
launch_count = _KERNELS.launch_count
reset_launches = _KERNELS.reset


def _check_cuda(x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"ssd_chunk: dtype {x.dtype} not supported (kernel "
                         f"takes {sorted(map(str, DTYPE_CODES))})")
    for t in (x, *others):
        if t.device != x.device:
            raise ValueError(f"ssd_chunk: tensors on {t.device} and "
                             f"{x.device}")
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_chunk: dtypes {t.dtype} and {x.dtype}")
        if not t.is_contiguous():
            raise ValueError("ssd_chunk: inputs must be contiguous")
    BC, _, H, P = x.shape
    N = others[-1].shape[-1]
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"ssd_chunk: head dim {P} / state {N}; the kernel "
                         f"takes at most {MAX_P} / {MAX_N}")
    if BC > 65535 or H > 65535:
        raise ValueError(f"ssd_chunk: {BC} chunks x {H} heads; at most "
                         f"65535 each")


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD.  x: (BC, Q, H, P); dt: (BC, Q, H) (post-softplus);
    A: (H,); Bm/Cm: (BC, Q, N), all of one dtype.

    Returns (y_intra (BC, Q, H, P), state (BC, H, P, N)) in x's dtype
    (fp32 or bf16 on the GPU; fp32 decays and accumulation either way).
    """
    if x.dim() != 4 or tuple(dt.shape) != tuple(x.shape[:3]) \
            or tuple(A.shape) != (x.shape[2],) or Bm.dim() != 3 \
            or Bm.shape != Cm.shape or tuple(Bm.shape[:2]) != \
            tuple(x.shape[:2]):
        raise ValueError(f"ssd_chunk: want x (BC,Q,H,P), dt (BC,Q,H), A (H,),"
                         f" B/C (BC,Q,N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: no kernel for device {x.device}")
    _check_cuda(x, dt, A, Bm, Cm)
    BC, Q, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    if x.numel() == 0 or N == 0:
        return y, x.new_zeros((BC, H, P, N))   # nothing to sum
    st = x.new_empty((BC, H, P, N))
    _KERNELS.launch("ssd_chunk", x, x.data_ptr(), dt.data_ptr(),
                    A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                    y.data_ptr(), st.data_ptr(), BC, Q, H, P, N)
    return y, st
