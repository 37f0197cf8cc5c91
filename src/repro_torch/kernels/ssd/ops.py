"""Public wrapper of the Hopper SSD intra-chunk kernel (``csrc/ssd_chunk.cu``).

Counterpart of ``src/repro/kernels/ssd/``.  For tensors on the GPU the
wrapper launches the kernel or raises; for tensors on the CPU it runs
the plain version (:mod:`.ref`).  There is no fallback: a dtype, layout
or width the kernel does not take is an error.

:func:`plan` chooses each launch's heads a block in plain Python (with
the grid and shared memory that follow); the kernel refuses any other.
:func:`launch_count` counts the kernel's launches since the last
:func:`reset_launches`, so a run can show that it went through it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from .._build import DTYPE_CODES, Launchers, library, refuse_grad
from .ref import ssd_chunk_ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"ssd_chunk": CSRC / "ssd_chunk.cu"}
#: largest head dim P and state size N the kernel takes
MAX_P = MAX_N = 128
#: the tiles the kernel is written for: rows of a y row tile (and
#: columns of P a block), positions a step, columns of N a state block
TQ, TJ, NS = 64, 32, 64
#: chunks of TJ positions the kernel's prefix cumsum stages at a time
PB = 8
#: heads a y block the kernel takes (64 threads a head); a state block
#: takes half as many (128 threads a head)
GROUPS = (2, 4)
#: SMs of an H100; the shared memory one block may opt into, one SM's
#: (1 KB of it reserved a block) and one SM's registers
SMS, SMEM_MAX, SMEM_SM, REGS_SM = 132, 232448, 233472, 65536
#: a grid dimension the kernel's y and z may not exceed
MAX_GRID = 65535
#: ctypes signatures of the ``extern "C"`` launchers, one for one
ARGTYPES = {
    # dtype; x, dt, A, B, C, y, st; bc, q, h, p, n; g; stream
    "ssd_chunk": ([ctypes.c_int] + [ctypes.c_void_p] * 7
                  + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
}

_KERNELS = Launchers(SOURCES, ARGTYPES)
#: launches of kernel ``name`` (a key of :data:`SOURCES`) since process
#: start or :func:`reset_launches`
launch_count = _KERNELS.launch_count
reset_launches = _KERNELS.reset


class Plan(NamedTuple):
    """How one ``ssd_chunk`` launch runs: G heads a y block (G′ = G / 2
    heads a state block; the tiles are :data:`TQ`, :data:`TJ`,
    :data:`NS`), the grid (head groups of G, chunks, items: the y blocks'
    row-tile pairs x P tiles, then the state blocks' two halves of the
    group x P x N tiles) and the dynamic shared memory of a block in
    bytes.  Only G goes to the kernel, which derives the rest itself
    (``ssd_chunk_query`` reports its grid and shared memory)."""
    g: int
    grid: tuple[int, int, int]
    smem: int

    @property
    def gs(self) -> int:
        return self.g // 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(g: int, n: int, esz: int) -> int:
    """A block's shared memory, as ``layout`` in ``ssd_chunk.cu`` sums it:
    two C row tiles, B for one C Bᵀ (2 TJ rows) and the two-slot x ring
    (elements of ``esz`` bytes, C and B rows padded by 16 bytes), C Bᵀ,
    M (or xw) and the cumsum arrays."""
    ce = 16 // esz
    ld = _cdiv(n, ce) * ce + ce
    parts = [2 * TQ * ld * esz, 2 * TJ * max(ld, NS) * esz,
             2 * g * TJ * TQ * esz, TQ * (2 * TJ + 1) * 4, g * TJ * TQ * 4,
             2 * g * TQ * 4, g * TJ * 4, g * TJ * 4, g * TJ * 4,
             PB * g * TJ * 4, g * 4]
    return sum(_cdiv(b, 16) * 16 for b in parts)


def _grid(bc: int, q: int, h: int, p: int, n: int, g: int
          ) -> tuple[int, int, int]:
    pairs = _cdiv(_cdiv(q, TQ), 2)
    pt = _cdiv(p, TQ)
    return (_cdiv(h, g), bc, pairs * pt + 2 * pt * _cdiv(n, NS))


def blocks_per_sm(g: int, smem: int) -> int:
    """Blocks of G heads (64 G threads) that one SM holds at once: by
    shared memory and by registers (up to 255 a thread, which is all
    that ``__launch_bounds__(64 G, 1)`` promises)."""
    return min(SMEM_SM // (smem + 1024), REGS_SM // (64 * g * 255))


@functools.lru_cache(maxsize=256)
def plan(bc: int, q: int, h: int, p: int, n: int,
         dtype: torch.dtype = torch.float32) -> Plan:
    """The launch plan of x (bc, q, h, p), B/C (bc, q, n) from the shape
    alone.  G = 4 heads a y block (C Bᵀ formed once for four heads),
    except G = 2 for one or two heads (a group of four would carry dead
    heads and nothing more), and where G = 4's grid is short of one wave
    on :data:`SMS` SMs while G = 2's whole grid runs in one wave: there
    the largest block sets the time, and G = 2's does two thirds of the
    work of G = 4's at N = 128.  The rule is the one that picks the faster G in every case
    timed both ways on the card (``PERF.md``, PR 18).
    Raises if no plan fits the kernel (shared memory, grid)."""
    esz = torch.empty((), dtype=dtype).element_size()
    plans = {g: Plan(g, _grid(bc, q, h, p, n, g), smem_bytes(g, n, esz))
             for g in GROUPS}
    two, four = plans[2], plans[4]
    if h <= 2 or (math.prod(four.grid) < SMS and math.prod(two.grid)
                  <= SMS * blocks_per_sm(2, two.smem)):
        out = two
    else:
        out = four
    check_plan(out)
    return out


def check_plan(pl: Plan) -> None:
    """Raise ValueError for a plan the kernel refuses (as
    ``ssd_chunk_launch`` does with cudaErrorInvalidValue)."""
    problems = []
    if pl.g not in GROUPS:
        problems.append(f"G = {pl.g} (kernel takes G in {GROUPS})")
    if pl.smem > SMEM_MAX:
        problems.append(f"{pl.smem} bytes of shared memory > {SMEM_MAX}")
    if max(pl.grid[1:]) > MAX_GRID:
        problems.append(f"grid {pl.grid}: y and z at most {MAX_GRID}")
    if problems:
        raise ValueError("ssd_chunk: plan refused: " + "; ".join(problems))


def kernel_layout(bc: int, q: int, h: int, p: int, n: int, g: int,
                  dtype: torch.dtype) -> tuple[int, tuple[int, int, int]]:
    """The shared memory and grid that the C side computes for a launch
    with G = ``g`` (``ssd_chunk_query``), to hold :func:`plan`'s against.
    Builds the kernel, so it needs the CUDA toolkit; raises where the C
    side refuses the launch."""
    fn = library(SOURCES["ssd_chunk"]).ssd_chunk_query
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(DTYPE_CODES[dtype], bc, q, h, p, n, g, out)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_query refused G = {g} at "
                           f"{(bc, q, h, p, n)}: CUDA error {err}")
    return out[0], (out[1], out[2], out[3])


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
    if BC > MAX_GRID or H > MAX_GRID:
        raise ValueError(f"ssd_chunk: {BC} chunks x {H} heads; at most "
                         f"{MAX_GRID} each")


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
    refuse_grad("ssd_chunk", "its backward is ROADMAP Queue 1, item 11c "
                "(mamba2 and zamba2 train on the CPU until then)",
                x, dt, A, Bm, Cm)
    _check_cuda(x, dt, A, Bm, Cm)
    BC, Q, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    if x.numel() == 0 or N == 0:
        return y, x.new_zeros((BC, H, P, N))   # nothing to sum
    st = x.new_empty((BC, H, P, N))
    pl = plan(BC, Q, H, P, N, x.dtype)
    _KERNELS.launch("ssd_chunk", x, x.data_ptr(), dt.data_ptr(),
                    A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                    y.data_ptr(), st.data_ptr(), BC, Q, H, P, N, pl.g)
    return y, st
