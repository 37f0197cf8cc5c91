"""Public wrappers of the Hopper SSD intra-chunk kernel (``csrc/ssd_chunk.cu``)
and of its backward (``csrc/ssd_chunk_bwd.cu``).

Counterpart of ``src/repro/kernels/ssd/``.  For tensors on the GPU the
wrapper launches the kernel or raises; for tensors on the CPU it runs
the plain version (:mod:`.ref`).  There is no fallback: a dtype, layout
or width the kernel does not take is an error.

:func:`plan` chooses each launch's heads a block in plain Python (with
the grid and shared memory that follow); the kernel refuses any other.
:func:`bwd_plan` is the backward's, which the C side derives itself and
reports (:func:`bwd_layout`).  :class:`SsdChunk` puts :func:`ssd_chunk`
under autograd, its backward one :func:`ssd_chunk_bwd` call.
:func:`launch_count` counts each kernel's launches since the last
:func:`reset_launches`, so a run can show that it went through it.

:func:`ssd_chunk_work` and :func:`ssd_chunk_bwd_work` are one call's
FLOPs and bytes, what ``chip_smoke.py`` bounds the kernels by and what a
census (``launch/hlo_analysis.py``) counts for each call.  On fake
tensors the wrappers refuse what the kernels refuse, launch nothing and
return empty outputs of the kernels' shapes and dtypes, their work
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

from .._build import (DTYPE_CODES, Launchers, fake_call, library, quiet,
                      record_work, refuse_grad)
from .ref import ssd_chunk_bwd_ref, ssd_chunk_ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"ssd_chunk": CSRC / "ssd_chunk.cu",
           "ssd_chunk_bwd": CSRC / "ssd_chunk_bwd.cu"}
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
    # dtype; x, dt, A, B, C, dy, dst; dx, ddtp, dcc, uw, dcr, dBp, dCp;
    # bc, q, h, p, n; stream
    "ssd_chunk_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 14
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
}
#: the backward's tile of positions (rows i and columns j) and the widths
#: it pads P and N to in shared memory
BWD_T, BWD_WIDTHS = 64, (64, 128)
BF16_GRAD = ("ssd_chunk: no bf16 backward (training runs in fp32, as the "
             "reference's; bf16 training is later kernel work)")

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


def ssd_chunk_work(bc: int, q: int, h: int, p: int, n: int, esz: int
                   ) -> tuple[float, int]:
    """(FLOPs, bytes) of one ``ssd_chunk`` call at x (bc, q, h, p), B/C
    (bc, q, n) of ``esz``-byte elements: C Bᵀ over the causal pairs once
    a chunk, M @ x a head, and the state; x, dt, A, B, C read once, y and
    the state written once."""
    pairs = q * (q + 1) // 2          # causal (i, j) pairs of a chunk
    flops = (2.0 * bc * pairs * n          # C B^T, once per chunk
             + 2.0 * bc * h * pairs * p    # M @ x
             + 2.0 * bc * h * q * p * n)   # the state
    x = bc * q * h * p
    return flops, (2 * x + bc * q * h + h + 2 * bc * q * n
                   + bc * h * p * n) * esz


def ssd_chunk_bwd_work(bc: int, q: int, h: int, p: int, n: int
                       ) -> tuple[float, int]:
    """(FLOPs, bytes) of one ``ssd_chunk_bwd`` call (fp32), its kernel
    and :func:`bwd_finish` together: the products over the causal pairs
    and the state's; x, dy, dx, dt and ddt, A and dA, B, C, dB, dC and
    dst each once."""
    pairs = q * (q + 1) // 2
    flops = bc * (4.0 * pairs * p * h + 6.0 * pairs * n
                  + 4.0 * q * p * n * h)
    return flops, 4 * (3 * bc * q * h * p + 2 * bc * q * h + 2 * h
                       + 4 * bc * q * n + bc * h * p * n)


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


def _check_shapes(name, x, dt, A, Bm, Cm) -> None:
    if x.dim() != 4 or tuple(dt.shape) != tuple(x.shape[:3]) \
            or tuple(A.shape) != (x.shape[2],) or Bm.dim() != 3 \
            or Bm.shape != Cm.shape or tuple(Bm.shape[:2]) != \
            tuple(x.shape[:2]):
        raise ValueError(f"{name}: want x (BC,Q,H,P), dt (BC,Q,H), A (H,),"
                         f" B/C (BC,Q,N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD.  x: (BC, Q, H, P); dt: (BC, Q, H) (post-softplus);
    A: (H,); Bm/Cm: (BC, Q, N), all of one dtype.

    Returns (y_intra (BC, Q, H, P), state (BC, H, P, N)) in x's dtype
    (fp32 or bf16 on the GPU; fp32 decays and accumulation either way).
    """
    _check_shapes("ssd_chunk", x, dt, A, Bm, Cm)
    BC, Q, H, P = x.shape
    N = Bm.shape[-1]
    if is_fake(x):
        refuse_grad("ssd_chunk", "differentiate it through SsdChunk.apply, "
                    "whose backward is the ssd_chunk_bwd kernel", x, dt, A,
                    Bm, Cm)
        _check_cuda(x, dt, A, Bm, Cm)
        if x.numel() and N:
            plan(BC, Q, H, P, N, x.dtype)
        return fake_call("ssd_chunk", ssd_chunk_work(
            BC, Q, H, P, N, x.element_size()),
            (torch.empty_like(x), x.new_empty((BC, H, P, N))))
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: no kernel for device {x.device}")
    refuse_grad("ssd_chunk", "differentiate it through SsdChunk.apply, "
                "whose backward is the ssd_chunk_bwd kernel", x, dt, A, Bm,
                Cm)
    _check_cuda(x, dt, A, Bm, Cm)
    y = torch.empty_like(x)
    if x.numel() == 0 or N == 0:
        return y, x.new_zeros((BC, H, P, N))   # nothing to sum
    st = x.new_empty((BC, H, P, N))
    pl = plan(BC, Q, H, P, N, x.dtype)
    _KERNELS.launch("ssd_chunk", x, x.data_ptr(), dt.data_ptr(),
                    A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                    y.data_ptr(), st.data_ptr(), BC, Q, H, P, N, pl.g)
    record_work("ssd_chunk", ssd_chunk_work(BC, Q, H, P, N,
                                            x.element_size()))
    return y, st


# -- the backward ------------------------------------------------------------

class BwdPlan(NamedTuple):
    """How one ``ssd_chunk_bwd`` launch runs: P and N padded to ``pw`` and
    ``nw`` in shared memory, G heads a block (4 at pw 64, 2 at 128: the
    registers of dx), the grid (head groups, chunks, a column and a row
    block of each 64-position tile) and a block's dynamic shared memory
    in bytes.  The C side derives the same from the shape
    (``ssd_chunk_bwd_query``, :func:`bwd_layout`)."""
    pw: int
    nw: int
    g: int
    grid: tuple[int, int, int]
    smem: int


def _f16(floats: int) -> int:
    return _cdiv(floats, 4) * 4


def bwd_smem_bytes(pw: int, nw: int, g: int) -> int:
    """A block's shared memory, as ``layout`` in ``ssd_chunk_bwd.cu`` sums
    it (floats, each part rounded to 16 bytes): the owned tile (B_j or
    C_i, 64 rows of nw + 4), G heads of the owned side (x_j or dy_i, 64
    rows of pw + 4 each), the walked tile and one head of the walked
    side, the M and dCB tiles (64 x 65), eight G x 64 arrays of cum, dt
    and sums, and cum_last."""
    t = BWD_T
    parts = [t * (nw + 4), g * t * (pw + 4), t * (nw + 4), t * (pw + 4),
             t * (t + 1), t * (t + 1)] + [g * t] * 8 + [g]
    return 4 * sum(_f16(f) for f in parts)


@functools.lru_cache(maxsize=256)
def bwd_plan(bc: int, q: int, h: int, p: int, n: int) -> BwdPlan:
    """The backward's launch plan from the shape alone; raises ValueError
    for one the kernel refuses (widths, grid)."""
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N and q >= 1 and h >= 1):
        raise ValueError(f"ssd_chunk_bwd: plan refused at P {p}, N {n}, "
                         f"Q {q}, H {h}")
    pw = BWD_WIDTHS[0] if p <= BWD_WIDTHS[0] else BWD_WIDTHS[1]
    nw = BWD_WIDTHS[0] if n <= BWD_WIDTHS[0] else BWD_WIDTHS[1]
    g = 4 if pw == BWD_WIDTHS[0] else 2
    grid = (_cdiv(h, g), bc, 2 * _cdiv(q, BWD_T))
    pl = BwdPlan(pw, nw, g, grid, bwd_smem_bytes(pw, nw, g))
    if pl.smem > SMEM_MAX or max(grid[1:]) > MAX_GRID:
        raise ValueError(f"ssd_chunk_bwd: plan refused: {pl}")
    return pl


def bwd_layout(bc: int, q: int, h: int, p: int, n: int
               ) -> tuple[int, tuple[int, int, int], int]:
    """The shared memory, grid and G that the C side computes for the
    backward's launch (``ssd_chunk_bwd_query``), to hold :func:`bwd_plan`
    against.  Builds the kernel, so it needs the CUDA toolkit; raises
    where the C side refuses the launch."""
    fn = library(SOURCES["ssd_chunk_bwd"]).ssd_chunk_bwd_query
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(0, bc, q, h, p, n, out)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd_query refused "
                           f"{(bc, q, h, p, n)}: CUDA error {err}")
    return out[0], (out[1], out[2], out[3]), out[4]


def ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                  dst: torch.Tensor):
    """Gradients (dx, ddt, dA, dB, dC) of :func:`ssd_chunk` at (x, dt, A,
    B, C) for the output gradients dy (BC, Q, H, P) and dst (BC, H, P,
    N).  fp32 on the GPU: one launch of the backward kernel (every
    product and every Q x Q term), then the finish in torch on its
    partials (the reverse cumsum of dcum, ddt's A term, dA's sum over
    chunks and positions, dB's and dC's sums over head groups), all in a
    fixed order, so two calls give the same bits.
    :func:`.ref.ssd_chunk_bwd_ref` on the CPU."""
    _check_shapes("ssd_chunk_bwd", x, dt, A, Bm, Cm)
    BC, Q, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dy.shape) != tuple(x.shape) \
            or tuple(dst.shape) != (BC, H, P, N):
        raise ValueError(f"ssd_chunk_bwd: want dy {tuple(x.shape)}, dst "
                         f"{(BC, H, P, N)}; got {tuple(dy.shape)}, "
                         f"{tuple(dst.shape)}")
    if is_fake(x):
        if x.dtype != torch.float32:
            raise NotImplementedError(BF16_GRAD)
        refuse_grad("ssd_chunk_bwd", "no double backward", x, dt, A, Bm,
                    Cm, dy, dst)
        _check_cuda(x, dt, A, Bm, Cm, dy, dst)
        if x.numel():
            bwd_plan(BC, Q, H, P, N)
        return fake_call("ssd_chunk_bwd", ssd_chunk_bwd_work(BC, Q, H, P, N),
                         tuple(torch.empty_like(t)
                               for t in (x, dt, A, Bm, Cm)))
    if x.device.type == "cpu":
        return ssd_chunk_bwd_ref(x, dt, A, Bm, Cm, dy, dst)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bwd: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise NotImplementedError(BF16_GRAD)
    refuse_grad("ssd_chunk_bwd", "no double backward", x, dt, A, Bm, Cm, dy,
                dst)
    _check_cuda(x, dt, A, Bm, Cm, dy, dst)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx, torch.zeros_like(dt), torch.zeros_like(A), \
            torch.zeros_like(Bm), torch.zeros_like(Cm)
    pl = bwd_plan(BC, Q, H, P, N)
    ddtp, dcc, uw, dcr = (x.new_empty((BC, Q, H)) for _ in range(4))
    dBp, dCp = (x.new_empty((pl.grid[0], BC, Q, N)) for _ in range(2))
    _KERNELS.launch("ssd_chunk_bwd", x, *(t.data_ptr() for t in (
        x, dt, A, Bm, Cm, dy, dst, dx, ddtp, dcc, uw, dcr, dBp, dCp)),
        BC, Q, H, P, N)
    with quiet():
        out = (dx, *bwd_finish(dt, A, ddtp, dcc, uw, dcr, dBp, dCp))
    record_work("ssd_chunk_bwd", ssd_chunk_bwd_work(BC, Q, H, P, N))
    return out


def bwd_finish(dt, A, ddtp, dcc, uw, dcr, dBp, dCp):
    """(ddt, dA, dB, dC) from the backward kernel's partials: dcum = its
    row part + its column part, with Σ_j u_j w_j added at the last
    position; da = the reverse cumsum of dcum; ddt = the partial + da A;
    dA = Σ da dt over chunks and positions; dB and dC summed over head
    groups.  Torch ops in a fixed order (no atomics)."""
    dcum = dcr + dcc
    dcum[:, -1] += uw.sum(1)
    da = dcum.flip(1).cumsum(1).flip(1)
    return ddtp + da * A, (da * dt).sum((0, 1)), dBp.sum(0), dCp.sum(0)


class SsdChunk(torch.autograd.Function):
    """:func:`ssd_chunk` with its backward, :func:`ssd_chunk_bwd`:
    ``SsdChunk.apply(x, dt, A, B, C)`` returns (y_intra, state).  Saves
    the five inputs; the backward recomputes cum, C Bᵀ, L and M from
    them.  Kernels on CUDA tensors, the plain versions on CPU tensors.
    A gradient of the state alone (one chunk: only ``h_final`` reads it)
    or of y alone arrives with the other as zeros.  A bf16 input that
    needs a gradient raises ``NotImplementedError`` (fp32 training
    only); under ``torch.no_grad`` it runs."""

    @classmethod
    def apply(cls, x, dt, A, Bm, Cm):
        # here, not in forward: forward runs with grad mode off, and its
        # ctx.needs_input_grad is set under torch.no_grad too
        if x.dtype != torch.float32 and torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, dt, A, Bm, Cm)):
            raise NotImplementedError(BF16_GRAD)
        return super().apply(x, dt, A, Bm, Cm)

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return ssd_chunk(x, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dst):
        return ssd_chunk_bwd(*ctx.saved_tensors, dy.contiguous(),
                             dst.contiguous())
