"""Public wrapper of the Hopper conv kernel (``csrc/conv2d_fused.cu``).

Counterpart of ``src/repro/kernels/conv2d/ops.py``.  For a tensor on the
GPU the wrapper launches the kernel or raises; for a tensor on the CPU
it runs the plain version (:mod:`.ref`).  There is no fallback: a shape,
dtype or layout the kernel does not take is an error.  An input smaller
than the kernel has an empty output, which is returned without a
launch.

The kernel's launch is planned per shape by :func:`plan`, in plain
Python: its variant (``ring`` or ``general``), its output tile and how
many blocks of a thread-block cluster split K.

:func:`launch_count` counts the launches since the last
:func:`reset_launches`, so a run can show that it went through the
kernel, and :data:`variant_counts` how many of them took each variant.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from .._build import library
from .ref import conv2d_fused_ref, out_size

SOURCE = Path(__file__).parent / "csrc" / "conv2d_fused.cu"
#: largest pool window (ph * pw) whose rows fit the smallest block tile
MAX_POOL_WINDOW = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: ctypes signature of ``conv2d_fused_launch`` in the source: dtype; x, w,
#: b, y; n, h, w, ci, kh, kw, co, sh, sw, ph, pw, relu, variant, bm, bn,
#: split; stream
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 16
            + [ctypes.c_void_p])
#: the variants, in the order of the code ``conv2d_fused_launch`` takes:
#: ``ring`` (CI and CO multiples of 4, 16-byte aligned x and w: cp.async
#: copies of 4 elements) and ``general`` (scalar loads, any shape)
VARIANTS = ("ring", "general")
#: output tiles (BM rows, BN channels) of a 256-thread block, larger
#: first; a thread holds (BM / 16) x (BN / 16) accumulators.  The
#: general variant takes 64 x 64 only
TILES = ((128, 64), (64, 64))
#: depth of one K slice (csrc BK): splits of K fall on its multiples
BK = 16
#: SMs of an H100 SXM.  A launch wants at least MIN_BLOCKS, three blocks
#: for every two SMs (an SM with one block cannot keep its FMA pipes
#: busy), and splits K further while it has fewer than FULL_BLOCKS (four
#: a SM) and each split keeps LONG_SPLIT_SLICES; every split keeps at
#: least MIN_SPLIT_SLICES.  The cluster's reduction costs more with each
#: split, so short splits pay only where blocks are scarce
SMS = 132
MIN_BLOCKS = 3 * SMS // 2
FULL_BLOCKS = 4 * SMS
MIN_SPLIT_SLICES = 4
LONG_SPLIT_SLICES = 64
#: blocks of a thread-block cluster (the portable limit)
MAX_SPLIT = 8


class Plan(NamedTuple):
    """How one conv launches: the variant, the output tile (BM, BN) and
    the split-K factor S (the blocks of one cluster)."""
    variant: str
    tile: tuple[int, int]
    split: int


@functools.lru_cache(maxsize=1024)
def plan(n: int, h: int, w: int, ci: int, kh: int, kw: int, co: int,
         stride: tuple[int, int] = (1, 1),
         pool: tuple[int, int] | None = None, aligned: bool = True) -> Plan:
    """The launch plan of x (n, h, w, ci), w (kh, kw, ci, co), from the
    shape alone (and 16-byte alignment, which every tensor the model
    makes has).

    - variant: ``ring`` where CI and CO are multiples of 4 and x and w
      aligned, else ``general``;
    - tile: the first of :data:`TILES` (64 x 64 for ``general``) whose
      blocks, split at most :data:`MAX_SPLIT` ways, reach
      :data:`MIN_BLOCKS`; else 64 x 64;
    - split S: doubled from 1 while the blocks number fewer than
      :data:`MIN_BLOCKS`, or fewer than :data:`FULL_BLOCKS` with every
      split keeping :data:`LONG_SPLIT_SLICES` slices of K, as long as each
      keeps at least :data:`MIN_SPLIT_SLICES`.  Block r of a cluster
      walks the BK slices ``_build.split_ranges(ceil(K / BK), S)[r]``.
    """
    ph, pw = pool or (1, 1)
    hp, wp = out_size(h, w, kh, kw, stride, pool)
    windows = n * hp * wp
    variant = "ring" if aligned and ci % 4 == 0 and co % 4 == 0 \
        else "general"
    slices = math.ceil(kh * kw * ci / BK)

    def blocks(tile):
        bm, bn = tile
        return math.ceil(windows / (bm // (ph * pw))) * math.ceil(co / bn)

    def split_of(tile):
        s, b = 1, blocks(tile)
        while s < MAX_SPLIT and slices >= 2 * s * MIN_SPLIT_SLICES and (
                b * s < MIN_BLOCKS or (b * s < FULL_BLOCKS and slices
                                       >= 2 * s * LONG_SPLIT_SLICES)):
            s *= 2
        return s

    tiles = TILES if variant == "ring" else TILES[-1:]
    tile = next((t for t in tiles if blocks(t) * split_of(t) >= MIN_BLOCKS),
                tiles[-1])
    return Plan(variant, tile, split_of(tile))


_launches = 0
#: launches of each variant (a key of :data:`VARIANTS`) since process
#: start or :func:`reset_launches`
variant_counts = dict.fromkeys(VARIANTS, 0)


def launch_count() -> int:
    """Kernel launches since process start or :func:`reset_launches`."""
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0
    for name in variant_counts:
        variant_counts[name] = 0


def normalize_stride(stride) -> tuple[int, int]:
    """Accept ``int | tuple[int, int]``; an int applies to both axes."""
    if isinstance(stride, int):
        stride = (stride, stride)
    sh, sw = (int(s) for s in stride)
    if sh < 1 or sw < 1:
        raise ValueError(f"conv2d: stride must be >= 1, got {stride!r}")
    return (sh, sw)


@functools.cache
def _kernel():
    fn = library(SOURCE).conv2d_fused_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(x, w, b, pool):
    for name, t in (("w", w), ("b", b)):
        if t is not None and t.device != x.device:
            raise ValueError(f"conv2d: {name} on {t.device}, x on {x.device}")
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"conv2d: {name} is {t.dtype}, x is {x.dtype}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"conv2d: dtype {x.dtype} not supported "
                         f"(kernel takes {sorted(map(str, _DTYPES))})")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"conv2d: {name} must be contiguous")
    if pool is not None and pool[0] * pool[1] > MAX_POOL_WINDOW:
        raise ValueError(f"conv2d: pool window {pool} larger than "
                         f"{MAX_POOL_WINDOW} elements")


def conv2d_fused(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor | None = None, *, stride=(1, 1),
                 relu: bool = False, pool: tuple[int, int] | None = None
                 ) -> torch.Tensor:
    """VALID NHWC x HWIO conv with the fused epilogue: + bias, ReLU, then
    an optional non-overlapping max-pool (window == stride ``pool``).

    x: (N, H, W, CI); w: (KH, KW, CI, CO); b: (CO,) or None.  Returns
    (N, HO // ph, WO // pw, CO) in x's dtype (fp32 or bf16 on the GPU;
    fp32 accumulation either way).
    """
    stride = normalize_stride(stride)
    if pool is not None:
        pool = (int(pool[0]), int(pool[1]))
        if pool[0] < 1 or pool[1] < 1:
            raise ValueError(f"conv2d: pool must be >= 1, got {pool}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d: want x (N,H,W,CI), w (KH,KW,CI,CO); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    n, h, wd, ci = x.shape
    kh, kw, ci2, co = w.shape
    if ci != ci2:
        raise ValueError(f"conv2d: channels differ: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if b is not None and tuple(b.shape) != (co,):
        raise ValueError(f"conv2d: bias {tuple(b.shape)}, want ({co},)")
    if x.device.type == "cpu":
        return conv2d_fused_ref(x, w, b, stride=stride, relu=relu, pool=pool)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d: no kernel for device {x.device}")
    _check_cuda(x, w, b, pool)
    hp, wp = out_size(h, wd, kh, kw, stride, pool)
    y = torch.empty((n, hp, wp, co), device=x.device, dtype=x.dtype)
    if y.numel() == 0:
        return y
    ph, pw = pool or (1, 1)
    p = plan(n, h, wd, ci, kh, kw, co, stride, pool,
             x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    err = _kernel()(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
        None if b is None else b.data_ptr(), y.data_ptr(),
        n, h, wd, ci, kh, kw, co, stride[0], stride[1], ph, pw, int(relu),
        VARIANTS.index(p.variant), *p.tile, p.split,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv2d_fused launch failed with CUDA error "
                           f"{err} for x {tuple(x.shape)} w {tuple(w.shape)} "
                           f"stride {stride} pool {pool} plan {p}")
    global _launches
    _launches += 1
    variant_counts[p.variant] += 1
    return y


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride=(1, 1)
           ) -> torch.Tensor:
    """VALID NHWC conv, no epilogue: :func:`conv2d_fused` without the
    fused tail."""
    return conv2d_fused(x, w, None, stride=stride)
