"""Plain PyTorch version of the conv kernel: the shifted-GEMM sum plus the
fused epilogue.

It is the kernel's oracle (CPU tests, and ``chip_smoke.py`` on the
card) and what the wrapper runs for tensors on the CPU.  It follows the
TPU kernel's arithmetic (``src/repro/kernels/conv2d/conv2d.py``): KH*KW
shifted matmuls into an fp32 accumulator, then bias, ReLU and a VALID
non-overlapping max-pool, cast to the input dtype at the end.
"""

from __future__ import annotations

import torch


def out_size(h: int, w: int, kh: int, kw: int, stride: tuple[int, int],
             pool: tuple[int, int] | None) -> tuple[int, int]:
    """(HP, WP): the VALID conv output, floored by the pool window.  An
    input smaller than the kernel gives an empty extent."""
    sh, sw = stride
    ho = (h - kh) // sh + 1 if h >= kh else 0
    wo = (w - kw) // sw + 1 if w >= kw else 0
    ph, pw = pool or (1, 1)
    return ho // ph, wo // pw


def conv2d_fused_ref(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, *,
                     stride: tuple[int, int] = (1, 1), relu: bool = False,
                     pool: tuple[int, int] | None = None) -> torch.Tensor:
    """x: (N, H, W, CI); w: (KH, KW, CI, CO); b: (CO,) or None.
    Returns (N, HP, WP, CO) in x's dtype."""
    n, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    sh, sw = stride
    ph, pw = pool or (1, 1)
    hp, wp = out_size(h, wd, kh, kw, stride, pool)
    if n * hp * wp == 0:
        return x.new_zeros((n, hp, wp, co))
    # only the rows the pool keeps are computed (ragged tail dropped)
    ho, wo = hp * ph, wp * pw
    xf, wf = x.float(), w.float()
    acc = xf.new_zeros((n * ho * wo, co))
    for dh in range(kh):
        for dw in range(kw):
            patch = xf[:, dh:dh + (ho - 1) * sh + 1:sh,
                       dw:dw + (wo - 1) * sw + 1:sw, :]
            acc.addmm_(patch.reshape(-1, ci), wf[dh, dw])
    y = acc.reshape(n, ho, wo, co)
    if b is not None:
        y = y + b.float()
    if relu:
        y = torch.relu(y)
    if pool is not None:
        y = y.reshape(n, hp, ph, wp, pw, co).amax(dim=(2, 4))
    return y.to(x.dtype)
