"""Implicit-GEMM NHWC conv with a fused bias/ReLU/max-pool epilogue:
the Hopper counterpart of ``src/repro/kernels/conv2d/``.

* ``csrc/conv2d_fused.cu`` — the CUDA kernel (``sm_90a``);
* :mod:`.ops` — the wrapper (checks, launch, launch counter);
* :mod:`.ref` — the plain PyTorch version (oracle, CPU path).
"""

from .ops import conv2d, conv2d_fused, launch_count, reset_launches
from .ref import conv2d_fused_ref

__all__ = ["conv2d", "conv2d_fused", "conv2d_fused_ref", "launch_count",
           "reset_launches"]
