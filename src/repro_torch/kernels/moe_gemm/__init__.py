"""The grouped (expert-batched) GEMM of the capacity-dispatch MoE: the
Hopper counterpart of ``src/repro/kernels/moe_gemm/``.

* ``csrc/moe_gemm.cu`` — the CUDA kernel (``sm_90a``);
* :mod:`.ops` — the wrapper (checks, launch, launch counter);
* :mod:`.ref` — the plain PyTorch version (oracle, CPU path).
"""

from .ops import (launch_count, moe_gemm, reset_launches,
                  variant_counts)
from .ref import moe_gemm_ref

__all__ = ["launch_count", "moe_gemm", "moe_gemm_ref", "reset_launches",
           "variant_counts"]
