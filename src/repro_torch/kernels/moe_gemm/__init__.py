"""The grouped (expert-batched) GEMM of the capacity-dispatch MoE: the
Hopper counterpart of ``src/repro/kernels/moe_gemm/``.

* ``csrc/moe_gemm.cu`` — the CUDA kernel (``sm_90a``);
* ``csrc/moe_gemm_bwd.cu`` — its backward's two products, dy wᵀ and
  xᵀ dy, read in place;
* :mod:`.ops` — the wrappers (checks, plans, launch, launch counters) and
  ``MoeGemm``, the product under autograd (its backward one
  ``moe_gemm_bwd`` launch for each input that needs a gradient);
* :mod:`.ref` — the plain PyTorch versions (oracles, CPU path).
"""

from .ops import (MoeGemm, launch_count, moe_gemm, moe_gemm_nt, moe_gemm_tn,
                  reset_launches, variant_counts)
from .ref import moe_gemm_nt_ref, moe_gemm_ref, moe_gemm_tn_ref

__all__ = ["MoeGemm", "launch_count", "moe_gemm", "moe_gemm_nt",
           "moe_gemm_nt_ref", "moe_gemm_ref", "moe_gemm_tn",
           "moe_gemm_tn_ref", "reset_launches", "variant_counts"]
