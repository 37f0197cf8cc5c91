"""Plain PyTorch version of the grouped expert GEMM.

The oracle the kernel is held to on the card, the CPU path of the
wrapper, and the ``backend="torch"`` path of ``moe``: the product in
fp32, returned in x's dtype, as the Pallas kernel accumulates
(``moe_gemm.py:23-35``).
"""

from __future__ import annotations

import torch


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F): y[e] = x[e] @ w[e]."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)
