"""Plain PyTorch versions of the grouped expert GEMM and of its
backward's two products.

The oracles the kernels are held to on the card, the CPU path of the
wrappers, and the ``backend="torch"`` path of ``moe``: the product in
fp32, returned in x's dtype, as the Pallas kernel accumulates
(``moe_gemm.py:23-35``).  The backward's products are einsums on the
tensors as given, transposes left to the einsum.
"""

from __future__ import annotations

import torch


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, F) -> (E, C, F): y[e] = x[e] @ w[e]."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def moe_gemm_nt_ref(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dy: (E, C, F); w: (E, D, F) -> (E, C, D): dx[e] = dy[e] @ w[e]ᵀ."""
    return torch.einsum("ecf,edf->ecd", dy.float(), w.float()).to(dy.dtype)


def moe_gemm_tn_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); dy: (E, C, F) -> (E, D, F): dw[e] = x[e]ᵀ @ dy[e]."""
    return torch.einsum("ecd,ecf->edf", x.float(), dy.float()).to(x.dtype)
