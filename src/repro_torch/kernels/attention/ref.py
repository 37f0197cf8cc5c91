"""Plain PyTorch versions of the two attention kernels.

They are the oracles the kernels are held to on the card, the CPU path
of the wrappers, and the ``backend="torch"`` path of the LM.  Scores
and softmax are fp32 whatever the input dtype; the probabilities are
rounded to v's dtype before the weighted sum (as the JAX package's
kernels do), which sums in fp32; the output is in q's dtype.
"""

from __future__ import annotations

import math

import torch

NEG = -1e30   # the mask value of the JAX package (not -inf)


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sliding_window: int = 0) -> torch.Tensor:
    """Causal GQA attention.  q: (B, S, K, G, D); k/v: (B, S, K, D).

    Query ``i`` sees keys ``j <= i`` (and ``i - j < sliding_window``
    when the window is set).  Returns (B, S, K, G, D).
    """
    S, D = q.shape[1], q.shape[-1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if sliding_window:
        mask &= (pos[:, None] - pos[None, :]) < sliding_window
    s = s.masked_fill(~mask, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    return (o / l).permute(0, 3, 1, 2, 4).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len) -> torch.Tensor:
    """One query token per (batch, kv-head) against a cache.

    q: (B, K, G, D); k/v: (B, W, K, D); ``valid_len``: int or 0-d
    tensor.  Entries at or past ``valid_len`` are masked.  Returns
    (B, K, G, D).
    """
    W, D = k.shape[1], q.shape[-1]
    s = torch.einsum("bkgd,bwkd->bkgw", q.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    mask = torch.arange(W, device=q.device) < valid_len
    w = torch.softmax(s.masked_fill(~mask, NEG), dim=-1)
    o = torch.einsum("bkgw,bwkd->bkgd", w.to(v.dtype).float(), v.float())
    return o.to(q.dtype)
