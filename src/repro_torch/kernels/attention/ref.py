"""Plain PyTorch versions of the attention kernels.

They are the oracles the kernels are held to on the card, the CPU path
of the wrappers, and the ``backend="torch"`` path of the LM.  Scores
and softmax are fp32 whatever the input dtype; the probabilities are
rounded to v's dtype before the weighted sum (as the JAX package's
kernels do), which sums in fp32; the output is in q's dtype.
:func:`flash_prefill_bwd_ref` is the backward of
:func:`flash_prefill_ref`, written out as formulas (not autograd), in
fp32.
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
    s = s.masked_fill(~_prefill_mask(S, sliding_window, q.device), NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    return (o / l).permute(0, 3, 1, 2, 4).to(q.dtype)


def _prefill_mask(s: int, sliding_window: int, device) -> torch.Tensor:
    """(S, S) bool: query i sees key j."""
    pos = torch.arange(s, device=device)
    mask = pos[:, None] >= pos[None, :]
    if sliding_window:
        mask &= (pos[:, None] - pos[None, :]) < sliding_window
    return mask


def flash_prefill_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, do: torch.Tensor,
                          sliding_window: int = 0
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Gradients (dq, dk, dv) of :func:`flash_prefill_ref` at (q, k, v)
    for the output gradient ``do``; ``o`` is the forward's output.

    P is recomputed with the forward's mask (-1e30) and scale; with
    Delta = rowsum(do o o), dP = do V^T and dS = P o (dP - Delta):
    dq = dS K / sqrt(D), dk = dS^T Q / sqrt(D) and dv = P^T do, each of
    dk and dv summed over the G query heads of its kv head.  Computed in
    fp32; returned in q's and k's dtypes.
    """
    S, D = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    s = s.masked_fill(~_prefill_mask(S, sliding_window, q.device), NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    delta = (dof * of).sum(dim=-1).permute(0, 2, 3, 1)   # (B, K, G, S)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len, with_lse: bool = False):
    """One query token per (batch, kv-head) against a cache.

    q: (B, K, G, D); k/v: (B, W, K, D); ``valid_len``: int or 0-d
    tensor.  Entries at or past ``valid_len`` are masked.  Returns
    (B, K, G, D); with ``with_lse``, (that, lse): each row's log-sum-exp
    of its scaled, masked scores, (B, K, G) fp32 (-1e30 where every entry
    is masked).
    """
    W, D = k.shape[1], q.shape[-1]
    s = torch.einsum("bkgd,bwkd->bkgw", q.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    mask = torch.arange(W, device=q.device) < valid_len
    s = s.masked_fill(~mask, NEG)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkd->bkgd", w.to(v.dtype).float(), v.float())
    if with_lse:
        return o.to(q.dtype), torch.logsumexp(s, dim=-1)
    return o.to(q.dtype)
