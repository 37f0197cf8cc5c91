"""Transformer layer primitives over torch tensors: the dense-attention
half of the JAX package's ``models/transformer/layers.py``.

* ``attention_prefill`` — causal attention over a whole sequence; its
  core, :func:`blockwise_causal_attention`, is the Hopper
  ``flash_prefill`` kernel;
* ``attention_decode`` — one token against a KV cache, through the
  Hopper ``decode_attention`` kernel;
* ``mlp`` — SwiGLU.

Layouts and names are the reference's: activations (B, S, d), q
(B, S, K, G, D), k/v (B, S, K, D), weights ``(in, out)``.  Every
attention takes ``backend``: ``"cuda"`` (the default) calls the kernel
wrappers, which run the kernels on GPU tensors and their plain versions
on CPU tensors; ``"torch"`` calls the plain versions on any device (the
reference's ``use_pallas=False``).

MoE, the Mamba2/SSD layers and ring attention are not ported yet
(ROADMAP Queue 1, items 10b-10d and 12).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...kernels.attention import ops as attn_ops
from ...kernels.attention import ref as attn_ref

BACKENDS = ("cuda", "torch")


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; choose from {BACKENDS}")
    return backend


# ---------------------------------------------------------------------------
# basics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Rotary embedding.  x: (..., T, H, D); positions: (..., T)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs          # (..., T, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)      # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class AttnParams(NamedTuple):
    wq: torch.Tensor          # (d, Hq*D)
    wk: torch.Tensor          # (d, K*D)
    wv: torch.Tensor          # (d, K*D)
    wo: torch.Tensor          # (Hq*D, d)
    bq: torch.Tensor | None = None
    bk: torch.Tensor | None = None
    bv: torch.Tensor | None = None


def qkv_project(p: AttnParams, x: torch.Tensor, n_heads: int, n_kv: int,
                hd: int):
    B, S, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, n_kv, n_heads // n_kv, hd)   # (B,S,K,G,D)
    k = k.reshape(B, S, n_kv, hd)
    v = v.reshape(B, S, n_kv, hd)
    return q, k, v


def blockwise_causal_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, sliding_window: int = 0,
                               backend: str = "cuda") -> torch.Tensor:
    """Flash-style causal attention; q (B, S, K, G, D) with rope applied,
    k/v (B, S, K, D).  Returns (B, S, K, G, D)."""
    if check_backend(backend) == "torch":
        return attn_ref.flash_prefill_ref(q, k, v, sliding_window)
    return attn_ops.flash_prefill(q.contiguous(), k.contiguous(),
                                  v.contiguous(),
                                  sliding_window=sliding_window)


def attention_prefill(p: AttnParams, x: torch.Tensor, *, n_heads: int,
                      n_kv: int, hd: int, rope_theta: float,
                      sliding_window: int = 0, backend: str = "cuda"
                      ) -> tuple[torch.Tensor, dict]:
    """Full-sequence causal attention.  Returns (out, kv_for_cache)."""
    B, S, _ = x.shape
    q, k, v = qkv_project(p, x, n_heads, n_kv, hd)
    pos = torch.arange(S, device=x.device)[None, :]
    q = rope(q.reshape(B, S, n_heads, hd), pos, rope_theta) \
        .reshape(B, S, n_kv, n_heads // n_kv, hd)
    k = rope(k, pos, rope_theta)
    o = blockwise_causal_attention(q, k, v, sliding_window, backend)
    o = o.reshape(B, S, n_heads * hd) @ p.wo
    return o, {"k": k, "v": v}


def attention_decode(p: AttnParams, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_len: torch.Tensor, *,
                     n_heads: int, n_kv: int, hd: int, rope_theta: float,
                     sliding_window: int = 0, backend: str = "cuda"
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x: (B, 1, d); cache_[kv]: (B, W, K, D), W the
    cache capacity (seq_len, or the window for SWA: a ring buffer).
    ``cache_len`` (0-d int32 tensor on x's device) is the number of
    tokens already in the cache (== the current position).

    Unlike the reference, which returns new arrays, the new k/v are
    written into ``cache_k``/``cache_v`` in place (no copy of the
    cache per token); they are returned for the reference's signature.
    Nothing here reads ``cache_len`` on the host.
    """
    if cache_len.dim() != 0:
        raise ValueError("attention_decode: cache_len must be a 0-d tensor "
                         "(one length for the whole batch)")
    B = x.shape[0]
    W = cache_k.shape[1]
    q, k, v = qkv_project(p, x, n_heads, n_kv, hd)
    pos = cache_len.reshape(1, 1)
    q = rope(q.reshape(B, 1, n_heads, hd), pos, rope_theta) \
        .reshape(B, n_kv, n_heads // n_kv, hd)
    k = rope(k, pos, rope_theta)
    last = torch.clamp(cache_len, max=W - 1)
    slot = ((cache_len % W) if sliding_window else last).long().reshape(1)
    cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v.to(cache_v.dtype))
    valid_len = (last + 1).to(torch.int32)
    if check_backend(backend) == "torch":
        o = attn_ref.decode_attention_ref(q, cache_k, cache_v, valid_len)
    else:
        o = attn_ops.decode_attention(q.contiguous(), cache_k, cache_v,
                                      valid_len)
    o = o.reshape(B, 1, n_heads * hd) @ p.wo
    return o, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MlpParams(NamedTuple):
    w1: torch.Tensor   # (d, ff) gate
    w3: torch.Tensor   # (d, ff) up
    w2: torch.Tensor   # (ff, d) down


def mlp(p: MlpParams, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p.w1) * (x @ p.w3)) @ p.w2
