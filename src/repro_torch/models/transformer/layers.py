"""Transformer / SSM layer primitives over torch tensors: the port of the
JAX package's ``models/transformer/layers.py``.

* ``attention_prefill`` — causal attention over a whole sequence; its
  core, :func:`blockwise_causal_attention`, is the Hopper
  ``flash_prefill`` kernel, differentiated by ``flash_prefill_bwd``;
* ``attention_decode`` — one token against a KV cache, through the
  Hopper ``decode_attention`` kernel;
* ``mlp`` — SwiGLU;
* ``moe`` — top-k routed experts with per-sample capacity dispatch; the
  three expert products are the Hopper ``moe_gemm`` kernel, differentiated
  by two more launches of it (``MoeGemm``);
* ``mamba2_prefill`` / ``mamba2_decode`` — Mamba2 (SSD): chunked
  prefill, whose intra-chunk step (:func:`ssd_chunked`) is the Hopper
  ``ssd_chunk`` kernel, and the O(1) recurrent decode (plain torch, as
  in the reference).

Layouts and names are the reference's: activations (B, S, d), q
(B, S, K, G, D), k/v (B, S, K, D), weights ``(in, out)``.  Every layer
with a kernel takes ``backend``: ``"cuda"`` (the default) calls the
kernel wrappers, which run the kernels on GPU tensors and their plain
versions on CPU tensors; ``"torch"`` calls the plain versions on any
device (the reference's ``use_pallas=False``).  The other products
(``x @ W``, the inter-chunk scan) are plain torch, as the reference
leaves them to XLA.

Ring attention is not ported yet (ROADMAP Queue 1, item 12).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...kernels.attention import ops as attn_ops
from ...kernels.attention import ref as attn_ref
from ...kernels.moe_gemm import ops as moe_ops
from ...kernels.moe_gemm import ref as moe_ref
from ...kernels.ssd import ops as ssd_ops
from ...kernels.ssd import ref as ssd_ref

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


def _pick_block(s: int, pref: int = 512) -> int:
    if s % pref == 0:
        return pref
    b = math.gcd(s, pref)
    return b if b >= 64 else s


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
    k/v (B, S, K, D).  Returns (B, S, K, G, D).  ``backend="cuda"`` goes
    through ``FlashPrefill``, so a backward runs the ``flash_prefill_bwd``
    kernel; ``"torch"`` is the plain version, differentiated by
    autograd."""
    if check_backend(backend) == "torch":
        return attn_ref.flash_prefill_ref(q, k, v, sliding_window)
    return attn_ops.FlashPrefill.apply(q.contiguous(), k.contiguous(),
                                       v.contiguous(), sliding_window)


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


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

class MoeParams(NamedTuple):
    router: torch.Tensor   # (d, E)
    w1: torch.Tensor       # (E, d, ff)
    w3: torch.Tensor       # (E, d, ff)
    w2: torch.Tensor       # (E, ff, d)


def moe(p: MoeParams, x: torch.Tensor, top_k: int,
        capacity_factor: float = 1.25, backend: str = "cuda"
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed MoE with *per-sample* capacity-based dispatch.

    x: (B, S, d).  Returns (out, aux_loss).  Each sample gives every
    expert ``cap = max(1, int(cf * k * S / E))`` slots, taken in
    token-major, k-minor order; assignments past ``cap`` are dropped (the
    residual covers them).  The expert buffers are laid out (E, B·cap, d),
    the reference's (B, E, cap, d) with the batch folded into the rows
    (exact: every row meets the same ``w[e]``), so each expert product
    is one ``moe_gemm`` launch (``MoeGemm``: under autograd, two more in
    the backward).

    Dispatch and combine use no atomic adds, so a run repeats bit for
    bit: the kept assignments, whose (expert, slot) pairs are unique,
    are written with a plain index write (the dropped ones go to one
    spare row that is never read); the combine gathers each token's k
    expert rows and sums them.  In bf16 that sum rounds once where the
    reference's scatter-add rounds k times.
    """
    check_backend(backend)
    B, S, d = x.shape
    E = p.router.shape[-1]
    logits = (x @ p.router).float()                       # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)         # sorted, as lax
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = idx.reshape(B, S * top_k)                    # (B, S*k)
    onehot = F.one_hot(flat_e, E)                         # (B, S*k, E)

    # load-balancing aux loss (Switch/Mixtral style)
    me = probs.mean(dim=(0, 1))
    ce = onehot.sum(dim=(0, 1)).float() / (B * S * top_k)
    aux = E * torch.sum(me * ce)

    cap = max(1, int(capacity_factor * top_k * S / E))
    pos_all = onehot.cumsum(dim=1) - 1
    pos = pos_all.gather(2, flat_e[..., None])[..., 0]    # (B, S*k)
    keep = pos < cap
    # the row of each assignment in the (E, B, cap) buffers; dropped ones
    # go to the spare row E*B*cap
    b_idx = torch.arange(B, device=x.device)[:, None]
    rows = torch.where(keep, (flat_e * B + b_idx) * cap + pos, E * B * cap)
    tok = torch.arange(S, device=x.device).repeat_interleave(top_k)

    buf = x.new_zeros((E * B * cap + 1, d))
    buf[rows.reshape(-1)] = x[:, tok].reshape(-1, d)
    xe = buf[:-1].view(E, B * cap, d)
    if backend == "torch":
        gemm = moe_ref.moe_gemm_ref
    else:
        gemm = moe_ops.MoeGemm.apply
    h = gemm(xe, p.w1)
    u = gemm(xe, p.w3)
    y = gemm(F.silu(h) * u, p.w2).reshape(E * B * cap, d)

    ye = y[rows.clamp(max=E * B * cap - 1)] * keep[..., None].to(x.dtype)
    out = (ye * gates.reshape(B, S * top_k, 1).to(x.dtype)) \
        .reshape(B, S, top_k, d).sum(dim=2)
    return out, aux


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------

class MambaParams(NamedTuple):
    w_in: torch.Tensor       # (d, 2*di + 2*N)  -> [z, xbc packed]
    w_dt: torch.Tensor       # (d, H)
    dt_bias: torch.Tensor    # (H,)
    conv_w: torch.Tensor     # (CK, di + 2*N) depthwise causal conv
    conv_b: torch.Tensor     # (di + 2*N,)
    A_log: torch.Tensor      # (H,)
    Dskip: torch.Tensor      # (H,)
    norm_w: torch.Tensor     # (di,)
    w_out: torch.Tensor      # (di, d)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv along S.  x: (B, S, C); w: (CK, C).

    Returns (y, new_state) where state holds the last CK-1 inputs.
    """
    CK, S = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], CK - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(CK)) + b
    new_state = xp[:, -(CK - 1):] if CK > 1 else state
    return y, new_state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, Dskip: torch.Tensor,
                chunk: int = 256, h0: torch.Tensor | None = None,
                backend: str = "cuda"):
    """SSD chunked scan (arXiv:2405.21060 Alg. 1; ngroups=1).

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) < 0;
    Bm/Cm: (B, S, N).  Returns (y, h_final) with h: (B, H, P, N).

    The chunk length is the reference's (``chunk`` when it divides S,
    else the largest common divisor of S and ``chunk`` if at least 64,
    else S itself), so both packages sum the same terms.  The
    intra-chunk output and each chunk's state come from ``ssd_chunk`` on
    the (B·nc, Q, ...) fold, under autograd through ``SsdChunk`` (its
    backward the ``ssd_chunk_bwd`` kernel) with ``backend="cuda"`` and
    through autograd of the plain version with ``backend="torch"``; the
    decays between chunks, the scan over chunks (a loop, the reference's
    ``lax.scan``) and the inter-chunk output stay in torch, in x's dtype
    as in the reference, and autograd differentiates them.
    """
    check_backend(backend)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk if S % chunk == 0 else _pick_block(S, chunk)
    nc = S // Q

    def fold(t):   # (B, S, ...) -> (B*nc, Q, ...), contiguous
        return t.reshape(Bsz * nc, Q, *t.shape[2:]).contiguous()

    ssd = ssd_ref.ssd_chunk_ref if backend == "torch" \
        else ssd_ops.SsdChunk.apply
    y_intra, chunk_state = ssd(fold(x), fold(dt), A.contiguous(), fold(Bm),
                               fold(Cm))
    y_intra = y_intra.reshape(Bsz, nc, Q, H, P)
    chunk_state = chunk_state.reshape(Bsz, nc, H, P, N)

    cum = torch.cumsum(dt.reshape(Bsz, nc, Q, H) * A, dim=2)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B, nc, H)
    h = h0 if h0 is not None else x.new_zeros((Bsz, H, P, N))
    h_prev = []                                           # state entering
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cm.reshape(Bsz, nc, Q, N),
                           torch.stack(h_prev, dim=1)) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    y = y + x * Dskip[None, None, :, None]
    return y, h


def mamba2_prefill(p: MambaParams, x: torch.Tensor, *, d_inner: int,
                   ssm_state: int, n_heads: int, head_dim: int,
                   norm_eps: float = 1e-5, backend: str = "cuda"):
    """Full-sequence Mamba2 block.  Returns (out, cache) where cache =
    {'conv': (B, CK-1, di+2N), 'ssm': (B, H, P, N)}."""
    B, S, _ = x.shape
    N = ssm_state
    zxbc = x @ p.w_in
    z, xbc = zxbc[..., :d_inner], zxbc[..., d_inner:]
    dt = F.softplus((x @ p.w_dt) + p.dt_bias)             # (B, S, H)
    xbc, conv_state = _causal_conv(xbc, p.conv_w, p.conv_b)
    xbc = F.silu(xbc)
    xs = xbc[..., :d_inner].reshape(B, S, n_heads, head_dim)
    Bm = xbc[..., d_inner:d_inner + N]
    Cm = xbc[..., d_inner + N:]
    A = -torch.exp(p.A_log)
    y, h = ssd_chunked(xs, dt, A, Bm, Cm, p.Dskip, backend=backend)
    y = y.reshape(B, S, d_inner) * F.silu(z)
    y = rms_norm(y, p.norm_w, norm_eps)
    return y @ p.w_out, {"conv": conv_state, "ssm": h}


def mamba2_decode(p: MambaParams, x: torch.Tensor, cache: dict, *,
                  d_inner: int, ssm_state: int, n_heads: int,
                  head_dim: int, norm_eps: float = 1e-5):
    """One-token recurrent update.  x: (B, 1, d); cache {'conv', 'ssm'}.
    Returns (out, new cache); the inputs are not modified."""
    B = x.shape[0]
    N = ssm_state
    zxbc = x @ p.w_in
    z, xbc = zxbc[..., :d_inner], zxbc[..., d_inner:]
    dt = F.softplus((x @ p.w_dt) + p.dt_bias)[:, 0]       # (B, H)
    xbc, conv_state = _causal_conv(xbc, p.conv_w, p.conv_b,
                                   state=cache["conv"])
    xbc = F.silu(xbc)[:, 0]                               # (B, di+2N)
    xs = xbc[:, :d_inner].reshape(B, n_heads, head_dim)
    Bm = xbc[:, d_inner:d_inner + N]
    Cm = xbc[:, d_inner + N:]
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)                             # (B, H)
    h = cache["ssm"] * decay[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, Bm, xs)
    y = torch.einsum("bn,bhpn->bhp", Cm, h) + xs * p.Dskip[None, :, None]
    y = y.reshape(B, 1, d_inner) * F.silu(z)
    y = rms_norm(y, p.norm_w, norm_eps)
    return y @ p.w_out, {"conv": conv_state, "ssm": h}
