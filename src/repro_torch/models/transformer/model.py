"""Decoder LM assembly over torch tensors: init, prefill, one-token decode.

The port of the JAX package's ``models/transformer/model.py`` for three
families: dense attention (``layer_pattern == "attn"``, with or without
QKV bias and sliding window), MoE (the same with ``moe`` in place of
the MLP) and SSM (``layer_pattern == "mamba"``, Mamba2 blocks).
Parameters keep the reference's tree: ``{"embed", "head", "final_norm",
"layers": {...}}`` with ``layers`` holding ``ln1`` and ``attn``/``ln2``/
``mlp`` (dense), ``attn``/``ln2``/``moe`` (MoE) or ``mamba`` (SSM), every
leaf stacked on a leading L axis and weights stored ``(in, out)``, so
:func:`params_from_numpy` moves the reference's parameters over with no
transposes.  Layers run in a Python loop (the reference's ``lax.scan``).

``prefill`` and ``decode_step`` take ``backend="cuda"`` (the default:
the Hopper kernels, or their plain versions on CPU tensors) or
``backend="torch"`` (the plain versions on any device).

Not ported yet, and refused with ``NotImplementedError``: the shared
attention block of zamba2 and the ``embeds`` input mode (ROADMAP Queue
1, item 10d); ``forward`` and ``loss_fn`` come with training (item 11).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import ArchConfig
from .layers import (AttnParams, MambaParams, MlpParams, MoeParams,
                     attention_decode, attention_prefill, check_backend,
                     mamba2_decode, mamba2_prefill, mlp, moe, rms_norm)

Params = dict
Cache = dict


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port lacks yet."""
    if cfg.shared_attn_every or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: the shared attention block and the 'embeds' "
            f"input mode are not ported yet (ROADMAP Queue 1, item 10d)")
    if cfg.layer_pattern not in ("attn", "mamba"):
        raise ValueError(f"{cfg.name}: layer_pattern {cfg.layer_pattern!r}")


#: the per-layer parameter groups, by key of ``params["layers"]``
GROUPS = {"attn": AttnParams, "mlp": MlpParams, "moe": MoeParams,
          "mamba": MambaParams}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """Seeded random parameters with the reference's shapes and scales
    (normal, std 0.02 for the embedding and 1/sqrt(fan_in) for every
    matrix, 1/sqrt(CK) for the Mamba2 conv; ones for the norms and
    ``Dskip``; zeros for biases; the reference's fixed ``dt_bias`` and
    ``A_log``).  Values are drawn in fp32 on ``generator``'s device, then
    moved to ``device`` and cast to ``dtype``."""
    check_supported(cfg)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_padded

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return t.mul_(scale).to(device=device, dtype=dtype)

    def const(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    def per_layer(row):      # an (n,) fp32 row stacked on L
        return row.to(device=device, dtype=dtype).expand(L, -1).clone()

    p: Params = {
        "embed": normal((V, d), 0.02),
        "head": normal((d, V), 1 / math.sqrt(d)),
        "final_norm": const((d,), 1.0),
    }
    layers: dict = {"ln1": const((L, d), 1.0)}
    if cfg.layer_pattern == "attn":
        nq, nkv, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff

        def bias(n):
            return const((L, n), 0.0) if cfg.qkv_bias else None

        layers["attn"] = AttnParams(
            wq=normal((L, d, nq * hd), 1 / math.sqrt(d)),
            wk=normal((L, d, nkv * hd), 1 / math.sqrt(d)),
            wv=normal((L, d, nkv * hd), 1 / math.sqrt(d)),
            wo=normal((L, nq * hd, d), 1 / math.sqrt(nq * hd)),
            bq=bias(nq * hd), bk=bias(nkv * hd), bv=bias(nkv * hd))
        layers["ln2"] = const((L, d), 1.0)
        if cfg.is_moe:
            E = cfg.n_experts
            layers["moe"] = MoeParams(
                router=normal((L, d, E), 1 / math.sqrt(d)),
                w1=normal((L, E, d, ff), 1 / math.sqrt(d)),
                w3=normal((L, E, d, ff), 1 / math.sqrt(d)),
                w2=normal((L, E, ff, d), 1 / math.sqrt(ff)))
        else:
            layers["mlp"] = MlpParams(
                w1=normal((L, d, ff), 1 / math.sqrt(d)),
                w3=normal((L, d, ff), 1 / math.sqrt(d)),
                w2=normal((L, ff, d), 1 / math.sqrt(ff)))
    else:
        di, N, H, CK = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_conv
        conv_ch = di + 2 * N
        layers["mamba"] = MambaParams(
            w_in=normal((L, d, 2 * di + 2 * N), 1 / math.sqrt(d)),
            w_dt=normal((L, d, H), 1 / math.sqrt(d)),
            dt_bias=per_layer(torch.log(torch.expm1(
                torch.linspace(1e-3, 0.1, H)))),
            conv_w=normal((L, CK, conv_ch), 1 / math.sqrt(CK)),
            conv_b=const((L, conv_ch), 0.0),
            A_log=per_layer(torch.log(torch.linspace(1.0, 16.0, H))),
            Dskip=const((L, H), 1.0),
            norm_w=const((L, di), 1.0),
            w_out=normal((L, di, d), 1 / math.sqrt(di)))
    p["layers"] = layers
    return p


def _tensor(a, device):
    if a is None:
        return None
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":          # numpy has no bf16 of its own
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device=device)


def params_from_numpy(cfg: ArchConfig, tree: dict,
                      device: str | torch.device = "cuda") -> Params:
    """The reference's parameter tree (leaves convertible by
    ``np.asarray``, e.g. ``jax.tree.map(np.asarray, params)``) as the
    port's: same keys, each per-layer group as its NamedTuple of
    :data:`GROUPS` (from the reference's NamedTuple of the same fields),
    leaves copied to ``device`` in their own dtype."""
    check_supported(cfg)

    def fields(obj, cls):
        return cls(**{f: _tensor(getattr(obj, f), device)
                      for f in cls._fields})

    return {
        "embed": _tensor(tree["embed"], device),
        "head": _tensor(tree["head"], device),
        "final_norm": _tensor(tree["final_norm"], device),
        "layers": {k: fields(v, GROUPS[k]) if k in GROUPS
                   else _tensor(v, device)
                   for k, v in tree["layers"].items()},
    }


def _layer(params: Params, i: int) -> dict:
    """Layer ``i``'s slice of ``params["layers"]`` (same keys)."""
    return {k: type(v)(*(None if t is None else t[i] for t in v))
            if k in GROUPS else v[i]
            for k, v in params["layers"].items()}


def _mask_padded_vocab(cfg: ArchConfig, logits: torch.Tensor
                       ) -> torch.Tensor:
    if cfg.vocab_padded == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.vocab_padded, device=logits.device) \
        >= cfg.vocab_size
    return logits.masked_fill(pad, -1e30)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> Cache:
    """An empty cache: ``len`` (0-d int32) and, for attention, k/v
    (L, B, W, K, D), W the window for sliding-window configs, else
    ``seq_len``; for Mamba2, ``conv`` (L, B, CK-1, di+2N) and ``ssm``
    (L, B, H, P, N)."""
    check_supported(cfg)
    L = cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache: Cache = {"len": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.layer_pattern == "attn":
        W = min(seq_len, cfg.sliding_window) if cfg.sliding_window \
            else seq_len
        cache["k"] = zeros(L, batch, W, cfg.n_kv_heads, cfg.hd)
        cache["v"] = zeros(L, batch, W, cfg.n_kv_heads, cfg.hd)
    else:
        CK, di, N = cfg.ssm_conv, cfg.d_inner, cfg.ssm_state
        cache["conv"] = zeros(L, batch, CK - 1, di + 2 * N)
        cache["ssm"] = zeros(L, batch, cfg.ssm_heads, cfg.ssm_head_dim, N)
    return cache


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

def _ffn(cfg: ArchConfig, lp: dict, x: torch.Tensor, backend: str
         ) -> torch.Tensor:
    """The attention block's second half: MoE or SwiGLU MLP on the
    normed residual (the MoE aux loss is dropped, as in the reference's
    serving path)."""
    xn = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        return moe(lp["moe"], xn, cfg.moe_top_k, cfg.capacity_factor,
                   backend=backend)[0]
    return mlp(lp["mlp"], xn)


def _ssm_dims(cfg: ArchConfig) -> dict:
    return dict(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                n_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim,
                norm_eps=cfg.norm_eps)


def prefill(cfg: ArchConfig, params: Params, batch: dict,
            backend: str = "cuda") -> tuple[torch.Tensor, Cache]:
    """batch: {'tokens': (B, S)}.  Returns (logits of the last position
    (B, vocab_padded), a cache holding the prompt's k/v, or the Mamba2
    conv and ssm states)."""
    check_backend(backend)
    x = params["embed"][batch["tokens"].long()]
    B, S, _ = x.shape
    W = min(S, cfg.sliding_window) if cfg.sliding_window else S

    def keep_window(t):   # (B, S, K, D) -> last W entries, ring-aligned
        if W >= S:
            return t
        # decode writes token t at slot t % W: token S-W+i goes to slot
        # (S-W+i) % W == (i + S) % W, so roll by S % W
        return torch.roll(t[:, -W:], shifts=S % W, dims=1)

    per_layer: dict[str, list] = {}
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        xn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.layer_pattern == "attn":
            h, kv = attention_prefill(
                lp["attn"], xn, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                hd=cfg.hd, rope_theta=cfg.rope_theta,
                sliding_window=cfg.sliding_window, backend=backend)
            x = x + h
            x = x + _ffn(cfg, lp, x, backend)
            layer_cache = {k: keep_window(t) for k, t in kv.items()}
        else:
            h, layer_cache = mamba2_prefill(lp["mamba"], xn,
                                            **_ssm_dims(cfg),
                                            backend=backend)
            x = x + h
        for k, t in layer_cache.items():
            per_layer.setdefault(k, []).append(t)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _mask_padded_vocab(cfg, x[:, -1] @ params["head"])
    cache = {"len": torch.full((), S, dtype=torch.int32, device=x.device)}
    cache.update({k: torch.stack(ts) for k, ts in per_layer.items()})
    return logits, cache


def decode_step(cfg: ArchConfig, params: Params, cache: Cache, inputs: dict,
                backend: str = "cuda") -> tuple[torch.Tensor, Cache]:
    """inputs: {'token': (B,) int}.  Returns (logits (B, vocab_padded),
    the cache one token longer).

    The new token's k/v (attention) or the new conv and ssm states
    (Mamba2) are written into the cache's tensors in place (the
    reference returns new arrays); the returned cache holds those same
    tensors and a new ``len``.  The host never reads ``len``: one step
    queues its work on the card without waiting.
    """
    check_backend(backend)
    x = params["embed"][inputs["token"].long()][:, None, :]   # (B, 1, d)
    cache_len = cache["len"]
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        xn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.layer_pattern == "attn":
            h, _, _ = attention_decode(
                lp["attn"], xn, cache["k"][i], cache["v"][i], cache_len,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
                rope_theta=cfg.rope_theta,
                sliding_window=cfg.sliding_window, backend=backend)
            x = x + h
            x = x + _ffn(cfg, lp, x, backend)
        else:
            h, new = mamba2_decode(
                lp["mamba"], xn, {"conv": cache["conv"][i],
                                  "ssm": cache["ssm"][i]}, **_ssm_dims(cfg))
            x = x + h
            cache["conv"][i] = new["conv"]
            cache["ssm"][i] = new["ssm"]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _mask_padded_vocab(cfg, (x @ params["head"])[:, 0])
    return logits, {**cache, "len": cache_len + 1}
