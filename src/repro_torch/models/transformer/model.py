"""Decoder LM assembly over torch tensors: init, prefill, one-token decode.

The port of the JAX package's ``models/transformer/model.py`` for the
dense attention family (``layer_pattern == "attn"`` without experts,
with or without QKV bias and sliding window).  Parameters keep the
reference's tree: ``{"embed", "head", "final_norm", "layers": {"ln1",
"attn": AttnParams, "ln2", "mlp": MlpParams}}`` with every layer leaf
stacked on a leading L axis and weights stored ``(in, out)``, so
:func:`params_from_numpy` moves the reference's parameters over with no
transposes.  Layers run in a Python loop (the reference's ``lax.scan``).

``prefill`` and ``decode_step`` take ``backend="cuda"`` (the default:
the Hopper attention kernels, or their plain versions on CPU tensors)
or ``backend="torch"`` (the plain versions on any device).

Not ported yet, and refused with ``NotImplementedError``: MoE layers
(ROADMAP Queue 1, item 10c), Mamba2 layers (10b), the shared attention
block of zamba2 and the ``embeds`` input mode (10d); ``forward`` and
``loss_fn`` come with training (item 11).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import ArchConfig
from .layers import (AttnParams, MlpParams, attention_decode,
                     attention_prefill, check_backend, mlp, rms_norm)

Params = dict
Cache = dict


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port lacks yet."""
    if cfg.layer_pattern != "attn":
        raise NotImplementedError(
            f"{cfg.name}: Mamba2 layers are not ported yet (ROADMAP "
            f"Queue 1, item 10b)")
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP Queue 1, "
            f"item 10c)")
    if cfg.shared_attn_every or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: the shared attention block and the 'embeds' "
            f"input mode are not ported yet (ROADMAP Queue 1, item 10d)")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """Seeded random parameters with the reference's shapes and scales
    (normal, std 0.02 for the embedding and 1/sqrt(fan_in) for every
    matrix; ones for the norms; zeros for the QKV biases).  Values are
    drawn in fp32 on ``generator``'s device, then moved to ``device``
    and cast to ``dtype``."""
    check_supported(cfg)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_padded
    nq, nkv, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return t.mul_(scale).to(device=device, dtype=dtype)

    def const(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    def bias(n):
        return const((L, n), 0.0) if cfg.qkv_bias else None

    p: Params = {
        "embed": normal((V, d), 0.02),
        "head": normal((d, V), 1 / math.sqrt(d)),
        "final_norm": const((d,), 1.0),
    }
    p["layers"] = {
        "ln1": const((L, d), 1.0),
        "attn": AttnParams(
            wq=normal((L, d, nq * hd), 1 / math.sqrt(d)),
            wk=normal((L, d, nkv * hd), 1 / math.sqrt(d)),
            wv=normal((L, d, nkv * hd), 1 / math.sqrt(d)),
            wo=normal((L, nq * hd, d), 1 / math.sqrt(nq * hd)),
            bq=bias(nq * hd), bk=bias(nkv * hd), bv=bias(nkv * hd)),
        "ln2": const((L, d), 1.0),
        "mlp": MlpParams(
            w1=normal((L, d, ff), 1 / math.sqrt(d)),
            w3=normal((L, d, ff), 1 / math.sqrt(d)),
            w2=normal((L, ff, d), 1 / math.sqrt(ff))),
    }
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
    port's: same keys, ``attn``/``mlp`` as :class:`AttnParams` /
    :class:`MlpParams` (from the reference's NamedTuples of the same
    fields), leaves copied to ``device`` in their own dtype."""
    check_supported(cfg)

    def fields(obj, cls):
        return cls(**{f: _tensor(getattr(obj, f), device)
                      for f in cls._fields})

    lp = tree["layers"]
    return {
        "embed": _tensor(tree["embed"], device),
        "head": _tensor(tree["head"], device),
        "final_norm": _tensor(tree["final_norm"], device),
        "layers": {
            "ln1": _tensor(lp["ln1"], device),
            "attn": fields(lp["attn"], AttnParams),
            "ln2": _tensor(lp["ln2"], device),
            "mlp": fields(lp["mlp"], MlpParams),
        },
    }


def _layer(params: Params, i: int):
    lp = params["layers"]
    attn = AttnParams(*(None if t is None else t[i] for t in lp["attn"]))
    return lp["ln1"][i], attn, lp["ln2"][i], MlpParams(*(t[i]
                                                        for t in lp["mlp"]))


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
    """An empty cache: ``len`` (0-d int32) and k/v (L, B, W, K, D), W
    the window for sliding-window configs, else ``seq_len``."""
    check_supported(cfg)
    W = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (cfg.n_layers, batch, W, cfg.n_kv_heads, cfg.hd)
    return {"len": torch.zeros((), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

def prefill(cfg: ArchConfig, params: Params, batch: dict,
            backend: str = "cuda") -> tuple[torch.Tensor, Cache]:
    """batch: {'tokens': (B, S)}.  Returns (logits of the last position
    (B, vocab_padded), a cache holding the prompt's k/v)."""
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

    ks, vs = [], []
    for i in range(cfg.n_layers):
        ln1, attn, ln2, mp = _layer(params, i)
        h, kv = attention_prefill(
            attn, rms_norm(x, ln1, cfg.norm_eps), n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, hd=cfg.hd, rope_theta=cfg.rope_theta,
            sliding_window=cfg.sliding_window, backend=backend)
        x = x + h
        x = x + mlp(mp, rms_norm(x, ln2, cfg.norm_eps))
        ks.append(keep_window(kv["k"]))
        vs.append(keep_window(kv["v"]))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _mask_padded_vocab(cfg, x[:, -1] @ params["head"])
    cache = {"len": torch.full((), S, dtype=torch.int32, device=x.device),
             "k": torch.stack(ks), "v": torch.stack(vs)}
    return logits, cache


def decode_step(cfg: ArchConfig, params: Params, cache: Cache, inputs: dict,
                backend: str = "cuda") -> tuple[torch.Tensor, Cache]:
    """inputs: {'token': (B,) int}.  Returns (logits (B, vocab_padded),
    the cache one token longer).

    The new token's k/v are written into ``cache["k"]``/``cache["v"]``
    in place (the reference returns new arrays); the returned cache
    holds those same tensors and a new ``len``.  The host never reads
    ``len``: one step queues its work on the card without waiting.
    """
    check_backend(backend)
    x = params["embed"][inputs["token"].long()][:, None, :]   # (B, 1, d)
    cache_len = cache["len"]
    for i in range(cfg.n_layers):
        ln1, attn, ln2, mp = _layer(params, i)
        h, _, _ = attention_decode(
            attn, rms_norm(x, ln1, cfg.norm_eps), cache["k"][i],
            cache["v"][i], cache_len, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, hd=cfg.hd, rope_theta=cfg.rope_theta,
            sliding_window=cfg.sliding_window, backend=backend)
        x = x + h
        x = x + mlp(mp, rms_norm(x, ln2, cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _mask_padded_vocab(cfg, (x @ params["head"])[:, 0])
    return logits, {"len": cache_len + 1, "k": cache["k"], "v": cache["v"]}
