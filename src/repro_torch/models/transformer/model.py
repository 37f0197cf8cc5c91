"""Decoder LM assembly over torch tensors: init, forward, prefill and
one-token decode.

The port of the JAX package's ``models/transformer/model.py`` for every
family it has: dense attention (``layer_pattern == "attn"``, with or
without QKV bias and sliding window), MoE (the same with ``moe`` in
place of the MLP), SSM (``layer_pattern == "mamba"``, Mamba2 blocks),
hybrid (zamba2: Mamba2 layers and one *shared* attention+MLP block
applied after every ``shared_attn_every``-th layer, one weight set and
a k/v cache per application site), each fed token ids or, with
``input_mode == "embeds"`` (llava, musicgen), precomputed embeddings.
Parameters keep the reference's tree: ``{"embed", "head", "final_norm",
"layers": {...}, "shared": {...}}`` (``embed`` for token inputs only,
``shared`` for hybrids only).  ``layers`` holds ``ln1`` and
``attn``/``ln2``/``mlp`` (dense), ``attn``/``ln2``/``moe`` (MoE) or
``mamba`` (SSM), every leaf stacked on a leading L axis; ``shared``
holds ``ln1``, ``attn``, ``ln2`` and ``mlp`` with no L axis.  Weights
are stored ``(in, out)``, so :func:`params_from_numpy` moves the
reference's parameters over with no transposes.

Layers run in a Python loop (the reference's ``lax.scan``), so the
layers the shared block follows, and its site in the cache, are Python
ints: no step reads a device value on the host, and a decode step
captures into one CUDA graph.

``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` take
``backend="cuda"`` (the default: the Hopper kernels, or their plain
versions on CPU tensors) or ``backend="torch"`` (the plain versions on
any device).  ``loss_fn`` is differentiable on both: attention through
``FlashPrefill`` and its backward kernel on the card, the MoE expert
products through ``MoeGemm`` (its backward the ``moe_gemm_bwd``
kernel), the SSD intra-chunk step through ``SsdChunk`` (its backward
the ``ssd_chunk_bwd`` kernel), so every family trains on the card, and
on the CPU through the plain versions.  zamba2 at full depth needs
about 8 x 9.7 GB with the functional optimizer, so one 80 GB card
trains it at reduced depth.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import sharded
from .config import ArchConfig
from .layers import (AttnParams, MambaParams, MlpParams, MoeParams,
                     attention_decode, attention_prefill, check_backend,
                     mamba2_decode, mamba2_prefill, mlp, moe, rms_norm)

Params = dict
Cache = dict


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a layer pattern neither package has."""
    if cfg.layer_pattern not in ("attn", "mamba"):
        raise ValueError(f"{cfg.name}: layer_pattern {cfg.layer_pattern!r}")


#: the parameter groups, by key of ``params["layers"]`` and
#: ``params["shared"]``
GROUPS = {"attn": AttnParams, "mlp": MlpParams, "moe": MoeParams,
          "mamba": MambaParams}


# ---------------------------------------------------------------------------
# the shared (zamba2) block's sites
# ---------------------------------------------------------------------------

def shared_apply_flags(cfg: ArchConfig) -> tuple[list[bool], list[int]]:
    """Per layer: whether the shared block follows it, and the block's
    application index there (its site in ``shared_k``/``shared_v``),
    clamped to 0 before the first application as in the reference's
    ``_shared_apply_flags``.  Plain Python, from the config alone."""
    L, k = cfg.n_layers, cfg.shared_attn_every
    if not k:
        return [False] * L, [0] * L
    apply = [(i + 1) % k == 0 for i in range(L)]
    return apply, [max((i + 1) // k - 1, 0) for i in range(L)]


def n_shared_apps(cfg: ArchConfig) -> int:
    """Applications of the shared block over the layers (0 without it)."""
    return (cfg.n_layers // cfg.shared_attn_every
            if cfg.shared_attn_every else 0)


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

    def attn_params(*stack):     # stack: () or (L,)
        nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

        def bias(n):
            return const((*stack, n), 0.0) if cfg.qkv_bias else None

        return AttnParams(
            wq=normal((*stack, d, nq * hd), 1 / math.sqrt(d)),
            wk=normal((*stack, d, nkv * hd), 1 / math.sqrt(d)),
            wv=normal((*stack, d, nkv * hd), 1 / math.sqrt(d)),
            wo=normal((*stack, nq * hd, d), 1 / math.sqrt(nq * hd)),
            bq=bias(nq * hd), bk=bias(nkv * hd), bv=bias(nkv * hd))

    def mlp_params(*stack):
        ff = cfg.d_ff
        return MlpParams(w1=normal((*stack, d, ff), 1 / math.sqrt(d)),
                         w3=normal((*stack, d, ff), 1 / math.sqrt(d)),
                         w2=normal((*stack, ff, d), 1 / math.sqrt(ff)))

    p: Params = {}
    if cfg.input_mode == "tokens":
        p["embed"] = normal((V, d), 0.02)
    p["head"] = normal((d, V), 1 / math.sqrt(d))
    p["final_norm"] = const((d,), 1.0)
    layers: dict = {"ln1": const((L, d), 1.0)}
    if cfg.layer_pattern == "attn":
        layers["attn"] = attn_params(L)
        layers["ln2"] = const((L, d), 1.0)
        if cfg.is_moe:
            E, ff = cfg.n_experts, cfg.d_ff
            layers["moe"] = MoeParams(
                router=normal((L, d, E), 1 / math.sqrt(d)),
                w1=normal((L, E, d, ff), 1 / math.sqrt(d)),
                w3=normal((L, E, d, ff), 1 / math.sqrt(d)),
                w2=normal((L, E, ff, d), 1 / math.sqrt(ff)))
        else:
            layers["mlp"] = mlp_params(L)
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
    if cfg.shared_attn_every:
        p["shared"] = {"ln1": const((d,), 1.0), "attn": attn_params(),
                       "ln2": const((d,), 1.0), "mlp": mlp_params()}
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
    port's: same keys, each parameter group as its NamedTuple of
    :data:`GROUPS` (from the reference's NamedTuple of the same fields,
    or a plain tuple in the fields' order, which the reference's model
    also takes for ``shared["attn"]``), leaves copied to ``device`` in
    their own dtype.  A tree of the ``embeds`` input mode has no
    ``embed``, and only a hybrid's has ``shared``."""
    check_supported(cfg)

    def convert(group: dict) -> dict:
        out = {}
        for k, v in group.items():
            if k not in GROUPS:
                out[k] = _tensor(v, device)
            elif hasattr(v, "_fields"):
                out[k] = GROUPS[k](**{f: _tensor(getattr(v, f), device)
                                      for f in GROUPS[k]._fields})
            else:
                out[k] = GROUPS[k](*(_tensor(t, device) for t in v))
        return out

    p = convert({k: v for k, v in tree.items()
                 if k in ("embed", "head", "final_norm")})
    p["layers"] = convert(tree["layers"])
    if "shared" in tree:
        p["shared"] = convert(tree["shared"])
    return p


def _unbind_layers(params: Params) -> list[dict]:
    """Every layer's slice of ``params["layers"]`` (same keys), from one
    ``unbind`` of each stacked leaf.  Under autograd a stacked leaf's
    gradient is then one stack of its layers' gradients; indexing it
    layer by layer makes each layer's gradient a zero-padded tensor of
    the whole stack, and L of them are added."""
    out: list[dict] = [{} for _ in range(params["layers"]["ln1"].shape[0])]
    for k, v in params["layers"].items():
        if k in GROUPS:
            cols = [None if t is None else t.unbind(0) for t in v]
            for i, lp in enumerate(out):
                lp[k] = type(v)(*(None if c is None else c[i] for c in cols))
        else:
            for lp, t in zip(out, v.unbind(0)):
                lp[k] = t
    return out


def _mask_padded_vocab(cfg: ArchConfig, logits: torch.Tensor
                       ) -> torch.Tensor:
    if cfg.vocab_padded == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.vocab_padded, device=logits.device) \
        >= cfg.vocab_size
    return logits.masked_fill(sharded.like(pad, logits), -1e30)


def _embed(cfg: ArchConfig, params: Params, batch: dict, tokens: str,
           embeds: str) -> torch.Tensor:
    """The decoder's input: ``params["embed"]`` at ``batch[tokens]``, or
    ``batch[embeds]`` itself in the ``embeds`` input mode (the
    reference's keys: ``tokens``/``embeds`` for a sequence,
    ``token``/``embed`` for one decode step)."""
    if cfg.input_mode == "tokens":
        return sharded.embed(params["embed"], batch[tokens].long())
    return batch[embeds]


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _window(cfg: ArchConfig, seq_len: int) -> int:
    """Cache entries of an attention layer: the window for sliding-window
    configs, else ``seq_len``."""
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window \
        else seq_len


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> Cache:
    """An empty cache: ``len`` (0-d int32) and, for attention, k/v
    (L, B, W, K, D), W from :func:`_window`; for Mamba2, ``conv``
    (L, B, CK-1, di+2N) and ``ssm`` (L, B, H, P, N); for a hybrid also
    ``shared_k``/``shared_v`` (A, B, W, K, D), A = :func:`n_shared_apps`."""
    check_supported(cfg)
    L, W = cfg.n_layers, _window(cfg, seq_len)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache: Cache = {"len": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.layer_pattern == "attn":
        cache["k"] = zeros(L, batch, W, cfg.n_kv_heads, cfg.hd)
        cache["v"] = zeros(L, batch, W, cfg.n_kv_heads, cfg.hd)
    else:
        CK, di, N = cfg.ssm_conv, cfg.d_inner, cfg.ssm_state
        cache["conv"] = zeros(L, batch, CK - 1, di + 2 * N)
        cache["ssm"] = zeros(L, batch, cfg.ssm_heads, cfg.ssm_head_dim, N)
    if cfg.shared_attn_every:
        A = n_shared_apps(cfg)
        cache["shared_k"] = zeros(A, batch, W, cfg.n_kv_heads, cfg.hd)
        cache["shared_v"] = zeros(A, batch, W, cfg.n_kv_heads, cfg.hd)
    return cache


# ---------------------------------------------------------------------------
# the layer loop: forward and prefill
# ---------------------------------------------------------------------------

def _attn_dims(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
                rope_theta=cfg.rope_theta,
                sliding_window=cfg.sliding_window)


def _ssm_dims(cfg: ArchConfig) -> dict:
    return dict(d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                n_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim,
                norm_eps=cfg.norm_eps)


def _ffn(cfg: ArchConfig, lp: dict, x: torch.Tensor, backend: str,
         moe_pspec=None) -> torch.Tensor:
    """The attention block's second half: MoE or SwiGLU MLP on the
    normed residual (the MoE aux loss is dropped, as in the reference's
    forward and serving path; on DTensors the MoE layer runs on local
    shards, ``sharded.moe``, and the MLP on its ``d_ff`` slices,
    ``sharded.mlp``)."""
    xn = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        return sharded.moe(moe, lp["moe"], xn, cfg.moe_top_k,
                           cfg.capacity_factor, backend, moe_pspec)
    return sharded.mlp(mlp, lp["mlp"], xn)


def _layers(cfg: ArchConfig, params: Params, x: torch.Tensor,
            backend: str, caches: bool, remat: bool = False, ring=None,
            act_pspec=None, moe_pspec=None) -> tuple[torch.Tensor, Cache]:
    """x (B, S, d) through every layer and, after each layer the shared
    block follows, the shared block; returns (the last hidden state,
    before the final norm; with ``caches``, the prefill's cache entries:
    k/v (the last W of them, ring-aligned) or the Mamba2 conv and ssm
    states per layer, and each shared-block site's k/v).

    The reference computes the shared block after every layer and keeps
    its result where the layer's flag is set (``jnp.where``; its k/v
    through a 0/1 blend into site ``app_idx``).  Computing it only where
    the flag is set gives the same values.

    ``remat`` (without ``caches``, with grad mode on): each layer and
    each shared-block application runs under
    ``torch.utils.checkpoint.checkpoint`` (non-reentrant), the
    counterpart of the reference's ``jax.checkpoint(body)``: only its
    input is kept, and the backward runs it again.

    ``ring=(mesh, axis)`` goes to the attention of every ``attn``-pattern
    layer (``attention_prefill``), never to the shared block or a Mamba2
    layer, as in the reference.

    ``act_pspec`` redistributes x after each layer and each shared-block
    application (the reference constrains its scan body's output);
    ``moe_pspec`` goes to the MoE layers (``sharded.moe``)."""
    B, S, _ = x.shape
    W = _window(cfg, S)

    def keep_window(t):   # (B, S, K, D) -> last W entries, ring-aligned
        if W >= S:
            return t
        # decode writes token t at slot t % W: token S-W+i goes to slot
        # (S-W+i) % W == (i + S) % W, so roll by S % W
        return torch.roll(t[:, -W:], shifts=S % W, dims=1)

    apply, app_idx = shared_apply_flags(cfg)
    shared = params.get("shared")
    per_layer: dict[str, list] = {}
    sites: dict[str, dict[int, torch.Tensor]] = {"shared_k": {},
                                                 "shared_v": {}}

    def layer(x, lp):
        x = sharded.rows(x)
        xn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.layer_pattern == "attn":
            h, layer_cache = attention_prefill(lp["attn"], xn,
                                               **_attn_dims(cfg),
                                               backend=backend, ring=ring)
            x = sharded.rows(x + h)
            return x + _ffn(cfg, lp, x, backend, moe_pspec), layer_cache
        h, layer_cache = sharded.mamba2(mamba2_prefill, lp["mamba"], xn,
                                        **_ssm_dims(cfg), backend=backend)
        return x + h, layer_cache

    def shared_block(x):
        x = sharded.rows(x)
        h, kv = attention_prefill(
            shared["attn"], rms_norm(x, shared["ln1"], cfg.norm_eps),
            **_attn_dims(cfg), backend=backend)
        x = sharded.rows(x + h)
        return x + sharded.mlp(mlp, shared["mlp"],
                               rms_norm(x, shared["ln2"], cfg.norm_eps)), kv

    def run(fn, *args):
        """fn(*args)[0] under checkpoint where ``remat`` asks for it,
        else fn(*args) whole."""
        if remat and not caches and torch.is_grad_enabled():
            return checkpoint(lambda *a: fn(*a)[0], *args,
                              use_reentrant=False), None
        return fn(*args)

    for i, lp in enumerate(_unbind_layers(params)):
        x, layer_cache = run(layer, x, lp)
        x = sharded.constrain(x, act_pspec)
        if caches:
            for k, t in layer_cache.items():
                per_layer.setdefault(k, []).append(
                    keep_window(t) if k in ("k", "v") else t)
        if apply[i]:
            x, kv = run(shared_block, x)
            x = sharded.constrain(x, act_pspec)
            if caches:
                for k in ("k", "v"):
                    sites["shared_" + k][app_idx[i]] = keep_window(kv[k])
    cache: Cache = {}
    if caches:
        cache = {k: torch.stack(ts) for k, ts in per_layer.items()}
        if shared is not None:
            cache.update({k: torch.stack([s[a] for a in range(len(s))])
                          for k, s in sites.items()})
    return x, cache


def forward(cfg: ArchConfig, params: Params, batch: dict,
            remat: bool = True, unroll: bool = False,
            backend: str = "cuda", ring=None, act_pspec=None,
            moe_pspec=None) -> torch.Tensor:
    """batch: {'tokens': (B, S)} or {'embeds': (B, S, d)}.  Returns the
    logits (B, S, vocab_padded), padded vocab slots masked; the MoE aux
    loss is dropped, as in the reference's ``forward``.

    ``remat`` (the reference's default, True): under grad mode, each
    layer and each shared-block application keeps only its input and is
    run again in the backward (``torch.utils.checkpoint``, the
    counterpart of ``jax.checkpoint``); it changes no value.  ``unroll``
    is accepted for the reference's signature and does nothing: the
    layers are a Python loop, not a ``lax.scan``.

    ``ring=(mesh, axis)``: every ``attn``-pattern layer's attention is
    ring attention over ``axis`` of the ``torch.distributed``
    ``DeviceMesh`` (where S is a multiple of its size; see
    ``layers.attention_prefill``).  Every rank of the axis calls this
    with the same params and batch, and every rank computes the layers
    outside attention on the whole sequence, as the reference's
    activations stay global.  Under remat the backward's recompute runs
    each ring again; every rank runs the same layers in the same order,
    so the collectives stay matched.  On placed params the ring's mesh
    must be the params' (``ValueError`` otherwise) and each layer's ring
    runs on each rank's rows (``sharded.ring_attention``), with
    ``act_pspec`` and ``moe_pspec`` as below.

    Sharding: on params placed by ``launch.sharding.distribute`` (DTensors,
    the batch placed by ``batch_pspecs``) every rank of the mesh calls
    this and gets the logits as a DTensor (``sharded.py``).
    ``act_pspec`` (a ``launch.sharding.P`` for the (B, S, d) activations,
    e.g. ``P(("data",), "model", None)``: sequence over ``model``)
    redistributes them after the embedding and after every layer;
    ``moe_pspec`` is the MoE dispatch buffer's (B, E, C, d) spec, which
    must be ``P(<data axes>, None, None, None)``: the port's buffer is
    batch-sharded whether it is given or not.  A pspec with plain-tensor
    params raises ``ValueError``."""
    check_backend(backend)
    sharded.check_specs(params["head"], act_pspec, moe_pspec)
    x = sharded.constrain(_embed(cfg, params, batch, "tokens", "embeds"),
                          act_pspec)
    x, _ = _layers(cfg, params, x, backend, caches=False, remat=remat,
                   ring=ring, act_pspec=act_pspec, moe_pspec=moe_pspec)
    x = rms_norm(sharded.rows(x), params["final_norm"], cfg.norm_eps)
    return _mask_padded_vocab(cfg, x @ params["head"])


def loss_fn(cfg: ArchConfig, params: Params, batch: dict,
            unroll: bool = False, backend: str = "cuda",
            ring=None, act_pspec=None, moe_pspec=None) -> torch.Tensor:
    """Mean next-token cross entropy of :func:`forward`'s logits (with
    remat, as the reference's) against ``batch['labels']`` (B, S), in
    fp32; a 0-d tensor.  ``unroll`` does nothing; ``ring``, ``act_pspec``
    and ``moe_pspec`` go to :func:`forward`.  On placed params the
    logits keep their vocab split over ``model`` (``sharded.token_nll``:
    each slice's log-sum-exp, gathered and combined, and the label's
    logit picked where it lies) and the loss is a 0-d DTensor,
    replicated: every rank holds the value."""
    logits = forward(cfg, params, batch, unroll=unroll, backend=backend,
                     ring=ring, act_pspec=act_pspec,
                     moe_pspec=moe_pspec).float()
    return sharded.replicated(
        sharded.token_nll(logits, batch["labels"].long()).mean())


def prefill(cfg: ArchConfig, params: Params, batch: dict,
            backend: str = "cuda", ring=None, act_pspec=None,
            moe_pspec=None) -> tuple[torch.Tensor, Cache]:
    """batch: {'tokens': (B, S)} or {'embeds': (B, S, d)}.  Returns
    (logits of the last position (B, vocab_padded), a cache holding the
    prompt's k/v, or the Mamba2 conv and ssm states, and a hybrid's
    shared-block k/v at each site).  ``ring=(mesh, axis)`` as in
    :func:`forward`; every rank returns the whole cache (on placed params
    in the placements the prefill without the ring gives).  ``act_pspec``
    and ``moe_pspec`` as in :func:`forward`: on placed params the logits
    and the cache's tensors are DTensors (``len`` a plain tensor)."""
    check_backend(backend)
    sharded.check_specs(params["head"], act_pspec, moe_pspec)
    x = sharded.constrain(_embed(cfg, params, batch, "tokens", "embeds"),
                          act_pspec)
    S = x.shape[1]
    x, layer_caches = _layers(cfg, params, x, backend, caches=True,
                              ring=ring, act_pspec=act_pspec,
                              moe_pspec=moe_pspec)
    x = rms_norm(sharded.rows(x), params["final_norm"], cfg.norm_eps)
    logits = _mask_padded_vocab(cfg, x[:, -1] @ params["head"])
    cache = {"len": torch.full((), S, dtype=torch.int32, device=x.device)}
    cache.update(layer_caches)
    return logits, cache


def decode_step(cfg: ArchConfig, params: Params, cache: Cache, inputs: dict,
                backend: str = "cuda") -> tuple[torch.Tensor, Cache]:
    """inputs: {'token': (B,) int} or {'embed': (B, d)}.  Returns
    (logits (B, vocab_padded), the cache one token longer).

    The new token's k/v (attention and the shared block's site) or the
    new conv and ssm states (Mamba2) are written into the cache's
    tensors in place (the reference returns new arrays); the returned
    cache holds those same tensors and a new ``len``.  The host never
    reads ``len``: one step queues its work on the card without waiting.

    Sharding: on params placed by ``launch.sharding.distribute`` the
    cache must be placed too (by ``cache_pspecs`` in either mode, or as
    ``prefill`` on placed params returns it), ``len`` plain or
    replicated; every rank of the mesh calls this, the logits come back
    as a DTensor and the cache is written in place in its own placements
    (``sharded.decode_attention``, ``sharded.mamba2_decode``; the MoE
    layer and the embedding through ``sharded.moe`` and
    ``sharded.embed``).  Plain params with a placed cache, or the
    reverse, raise ``ValueError``."""
    check_backend(backend)
    head = params["head"]
    sharded.check_cache(head, cache)
    x = _embed(cfg, params, inputs, "token", "embed")[:, None, :]  # (B,1,d)
    x = sharded.like(x, head) if not sharded.placed(x) else x
    cache_len = cache["len"]
    apply, app_idx = shared_apply_flags(cfg)
    shared = params.get("shared")

    def attend(p, xn, k, v):
        return attention_decode(p, xn, k, v, cache_len, **_attn_dims(cfg),
                                backend=backend)[0]

    # each residual branch is taken to whole rows before its add: on a
    # Partial branch DTensor's own choice (divide the residual, or reduce
    # the branch) differs between torch releases
    for i, lp in enumerate(_unbind_layers(params)):
        x = sharded.rows(x)
        xn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.layer_pattern == "attn":
            x = x + sharded.rows(attend(lp["attn"], xn,
                                        sharded.layer(cache["k"], i),
                                        sharded.layer(cache["v"], i)))
            x = x + sharded.rows(_ffn(cfg, lp, sharded.rows(x), backend))
        else:
            x = x + sharded.mamba2_decode(
                mamba2_decode, lp["mamba"], xn,
                sharded.layer(cache["conv"], i),
                sharded.layer(cache["ssm"], i), **_ssm_dims(cfg))
        if apply[i]:
            ai = app_idx[i]
            x = sharded.rows(x)
            x = x + sharded.rows(attend(
                shared["attn"], rms_norm(x, shared["ln1"], cfg.norm_eps),
                sharded.layer(cache["shared_k"], ai),
                sharded.layer(cache["shared_v"], ai)))
            x = sharded.rows(x)
            x = x + sharded.rows(sharded.mlp(
                mlp, shared["mlp"], rms_norm(x, shared["ln2"], cfg.norm_eps)))
    x = rms_norm(sharded.rows(x), params["final_norm"], cfg.norm_eps)
    logits = _mask_padded_vocab(cfg, (x @ head)[:, 0])
    return logits, {**cache, "len": cache_len + 1}
