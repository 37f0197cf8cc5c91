"""Export decoder architectures as PICO graphs.

Each transformer/SSM block becomes a vertex chain over the *sequence*
dimension (W = seq_len, H = 1):

* full attention   -> 'attn' vertex, global receptive field (the halo is
  the whole sequence — the Fig. 6 analogue: tiling inside a fused piece
  that crosses it degenerates to full recomputation, which C(M) prices),
* sliding window   -> 'swa' vertex, kernel = window (finite halo),
* mamba2 conv1d    -> 'conv1d' vertex, kernel = ssm_conv (halo 3),
* SSD scan         -> 'ssd' vertex, kernel 1 (state passes at chunk
  boundaries; inter-chunk recurrence is sequential but cheap),
* mlp / moe        -> pointwise vertices with exact FLOPs coefficients,
* Zamba2's shared block -> extra attn+mlp vertices every k layers.

This lets Algorithm 1 cut pieces for the assigned archs exactly as for
CNNs, and Algorithms 2+3 build pipelines over any cluster of devices.
A framework-free copy of the JAX package's module: the same vertices,
coefficients and edges.
"""

from __future__ import annotations

from ..core.graph import Graph, LayerSpec
from .transformer.config import ArchConfig


def _attn_vertex(name: str, cfg: ArchConfig, seq_len: int) -> LayerSpec:
    d, hd, nq, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    proj = 2 * d * (nq * hd) + 2 * 2 * d * (nkv * hd)  # q,o + k,v MACs*2
    if cfg.sliding_window:
        ctx = min(cfg.sliding_window, seq_len)
        kind, kernel = "swa", (cfg.sliding_window, 1)
        glob = False
    else:
        ctx = seq_len / 2  # causal average context
        kind, kernel = "attn", (1, 1)
        glob = True
    score = 2 * 2 * nq * hd * ctx      # QK^T + PV per output token
    return LayerSpec(
        name, kind, kernel=kernel, stride=(1, 1), padding=(0, 0),
        in_channels=d, out_channels=d,
        flops_coeff=proj + score,
        param_bytes=2 * (2 * d * nq * hd + 2 * d * nkv * hd),
        global_rf=glob, tile_independent_flops=True)


def _mlp_vertex(name: str, cfg: ArchConfig) -> LayerSpec:
    d, ff = cfg.d_model, cfg.d_ff
    return LayerSpec(name, "ffn", in_channels=d, out_channels=d,
                     flops_coeff=2 * 3 * d * ff,
                     param_bytes=2 * 3 * d * ff)


def _moe_vertex(name: str, cfg: ArchConfig) -> LayerSpec:
    d, ff = cfg.d_model, cfg.d_ff
    active = 2 * 3 * d * ff * cfg.moe_top_k * cfg.capacity_factor
    return LayerSpec(name, "moe", in_channels=d, out_channels=d,
                     flops_coeff=active + 2 * d * cfg.n_experts,
                     param_bytes=2 * (3 * d * ff * cfg.n_experts
                                      + d * cfg.n_experts))


def _mamba_vertices(i: int, cfg: ArchConfig) -> list[LayerSpec]:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * N
    # projections (pointwise) -> causal conv1d (halo CK-1) -> SSD scan
    return [
        LayerSpec(f"l{i}.in_proj", "ffn", in_channels=d,
                  out_channels=conv_ch,
                  flops_coeff=2 * d * (2 * di + 2 * N + H),
                  param_bytes=2 * d * (2 * di + 2 * N + H)),
        LayerSpec(f"l{i}.conv1d", "conv1d", kernel=(cfg.ssm_conv, 1),
                  stride=(1, 1), padding=(cfg.ssm_conv - 1, 0),
                  in_channels=conv_ch, out_channels=conv_ch,
                  flops_coeff=2 * cfg.ssm_conv * conv_ch,
                  param_bytes=2 * cfg.ssm_conv * conv_ch),
        LayerSpec(f"l{i}.ssd", "ssd", in_channels=conv_ch,
                  out_channels=di,
                  flops_coeff=2 * H * cfg.ssm_head_dim * N * 4,
                  param_bytes=2 * 3 * H),
        LayerSpec(f"l{i}.out_proj", "ffn", in_channels=di,
                  out_channels=d, flops_coeff=2 * di * d,
                  param_bytes=2 * di * d),
    ]


def export_graph(cfg: ArchConfig, seq_len: int) -> Graph:
    """Decoder -> PICO Graph over the sequence dimension."""
    g = Graph()
    g.add(LayerSpec("embed", "embed", in_channels=1,
                    out_channels=cfg.d_model,
                    flops_coeff=0.0,
                    param_bytes=2 * cfg.vocab_padded * cfg.d_model,
                    global_rf=False))
    prev = "embed"
    for i in range(cfg.n_layers):
        if cfg.layer_pattern == "attn":
            a = g.add(_attn_vertex(f"l{i}.attn", cfg, seq_len), [prev])
            if cfg.is_moe:
                prev = g.add(_moe_vertex(f"l{i}.moe", cfg), [a])
            else:
                prev = g.add(_mlp_vertex(f"l{i}.mlp", cfg), [a])
        else:
            vs = _mamba_vertices(i, cfg)
            for v in vs:
                prev = g.add(v, [prev])
        if cfg.shared_attn_every and (i + 1) % cfg.shared_attn_every == 0:
            sa = g.add(_attn_vertex(f"l{i}.shared_attn", cfg, seq_len),
                       [prev])
            prev = g.add(_mlp_vertex(f"l{i}.shared_mlp", cfg), [sa])
    # the LM head is pointwise per token (unlike a CNN fc over a map)
    g.add(LayerSpec("head", "ffn", in_channels=cfg.d_model,
                    out_channels=cfg.vocab_padded,
                    flops_coeff=2 * cfg.d_model * cfg.vocab_padded,
                    param_bytes=2 * cfg.d_model * cfg.vocab_padded),
          [prev])
    return g
