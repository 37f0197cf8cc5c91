"""Shared inputs of the port's tests (``tests/test_torch_*.py``), made with
numpy from a seed so that both packages get the same numbers.  Imports
neither ``jax`` nor ``torch``: the ``cuda``-marked tests run on a
machine without JAX."""

import ctypes
import re

import numpy as np

# the JAX package's tiny zoo sizes (tests/test_exec_equivalence.py)
ZOO_TINY = {
    "vgg16": dict(input_size=(40, 40), scale=0.1, head=False),
    "yolov2": dict(input_size=(64, 64), scale=0.05),
    "resnet34": dict(input_size=(64, 64), scale=0.1),
    "inceptionv3": dict(input_size=(96, 96), scale=0.1),
    "squeezenet": dict(input_size=(64, 64), scale=0.1),
    "mobilenetv3": dict(input_size=(64, 64), scale=0.1),
    "nasnet": dict(n_cells=2, input_size=(48, 48), scale=0.15),
}

# conv kernel cases: (x shape, w shape, stride, pool, relu, bias)
CONV_CASES = {
    "plain": ((2, 9, 11, 8), (3, 3, 8, 16), (1, 1), None, False, False),
    "stride2_tail": ((1, 12, 12, 5), (3, 3, 5, 7), (2, 2), None, True, True),
    "stride1x2": ((1, 13, 11, 6), (3, 3, 6, 9), (1, 2), None, False, True),
    "k1x7": ((1, 9, 15, 8), (1, 7, 8, 12), (1, 1), None, True, True),
    "k7x1": ((1, 15, 9, 8), (7, 1, 8, 12), (1, 1), None, True, True),
    "stem7x7s2": ((1, 20, 20, 3), (7, 7, 3, 16), (2, 2), None, True, True),
    "pool_odd": ((2, 13, 13, 5), (3, 3, 5, 7), (1, 1), (2, 2), True, True),
    "stride2_pool_odd": ((1, 17, 15, 8), (3, 3, 8, 8), (2, 2), (2, 2), True,
                         False),
    "tail_pool3": ((1, 14, 16, 13), (3, 3, 13, 70), (1, 1), (3, 3), False,
                   True),
}

# the conv kernel's launch plan (kernels/conv2d/ops.py, `plan`):
# (variant, (BM, BN) tile, split-K S).  The 15 launches of one
# single-frame VGG16 runner call on the paper's 8-Pi plan, in order:
# (x shape, w shape, pool) and the plan each takes
VGG16_LAUNCHES = [
    ((1, 226, 226, 3), (3, 3, 3, 64), None, ("general", (64, 64), 1)),
    ((1, 226, 226, 64), (3, 3, 64, 64), (2, 2), ("ring", (128, 64), 1)),
    ((1, 114, 114, 64), (3, 3, 64, 128), None, ("ring", (128, 64), 2)),
    ((1, 114, 114, 128), (3, 3, 128, 128), None, ("ring", (128, 64), 2)),
    ((1, 58, 58, 128), (3, 3, 128, 256), None, ("ring", (128, 64), 2)),
    ((1, 58, 33, 256), (3, 3, 256, 256), None, ("ring", (128, 64), 4)),
    ((1, 58, 32, 256), (3, 3, 256, 256), (2, 2), ("ring", (128, 64), 4)),
    ((1, 58, 29, 256), (3, 3, 256, 256), None, ("ring", (128, 64), 8)),
    ((1, 58, 28, 256), (3, 3, 256, 256), (2, 2), ("ring", (128, 64), 8)),
    ((1, 30, 30, 256), (3, 3, 256, 512), None, ("ring", (128, 64), 4)),
    ((1, 30, 30, 512), (3, 3, 512, 512), None, ("ring", (128, 64), 4)),
    ((1, 30, 30, 512), (3, 3, 512, 512), (2, 2), ("ring", (128, 64), 4)),
    ((1, 16, 16, 512), (3, 3, 512, 512), None, ("ring", (64, 64), 8)),
    ((1, 16, 16, 512), (3, 3, 512, 512), None, ("ring", (64, 64), 8)),
    ((1, 16, 16, 512), (3, 3, 512, 512), (2, 2), ("ring", (64, 64), 8)),
]
# the plan each of CONV_CASES takes
CONV_CASE_PLANS = {
    "plain": ("ring", (64, 64), 1),
    "stride2_tail": ("general", (64, 64), 1),
    "stride1x2": ("general", (64, 64), 1),
    "k1x7": ("ring", (64, 64), 1),
    "k7x1": ("ring", (64, 64), 1),
    "stem7x7s2": ("general", (64, 64), 2),
    "pool_odd": ("general", (64, 64), 1),
    "stride2_pool_odd": ("ring", (64, 64), 1),
    "tail_pool3": ("general", (64, 64), 2),
}
# the plan's edges at full size, (x, w, stride, pool, relu, bias) and the
# plan: VGG16's launch 15 (S = 8 and the 2x2 pool); K = 1800, no
# multiple of S BK, with CI = 200 no multiple of BK; CI = 12 (a slice
# spans several (dh, dw)) split four ways; CI = 3 and CI = 13 / CO = 70
# (general); a 3x3 pool in 128-row tiles (14 windows a block); VGG16's
# launch 2 for a batch of 8 frames
CONV_PLAN_CASES = {
    "vgg_launch15": ((1, 16, 16, 512), (3, 3, 512, 512), (1, 1), (2, 2),
                     True, True, ("ring", (64, 64), 8)),
    "k1800": ((1, 16, 16, 200), (3, 3, 200, 256), (1, 1), None, True, True,
              ("ring", (64, 64), 8)),
    "ci12": ((1, 24, 24, 12), (5, 5, 12, 32), (1, 1), None, False, True,
             ("ring", (64, 64), 4)),
    "ci3": ((1, 60, 60, 3), (3, 3, 3, 64), (1, 1), None, True, True,
            ("general", (64, 64), 1)),
    "ci13": ((2, 31, 29, 13), (3, 3, 13, 70), (1, 1), (2, 2), True, False,
             ("general", (64, 64), 2)),
    "pool3_bm128": ((1, 100, 100, 32), (3, 3, 32, 64), (1, 1), (3, 3), True,
                    True, ("ring", (128, 64), 4)),
    "vgg_launch2_batch8": ((8, 226, 226, 64), (3, 3, 64, 64), (1, 1), (2, 2),
                           True, True, ("ring", (128, 64), 1)),
}


def conv_inputs(x_shape, w_shape, bias, seed=0):
    """x, w (scaled by 1/sqrt(fan_in)) and an optional bias, fp32."""
    rng = np.random.default_rng(seed)
    kh, kw, ci, co = w_shape
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal(w_shape) / np.sqrt(kh * kw * ci)).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(co)).astype(np.float32) if bias else None
    return x, w, b


def np_params(m, seed=0):
    """Reference-layout weights ``{layer: {"w", "b"}}`` for either
    package's model ``m``: the JAX init's shapes and scales, plus a
    nonzero bias."""
    rng = np.random.default_rng(seed)
    params = {}
    for n, spec in m.graph.layers.items():
        if spec.kind == "conv":
            shape = (spec.kernel[1], spec.kernel[0], spec.in_channels,
                     spec.out_channels)
        elif spec.kind == "fc":
            shape = (spec.in_channels, spec.out_channels)
        else:
            continue
        fan_in = int(np.prod(shape[:-1]))
        params[n] = {
            "w": (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32),
            "b": (0.1 * rng.standard_normal(spec.out_channels)).astype(
                np.float32)}
    return params


def image(m, seed=1, n=1):
    """An (n, H, W, C) fp32 input for model ``m``."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, m.input_size[1], m.input_size[0], m.in_channels)
    ).astype(np.float32)


# attention kernel cases.  flash-prefill: (B, S, K, G, D, sliding window);
# the first four are tests/test_kernels.py's sweep, then S that no tile
# divides, with and without a window, and a G that does not divide 64;
# then the bf16 kernel's edges: the head dim padded (D = 8 to 16, D = 40
# to 64) or in two 64-column atoms (D = 128), granite's G = 3 at S = 511
# (63 live rows of 64), a window at Llama's G and D, and G = 64 (one
# position a block)
PREFILL_CASES = {
    "s64": (1, 64, 2, 2, 16, 0),
    "s128_g4": (2, 128, 1, 4, 32, 0),
    "s256_g1_d64": (1, 256, 2, 1, 64, 0),
    "s128_w32": (1, 128, 2, 2, 16, 32),
    "s37": (2, 37, 2, 2, 16, 0),
    "s37_g3_w8": (1, 37, 2, 3, 8, 8),
    "s70_d8": (1, 70, 2, 2, 8, 0),
    "s80_d40": (1, 80, 2, 2, 40, 0),
    "s96_d128": (1, 96, 1, 2, 128, 0),
    "s511_g3": (1, 511, 1, 3, 64, 0),
    "s200_g4_w32": (1, 200, 2, 4, 64, 32),
    "s40_g64": (1, 40, 1, 64, 32, 0),
}
# flash-prefill at the LM paths' full prefill shapes (B 4, S 511): q (B,
# S, K, G, D)
PREFILL_FULL_SHAPES = {
    "llama3.2-1b": (4, 511, 8, 4, 64),
    "granite-moe-3b-a800m": (4, 511, 8, 3, 64),
    "qwen1.5-0.5b": (4, 511, 16, 1, 64),
}
# flash-decode: (B, K, G, D, cache W, valid_len), tests/test_kernels.py's
# sweep plus a cache that no tile divides, filled to one entry
DECODE_CASES = {
    "w64": (2, 2, 4, 16, 64, 64),
    "w128_vl100": (1, 8, 1, 32, 128, 100),
    "w256_vl7": (2, 1, 8, 64, 256, 7),
    "w32": (3, 4, 2, 8, 32, 32),
    "w512_vl511_d128": (1, 2, 2, 128, 512, 511),
    "w37_vl1": (2, 2, 4, 64, 37, 1),
}

# the decode kernel's splits of the cache (kernels/attention/ops.py,
# `decode_splits`): (B, K, G, D, cache W, valid_len) and the splits S.
# Llama-3.2-1B's and granite's decode shapes with valid_len on a split
# boundary, 1 (split 0 alone live), 0 (all W entries, equal weights),
# past W and inside the cache; W = 37 (one split); G = 64, D = 8, D = 128
# (eight splits of B K = 8); B K = 1024 (one split)
DECODE_SPLIT_CASES = {
    "llama_vl_boundary": (4, 8, 4, 64, 544, 272, 4),
    "llama_vl1": (4, 8, 4, 64, 544, 1, 4),
    "llama_vl0": (4, 8, 4, 64, 544, 0, 4),
    "llama_vl_past_w": (4, 8, 4, 64, 544, 549, 4),
    "granite": (4, 8, 3, 64, 544, 530, 4),
    "w37": (4, 8, 4, 64, 37, 30, 1),
    "g64": (1, 2, 64, 32, 200, 150, 4),
    "d8": (4, 8, 4, 8, 544, 530, 4),
    "d128": (1, 8, 8, 128, 1000, 999, 8),
    "bk1024": (32, 32, 4, 64, 256, 200, 1),
}


def prefill_inputs(b, s, k, g, d, seed=0):
    """q (B, S, K, G, D), k and v (B, S, K, D), fp32 standard normal."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, k, g, d)).astype(np.float32),
            rng.standard_normal((b, s, k, d)).astype(np.float32),
            rng.standard_normal((b, s, k, d)).astype(np.float32))


def decode_inputs(b, k, g, d, w, seed=0):
    """q (B, K, G, D), k and v (B, W, K, D), fp32 standard normal."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, k, g, d)).astype(np.float32),
            rng.standard_normal((b, w, k, d)).astype(np.float32),
            rng.standard_normal((b, w, k, d)).astype(np.float32))


# SSD intra-chunk cases: (BC, Q, H, P, N); tests/test_kernels.py's sweep,
# then chunk lengths that no 64-row tile divides, then a head count that
# no head group of the kernel divides with P and N that the kernel's
# 16-byte copies do not take in bf16 (its plain-load path), and three
# 64-row tiles (an odd middle tile without a partner) with H = 6
SSD_CASES = {
    "q16": (2, 16, 2, 16, 8),
    "q64": (1, 64, 4, 32, 16),
    "q32_n128": (3, 32, 1, 8, 128),
    "q128_p64": (2, 128, 2, 64, 64),
    "q37": (2, 37, 2, 16, 8),
    "q73": (1, 73, 3, 16, 32),
    "h5_p20_n12": (1, 40, 5, 20, 12),
    "q150_h6": (1, 150, 6, 8, 16),
}
# the kernel's edges on the card: (BC, Q, H, P, N) and the heads a block
# ``ops.plan`` must choose in fp32 and in bf16.  mamba2-370m's prefill
# chunk (Q = 511, eight row tiles: four pairs) and a 1024-token prompt's
# (Q = 256); H not a multiple of G = 4; an odd number of row tiles at
# BC = 1; Q = 1030 (nothing sized by Q; in fp32 G = 2's grid would take
# two waves); P = 128 (two P tiles) with N = 8; two heads
SSD_EDGE_CASES = {
    "mamba2_prefill": ((4, 511, 32, 64, 128), (4, 4)),
    "mamba2_q256": ((16, 256, 32, 64, 128), (4, 4)),
    "h3": ((64, 256, 3, 64, 128), (4, 4)),
    "h6": ((16, 511, 6, 64, 128), (4, 4)),
    "q511_bc1": ((1, 511, 32, 64, 128), (2, 2)),
    "q1030": ((1, 1030, 32, 64, 128), (4, 2)),
    "p128_n8": ((2, 256, 4, 128, 8), (2, 2)),
    "h2": ((64, 256, 2, 64, 128), (2, 2)),
}
# grouped expert GEMM cases: (E, C, D, F); tests/test_kernels.py's sweep,
# then the capacities of a granite decode (C = 4) and prefill (C = 508),
# then the variants' edges: C = 508 at granite's D (the C tail of
# 128-row tiles), a D tail inside one expert (D = 40, between experts of
# nonzero data), F = 8 at prefill, D or F not a multiple of 8 (the
# general variant in bf16), a decode at granite's width, C = 12 with D
# split sixteen ways (fp32), and a decode whose D TMA cannot address
# (general in bf16)
MOE_GEMM_CASES = {
    "e4": (4, 16, 32, 64),
    "e8_c128": (8, 128, 64, 128),
    "e3_d512": (3, 8, 512, 16),
    "e40": (40, 4, 24, 8),
    "c4": (6, 4, 64, 32),
    "c508": (2, 508, 32, 16),
    "c508_d1536": (2, 508, 1536, 64),
    "d40": (3, 40, 40, 64),
    "f8": (2, 32, 64, 8),
    "d30_f12": (2, 24, 30, 12),
    "d36_c20": (2, 20, 36, 16),
    "c4_f12": (3, 4, 32, 12),
    "granite_c4": (40, 4, 1536, 512),
    "c12_d1024": (4, 12, 1024, 256),
    "c4_d36": (3, 4, 36, 16),
}
# the variant of ops.moe_gemm that each case takes, fp32 then bf16:
# stream for C <= 16, wgmma (bf16) or simt (fp32) above, where the rows
# hold whole 16-byte vectors (bf16: D and F multiples of 8); general for
# the rest
MOE_GEMM_VARIANTS = {
    "e4": ("stream", "stream"),
    "e8_c128": ("simt", "wgmma"),
    "e3_d512": ("stream", "stream"),
    "e40": ("stream", "stream"),
    "c4": ("stream", "stream"),
    "c508": ("simt", "wgmma"),
    "c508_d1536": ("simt", "wgmma"),
    "d40": ("simt", "wgmma"),
    "f8": ("simt", "wgmma"),
    "d30_f12": ("general", "general"),
    "d36_c20": ("simt", "general"),
    "c4_f12": ("stream", "general"),
    "granite_c4": ("stream", "stream"),
    "c12_d1024": ("stream", "stream"),
    "c4_d36": ("stream", "general"),
}


def ssd_inputs(bc, q, h, p, n, seed=0):
    """x, dt (softplus of a normal), A (< 0), B and C for one SSD chunk
    batch, fp32, scaled as in tests/test_kernels.py's sweep."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((bc, q, h, p))
    dt = np.logaddexp(rng.standard_normal((bc, q, h)), 0.0)
    A = -np.exp(0.3 * rng.standard_normal(h))
    B = 0.3 * rng.standard_normal((bc, q, n))
    C = 0.3 * rng.standard_normal((bc, q, n))
    return tuple(a.astype(np.float32) for a in (x, dt, A, B, C))


def moe_gemm_inputs(e, c, d, f, seed=0):
    """x (E, C, D) standard normal and w (E, D, F) / sqrt(D), fp32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, c, d)).astype(np.float32),
            (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32))


# LM configs of the parity tests: an arch reduced as the serve launcher's
# --reduced does (d_model 128, 2 layers or "n_layers"), or explicit
# ArchConfig fields; "window" swaps in the sliding-window variant;
# "prefill" sets the prefilled length (default: LM_PROMPT tokens in all)
LM_CASES = {
    "llama": dict(arch="llama3.2-1b"),
    "qwen_bias": dict(arch="qwen1.5-0.5b"),
    "llama_swa16": dict(arch="llama3.2-1b", window=16),
    "gqa_bias": dict(fields=dict(name="gqa", n_layers=2, d_model=64,
                                 n_heads=4, n_kv_heads=2, d_ff=128,
                                 vocab_size=500, qkv_bias=True)),
    "mamba2": dict(arch="mamba2-370m"),
    "granite_moe": dict(arch="granite-moe-3b-a800m"),
    # 512 prefilled tokens: ssd_chunked takes Q = 256, two chunks, so the
    # inter-chunk scan runs through the model
    "mamba2_q256": dict(arch="mamba2-370m", prefill=512),
    # the shared block after layers 1 and 3: two sites (A = 2), so a k/v
    # written to the wrong site shows
    "zamba2": dict(arch="zamba2-2.7b", n_layers=4),
    # tests/test_transformer.py's hybrid and embeds families
    "hybrid": dict(fields=dict(name="hybrid", n_layers=4, d_model=64,
                               n_heads=4, n_kv_heads=2, d_ff=128,
                               vocab_size=500, ssm_state=16, ssm_head_dim=16,
                               layer_pattern="mamba", shared_attn_every=2,
                               family="hybrid")),
    "embeds": dict(fields=dict(name="embeds", n_layers=2, d_model=64,
                               n_heads=4, n_kv_heads=2, d_ff=128,
                               vocab_size=500, input_mode="embeds")),
    "musicgen": dict(arch="musicgen-medium"),
}
LM_BATCH, LM_PROMPT = 2, 24     # the prompt is longer than the window


def lm_config(configs, case):
    """``case``'s config from either package's ``configs`` module."""
    spec = LM_CASES[case]
    if "fields" in spec:
        cfg = configs.ArchConfig(**spec["fields"])
    else:
        cfg = configs.get(spec["arch"]).reduced(
            n_layers=spec.get("n_layers", 2), d_model=128)
    return cfg.with_sliding_window(spec["window"]) if "window" in spec \
        else cfg


def lm_tokens(cfg, n=LM_PROMPT, batch=LM_BATCH, seed=2):
    """(batch, n) int32 token ids below the config's vocab size."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, n)).astype(np.int32)


def lm_inputs(cfg, n=LM_PROMPT, batch=LM_BATCH, seed=2):
    """A config's input sequence: :func:`lm_tokens`, or for the
    ``embeds`` input mode (batch, n, d_model) fp32 standard normal
    embeddings."""
    if cfg.input_mode == "tokens":
        return lm_tokens(cfg, n, batch, seed)
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, n, cfg.d_model)).astype(np.float32)


def qkv_biases(cfg, seed=3):
    """Nonzero (L, width) QKV biases for a config with ``qkv_bias`` (the
    reference initialises them to zero, which would test nothing)."""
    rng = np.random.default_rng(seed)
    L, hd = cfg.n_layers, cfg.hd
    return {name: (0.1 * rng.standard_normal((L, n * hd))).astype(np.float32)
            for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads))}


def c_argtypes(source, name):
    """The ctypes signature that the ``extern "C"`` prototype of
    ``<name>_launch`` in ``source`` (a path) calls for: c_void_p for each
    pointer, c_int for each int.  ctypes checks only the argument count
    of a foreign call, and a pointer passed as a C int is cut to 32 bits,
    so each wrapper's argtypes must equal this, one for one."""
    proto = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)',
                      source.read_text())
    return [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in proto.group(1).split(",")]
