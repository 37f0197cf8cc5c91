#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases (each exits non-zero on failure; nothing is caught and skipped):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions.  No CUDA device: exit 1, no result;
2. build of every kernel of the paths from the sources in the
   checkout (``nvcc``, ``sm_90a``; one ``nvcc`` per source, all started
   together), with each build time and, per kernel entry, its
   registers, static shared memory and spills;
3. each kernel against its plain PyTorch version on the card, at every
   shape its path launches plus edge cases, with times for the kernel,
   the plain version, one library call and the card's bound (CUDA
   events), and the kernel's and the library call's device time
   (``torch.profiler``); every ``conv2d_fused``, ``decode_attention``,
   ``flash_prefill`` and ``moe_gemm`` case also called twice, which must
   give the same bits; each conv case names its plan (variant, tile,
   split-K) and must run the planned variant, the conv and decode edge
   cases must take the plan (splits) they are listed with, each
   ``moe_gemm`` case names its variant; a table of the 15 conv launches
   of one runner call (plan, ms, device ms against cuDNN's, share of the
   bound);
4. the CNN path: ``repro_torch.compile(vgg16 full width, 8-Pi cluster)``
   then ``Deployment.run`` on one frame and on a list of 8 frames.  The
   conv kernel's launch counter is reset just before and read just
   after; the logits are checked for shape, finiteness and agreement
   with the ``"torch"`` backend and the monolithic forward;
5. the LM paths: ``repro_torch.serving.lm.generate`` at full width with
   random weights from a seed, batch 4, a 512-token prompt, 32 new
   greedy tokens, once in fp32 and once in bf16, for Llama-3.2-1B
   (attention kernels), mamba2-370m (``ssd_chunk``) and
   granite-moe-3b-a800m (``moe_gemm`` and the attention kernels at
   G = 3), each model freed before the next.  The kernels' counters are
   reset just before each generate and read just after (Llama: 16
   flash_prefill and 16 x 32 decode_attention; mamba2: 48 ssd_chunk;
   granite: 32 flash_prefill, 32 x 32 decode_attention and
   3 x 32 x (1 + 32) moe_gemm, the 96 prefill ones through the wgmma
   (bf16) or simt (fp32) variant and the 3072 decode ones through
   stream); prefill and decode times; agreement with
   ``backend="torch"`` on the same weights (``_lm_agreement``, and for
   granite each MoE layer on shared inputs, ``_moe_agreement``); a
   profiled decode step (with granite, moe_gemm's time inside it);
6. one ``{"kernels": [...]}`` JSON line (five kernels), the card line,
   and last ``{"ok": true, "device": {...}}``.

TF32 is switched off for matmuls and cuDNN, so every fp32 number here is
IEEE fp32.  The script imports neither ``jax`` nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FLOPS = {"float32": 67e12,        # fp32 FMA, outside the tensor cores
              "bfloat16": 989e12}      # bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_TOL = 1e-4      # x max(1, max|ref|): fp32 sums in another order
# bf16, per element: |y - ref| <= BF16_TOL x (|ref| + rms(ref)).  The
# |ref| term is the output's own rounding (one bf16 ulp is at most 2^-7
# relative, on each side); the rms term is the probabilities rounded to
# bf16 against another running max (flash vs plain softmax), noise of a
# fraction of the output's scale that does not shrink with |ref|.  A
# limit from the global max|ref| would let a fault of a few hundredths
# pass wherever |ref| is small (late causal rows average over hundreds
# of keys).
BF16_TOL = 2 ** -6
LOGIT_TOL = 1e-4     # x max|logit|: 13 fp32 convs summed in other orders
REPLACES = {"conv2d_fused": "src/repro/kernels/conv2d/conv2d.py:110",
            "flash_prefill":
                "src/repro/kernels/attention/flash_prefill.py:87",
            "decode_attention":
                "src/repro/kernels/attention/decode_attn.py:71",
            "ssd_chunk": "src/repro/kernels/ssd/ssd_chunk.py:54",
            "moe_gemm": "src/repro/kernels/moe_gemm/moe_gemm.py:48"}
CLUSTER_GHZ = [1.5, 1.5, 1.2, 1.2, 1.0, 1.0, 0.8, 0.8]
# LMs, all at full width (src/repro_torch/configs/): each arch's serving
# path and the kernels it launches.  Llama-3.2-1B's attention kernels
# give the flash_prefill / decode_attention entries of the kernels line.
LM_ARCH, SSM_ARCH, MOE_ARCH = ("llama3.2-1b", "mamba2-370m",
                               "granite-moe-3b-a800m")
LM_FAMILIES = {LM_ARCH: ("flash_prefill", "decode_attention"),
               SSM_ARCH: ("ssd_chunk",),
               MOE_ARCH: ("flash_prefill", "decode_attention", "moe_gemm")}
LM_BATCH, LM_PROMPT, LM_NEW = 4, 512, 32
# kernel path vs backend="torch" on the same weights, x max|logit| over
# the real vocab.  fp32: only the kernels differ (sums in another
# order), through every layer.  bf16: both paths round the same tensors
# to bf16, but a different fp32 sum can land one bf16 ulp (2^-8
# relative) apart, and that carries through the layers: a logit band
# only, and no token check
LM_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` a call: the kernels' own durations as
    ``torch.profiler`` records them (host time between launches not
    counted; ``time_ms`` counts it when the host is the slower).  Each
    kernel's mean over the launches the profiler caught, times its
    launches a call (the profiler can miss the first few of a window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / e.count
               * max(1, round(e.count / iters))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.count) / 1e3


def bound(flops: float, nbytes: float, dtype_name: str) -> dict:
    """The card's least time for the work, and which side bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(t_ops_ms=t_ops * 1e3, t_bytes_ms=t_bytes * 1e3,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def check_close(y, y_ref, dtype):
    """(max |error|, worst error over its limit, ok) of a kernel's output
    against its plain version's, under FP32_TOL or BF16_TOL; fails on a
    shape or dtype mismatch."""
    import torch
    if y.shape != y_ref.shape or y.dtype != y_ref.dtype:
        fail(f"{tuple(y.shape)} {y.dtype} != plain {tuple(y_ref.shape)} "
             f"{y_ref.dtype}")
    err = (y.float() - y_ref.float()).abs()
    ref = y_ref.float().abs()
    if dtype == torch.float32:
        limit = FP32_TOL * max(1.0, ref.max().item())
    else:
        limit = BF16_TOL * (ref + ref.square().mean().sqrt())
    of_limit = (err / limit).max().item()
    return (err.max().item(), of_limit,
            of_limit <= 1.0 and bool(torch.isfinite(y).all()))


def conv_case(x_shape, w_shape, stride, pool, dtype_name, relu=True,
              bias=True, seed=0):
    """One kernel-vs-plain case on the card; returns a result dict with the
    launch's plan (``ops.plan``), the variant that the counts show it
    took, and whether two calls gave the same bits."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d import ops, ref

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    kh, kw, ci, co = w_shape
    x = torch.randn(x_shape, generator=g, device="cuda").to(dtype)
    w = (torch.randn(w_shape, generator=g, device="cuda")
         / (kh * kw * ci) ** 0.5).to(dtype)
    b = (0.1 * torch.randn((co,), generator=g, device="cuda")).to(dtype) \
        if bias else None
    kw_args = dict(stride=stride, relu=relu, pool=pool)
    plan = ops.plan(*x_shape, kh, kw, co, ops.normalize_stride(stride), pool)
    before = dict(ops.variant_counts)
    y = ops.conv2d_fused(x, w, b, **kw_args)
    ran = [v for v in ops.VARIANTS if ops.variant_counts[v] != before[v]]
    y2 = ops.conv2d_fused(x, w, b, **kw_args)
    y_ref = ref.conv2d_fused_ref(x, w, b, **kw_args)
    torch.cuda.synchronize()
    err, of_limit, ok = check_close(y, y_ref, dtype)
    same = torch.equal(y, y2)      # two calls, the same bits

    # library yardstick: one cuDNN conv (+ bias) on channels-last views
    # of the same memory; the ReLU and pool are not in it
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    ms = time_ms(lambda: ops.conv2d_fused(x, w, b, **kw_args))
    plain_ms = time_ms(lambda: ref.conv2d_fused_ref(x, w, b, **kw_args))
    library_ms = time_ms(lambda: F.conv2d(xc, wc, b, stride=stride))
    dev = (device_ms(lambda: ops.conv2d_fused(x, w, b, **kw_args)),
           device_ms(lambda: F.conv2d(xc, wc, b, stride=stride)))

    n = x_shape[0]
    hp, wp = y.shape[1], y.shape[2]
    ph, pw = pool or (1, 1)
    flops = 2.0 * n * hp * ph * wp * pw * co * kh * kw * ci
    nbytes = sum(t.numel() * t.element_size()
                 for t in (x, w, b, y) if t is not None)
    return dict(x=tuple(x_shape), w=tuple(w_shape), stride=tuple(stride),
                pool=pool, dtype=dtype_name, err=err, of_limit=of_limit,
                ok=ok and same and ran == [plan.variant], same=same,
                plan=plan, ran=ran, per_call=0, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, dev_ms=dev[0], library_dev_ms=dev[1],
                **bound(flops, nbytes, dtype_name))


def _plan_text(p) -> str:
    return f"{p.variant} {p.tile[0]}x{p.tile[1]} S{p.split}"


def prefill_case(shape, window, dtype_name, seed=0) -> dict:
    """flash_prefill against its plain version at q shape (B, S, K, G, D);
    the library call is SDPA (``enable_gqa``, causal or windowed mask)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import ops, ref

    dtype = getattr(torch, dtype_name)
    b, s, k, g, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    kk, vv = (torch.randn((b, s, k, d), generator=gen, device="cuda")
              .to(dtype) for _ in range(2))
    y = ops.flash_prefill(q, kk, vv, sliding_window=window)
    y2 = ops.flash_prefill(q, kk, vv, sliding_window=window)
    y_ref = ref.flash_prefill_ref(q, kk, vv, window)
    torch.cuda.synchronize()
    err, of_limit, ok = check_close(y, y_ref, dtype)
    same = torch.equal(y, y2)      # two calls, the same bits

    qh = q.reshape(b, s, k * g, d).transpose(1, 2)
    kh, vh = kk.transpose(1, 2), vv.transpose(1, 2)
    mask = None
    if window:
        pos = torch.arange(s, device="cuda")
        diff = pos[:, None] - pos[None, :]
        mask = (diff >= 0) & (diff < window)
    ms = time_ms(lambda: ops.flash_prefill(q, kk, vv, sliding_window=window))
    plain_ms = time_ms(lambda: ref.flash_prefill_ref(q, kk, vv, window))
    def sdpa():
        return F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)

    library_ms = time_ms(sdpa)
    dev = (device_ms(lambda: ops.flash_prefill(q, kk, vv,
                                               sliding_window=window)),
           device_ms(sdpa))
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
    nbytes = 2 * (q.numel() + kk.numel()) * q.element_size()  # q, k, v, o
    return dict(kernel="flash_prefill", desc=f"q{tuple(shape)} w{window}"
                + ("" if same else " NOT BIT-REPRODUCIBLE"),
                dtype=dtype_name, err=err, of_limit=of_limit, ok=ok and same,
                per_call=0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                dev_ms=dev[0], library_dev_ms=dev[1],
                **bound(4.0 * b * k * g * d * pairs, nbytes, dtype_name))


def decode_case(q_shape, w, valid_len, dtype_name, seed=0) -> dict:
    """decode_attention against its plain version at q (B, K, G, D) and a
    cache of W entries, and two calls that must give the same bits; the
    library call is SDPA (``enable_gqa``, mask).  The description names
    the splits of the cache per (b, kv head) (``ops.decode_splits``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import ops, ref

    dtype = getattr(torch, dtype_name)
    b, k, g, d = q_shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(q_shape, generator=gen, device="cuda").to(dtype)
    kk, vv = (torch.randn((b, w, k, d), generator=gen, device="cuda")
              .to(dtype) for _ in range(2))
    vl = torch.tensor(valid_len, dtype=torch.int32, device="cuda")
    y = ops.decode_attention(q, kk, vv, vl)
    y2 = ops.decode_attention(q, kk, vv, vl)
    y_ref = ref.decode_attention_ref(q, kk, vv, vl)
    torch.cuda.synchronize()
    err, of_limit, ok = check_close(y, y_ref, dtype)
    same = torch.equal(y, y2)      # two calls, the same bits

    qh = q.reshape(b, k * g, 1, d)
    kh, vh = kk.transpose(1, 2), vv.transpose(1, 2)
    mask = (torch.arange(w, device="cuda") < vl)[None, None, None]

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              enable_gqa=True)

    ms = time_ms(lambda: ops.decode_attention(q, kk, vv, vl))
    plain_ms = time_ms(lambda: ref.decode_attention_ref(q, kk, vv, vl))
    library_ms = time_ms(sdpa)
    dev = (device_ms(lambda: ops.decode_attention(q, kk, vv, vl)),
           device_ms(sdpa))
    live = min(valid_len, w) if valid_len > 0 else w   # entries read
    nbytes = (2 * q.numel() + 2 * b * live * k * d) * q.element_size() + 4
    splits = ops.decode_splits(b, k, w)
    return dict(kernel="decode_attention",
                desc=f"q{tuple(q_shape)} W{w} vl{valid_len} S{splits}"
                + ("" if same else " NOT BIT-REPRODUCIBLE"),
                dtype=dtype_name, err=err, splits=splits,
                of_limit=of_limit, ok=ok and same, per_call=0, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, dev_ms=dev[0],
                library_dev_ms=dev[1],
                **bound(4.0 * b * k * g * d * live, nbytes, dtype_name))


def ssd_case(shape, dtype_name, seed=0) -> dict:
    """ssd_chunk against its plain version at (BC, Q, H, P, N), with the
    model's ranges: dt the softplus of a normal around the init's
    ``dt_bias``, A from -1 to -16 (so cum falls to about -10^3 over
    Q = 511).  No single PyTorch call computes the function: no library
    time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd import ops, ref

    dtype = getattr(torch, dtype_name)
    bc, q, h, p, n = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*size):
        return torch.randn(size, generator=gen, device="cuda")

    dt_bias = torch.log(torch.expm1(torch.linspace(1e-3, 0.1, h,
                                                   device="cuda")))
    x = randn(bc, q, h, p).to(dtype)
    dt = F.softplus(randn(bc, q, h) + dt_bias).to(dtype)
    A = (-torch.linspace(1.0, 16.0, h, device="cuda")).to(dtype)
    Bm, Cm = randn(bc, q, n).to(dtype), randn(bc, q, n).to(dtype)
    y, st = ops.ssd_chunk(x, dt, A, Bm, Cm)
    y_ref, st_ref = ref.ssd_chunk_ref(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    checks = [check_close(y, y_ref, dtype), check_close(st, st_ref, dtype)]

    ms = time_ms(lambda: ops.ssd_chunk(x, dt, A, Bm, Cm))
    plain_ms = time_ms(lambda: ref.ssd_chunk_ref(x, dt, A, Bm, Cm))
    pairs = q * (q + 1) // 2          # causal (i, j) pairs of a chunk
    flops = (2.0 * bc * pairs * n          # C B^T, once per chunk
             + 2.0 * bc * h * pairs * p    # M @ x
             + 2.0 * bc * h * q * p * n)   # the state
    nbytes = (2 * x.numel() + dt.numel() + A.numel() + 2 * Bm.numel()
              + st.numel()) * x.element_size()
    return dict(kernel="ssd_chunk", desc=f"(BC,Q,H,P,N){tuple(shape)}",
                dtype=dtype_name, err=max(c[0] for c in checks),
                of_limit=max(c[1] for c in checks),
                ok=all(c[2] for c in checks), per_call=0, ms=ms,
                plain_ms=plain_ms, library_ms=None,
                **bound(flops, nbytes, dtype_name))


def moe_case(x_shape, f, dtype_name, seed=0) -> dict:
    """moe_gemm against its plain version at x (E, C, D), w (E, D, F);
    the library call is ``torch.bmm`` on the same tensors."""
    import torch
    from repro_torch.kernels.moe_gemm import ops, ref

    dtype = getattr(torch, dtype_name)
    e, c, d = x_shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((e, c, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((e, d, f), generator=gen, device="cuda")
         / d ** 0.5).to(dtype)
    before = dict(ops.variant_counts)
    y = ops.moe_gemm(x, w)
    variant = next(v for v in ops.VARIANTS
                   if ops.variant_counts[v] != before[v])
    y2 = ops.moe_gemm(x, w)
    y_ref = ref.moe_gemm_ref(x, w)
    torch.cuda.synchronize()
    err, of_limit, ok = check_close(y, y_ref, dtype)
    same = torch.equal(y, y2)      # two calls, the same bits
    ms = time_ms(lambda: ops.moe_gemm(x, w))
    plain_ms = time_ms(lambda: ref.moe_gemm_ref(x, w))
    library_ms = time_ms(lambda: torch.bmm(x, w))
    dev = (device_ms(lambda: ops.moe_gemm(x, w)),
           device_ms(lambda: torch.bmm(x, w)))
    nbytes = (x.numel() + w.numel() + y.numel()) * x.element_size()
    return dict(kernel="moe_gemm", desc=f"x{tuple(x_shape)} F{f} {variant}"
                + ("" if same else " NOT BIT-REPRODUCIBLE"), variant=variant,
                dtype=dtype_name, err=err, of_limit=of_limit, ok=ok and same,
                per_call=0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                dev_ms=dev[0], library_dev_ms=dev[1],
                **bound(2.0 * e * c * d * f, nbytes, dtype_name))


def _print_cases(cases) -> None:
    for r in cases:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        dev = (f" | device {r['dev_ms']:.4f} / {r['library_dev_ms']:.4f}"
               if "dev_ms" in r else "")
        print(f"  {'ok ' if r['ok'] else 'BAD'} {r['kernel']} {r['desc']} "
              f"{r['dtype']} x{r['per_call']} | {r['err']:.3g} "
              f"({r['of_limit']:.2f} of limit) | {r['ms']:.4f} / "
              f"{r['plain_ms']:.4f} / {lib} / {r['bound_ms']:.5f} "
              f"({r['bound_by']}){dev}")


# -- the LM paths ---------------------------------------------------------

def _kernel_ops() -> dict:
    """Each LM kernel's wrapper module, by kernel name."""
    from repro_torch.kernels.attention import ops as attn
    from repro_torch.kernels.moe_gemm import ops as moe
    from repro_torch.kernels.ssd import ops as ssd
    return {"flash_prefill": attn, "decode_attention": attn,
            "ssd_chunk": ssd, "moe_gemm": moe}


def _reset_counts() -> None:
    for mod in set(_kernel_ops().values()):
        mod.reset_launches()


def _record_key(name, args, kwargs):
    """(shape, argument) of one wrapper call, as its case function takes
    them."""
    if name == "flash_prefill":
        return tuple(args[0].shape), kwargs.get("sliding_window", 0)
    if name == "decode_attention":
        q, k, _, valid_len = args
        return (tuple(q.shape), k.shape[1]), int(valid_len)
    if name == "ssd_chunk":
        return (*args[0].shape, args[3].shape[-1]), None
    return (tuple(args[0].shape), args[1].shape[-1]), None      # moe_gemm


CASES = {
    "flash_prefill": lambda shape, arg, dt: prefill_case(shape, arg, dt),
    "decode_attention": lambda shape, arg, dt: decode_case(shape[0],
                                                           shape[1], arg, dt),
    "ssd_chunk": lambda shape, arg, dt: ssd_case(shape, dt),
    "moe_gemm": lambda shape, arg, dt: moe_case(shape[0], shape[1], dt),
}


def _record_shapes(names, fn) -> dict:
    """Run ``fn()`` with recording wrappers around the kernels ``names``;
    returns {(name, shape, argument, dtype): launches}.  These launches
    are not the counted run's."""
    import torch

    ops = _kernel_ops()
    real = {n: getattr(ops[n], n) for n in names}
    launched: dict[tuple, int] = {}

    def recording(n):
        def rec(*args, **kwargs):
            key = (n, *_record_key(n, args, kwargs),
                   str(args[0].dtype).removeprefix("torch."))
            launched[key] = launched.get(key, 0) + 1
            return real[n](*args, **kwargs)
        return rec

    for n in names:
        setattr(ops[n], n, recording(n))
    try:
        fn()
    finally:
        for n in names:
            setattr(ops[n], n, real[n])
    torch.cuda.synchronize()
    return launched


def _want_launches(cfg, names) -> dict:
    """Launches of one generate (prefill of LM_PROMPT - 1 tokens, LM_NEW
    decode steps) by construction of the model."""
    L = cfg.n_layers
    per = {"flash_prefill": L, "decode_attention": L * LM_NEW,
           "ssd_chunk": L, "moe_gemm": 3 * L * (1 + LM_NEW)}
    return {n: per[n] for n in names}


def _check_variants(cfg, dtype_name, counts) -> None:
    """granite's counted generate: every prefill expert GEMM (3 a layer,
    C = 508) through the prefill variant of its dtype (wgmma for bf16,
    simt for fp32) and every decode one (C = 4) through stream."""
    L = cfg.n_layers
    want = dict.fromkeys(counts, 0)
    want["wgmma" if dtype_name == "bfloat16" else "simt"] = 3 * L
    want["stream"] = 3 * L * LM_NEW
    print(f"[slice] {cfg.name} {dtype_name} moe_gemm variants: "
          + ", ".join(f"{v} {n}" for v, n in counts.items())
          + f" (want {want})")
    if dict(counts) != want:
        fail(f"{cfg.name} {dtype_name} moe_gemm variants {dict(counts)}, "
             f"want {want}")


def _extra_cases(cfg) -> list[dict]:
    """Kernel cases beyond the path's own shapes: edge cases of the
    attention kernels (with Llama), of moe_gemm's variants (with
    granite) and a longer Mamba2 prompt."""
    cases = []
    if cfg.name == LM_ARCH:
        b, k, g, d = LM_BATCH, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,\
            cfg.hd
        w = LM_PROMPT + LM_NEW
        for shape, window, dt in [
                ((2, 37, k, g, d), 0, "float32"),      # S no tile divides
                ((2, 200, k, g, d), 32, "float32"),    # sliding window
                ((2, 200, k, g, d), 32, "bfloat16"),
                ((2, 256, 16, 1, d), 0, "float32"),    # G = 1
                ((1, 256, 8, 8, 128), 0, "float32"),   # D = 128
                ((1, 256, 8, 8, 128), 0, "bfloat16"),
                # the bf16 wgmma kernel's edges: D padded to 16 and to
                # 64, G = 3 at S = 511 (63 of 64 rows), G = 64, S = 37
                ((2, 300, k, g, 8), 0, "bfloat16"),
                ((2, 300, k, g, 40), 0, "bfloat16"),
                ((b, 511, k, 3, d), 0, "bfloat16"),
                ((1, 130, 2, 64, 32), 0, "bfloat16"),
                ((2, 37, k, g, d), 0, "bfloat16")]:
            cases.append(prefill_case(shape, window, dt))
        # the split-KV kernel's edges, each with the splits it must take:
        # valid_len 1 (split 0 alone live), W, on a split boundary
        # (W / 2), 0 (all W entries, equal weights) and past W; W = 37
        # (one split); G = 1, G = 64, D = 8, D = 128 (eight splits of
        # B K = 8); B K = 1024 (one split)
        for q_shape, cache_w, vl, dts, want_splits in [
                ((b, k, g, d), w, 1, ("float32", "bfloat16"), 4),
                ((b, k, g, d), w, w, ("float32", "bfloat16"), 4),
                ((b, k, g, d), w, w // 2, ("float32",), 4),
                ((b, k, g, d), w, 0, ("float32", "bfloat16"), 4),
                ((b, k, g, d), w, w + 5, ("float32",), 4),
                ((b, k, g, d), 37, 30, ("float32", "bfloat16"), 1),
                ((2, 16, 1, d), 300, 257, ("float32",), 4),
                ((1, 2, 64, 32), 200, 150, ("float32", "bfloat16"), 4),
                ((b, k, g, 8), w, w - 14, ("float32", "bfloat16"), 4),
                ((1, 8, 8, 128), 1000, 999, ("float32", "bfloat16"), 8),
                ((32, 32, g, d), 256, 200, ("float32", "bfloat16"), 1)]:
            for dt in dts:
                r = decode_case(q_shape, cache_w, vl, dt)
                if r["splits"] != want_splits:
                    fail(f"decode_attention {r['desc']}: want "
                         f"{want_splits} splits")
                cases.append(r)
    if cfg.is_moe:
        # moe_gemm's variants at their edges: the C tail of 128-row tiles
        # at granite's D, a D tail inside one expert, F = 8, D and F not
        # a multiple of 8 (general in bf16), C = 12 with D split, and
        # granite's decode through the stream variant's other row count
        for x_shape, f in [((2, 508, 1536), 64), ((3, 40, 40), 64),
                           ((2, 32, 64), 8), ((2, 24, 30), 12),
                           ((4, 12, 1024), 256), ((40, 16, 1536), 512)]:
            cases += [moe_case(x_shape, f, dt)
                      for dt in ("float32", "bfloat16")]
    if cfg.is_ssm:      # a 1024-token prompt: Q = 256, four chunks each
        shape = (LM_BATCH * 4, 256, cfg.ssm_heads, cfg.ssm_head_dim,
                 cfg.ssm_state)
        cases += [ssd_case(shape, dt) for dt in ("float32", "bfloat16")]
    return cases


def _lm_agreement(cfg, params, prompt, toks, dtype_name, hold=True) -> None:
    """Prefill and each teacher-forced decode step of the kernel path
    against ``backend="torch"`` on the same weights, fed the kernel
    path's tokens.  fp32: logits within LM_LOGIT_TOL x max|logit|, and
    the kernel path's greedy token equal to the plain path's wherever
    the plain path's top-2 gap exceeds twice that; bf16: the band only.
    With ``hold`` false the band is printed, not enforced.
    """
    import torch
    from repro_torch.models.transformer import model as M
    from repro_torch.serving import lm

    rel = LM_LOGIT_TOL[dtype_name]
    V = cfg.vocab_size
    (lc, cc), (lt, ct) = (lm.prefill_prompt(cfg, params, prompt, LM_NEW,
                                            backend=be)
                          for be in ("cuda", "torch"))
    worst, n_differ = 0.0, 0
    for i in range(LM_NEW + 1):
        lc, lt = lc[:, :V].float(), lt[:, :V].float()
        if not bool(torch.isfinite(lc).all()):
            fail(f"{dtype_name} logits not finite at step {i}")
        tol = rel * lt.abs().max().item()
        diff = (lc - lt).abs().max().item()
        worst = max(worst, diff / tol)
        if diff > tol and hold:
            fail(f"{dtype_name} {'prefill' if i == 0 else f'decode {i}'} "
                 f"logits differ by {diff:.3g} > {tol:.3g} from the torch "
                 f"backend")
        if i and dtype_name == "float32":
            top2 = lt.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
            same = lt.argmax(dim=-1) == toks[:, i - 1].long()
            if hold and bool((sure & ~same).any()):
                fail(f"greedy token of decode step {i} differs from the "
                     f"torch backend where its top-2 gap exceeds 2 x tol")
            n_differ += int((~same).sum())
        if i == LM_NEW:
            break
        tok = prompt[:, -1] if i == 0 else toks[:, i - 1]
        (lc, cc), (lt, ct) = (
            M.decode_step(cfg, params, c, {"token": tok}, backend=be)
            for c, be in ((cc, "cuda"), (ct, "torch")))
    held = "within" if hold else "not held; worst"
    print(f"[slice] {cfg.name} {dtype_name} logits vs torch backend: "
          f"prefill and {LM_NEW} teacher-forced decode steps, {held} "
          f"{rel:g} x max|logit| (worst {worst:.3f} of the limit)"
          + (f"; greedy tokens: {n_differ} of {LM_BATCH * LM_NEW} "
             f"differ from the plain path's"
             + (", none where its top-2 gap exceeds 2 x tol" if hold
                else "")
             if dtype_name == "float32" else "; bf16: logit band only"))


def _gated_terms(moe, p, x, top_k, capacity_factor):
    """sum_k gate_k |y_k| for each output element of the plain MoE layer:
    the layer run with its last expert product (w2) taken in absolute
    value, so the combine adds magnitudes."""
    from repro_torch.kernels.moe_gemm import ref as moe_ref

    plain, calls = moe_ref.moe_gemm_ref, [0]

    def abs_w2(xe, w):
        calls[0] += 1
        y = plain(xe, w)
        return y.abs() if calls[0] == 3 else y   # w1, w3, then w2

    moe_ref.moe_gemm_ref = abs_w2
    try:
        return moe(p, x, top_k, capacity_factor, backend="torch")[0]
    finally:
        moe_ref.moe_gemm_ref = plain


def _moe_agreement(cfg, params, prompt, toks, dtype_name) -> None:
    """granite: each MoE layer of the kernel path against the plain
    version on the same input (router, top-k and dispatch are shared;
    only the expert GEMMs differ), over the prefill and every
    teacher-forced decode step; then the logits end to end, with the
    routing decisions (a token's top-k set in a layer) that differ
    between the two backends counted.

    fp32: FP32_TOL x max(1, max|ref|).  bf16, per element:
    |out - ref| <= BF16_TOL x (sum_k gate_k |y_k| + rms(ref)).  Each
    output sums k gated expert rows, each rounded to bf16 (and to bf16
    again after the gate) in both paths from fp32 sums taken in other
    orders: a one-ulp flip (2^-7 relative at most) of a term as large as
    the terms' own magnitude, which can cancel to a small |ref|; the rms
    term is an ulp flip of h or u carried through the w2 product.

    Top-k routing is discrete: a one-ulp difference in an expert output
    can move a near-tie of the router in a later layer, and then that
    token's whole MoE output differs.  In fp32 the logits are held to
    LM_LOGIT_TOL all the same.  In bf16 the ulp is 2^-8 and near-ties
    move often; the end-to-end difference is then a count of flipped
    routes and not a tolerance, so it is printed and not held: the
    per-layer check above is the kernel's test.
    """
    import torch
    from repro_torch.models.transformer import model as M

    real = M.moe
    routes = {"cuda": [], "torch": []}
    per_layer = {"n": 0, "bad": 0, "worst": 0.0, "err": 0.0}

    def checking(p, x, top_k, capacity_factor=1.25, backend="cuda"):
        out, aux = real(p, x, top_k, capacity_factor, backend=backend)
        probs = torch.softmax((x @ p.router).float(), dim=-1)
        routes[backend].append(
            torch.topk(probs, top_k, dim=-1).indices.sort(dim=-1).values)
        if backend == "cuda":
            plain, _ = real(p, x, top_k, capacity_factor, backend="torch")
            if x.dtype == torch.float32:
                err, of_limit, ok = check_close(out, plain, x.dtype)
            else:
                diff = (out.float() - plain.float()).abs()
                limit = BF16_TOL * (
                    _gated_terms(real, p, x, top_k, capacity_factor).float()
                    + plain.float().square().mean().sqrt())
                err, of_limit = diff.max().item(), (diff / limit).max().item()
                ok = of_limit <= 1.0 and bool(torch.isfinite(out).all())
            per_layer["n"] += 1
            per_layer["bad"] += not ok
            per_layer["worst"] = max(per_layer["worst"], of_limit)
            per_layer["err"] = max(per_layer["err"], err)
        return out, aux

    M.moe = checking
    try:
        _lm_agreement(cfg, params, prompt, toks, dtype_name,
                      hold=dtype_name == "float32")
    finally:
        M.moe = real
    flips = sum(int((a != b).any(dim=-1).sum())
                for a, b in zip(routes["cuda"], routes["torch"]))
    total = sum(a.shape[0] * a.shape[1] for a in routes["cuda"])
    print(f"[slice] {cfg.name} {dtype_name} MoE layers, kernel vs plain "
          f"expert GEMMs on the same inputs: {per_layer['n']} calls, max "
          f"|error| {per_layer['err']:.3g} (worst {per_layer['worst']:.3f} "
          f"of the limit); routing decisions that differ between the two "
          f"backends end to end: {flips} of {total}")
    if per_layer["bad"]:
        fail(f"{per_layer['bad']} {dtype_name} MoE layer call(s) disagree "
             f"with the plain expert GEMMs")


def _decode_profile(cfg, params, prompt, dtype_name, alone_ms=None,
                    steps: int = 4) -> None:
    """Where a decode step's time goes: ``torch.profiler`` over a few
    steps; kernels launched per step, the card's busy time and the top
    kernels by time; with ``alone_ms`` (moe_gemm's mean device time a
    decode launch, timed alone) also moe_gemm's device time inside the step
    beside it.  A diagnostic: nothing here is checked."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.transformer import model as M
    from repro_torch.serving import lm

    _, cache = lm.prefill_prompt(cfg, params, prompt, LM_NEW)
    tok = prompt[:, -1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = M.decode_step(cfg, params, cache, {"token": tok})
            tok = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if busy_ms <= 0:
        print(f"[profile] {cfg.name} {dtype_name} decode step: the profiler "
              f"saw no device time; busy share not measured")
        return
    launches = sum(e.count for e in kernels) / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    print(f"[profile] {cfg.name} {dtype_name} decode step (torch.profiler, "
          f"{steps} steps): {launches:.0f} kernels per step, device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f}%); top: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3 / steps:.3f} ms"
              for e in top))
    if alone_ms is not None:
        moe = [e for e in kernels if "moe_gemm" in e.key]
        n = sum(e.count for e in moe)
        in_ms = sum(e.self_device_time_total for e in moe) / 1e3
        if n:
            print(f"[profile] {cfg.name} {dtype_name} moe_gemm inside the "
                  f"decode step: {in_ms / steps:.3f} ms a step over "
                  f"{n / steps:.0f} launches, {1e3 * in_ms / n:.2f} us a "
                  f"launch; alone (warm L2, device time, profiler) "
                  f"{1e3 * alone_ms:.2f} us a launch")


def _describe(cfg) -> str:
    if cfg.is_ssm:
        return (f"{cfg.n_layers} Mamba2 layers, d {cfg.d_model}, d_inner "
                f"{cfg.d_inner}, N {cfg.ssm_state}, {cfg.ssm_heads} heads of "
                f"{cfg.ssm_head_dim}, conv {cfg.ssm_conv}")
    moe = (f", {cfg.n_experts} experts of ff {cfg.d_ff}, top-"
           f"{cfg.moe_top_k}" if cfg.is_moe else f", ff {cfg.d_ff}")
    return (f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} "
            f"q-heads, {cfg.n_kv_heads} kv-heads, hd {cfg.hd}{moe}")


def run_lm(arch: str) -> dict[str, dict]:
    """Phases 3 and 5 for one LM: the serving path of ``arch`` at full
    width.  Returns the ``kernels`` entries of its kernels, summed over
    its counted fp32 generate."""
    import torch
    from repro_torch import configs
    from repro_torch.models.transformer import model as M
    from repro_torch.serving import lm

    cfg = configs.get(arch)
    names = LM_FAMILIES[arch]
    ops = _kernel_ops()
    # the same draws (seed 0) in both dtypes: bf16 is the fp32 set rounded
    params = {dt: M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
        dtype=getattr(torch, dt)) for dt in ("float32", "bfloat16")}
    prompt = torch.randint(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1))
    print(f"[lm] {cfg.name}: {_describe(cfg)}, vocab {cfg.vocab_size} "
          f"padded to {cfg.vocab_padded}, {cfg.param_count() / 1e9:.2f} G "
          f"params; batch {LM_BATCH}, prompt {LM_PROMPT}, {LM_NEW} new "
          f"tokens, greedy")

    # shapes the path gives the kernels: one warm-up generate per dtype
    launched = _record_shapes(names, lambda: [
        lm.generate(cfg, p, prompt, LM_NEW) for p in params.values()])

    # -- 3. kernel vs plain on the card ----------------------------------
    vls = sorted({a for (n, _, a, _) in launched if n == "decode_attention"})
    # Llama holds every valid length; granite the first, every eighth and
    # the last
    held_vl = set(vls if arch == LM_ARCH else vls[::8] + vls[-1:])
    cases = []
    for (name, shape, arg, dt), cnt in sorted(launched.items()):
        if name == "decode_attention" and arg not in held_vl:
            continue
        r = CASES[name](shape, arg, dt)
        r["per_call"] = cnt
        cases.append(r)
    cases += _extra_cases(cfg)
    print(f"[kernel] {cfg.name}: {len(cases)} cases of {', '.join(names)}: "
          f"shape, dtype, launches per generate | max_abs_err (worst error "
          f"/ its limit) | ms kernel / plain / library / bound (CUDA "
          f"events around 20 calls); flash_prefill and moe_gemm also | "
          f"device ms kernel / library (torch.profiler, kernels only)"
          + (f"; decode_attention held at valid lengths {sorted(held_vl)} "
             f"of {len(vls)}" if len(held_vl) < len(vls) else ""))
    _print_cases(cases)
    bad = [r for r in cases if not r["ok"]]
    if bad:
        fail(f"{len(bad)} {cfg.name} kernel case(s) disagree with the plain "
             f"version")

    # -- 5. the path, counted, per dtype ----------------------------------
    want = _want_launches(cfg, names)
    launches, tokens = {}, {}
    for dt, p in params.items():
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = lm.generate(cfg, p, prompt, LM_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        got = {n: ops[n].launch_count(n) for n in names}
        print(f"[slice] {cfg.name} {dt} generate: " + ", ".join(
            f"{n} launches {got[n]} (want {want[n]})" for n in names))
        if got != want:
            fail(f"{cfg.name} {dt} generate launched {got}, want {want}")
        if "moe_gemm" in names:
            _check_variants(cfg, dt, ops["moe_gemm"].variant_counts)
        launches[dt] = got
        if tuple(toks.shape) != (LM_BATCH, LM_NEW) or \
                int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            fail(f"{dt} tokens: shape {tuple(toks.shape)}, range "
                 f"{int(toks.min())}..{int(toks.max())}")
        tokens[dt] = toks
        reps = 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            lm.prefill_prompt(cfg, p, prompt, LM_NEW)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) / reps * 1e3
        dec_ms = (gen_s * 1e3 - pre_ms) / LM_NEW
        print(f"[slice] {cfg.name} {dt}: generate {gen_s * 1e3:.1f} ms "
              f"({LM_BATCH * LM_NEW / gen_s:.1f} new tokens/s); prefill of "
              f"{LM_PROMPT - 1} tokens x {LM_BATCH} {pre_ms:.2f} ms (mean of "
              f"{reps}); decode {dec_ms:.3f} ms per step of {LM_BATCH} "
              f"tokens (generate less prefill, over {LM_NEW} steps; host "
              f"clock around synchronized runs)")

    # -- 5b. agreement with the plain path; where a decode step goes ------
    for dt, p in params.items():
        if cfg.is_moe:
            _moe_agreement(cfg, p, prompt, tokens[dt], dt)
        else:
            _lm_agreement(cfg, p, prompt, tokens[dt], dt)
        dec = [r for r in cases if r["kernel"] == "moe_gemm"
               and r["per_call"] and r["dtype"] == dt
               and r["desc"].startswith(f"x({cfg.n_experts}, {LM_BATCH},")]
        alone = (sum(r["dev_ms"] * r["per_call"] for r in dec)
                 / sum(r["per_call"] for r in dec)) if dec else None
        _decode_profile(cfg, p, prompt, dt, alone)
    del params
    torch.cuda.empty_cache()

    # -- the kernels' entries: one fp32 generate ---------------------------
    out = {}
    for name in names:
        path = [r for r in cases if r["kernel"] == name and r["per_call"]
                and r["dtype"] == "float32"]
        bf = [r for r in cases if r["kernel"] == name and r["per_call"]
              and r["dtype"] == "bfloat16"]

        def total(rows, key):
            if any(r[key] is None for r in rows):
                return None
            return sum(r[key] * r["per_call"] for r in rows)

        t_ops, t_bytes = total(path, "t_ops_ms"), total(path, "t_bytes_ms")
        out[name] = {
            "name": name, "route": "cuda",
            "source": str(ops[name].SOURCES[name].relative_to(ROOT)),
            "replaces": REPLACES[name],
            "launches": launches["float32"][name],
            "max_abs_err": max(r["err"] for r in path),
            **{key: total(path, key)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
        held = sum(r["per_call"] for r in path)
        lib = total(bf, "library_ms")
        print(f"[kernels] {cfg.name} {name}: fp32 over {held} of "
              f"{launches['float32'][name]} launches: ms "
              f"{out[name]['ms']:.4f}, bound {out[name]['bound_ms']:.5f}; "
              f"bf16 ms {total(bf, 'ms'):.4f}, plain "
              f"{total(bf, 'plain_ms'):.4f}, library "
              f"{'-' if lib is None else f'{lib:.4f}'}, bound "
              f"{total(bf, 'bound_ms'):.5f}")
        if all("dev_ms" in r for r in path + bf):
            print(f"[kernels] {cfg.name} {name} device time (profiler) "
                  f"over the same launches: fp32 {total(path, 'dev_ms'):.4f}"
                  f", library {total(path, 'library_dev_ms'):.4f}; bf16 "
                  f"{total(bf, 'dev_ms'):.4f}, library "
                  f"{total(bf, 'library_dev_ms'):.4f}")
        if name == "moe_gemm":      # the split by variant, per dtype
            for dt, rows in (("float32", path), ("bfloat16", bf)):
                for v in sorted({r["variant"] for r in rows}):
                    vr = [r for r in rows if r["variant"] == v]
                    lib = total(vr, "library_ms")
                    print(f"[kernels] {cfg.name} moe_gemm {dt} {v}: "
                          f"{sum(r['per_call'] for r in vr)} launches, ms "
                          f"{total(vr, 'ms'):.4f}, library "
                          f"{'-' if lib is None else f'{lib:.4f}'}, bound "
                          f"{total(vr, 'bound_ms'):.5f}; device "
                          f"{total(vr, 'dev_ms'):.4f}, library "
                          f"{total(vr, 'library_dev_ms'):.4f}")
    return out


def _entry_name(mangled: str) -> str:
    """A readable name for a mangled kernel entry: the function's name
    and its template arguments (types, ints and bools), e.g.
    ``moe_gemm_stream<bf16,4>``."""
    import re
    rest = mangled.removeprefix("_ZN").removeprefix("_Z")
    name = mangled
    while m := re.match(r"(\d+)", rest):
        n, k = int(m.group(1)), len(m.group(1))
        name, rest = rest[k:k + n], rest[k + n:]
        if not name.startswith("_GLOBAL__N"):   # skip the unnamed namespace
            break
    if not rest.startswith("I"):
        return name
    args = []
    for tok in re.finditer(r"Li(-?\d+)E|Lb([01])E|13__nv_bfloat16|f(?=[LE1])",
                           rest):
        args.append(tok.group(1) if tok.group(1) is not None
                    else ("false", "true")[int(tok.group(2))]
                    if tok.group(2) is not None
                    else "bf16" if "bfloat16" in tok.group(0) else "float")
        if rest[tok.end():].startswith("EE"):
            break
    return f"{name}<{','.join(args)}>"


def _ptxas_summary(log: str) -> list[str]:
    """One line per kernel entry from ``nvcc -Xptxas -v``'s output:
    registers, shared memory (static) and spill bytes."""
    import re
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _entry_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spills {m.group(1)} / {m.group(2)} bytes"
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, "
                       f"{m.group(2) or 0} bytes static smem, "
                       f"{spill or 'spills not reported'}")
            name, spill = None, ""
    return out


def build_all(sources) -> None:
    """Phase 2: one ``nvcc`` per source, all started together; one
    ``[build]`` line per kernel entry with its registers, static shared
    memory and spills (``-Xptxas -v``)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(_build.build, sources))
    print(f"[build] {len(paths)} kernels in {time.perf_counter() - t0:.1f} s "
          f"wall (parallel nvcc)")
    for lib_path in paths:
        build_s, log = _build.BUILD_LOG[lib_path.name]
        print(f"[build] {lib_path.name}: {build_s:.1f} s nvcc")
        for line in _ptxas_summary(log):
            print(f"[build]   {line}")


def run_cnn() -> dict:
    """Phases 3-4 for the conv kernel: the CNN main path.  Returns the
    kernel's entry of the ``kernels`` line."""
    import torch
    import repro_torch
    from repro_torch.api.specs import ExecSpec, PlanSpec
    from repro_torch.core import make_pi_cluster
    from repro_torch.kernels.conv2d import ops
    from repro_torch.models.cnn import zoo

    # -- 4a. the deployment (planned before phase 3: its shapes) --------
    model = zoo.vgg16(input_size=(224, 224), scale=1.0, head=True)
    cluster = make_pi_cluster(CLUSTER_GHZ)
    dep = repro_torch.compile(model, cluster, PlanSpec(),
                              ExecSpec(backend="cuda"))
    print(dep.describe())
    dep.load_params(torch.Generator().manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    frames = list(torch.randn((8, 1, 224, 224, 3), generator=g,
                              device="cuda"))
    planned = sum(
        sum(model.graph.layers[n].kind == "conv" for n in ex.nodes)
        for ex in dep.runner.stages for tp in ex.plans if not tp.empty)
    if planned <= 0:
        fail("the plan launches no conv kernel")

    # shapes the main path gives the kernel: one warm-up pass of each
    # form with a recording wrapper (these launches are not counted);
    # `order` keeps the single-frame call's launches in order
    launched: dict[tuple, int] = {}
    order: list[tuple] = []
    real = ops.conv2d_fused

    def recording(x, w, b=None, *, stride=(1, 1), relu=False, pool=None):
        key = (tuple(x.shape), tuple(w.shape), ops.normalize_stride(stride),
               None if pool is None else tuple(pool), relu, b is not None,
               str(x.dtype).removeprefix("torch."))
        launched[key] = launched.get(key, 0) + 1
        if x.shape[0] == 1:
            order.append(key)
        return real(x, w, b, stride=stride, relu=relu, pool=pool)

    ops.conv2d_fused = recording
    try:
        dep.run(frames[0])
        dep.run(frames)
    finally:
        ops.conv2d_fused = real
    torch.cuda.synchronize()
    per_call = sum(c for k, c in launched.items() if k[0][0] == 1)
    print(f"[plan] {planned} kernel launches per runner call, "
          f"{sum(c for k, c in launched.items() if k[0][0] == 1 and k[3])} "
          f"of them with a fused pool; {len(launched)} distinct shapes "
          f"over both forms")
    if per_call != planned:
        fail(f"one runner call launched {per_call} kernels, plan says "
             f"{planned}")

    # -- 3. kernel vs plain on the card ----------------------------------
    cases = []
    for (xs, ws, st, pool, relu, bias, dt), cnt in launched.items():
        r = conv_case(xs, ws, st, pool, dt, relu=relu, bias=bias)
        r["per_call"] = cnt if xs[0] == 1 else 0
        cases.append(r)
    # the path's shapes also with the fused pool toggled, and edge cases
    for (xs, ws, st, pool, relu, bias, dt) in list(launched):
        if xs[0] == 1:
            cases.append(conv_case(xs, ws, st, None if pool else (2, 2), dt))
    for xs, ws, st, pool, dt in [
            ((1, 57, 57, 64), (3, 3, 64, 128), (2, 2), None, "float32"),
            ((1, 56, 56, 64), (1, 1, 64, 128), (2, 2), None, "float32"),
            ((1, 230, 230, 3), (7, 7, 3, 64), (2, 2), None, "float32"),
            ((1, 17, 23, 192), (1, 7, 192, 160), (1, 1), None, "float32"),
            ((1, 23, 17, 160), (7, 1, 160, 192), (1, 1), None, "float32"),
            ((1, 20, 22, 16), (3, 3, 16, 24), (1, 1), (3, 3), "float32"),
            ((1, 58, 58, 128), (3, 3, 128, 256), (1, 1), (2, 2),
             "bfloat16")]:
        cases.append(conv_case(xs, ws, st, pool, dt))
    # the plan's edges, each with the plan it must take: launch 15 (S = 8,
    # 2x2 pool); K = 1800, no multiple of S BK (CI = 200 not one of BK
    # either); CI = 12 (a slice spans several (dh, dw)) with a split;
    # CI = 3 and CI = 13 / CO = 70 (general); a 3x3 pool in 128-row
    # tiles; bf16 with a split
    for xs, ws, pool, dt, want in [
            ((1, 16, 16, 512), (3, 3, 512, 512), (2, 2), "float32",
             ("ring", (64, 64), 8)),
            ((1, 16, 16, 200), (3, 3, 200, 256), None, "float32",
             ("ring", (64, 64), 8)),
            ((1, 24, 24, 12), (5, 5, 12, 32), None, "float32",
             ("ring", (64, 64), 4)),
            ((1, 60, 60, 3), (3, 3, 3, 64), None, "float32",
             ("general", (64, 64), 1)),
            ((2, 31, 29, 13), (3, 3, 13, 70), (2, 2), "float32",
             ("general", (64, 64), 2)),
            ((1, 100, 100, 32), (3, 3, 32, 64), (3, 3), "float32",
             ("ring", (128, 64), 4)),
            ((1, 30, 30, 512), (3, 3, 512, 512), (2, 2), "bfloat16",
             ("ring", (128, 64), 4))]:
        r = conv_case(xs, ws, (1, 1), pool, dt)
        if tuple(r["plan"]) != want:
            fail(f"conv plan {_plan_text(r['plan'])} for x{xs} w{ws} "
                 f"p{pool}, want {want}")
        cases.append(r)
    print(f"[kernel] {len(cases)} cases: x, w, stride, pool, dtype, plan "
          f"(variant, tile, split S) | max_abs_err (worst error / its "
          f"limit), same bits on two calls | ms kernel / plain / library "
          f"/ bound (CUDA events around 20 calls) | device ms kernel / "
          f"library (torch.profiler)")
    for r in cases:
        print(f"  {'ok ' if r['ok'] else 'BAD'} x{r['x']} w{r['w']} "
              f"s{r['stride']} p{r['pool']} {r['dtype']} "
              f"{_plan_text(r['plan'])} (ran {'/'.join(r['ran'])}) | "
              f"{r['err']:.3g} ({r['of_limit']:.2f} of limit)"
              f"{'' if r['same'] else ' NOT BIT-REPRODUCIBLE'} | "
              f"{r['ms']:.4f} / {r['plain_ms']:.4f} / {r['library_ms']:.4f}"
              f" / {r['bound_ms']:.4f} ({r['bound_by']}) | device "
              f"{r['dev_ms']:.4f} / {r['library_dev_ms']:.4f}")
    bad = [r for r in cases if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel case(s) disagree with the plain version, "
             f"repeat no bits or ran another variant")

    # the launches of one single-frame runner call, in order
    by_key = {(r["x"], r["w"], r["stride"], r["pool"], r["dtype"]): r
              for r in cases[:len(launched)]}
    print("[conv] the launches of one single-frame runner call: x, w, pool "
          "| plan | ms kernel (events) / device ms kernel / cuDNN device ms "
          "/ bound ms | bound over device ms")
    sums = dict.fromkeys(("ms", "dev_ms", "library_dev_ms", "bound_ms"), 0.0)
    for i, (xs, ws, st, pool, relu, bias, dt) in enumerate(order, 1):
        r = by_key[(xs, ws, st, pool, dt)]
        for key in sums:
            sums[key] += r[key]
        print(f"  {i:2d} x{xs} w{ws} p{pool} | {_plan_text(r['plan'])} | "
              f"{r['ms']:.4f} / {r['dev_ms']:.4f} / "
              f"{r['library_dev_ms']:.4f} / {r['bound_ms']:.4f} | "
              f"{100 * r['bound_ms'] / r['dev_ms']:.1f}%")
    print(f"  sum of {len(order)}: {sums['ms']:.4f} / {sums['dev_ms']:.4f} "
          f"/ {sums['library_dev_ms']:.4f} / {sums['bound_ms']:.4f} | "
          f"{100 * sums['bound_ms'] / sums['dev_ms']:.1f}%")

    # -- 4b. the main path, counted --------------------------------------
    reps = 10
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        one = dep.run(frames[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        many = dep.run(frames)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ops.launch_count()
    ms_one = (t1 - t0) / reps * 1e3
    ms_many = (t2 - t1) / reps / len(frames) * 1e3
    print(f"[slice] conv2d_fused launches {launches} "
          f"(plan: {planned} x {2 * reps} runner calls)")
    if launches <= 0 or launches != planned * 2 * reps:
        fail(f"kernel launches {launches} != {planned} x {2 * reps}")
    print(f"[slice] dep.run(frame): {ms_one:.3f} ms/frame; "
          f"dep.run([{len(frames)} frames]): {ms_many:.3f} ms/frame "
          f"(host clock around synchronized runs)")

    # -- 4c. the outputs -------------------------------------------------
    sink = model.graph.sinks()[0]
    logits = torch.stack([o[sink] for o in many])
    if tuple(logits.shape) != (len(frames), 1, 1, 1, 1000):
        fail(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail("logits not finite")
    dep_t = repro_torch.compile(model, cluster, PlanSpec(),
                                ExecSpec(backend="torch"), params=dep.params)
    ref_t = torch.stack([o[sink] for o in dep_t.run(frames)])
    ref_m = model.forward(dep.params, torch.cat(frames))[sink].unsqueeze(1)
    scale = ref_t.abs().max().item()
    tol = LOGIT_TOL * scale
    d_t = (logits - ref_t).abs().max().item()
    d_m = (logits - ref_m).abs().max().item()
    d_1 = (one[sink] - logits[0]).abs().max().item()
    print(f"[slice] logits {tuple(logits.shape)} finite; max |diff| vs "
          f"torch backend {d_t:.3g}, vs monolithic forward {d_m:.3g}, "
          f"one frame vs batch-folded {d_1:.3g} (limit {tol:.3g} = "
          f"{LOGIT_TOL:g} x max |logit| {scale:.3g})")
    if not (d_t <= tol and d_m <= tol and d_1 <= tol):
        fail("logits disagree")

    path = [r for r in cases if r["per_call"]]
    t_ops = sum(r["t_ops_ms"] * r["per_call"] for r in path)
    t_bytes = sum(r["t_bytes_ms"] * r["per_call"] for r in path)
    print("[kernels] conv2d_fused: ms, plain_ms, bound_ms, library_ms "
          "summed over the launches of one single-frame runner call; "
          "max_abs_err over those shapes; device time (profiler) over the "
          f"same launches: {sum(r['dev_ms'] * r['per_call'] for r in path):.4f}"
          f", cuDNN {sum(r['library_dev_ms'] * r['per_call'] for r in path):.4f}")
    return {
        "name": "conv2d_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/conv2d/csrc/conv2d_fused.cu",
        "replaces": REPLACES["conv2d_fused"], "launches": launches,
        "max_abs_err": max(r["err"] for r in path),
        "ms": sum(r["ms"] * r["per_call"] for r in path),
        "plain_ms": sum(r["plain_ms"] * r["per_call"] for r in path),
        "bound_ms": sum(r["bound_ms"] * r["per_call"] for r in path),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(r["library_ms"] * r["per_call"] for r in path),
    }


def main() -> None:
    # the port's package comes from this checkout; alone, the script
    # stops here with an ImportError and prints nothing
    import torch
    from repro_torch.kernels.conv2d import ops as conv_ops

    # -- 1. the card ---------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs "
             "the GPU and does not fall back to the CPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TF32 off for matmul and cuDNN")

    # -- 2. build --------------------------------------------------------
    lm_sources = {mod.SOURCES[n] for n, mod in _kernel_ops().items()}
    build_all([conv_ops.SOURCE, *sorted(lm_sources)])

    # -- 3./4./5. the CNN path, then each LM path ------------------------
    t0 = time.perf_counter()
    kernels = [run_cnn()]
    print(f"[time] CNN phases {time.perf_counter() - t0:.1f} s")
    entries = {}
    for arch in LM_FAMILIES:
        t0 = time.perf_counter()
        got = run_lm(arch)
        # the attention kernels' entries stay Llama's (comparable with
        # earlier runs); granite's attention launches are in its lines
        entries.update({n: e for n, e in got.items() if n not in entries})
        print(f"[time] {arch} phases {time.perf_counter() - t0:.1f} s")
    kernels += [entries[n] for n in ("flash_prefill", "decode_attention",
                                     "ssd_chunk", "moe_gemm")]
    print("[kernels] ssd_chunk: library_ms null: no single PyTorch call "
          "computes the intra-chunk SSD; moe_gemm: library_ms is torch.bmm "
          "on the same (E, C, D) x (E, D, F)")

    # -- 6. result lines -------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
