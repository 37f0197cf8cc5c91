#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases (each exits non-zero on failure; nothing is caught and skipped):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions.  No CUDA device: exit 1, no result;
2. build of every kernel of the main path from the sources in the
   checkout (``nvcc``, ``sm_90a``), with its build time;
3. each kernel against its plain PyTorch version on the card, at every
   shape the main path launches plus edge cases, with times for the
   kernel, the plain version, one library call and the card's bound;
4. the main path: ``repro_torch.compile(vgg16 full width, 8-Pi cluster)``
   then ``Deployment.run`` on one frame and on a list of 8 frames.  The
   kernels' launch counters are reset just before and read just after;
   the logits are checked for shape, finiteness and agreement with the
   ``"torch"`` backend and the monolithic forward;
5. one ``{"kernels": [...]}`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

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
BF16_TOL = 2e-2      # x max|ref|: one bf16 rounding of the output
LOGIT_TOL = 1e-4     # x max|logit|: 13 fp32 convs summed in other orders
REPLACES = "src/repro/kernels/conv2d/conv2d.py:110"
CLUSTER_GHZ = [1.5, 1.5, 1.2, 1.2, 1.0, 1.0, 0.8, 0.8]


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


def conv_case(x_shape, w_shape, stride, pool, dtype_name, relu=True,
              bias=True, seed=0):
    """One kernel-vs-plain case on the card; returns a result dict."""
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
    y = ops.conv2d_fused(x, w, b, **kw_args)
    y_ref = ref.conv2d_fused_ref(x, w, b, **kw_args)
    torch.cuda.synchronize()
    if y.shape != y_ref.shape:
        fail(f"shape {tuple(y.shape)} != plain {tuple(y_ref.shape)}")
    err = (y.float() - y_ref.float()).abs().max().item()
    scale = y_ref.float().abs().max().item()
    tol = (FP32_TOL * max(1.0, scale) if dtype == torch.float32
           else BF16_TOL * scale)
    ok = err <= tol and bool(torch.isfinite(y).all())

    # library yardstick: one cuDNN conv (+ bias) on channels-last views
    # of the same memory; the ReLU and pool are not in it
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    ms = time_ms(lambda: ops.conv2d_fused(x, w, b, **kw_args))
    plain_ms = time_ms(lambda: ref.conv2d_fused_ref(x, w, b, **kw_args))
    library_ms = time_ms(lambda: F.conv2d(xc, wc, b, stride=stride))

    n = x_shape[0]
    hp, wp = y.shape[1], y.shape[2]
    ph, pw = pool or (1, 1)
    flops = 2.0 * n * hp * ph * wp * pw * co * kh * kw * ci
    nbytes = sum(t.numel() * t.element_size()
                 for t in (x, w, b, y) if t is not None)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(x=tuple(x_shape), w=tuple(w_shape), stride=tuple(stride),
                pool=pool, dtype=dtype_name, err=err, tol=tol, ok=ok,
                per_call=0,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                t_ops_ms=t_ops * 1e3, t_bytes_ms=t_bytes * 1e3,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def main() -> None:
    # the port's package comes from this checkout; alone, the script
    # stops here with an ImportError and prints nothing
    import torch
    import repro_torch
    from repro_torch.api.specs import ExecSpec, PlanSpec
    from repro_torch.core import make_pi_cluster
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d import ops
    from repro_torch.models.cnn import zoo

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
    t0 = time.perf_counter()
    lib_path = _build.build(ops.SOURCE)
    build_s, log = _build.BUILD_LOG[lib_path.name]
    print(f"[build] {lib_path.name}: {build_s:.1f} s nvcc "
          f"({time.perf_counter() - t0:.1f} s with the cache check)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

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
    # form with a recording wrapper (these launches are not counted)
    launched: dict[tuple, int] = {}
    real = ops.conv2d_fused

    def recording(x, w, b=None, *, stride=(1, 1), relu=False, pool=None):
        key = (tuple(x.shape), tuple(w.shape), ops.normalize_stride(stride),
               None if pool is None else tuple(pool), relu, b is not None,
               str(x.dtype).removeprefix("torch."))
        launched[key] = launched.get(key, 0) + 1
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
            ((2, 31, 29, 13), (3, 3, 13, 70), (1, 1), (2, 2), "float32"),
            ((1, 20, 22, 16), (3, 3, 16, 24), (1, 1), (3, 3), "float32"),
            ((1, 58, 58, 128), (3, 3, 128, 256), (1, 1), (2, 2),
             "bfloat16")]:
        cases.append(conv_case(xs, ws, st, pool, dt))
    print(f"[kernel] {len(cases)} cases: x, w, stride, pool, dtype | "
          f"max_abs_err (tol) | ms kernel / plain / library / bound")
    for r in cases:
        print(f"  {'ok ' if r['ok'] else 'BAD'} x{r['x']} w{r['w']} "
              f"s{r['stride']} p{r['pool']} {r['dtype']} | {r['err']:.3g} "
              f"({r['tol']:.3g}) | {r['ms']:.4f} / {r['plain_ms']:.4f} / "
              f"{r['library_ms']:.4f} / {r['bound_ms']:.4f} "
              f"({r['bound_by']})")
    bad = [r for r in cases if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel case(s) disagree with the plain version")

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

    # -- 5. result lines -------------------------------------------------
    path = [r for r in cases if r["per_call"]]
    t_ops = sum(r["t_ops_ms"] * r["per_call"] for r in path)
    t_bytes = sum(r["t_bytes_ms"] * r["per_call"] for r in path)
    kernel = {
        "name": "conv2d_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/conv2d/csrc/conv2d_fused.cu",
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(r["err"] for r in path),
        "ms": sum(r["ms"] * r["per_call"] for r in path),
        "plain_ms": sum(r["plain_ms"] * r["per_call"] for r in path),
        "bound_ms": sum(r["bound_ms"] * r["per_call"] for r in path),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(r["library_ms"] * r["per_call"] for r in path),
    }
    print("[kernels] ms, plain_ms, bound_ms, library_ms: summed over the "
          "launches of one single-frame runner call; max_abs_err over "
          "those shapes")
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
