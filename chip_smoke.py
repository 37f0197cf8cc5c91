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
   (``torch.profiler``); every case also called twice, which must give
   the same bits; each conv case names its plan (variant, tile, split-K)
   and must run the planned variant, the conv, decode, ``ssd_chunk``
   and ``flash_prefill`` edge cases must take the plan (splits, heads a
   block, padded D and grid) they are listed with, each ``moe_gemm``
   case names its variant and each ``ssd_chunk`` and ``flash_prefill``
   case its plan (G, G', tiles, grid; rows, padded D, grid, tile order),
   held equal to the C side's; a table of the 15 conv launches
   of one runner call (plan, ms, device ms against cuDNN's, share of the
   bound);
4. the CNN path: ``repro_torch.compile(vgg16 full width, 8-Pi cluster)``
   then ``Deployment.run`` on one frame and on a list of 8 frames, each
   stage's body replayed from a CUDA graph.  The conv kernel's launch
   counter is reset just before and read just after (a graph's replays
   are credited with its launches); the logits are checked for shape,
   finiteness and agreement with the ``"torch"`` backend and the
   monolithic forward.  ``[graph]`` lines: each stage's replays equal
   its eager body bit for bit in both forms; ``dep.run`` ms/frame
   graphed and eager, in turns; parameter sets A, B, A each give their
   own eager outputs; an output handed out is unchanged by the next run.
   4c: the same model and cluster compiled with ``ExecSpec(backend=
   "cuda", calibrate=True, autotune=True)``: ``[autotune]`` a line per
   conv key (winner plan and its device us, the heuristic plan's us and
   the spread a winner must beat it by), ``[calibrate]`` the measured
   fp32 matmul rate beside the card's fp32 peak and its spread over ten
   more measurements, each stage's ms and ratio, the re-planned stages;
   saved and loaded with the planner, calibrator and tuner counted at
   zero; each launch that takes a tuned plan other than the heuristic's,
   held against the plain version at its shape under that plan;
   ``dep.run`` ms/frame under the default and the tuned plans in turns,
   and the tuned plans' difference, flagged where they were slower;
   the path counted again (launches reset just before, read just after);
   the loaded deployment's outputs equal the compiled one's bit for bit
   and the ``"torch"`` backend's within the logit tolerance; the
   ``[graph]`` checks again under the tuned plans.
   4d: ``Deployment.runtime`` with real compute on the same deployment
   (the event-driven cluster runtime): 24 seeded frames at half the
   plan's period, up to 4 coalesced at stage 0, the plan's slowest
   device leaving once a third have arrived.  ``[runtime]`` lines: 24
   completed, one ``leave`` re-plan, the conv launches of the run
   (reset just before, read just after), every frame's logits against
   the ``"torch"`` backend's monolithic forward, single-frame batches
   of the first plan equal to ``dep.run``'s stages bit for bit, each
   frame's stage outputs unchanged by later replays, virtual time equal
   to the timing-only run's, graphs captured under each plan, memory
   before and after the churn, wall ms/frame beside ``dep.run``'s.
   Then the abort run, traced: one device of stage 0 leaves in the
   middle of a coalesced batch (the first such ``stage.compute`` span
   once a third of the frames have arrived, from a traced timing-only
   run of the same arrivals; else a single-frame run of any stage), so
   the runtime aborts the batch and restarts its frames under the new
   plan.  ``[runtime]`` lines: what was aborted (stage, batch size,
   frame ids) and each frame re-run under the new plan, restarts equal
   to the timing-only run's and at least 1, 24 completed, 0 dropped, one
   ``leave`` re-plan, the conv launches of the run, the logits, virtual
   time, graphs and memory as in the first run, wall ms/frame; the
   run's trace is saved for 4g.
   4e: ``Deployment.fleet`` on the same deployment, one worker per stage.
   ``[dist]`` lines: ``repro_torch.dist.validate`` in thread mode over
   memory links, 8 frames bit-identical to the in-process runner and 0
   dropped, the observed/modeled compute ratios, and the conv launches
   of the dist run alone (reset just before, read before the in-process
   oracle starts: 15 x (8 frames + the warm-up probe)); then thread mode
   over memory, thread mode over TCP with two frames a message, and
   process mode (one spawned process per stage, TCP), each bit-identical
   to the in-process runner chunked the same way, with start and run
   ms/frame, bytes on each link, compute per stage, the device each
   worker named in its ready message (each a CUDA device), memory and
   captures; the ``"torch"`` backend not bit-equal to the kernel path;
   a killed-worker drill (DeviceLeave, drops with reasons, re-plan on
   the survivors, resubmission equal to the re-planned runner bit for
   bit); ``dep.run`` ms/frame beside the workers'.
   4f: ``[serve]`` lines: ``dep.server()`` and
   ``dep.server(streaming=True)`` serve 8 requests, outputs equal to
   ``dep.run``'s bit for bit and within the logit limit of the
   ``"torch"`` backend; then the multi-tenant scheduler on
   ``benchmarks/fig_serving_mt.py``'s two scenarios (squeezenet,
   mobilenetv3 and resnet34 at 224, scale 1.0, on the 8 Pis; load 2.0,
   then load 0.65 with the weakest device leaving at half the horizon)
   with real compute on the card: 0 dropped in flight, virtual time
   equal to the same scenario timing-only, every served frame's logits
   within the limit of its tenant's ``"torch"`` forward, the throughput
   ratio against time-sliced serving and the churn recovery (printed,
   not held at full width), conv launches and wall time.
   4g: ``[tools]`` lines: ``repro_torch.tools.plan.main`` in this
   process plans phase 4's configuration (VGG16 at full width on the 8
   Pis), saves it (the artifact equal to ``repro_torch.compile``'s with
   the same specs, the planner's wall times zeroed), then ``--load
   --validate --execute`` with the conv launches counted (reset just
   before, read just after); ``python -m repro_torch.tools.plan --load
   ... --validate --execute`` as a command with no ``--device`` (runs
   on the card: rc 0 and its "execute: ... match" line); ``python -m
   repro_torch.tools.trace`` on the abort run's trace: ``--validate``
   rc 0, then the summary (24 frames, one per-device row for each
   device that computed, the bubble fraction in [0, 1));
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
   stream); the decode steps after the first replay one CUDA graph,
   whose replays are credited with its launches; prefill and decode
   times; agreement with ``backend="torch"`` on the same weights
   (``_lm_agreement``, and for granite each MoE layer on shared inputs,
   ``_moe_agreement``); ``[graph]`` lines: replayed logits equal eager
   ``decode_step``'s bit for bit, the graphed generate's greedy tokens
   equal the eager loop's, decode ms/step graphed and eager in turns,
   capture ms; profiled decode steps, eager and replayed (with granite,
   moe_gemm's time inside the eager step).  Then zamba2-2.7b the same
   way (the hybrid: 54 ssd_chunk, 9 flash_prefill and 9 x 32
   decode_attention a generate, one attention a shared-block site), with
   its attention at D = 64 and 128 beside the path's D = 80 (padded to
   128: ``[pad]`` lines), and ``forward`` / ``loss_fn`` on its fp32
   weights (``[forward]`` lines: 54 ssd_chunk and 9 flash_prefill,
   counted; the last position against ``prefill``, the loss against
   ``backend="torch"``).  Last, the ``embeds`` input mode with
   musicgen-medium: seeded embeddings through ``prefill`` and 32
   ``Decoder`` steps (48 flash_prefill, 48 x 32 decode_attention),
   fp32 and bf16, its kernels held at the path's shapes, logits against
   ``backend="torch"``, replays bit-equal to eager;
6. training Llama-3.2-1B at full width in fp32 (``[train]`` lines):
   (a) the ``flash_prefill`` backward kernel (``flash_prefill_bwd``)
   against its plain version at the path's (4, 512, 8, 4, 64) and at
   G = 1, D = 80, D = 128, S = 511 and a window of 128, each within
   1e-4 x max|ref| per output and called twice for the same bits, with
   its ms, device ms, bound, plain ms and SDPA's backward beside it;
   (b) ``loss_fn`` and its gradient through the kernels against
   ``backend="torch"`` on the same weights and ``TokenStream`` batch
   (batch 4, seq 512): the loss within 1e-5 relative, every parameter
   leaf with a finite gradient within 1e-3 x max|g| of its leaf, the
   worst leaf named; (c) five AdamW steps through
   ``repro_torch.launch.train.main`` with the kernels counted (reset
   just before, read just after: 32 ``flash_prefill`` a step, 16 of the
   forward and 16 of remat's recompute, and 16 ``flash_prefill_bwd``),
   finite losses, step ms from step 2 on, tokens/s and peak memory, then
   one profiled step (device time by kernel, the backward kernel's
   share).  Then granite-moe-3b-a800m at full width in fp32: (a')
   ``moe_gemm``'s backward, ``MoeGemm``'s dx = dy wᵀ and dw = xᵀ dy
   (two more launches of the kernel, on transposed copies) against
   autograd of the plain version at granite's training shapes (x (40,
   512, 1536) against w (40, 1536, 512), and the w2 twin), at C = 12,
   C = 10 (no multiple of 4), C = 4 and mixtral's experts at C = 64,
   each within FP32_TOL x max(1, max|ref|) and called twice for the
   same bits, with each launch's variant, ms, device ms, plain ms, the
   library's (``torch.bmm`` on transposed views, no copies) and the
   bound; (b') ``loss_and_grads`` at full depth (32 layers) against
   ``backend="torch"`` as in (b): 384 ``moe_gemm`` (3 a layer forward,
   3 in remat's recompute, 6 backward), 64 ``flash_prefill`` and 32
   ``flash_prefill_bwd`` launches, the routing decisions that differ
   between the two paths counted, peak memory; (c') five steps of
   ``training.loop.train`` at 16 of the 32 layers (the functional
   AdamW holds about 8 copies of the params, so full depth needs about
   108 GB), counted: 960 ``moe_gemm``, each in the variant of its own
   shape, 160 ``flash_prefill`` and 80 ``flash_prefill_bwd``; finite
   losses, step ms, tokens/s and peak memory, then one profiled step
   with ``moe_gemm``'s device time in the forward, the recompute and
   the backward, and the transposed copies' share.  Then mamba2-370m
   and zamba2-2.7b at full width in fp32: (a″) ``ssd_chunk``'s backward
   kernel (``ssd_chunk_bwd``), ``SsdChunk``'s dx, ddt, dA, dB and dC
   against autograd of the plain version at mamba2's and zamba2's
   training folds (8, 256, 32, 64, 128) and (8, 256, 80, 64, 64), the
   forward's Q = 511 edge at one chunk, H = 6, P and N below 64, and a
   chunk whose decays sum past -100 (finite gradients where exp above
   the diagonal would overflow), each within FP32_TOL x max(1, max|ref|)
   and called twice for the same bits, its plan's grid, G and shared
   memory the C side's, with the wrapper's ms, device ms (the kernel's
   and the torch finish's apart), plain ms and the bound; (b″) and (b‴)
   ``loss_and_grads`` of mamba2 and of zamba2 at full depth against
   ``backend="torch"`` as in (b): 96 ``ssd_chunk`` (48 forward, 48 in
   remat's recompute) and 48 ``ssd_chunk_bwd``; zamba2 108, 54, 18
   ``flash_prefill`` and 9 ``flash_prefill_bwd``; (c″) five mamba2
   steps through ``launch.train.main``, counted (480 ``ssd_chunk``, 240
   ``ssd_chunk_bwd``), then one profiled step with ``ssd_chunk_bwd``'s
   device time and share and its torch finish's; (c‴) five
   ``training.loop.train`` steps of zamba2 at 24 of its 54 layers (4
   shared-block sites; 8 copies of the params at full depth would be
   about 78 GB), counted (240, 120, 40, 20);
7. one ``{"kernels": [...]}`` JSON line (seven kernels; conv2d_fused's
   launches are those of phases 4b, 4d's abort run, 4e, 4f and 4g's
   in-process plan CLI, ssd_chunk's those of mamba2's fp32 generate
   and of phase 6's (b″)-(c‴), moe_gemm's those of granite's fp32
   generate and of phase 6's (b') and (c'), flash_prefill_bwd's those of
   the five Llama training steps, ssd_chunk_bwd's phase 6's), the card
   line, and last ``{"ok": true, "device": {...}}``.

TF32 is switched off for matmuls and cuDNN, so every fp32 number here is
IEEE fp32.  The script imports neither ``jax`` nor the JAX package.
Shapes are recorded, and the plain oracles (the ``"torch"`` backend, the
agreement checks) run, with every body eager (``exec.graph.eager``).
"""

from __future__ import annotations

import contextlib
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
            "moe_gemm": "src/repro/kernels/moe_gemm/moe_gemm.py:48",
            "flash_prefill_bwd": "none: the reference differentiates "
                                 "src/repro/models/transformer/layers.py:86 "
                                 "(blockwise_causal_attention) in XLA",
            "ssd_chunk_bwd": "none: the reference differentiates "
                             "src/repro/models/transformer/layers.py:314 "
                             "(ssd_chunked) in XLA"}
CLUSTER_GHZ = [1.5, 1.5, 1.2, 1.2, 1.0, 1.0, 0.8, 0.8]
# LMs, all at full width (src/repro_torch/configs/): each arch's serving
# path and the kernels it launches.  Llama-3.2-1B's attention kernels
# give the flash_prefill / decode_attention entries of the kernels line.
LM_ARCH, SSM_ARCH, MOE_ARCH = ("llama3.2-1b", "mamba2-370m",
                               "granite-moe-3b-a800m")
# zamba2: 54 Mamba2 layers and the shared attention block at 9 sites, head
# dim 80; musicgen-medium takes embeddings (no token loop: its prefill and
# decode steps are driven directly)
HYBRID_ARCH, EMBEDS_ARCH = "zamba2-2.7b", "musicgen-medium"
LM_FAMILIES = {LM_ARCH: ("flash_prefill", "decode_attention"),
               SSM_ARCH: ("ssd_chunk",),
               MOE_ARCH: ("flash_prefill", "decode_attention", "moe_gemm"),
               HYBRID_ARCH: ("flash_prefill", "decode_attention",
                             "ssd_chunk")}
LM_BATCH, LM_PROMPT, LM_NEW = 4, 512, 32
GRAPH_STEPS = 6      # decode steps held bit for bit, eager against replayed
# phase 4d: the event-driven runtime, frames arriving at half the plan's
# period (stage 0 queues and coalesces up to RUNTIME_BATCH of them), the
# plan's slowest device leaving once a third of them have arrived
RUNTIME_FRAMES, RUNTIME_BATCH = 24, 4
# a run's memory outside what its frames hold (their inputs and stage
# outputs): growth allowed once every graph of the run is captured
RUNTIME_MEM_SLACK = 16 << 20
# phase 4e: dep.fleet, one worker per stage: frames per run, and the
# killed-worker drill's peer timeout (several seconds: a worker computes
# between heartbeats)
DIST_FRAMES, DIST_PEER_TIMEOUT_S = 8, 3.0
# phase 4f: requests through each server; the scheduler's tenants and,
# per scenario of benchmarks/fig_serving_mt.py, the load and the
# duration of the arrivals (the benchmark's SMOKE durations)
SERVE_REQUESTS = 8
MT_TENANTS = ("squeezenet", "mobilenetv3", "resnet34")
MT_SIZE, MT_SCALE = (224, 224), 1.0
MT_LOADS = {"saturated": (2.0, 1.5), "churn": (0.65, 3.0)}
# kernel path vs backend="torch" on the same weights, x max|logit| over
# the real vocab.  fp32: only the kernels differ (sums in another
# order), through every layer.  bf16: both paths round the same tensors
# to bf16, but a different fp32 sum can land one bf16 ulp (2^-8
# relative) apart, and that carries through the layers: a logit band
# only, and no token check
LM_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# phase 6: training Llama-3.2-1B (LM_ARCH) in fp32.  The backward kernel
# per element within BWD_TOL x max|ref| of each output (fp32 sums in
# another order); the kernel path's loss within LOSS_TOL relative and each
# gradient leaf within GRAD_TOL x max|g| of backend="torch"'s (every
# layer's attention, its backward and the embedding's scatter sum in other
# orders, through 16 layers).  Cases: (q shape (B, S, K, G, D), window):
# the path's, G = 1, zamba2's D = 80, D = 128, S = 511, a window of 128
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 5
BWD_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 1e-3
BWD_CASES = [((4, 512, 8, 4, 64), 0), ((2, 256, 16, 1, 64), 0),
             ((4, 512, 32, 1, 80), 0), ((2, 512, 8, 4, 128), 0),
             ((4, 511, 8, 4, 64), 0), ((4, 512, 8, 4, 64), 128)]
# then granite (MOE_ARCH) in fp32.  MoeGemm's backward at x (E, C, D)
# against w (E, D, F): granite's training products (C = 4 x 128 slots,
# w1/w3 and the w2 twin), C = 12, C = 10 (dw's depth no multiple of 4),
# C = 4 and mixtral's experts at a small C.  The train steps run at 16
# of granite's 32 layers: the functional AdamW holds about 8 copies of
# the params (8 x 13.5 GB at full depth, past one card's 80 GB)
MOE_BWD_CASES = [(40, 512, 1536, 512), (40, 512, 512, 1536),
                 (4, 12, 1024, 256), (4, 10, 1024, 256), (40, 4, 1536, 512),
                 (8, 64, 4096, 14336)]
MOE_TRAIN_LAYERS = 16
# then mamba2 (SSM_ARCH) and zamba2 (HYBRID_ARCH) in fp32.  SsdChunk's
# backward (the ssd_chunk_bwd kernel) at (BC, Q, H, P, N): mamba2's and
# zamba2's training folds (batch 4 x two 256-position chunks), the
# forward's Q = 511 edge at one chunk, H = 6 (no multiple of G = 4), P and
# N below 64, and a chunk whose decays sum past -100 with A = -1 (the
# exp above the diagonal would overflow; the gradients must be finite).
# zamba2 trains at 24 of its 54 layers (4 shared-block sites): about 8
# copies of the params with the functional AdamW, 8 x 9.7 GB at full depth
SSD_BWD_CASES = [((8, 256, 32, 64, 128), False), ((8, 256, 80, 64, 64), False),
                 ((4, 511, 32, 64, 128), False), ((8, 256, 6, 64, 128), False),
                 ((4, 256, 8, 32, 16), False), ((2, 256, 8, 64, 64), True)]
HYBRID_TRAIN_LAYERS = 24


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


# device_ms's state: how many windows a call tries before it times with
# CUDA events instead (one after a call found the profiler blind, so a
# profiler that stays blind costs one window a call), and how many
# readings fell back so far.
_PROFILER = {"tries": 5, "fallbacks": 0}


def device_ms(fn, iters: int = 20, tries: int = 5) -> float:
    """Mean device time of ``fn`` a call: the kernels' own durations as
    ``torch.profiler`` records them (host time between launches not
    counted; ``time_ms`` counts it when the host is the slower).  Each
    kernel's mean over the launches the profiler caught, times its
    launches a call.  A window that starts cold can miss launches (once,
    late in this script's run, enough that a call's two launches of one
    kernel read as one), so each window is ``iters`` calls recorded
    after ``iters`` calls of warm-up under the running profiler.  Now
    and then a window records no kernel at all; it is taken again, up
    to ``tries`` windows.  If none records a kernel, the reading is
    ``time_ms`` over ``iters`` calls (CUDA events, host gaps included),
    said so on a line of its own, and later calls try one window only
    until the profiler records again."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    n = min(tries, _PROFILER["tries"])
    for _ in range(n):
        recorded = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: recorded.extend(
                         p.key_averages())) as prof:
            for _ in range(2):               # warm-up, then recorded
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        ms = sum(e.self_device_time_total / e.count
                 * max(1, round(e.count / iters))
                 for e in recorded
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.count) / 1e3
        if ms > 0:
            _PROFILER["tries"] = tries
            return ms
        time.sleep(0.1)
    _PROFILER["tries"] = 1
    _PROFILER["fallbacks"] += 1
    ms = time_ms(fn, iters)
    print(f"[profile] torch.profiler recorded no kernel in {n} window(s) of "
          f"{iters} calls; this device ms, {ms:.4f}, is CUDA events' time "
          f"instead (host gaps included; fallback "
          f"{_PROFILER['fallbacks']} of the run)")
    return ms


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


def _prefill_plan_text(p) -> str:
    order = "tiles outer" if p.tile_outer else "tiles inner"
    return (f"rows{p.rows} DP{p.dp} grid{p.grid} order {p.order[0]}.."
            f"{p.order[-1]} {order}")


def prefill_case(shape, window, dtype_name, seed=0) -> dict:
    """flash_prefill against its plain version at q shape (B, S, K, G, D);
    the library call is SDPA (``enable_gqa``, causal or windowed mask).
    The description names the launch's plan (``ops.prefill_plan``: rows
    a block, padded D, grid, tile order), whose rows, padded D, threads,
    shared memory and grid must be the C side's (``ops.prefill_layout``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import ops, ref

    dtype = getattr(torch, dtype_name)
    b, s, k, g, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    kk, vv = (torch.randn((b, s, k, d), generator=gen, device="cuda")
              .to(dtype) for _ in range(2))
    pl = ops.prefill_plan(*shape, dtype)
    same_layout = ops.prefill_layout(*shape, dtype) == (
        pl.rows, pl.dp, pl.threads, pl.smem, pl.grid)
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
    return dict(kernel="flash_prefill", desc=f"q{tuple(shape)} w{window} "
                + _prefill_plan_text(pl)
                + ("" if same else " NOT BIT-REPRODUCIBLE")
                + ("" if same_layout else " PLAN AND KERNEL DIFFER"),
                plan=pl, shape=tuple(shape), dtype=dtype_name, err=err,
                of_limit=of_limit,
                ok=ok and same and same_layout,
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
    Q = 511); two calls must give the same bits.  The description names
    the launch's plan (``ops.plan``: G heads a y block, G' a state block,
    the tiles, the grid), whose grid and shared memory must be the C
    side's (``ops.kernel_layout``).  No single PyTorch call computes the
    function: no library time."""
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
    pl = ops.plan(bc, q, h, p, n, dtype)
    # the plan's grid and shared memory as the C side computes them
    same_layout = ops.kernel_layout(bc, q, h, p, n, pl.g, dtype) \
        == (pl.smem, pl.grid)
    y, st = ops.ssd_chunk(x, dt, A, Bm, Cm)
    y2, st2 = ops.ssd_chunk(x, dt, A, Bm, Cm)
    y_ref, st_ref = ref.ssd_chunk_ref(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    checks = [check_close(y, y_ref, dtype), check_close(st, st_ref, dtype)]
    same = torch.equal(y, y2) and torch.equal(st, st2)

    ms = time_ms(lambda: ops.ssd_chunk(x, dt, A, Bm, Cm))
    plain_ms = time_ms(lambda: ref.ssd_chunk_ref(x, dt, A, Bm, Cm))
    dev = device_ms(lambda: ops.ssd_chunk(x, dt, A, Bm, Cm))
    pairs = q * (q + 1) // 2          # causal (i, j) pairs of a chunk
    flops = (2.0 * bc * pairs * n          # C B^T, once per chunk
             + 2.0 * bc * h * pairs * p    # M @ x
             + 2.0 * bc * h * q * p * n)   # the state
    nbytes = (2 * x.numel() + dt.numel() + A.numel() + 2 * Bm.numel()
              + st.numel()) * x.element_size()
    return dict(kernel="ssd_chunk",
                desc=f"(BC,Q,H,P,N){tuple(shape)} G{pl.g} G'{pl.gs} "
                f"TQ{ops.TQ} TJ{ops.TJ} NS{ops.NS} grid{pl.grid}"
                + ("" if same else " NOT BIT-REPRODUCIBLE")
                + ("" if same_layout else " PLAN AND KERNEL DIFFER"),
                dtype=dtype_name, err=max(c[0] for c in checks),
                of_limit=max(c[1] for c in checks),
                ok=all(c[2] for c in checks) and same and same_layout,
                per_call=0, ms=ms,
                plain_ms=plain_ms, library_ms=None, dev_ms=dev,
                library_dev_ms=None, **bound(flops, nbytes, dtype_name))


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
        lib_dev = "-" if r.get("library_dev_ms") is None \
            else f"{r['library_dev_ms']:.4f}"
        dev = (f" | device {r['dev_ms']:.4f} / {lib_dev}"
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
    return {"flash_prefill": attn, "flash_prefill_bwd": attn,
            "decode_attention": attn, "ssd_chunk": ssd,
            "ssd_chunk_bwd": ssd, "moe_gemm": moe}


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
    decode steps) by construction of the model: attention once a layer,
    or in a hybrid once a shared-block site."""
    from repro_torch.models.transformer import model as M

    L = cfg.n_layers
    attn = M.n_shared_apps(cfg) if cfg.shared_attn_every else L
    per = {"flash_prefill": attn, "decode_attention": attn * LM_NEW,
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
    granite), a longer Mamba2 prompt (with mamba2), and zamba2's
    attention shapes at D = 64 and D = 128 beside its D = 80 (padded to
    128) and its decode cache full and partly filled."""
    cases = []
    if cfg.name == LM_ARCH:
        b, k, g, d = LM_BATCH, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,\
            cfg.hd
        w = LM_PROMPT + LM_NEW
        # each with the padded D and grid its plan must give in fp32 (one
        # dimension, the query tiles outer) and in bf16 (query tiles,
        # B K); 64 rows a block in both
        for shape, window, dts, dp, n_qt in [
                ((2, 37, k, g, d), 0, ("float32", "bfloat16"), 64, 3),
                ((2, 200, k, g, d), 32, ("float32", "bfloat16"), 64, 13),
                ((2, 256, 16, 1, d), 0, ("float32",), 64, 4),    # G = 1
                ((1, 256, 8, 8, 128), 0, ("float32", "bfloat16"), 128, 32),
                # D padded to 16 and to 64, G = 3 at S = 511 (63 of 64
                # rows), G = 64, and qwen1.5-0.5b's prefill (G = 1 at the
                # path's size)
                ((2, 300, k, g, 8), 0, ("float32", "bfloat16"), 16, 19),
                ((2, 300, k, g, 40), 0, ("float32", "bfloat16"), 64, 19),
                ((b, 511, k, 3, d), 0, ("float32", "bfloat16"), 64, 25),
                ((1, 130, 2, 64, 32), 0, ("float32", "bfloat16"), 32, 130),
                ((b, 511, 16, 1, d), 0, ("float32",), 64, 8)]:
            bk = shape[0] * shape[2]
            for dt in dts:
                r = prefill_case(shape, window, dt)
                want = (dp, (n_qt * bk, 1) if dt == "float32"
                        else (n_qt, bk))
                if (r["plan"].dp, r["plan"].grid) != want:
                    fail(f"flash_prefill {r['desc']} {dt}: want DP and "
                         f"grid {want}")
                cases.append(r)
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
    if cfg.shared_attn_every:
        b, k, g = LM_BATCH, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        w = LM_PROMPT + LM_NEW
        for d in (64, 128):
            for dt in ("float32", "bfloat16"):
                r = prefill_case((b, LM_PROMPT - 1, k, g, d), 0, dt)
                if r["plan"].dp != d:
                    fail(f"flash_prefill {r['desc']} {dt}: want DP {d}")
                cases.append(r)
        for vl in (w, w // 2 + 28):
            cases += [decode_case((b, k, g, cfg.hd), w, vl, dt)
                      for dt in ("float32", "bfloat16")]
    if cfg.name == SSM_ARCH:
        hp, n = cfg.ssm_head_dim, cfg.ssm_state
        # shape, and the heads a y block that ops.plan must choose in fp32
        # and in bf16 (G = 2 where G = 4's grid is short of a wave)
        for shape, want_g in [
                # a 1024-token prompt: Q = 256, four chunks each
                ((LM_BATCH * 4, 256, cfg.ssm_heads, hp, n), (4, 4)),
                # H not a multiple of G
                ((64, 256, 3, hp, n), (4, 4)), ((16, 511, 6, hp, n), (4, 4)),
                # an odd number of row tiles at BC = 1; Q = 1030 (in fp32
                # G = 2's grid takes two waves of one block an SM)
                ((1, 511, cfg.ssm_heads, hp, n), (2, 2)),
                ((1, 1030, cfg.ssm_heads, hp, n), (4, 2)),
                # P = 128 (two P tiles) with N = 8 (one live column in four)
                ((2, 256, 4, 128, 8), (2, 2)),
                # two heads: G = 2 by construction
                ((64, 256, 2, hp, n), (2, 2))]:
            for dt, g in zip(("float32", "bfloat16"), want_g):
                r = ssd_case(shape, dt)
                if f" G{g} " not in r["desc"]:
                    fail(f"ssd_chunk {r['desc']}: want G = {g}")
                cases.append(r)
    return cases


def _padding_cost(cfg, cases) -> None:
    """zamba2's prefill attention: the head dim D = 80 runs padded to
    DP = 128, so (128 - 80) / 128 of the padded work is padding.  Device
    ms at D = 64, 80 and 128 on the same (B, S, K, G), beside the bound
    at the real D = 80 and SDPA's time at D = 80."""
    g = cfg.n_heads // cfg.n_kv_heads
    for dt in ("float32", "bfloat16"):
        at = {r["shape"][4]: r for r in cases
              if r["kernel"] == "flash_prefill" and r["dtype"] == dt
              and r["shape"][:4] == (LM_BATCH, LM_PROMPT - 1,
                                     cfg.n_kv_heads, g)}
        r, dp = at[cfg.hd], at[cfg.hd]["plan"].dp
        print(f"[pad] {cfg.name} {dt} flash_prefill q{r['shape']}: D "
              f"{cfg.hd} runs padded to DP {dp}, "
              f"{100 * (dp - cfg.hd) / dp:.1f}% of the padded work padding; "
              f"device ms at D " + " / ".join(map(str, sorted(at))) + ": "
              + " / ".join(f"{at[d]['dev_ms']:.4f}" for d in sorted(at))
              + f" (D {cfg.hd} takes {r['dev_ms'] / at[128]['dev_ms']:.3f} "
              f"of D 128's time); bound at D {cfg.hd} {r['bound_ms']:.5f} "
              f"({r['bound_by']}; {100 * r['bound_ms'] / r['dev_ms']:.1f}% "
              f"of the kernel's device time); SDPA at D {cfg.hd} "
              f"{r['library_ms']:.4f} ms, device {r['library_dev_ms']:.4f}")


def _lm_agreement(cfg, params, prompt, toks, dtype_name, hold=True,
                  feeds=None) -> None:
    """Prefill and each teacher-forced decode step of the kernel path
    against ``backend="torch"`` on the same weights, fed the kernel
    path's tokens (``toks``), or for an embeds model the LM_NEW
    embeddings ``feeds`` (``toks`` None).  fp32: logits within
    LM_LOGIT_TOL x max|logit|, and the kernel path's greedy token equal
    to the plain path's wherever the plain path's top-2 gap exceeds
    twice that; bf16: the band only.  With ``hold`` false the band is
    printed, not enforced.
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
        if i and toks is not None and dtype_name == "float32":
            top2 = lt.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
            same = lt.argmax(dim=-1) == toks[:, i - 1].long()
            if hold and bool((sure & ~same).any()):
                fail(f"greedy token of decode step {i} differs from the "
                     f"torch backend where its top-2 gap exceeds 2 x tol")
            n_differ += int((~same).sum())
        if i == LM_NEW:
            break
        if feeds is not None:
            inp = {"embed": feeds[i]}
        else:
            inp = {"token": prompt[:, -1] if i == 0 else toks[:, i - 1]}
        (lc, cc), (lt, ct) = (
            M.decode_step(cfg, params, c, inp, backend=be)
            for c, be in ((cc, "cuda"), (ct, "torch")))
    held = "within" if hold else "not held; worst"
    print(f"[slice] {cfg.name} {dtype_name} logits vs torch backend: "
          f"prefill and {LM_NEW} teacher-forced decode steps, {held} "
          f"{rel:g} x max|logit| (worst {worst:.3f} of the limit)"
          + (f"; greedy tokens: {n_differ} of {LM_BATCH * LM_NEW} "
             f"differ from the plain path's"
             + (", none where its top-2 gap exceeds 2 x tol" if hold
                else "")
             if dtype_name == "float32" and toks is not None
             else "; logit band only"))


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
                    steps: int = 4) -> dict:
    """Where a decode step's time goes: ``torch.profiler`` over a few
    steps, eager (a loop of ``decode_step``) and replayed from a
    ``Decoder``'s CUDA graph (captured before the window); kernels
    launched per step, the card's busy time and the top kernels by time;
    with ``alone_ms`` (moe_gemm's mean device time a decode launch, timed
    alone) also moe_gemm's device time inside the eager step beside it.
    Returns {mode: (busy ms, wall ms) a step, or None where the profiler
    saw no device time}.  A diagnostic: nothing here is checked."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.transformer import model as M
    from repro_torch.serving import lm

    out = {}
    for mode in ("eager", "graph"):
        _, cache = lm.prefill_prompt(cfg, params, prompt, LM_NEW)
        tok = prompt[:, -1].long()
        if mode == "graph":
            decoder = lm.Decoder(cfg, params, cache)
            tok = decoder(tok).argmax(dim=-1)    # warm-up and capture

            def step(tok):
                return decoder(tok).argmax(dim=-1)
        else:
            def step(tok):
                nonlocal cache
                logits, cache = M.decode_step(cfg, params, cache,
                                              {"token": tok})
                return logits.argmax(dim=-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                tok = step(tok)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 \
            / steps
        what = ("decode step" if mode == "eager"
                else "decode step replayed from its CUDA graph")
        if busy_ms <= 0:
            print(f"[profile] {cfg.name} {dtype_name} {what}: the profiler "
                  f"saw no device time; busy share not measured")
            out[mode] = None
            continue
        out[mode] = (busy_ms, wall_ms)
        launches = sum(e.count for e in kernels) / steps
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
        print(f"[profile] {cfg.name} {dtype_name} {what} (torch.profiler, "
              f"{steps} steps): {launches:.0f} kernels per step, device "
              f"busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
              f"({100 * busy_ms / wall_ms:.1f}%); top: " + "; ".join(
                  f"{e.key[:40]} {e.self_device_time_total / 1e3 / steps:.3f}"
                  f" ms" for e in top))
        if alone_ms is not None and mode == "eager":
            moe = [e for e in kernels if "moe_gemm" in e.key]
            n = sum(e.count for e in moe)
            in_ms = sum(e.self_device_time_total for e in moe) / 1e3
            if n:
                print(f"[profile] {cfg.name} {dtype_name} moe_gemm inside "
                      f"the decode step: {in_ms / steps:.3f} ms a step over "
                      f"{n / steps:.0f} launches, {1e3 * in_ms / n:.2f} us "
                      f"a launch; alone (warm L2, device time, profiler) "
                      f"{1e3 * alone_ms:.2f} us a launch")
    return out


def _replays_equal_eager(cfg, params, prompt, head, feeds=None) -> None:
    """A ``Decoder``'s first (eager) step and its replays against eager
    ``decode_step`` from the same cache, bit for bit over GRAPH_STEPS
    teacher-forced steps: fed each step's greedy token, or for an embeds
    model the embeddings ``feeds``."""
    import torch
    from repro_torch.models.transformer import model as M
    from repro_torch.serving import lm

    _, cache = lm.prefill_prompt(cfg, params, prompt, LM_NEW)
    eager_cache = {k: v.clone() for k, v in cache.items()}
    decoder = lm.Decoder(cfg, params, cache)
    x = prompt[:, -1].long() if feeds is None else feeds[0]
    for i in range(GRAPH_STEPS):
        want, eager_cache = M.decode_step(cfg, params, eager_cache,
                                          {decoder.key: x})
        got = decoder(x)
        if not torch.equal(got, want):
            fail(f"{head}: decode step {i} "
                 f"{'(eager warm-up)' if i == 0 else 'replayed'} differs "
                 f"from eager decode_step by "
                 f"{(got.float() - want.float()).abs().max().item():.3g}")
        x = want.argmax(dim=-1) if feeds is None else feeds[i + 1]
    print(f"{head}: {GRAPH_STEPS} decode steps (the first eager, then "
          f"{GRAPH_STEPS - 1} replays) equal eager decode_step from the "
          f"same cache bit for bit; capture and instantiation "
          f"{decoder.graph.capture_s * 1e3:.1f} ms")


def _decode_graph(cfg, params, prompt, dtype_name, toks, pre_ms,
                  busy) -> None:
    """``[graph]`` lines of one LM and dtype: a ``Decoder``'s first
    (eager) step and its replays against eager ``decode_step`` from the
    same cache, bit for bit over GRAPH_STEPS teacher-forced steps; the
    graphed generate's greedy tokens (``toks``, the counted run's) against
    the eager loop's; decode ms/step graphed and eager from one generate
    each, in turns (generate less ``pre_ms``, the prefill), and of the
    steps alone; capture and instantiation ms; the profiled busy shares
    (``busy``, from ``_decode_profile``)."""
    import torch
    from repro_torch.exec import graph
    from repro_torch.serving import lm

    head = f"[graph] {cfg.name} {dtype_name}"
    _replays_equal_eager(cfg, params, prompt, head)

    # one generate each, in turns; the steps alone, after the first
    gen = {"eager": [], "graph": []}
    steps = {}
    for mode in ("eager", "graph", "graph", "eager"):
        ctx = graph.eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = lm.generate(cfg, params, prompt, LM_NEW)
            torch.cuda.synchronize()
            gen[mode].append(((time.perf_counter() - t0) * 1e3 - pre_ms)
                             / LM_NEW)
            if not torch.equal(out, toks):
                fail(f"{head}: {mode} generate's {LM_NEW} greedy tokens "
                     f"differ from the graphed counted run's in "
                     f"{int((out != toks).sum())} places")
            if mode not in steps:
                _, cache = lm.prefill_prompt(cfg, params, prompt, LM_NEW)
                decoder = lm.Decoder(cfg, params, cache)
                tok = decoder(prompt[:, -1].long()).argmax(dim=-1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(LM_NEW - 1):
                    tok = decoder(tok).argmax(dim=-1)
                torch.cuda.synchronize()
                steps[mode] = (time.perf_counter() - t0) * 1e3 / (LM_NEW - 1)
                del decoder, cache
    print(f"{head}: greedy tokens of the graphed generate equal the eager "
          f"loop's over all {LM_NEW}; decode ms/step (generate less "
          f"prefill, one call each, in the turns eager, graph, graph, "
          f"eager; the graph's capture included): graphed "
          + " / ".join(f"{v:.3f}" for v in gen["graph"]) + ", eager "
          + " / ".join(f"{v:.3f}" for v in gen["eager"])
          + f"; steps 2..{LM_NEW} alone: graphed {steps['graph']:.3f}, eager "
          f"{steps['eager']:.3f} ms/step (host clock, synchronized)")
    if max(gen["graph"]) >= min(gen["eager"]):
        print(f"{head}: NOTE graphed decode not below eager in every turn")
    share = {m: ("not measured" if v is None else
                 f"{v[0]:.3f} of {v[1]:.3f} ms ({100 * v[0] / v[1]:.1f}%)")
             for m, v in busy.items()}
    print(f"{head}: device busy a decode step (torch.profiler): replayed "
          f"{share['graph']}, eager {share['eager']}")


def _held_cases(launched, held_vl=None) -> list[dict]:
    """Each recorded (kernel, shape, argument, dtype) as a case held
    against its plain version, with its launches; decode_attention at
    the valid lengths ``held_vl`` (default: the first, every eighth and
    the last)."""
    vls = sorted({a for (n, _, a, _) in launched if n == "decode_attention"})
    held = set(vls[::8] + vls[-1:]) if held_vl is None else held_vl
    cases = []
    for (name, shape, arg, dt), cnt in sorted(launched.items()):
        if name == "decode_attention" and arg not in held:
            continue
        r = CASES[name](shape, arg, dt)
        r["per_call"] = cnt
        cases.append(r)
    return cases


def _forward_loss(cfg, params, prompt, served) -> None:
    """zamba2 fp32, on the weights of the served path: ``forward`` over
    the whole prompt (B, LM_PROMPT) with its kernels counted (reset just
    before, read just after: one ssd_chunk a layer, one flash_prefill a
    shared-block site), each kernel held against its plain version at
    the shapes ``forward`` gives it that the served path did not
    (``served``, from ``_record_shapes``); its last position against
    ``prefill``'s logits, and ``loss_fn`` (labels the next tokens)
    against ``backend="torch"``'s, within LM_LOGIT_TOL x max|logit|."""
    import torch
    from repro_torch.models.transformer import model as M

    ops = _kernel_ops()
    names = ("ssd_chunk", "flash_prefill")
    V, rel = cfg.vocab_size, LM_LOGIT_TOL["float32"]
    batch = {"tokens": prompt, "labels": torch.roll(prompt, -1, dims=1)}
    launched = _record_shapes(names, lambda: M.forward(cfg, params, batch))
    seen = {k[:2] for k in served}
    new = _held_cases({k: n for k, n in launched.items()
                       if k[:2] not in seen})
    print(f"[forward] {cfg.name} float32: {len(new)} kernel cases at the "
          f"shapes forward gives the kernels and the served path did not:")
    _print_cases(new)
    if any(not r["ok"] for r in new):
        fail(f"{cfg.name} forward's kernel cases disagree with the plain "
             f"versions")

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = M.forward(cfg, params, batch)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    got = {n: ops[n].launch_count(n) for n in names}
    want = {"ssd_chunk": cfg.n_layers, "flash_prefill": M.n_shared_apps(cfg)}
    print(f"[forward] {cfg.name} float32 forward of {tuple(prompt.shape)} "
          f"tokens: " + ", ".join(f"{n} launches {got[n]} (want {want[n]})"
                                  for n in names)
          + f"; {fwd_ms:.2f} ms (host clock, synchronized)")
    if got != want:
        fail(f"{cfg.name} forward launched {got}, want {want}")
    real = logits[..., :V]
    if tuple(logits.shape) != (LM_BATCH, LM_PROMPT, cfg.vocab_padded) or \
            not bool(torch.isfinite(real).all()):
        fail(f"{cfg.name} forward logits {tuple(logits.shape)}, or not "
             f"finite")
    last, _ = M.prefill(cfg, params, {"tokens": prompt})
    tol = rel * last[:, :V].abs().max().item()
    diff = (real[:, -1] - last[:, :V]).abs().max().item()
    scale = real.abs().max().item()
    del logits, real
    loss, loss_t = (M.loss_fn(cfg, params, batch, backend=be).item()
                    for be in ("cuda", "torch"))
    print(f"[forward] {cfg.name} float32: last position vs prefill's logits "
          f"{diff:.3g} ({diff / tol:.3f} of {rel:g} x max|logit|); loss_fn "
          f"{loss:.6f}, torch backend {loss_t:.6f}, difference "
          f"{abs(loss - loss_t):.3g} ({abs(loss - loss_t) / (rel * scale):.3f}"
          f" of {rel:g} x max|logit| {scale:.3f})")
    if diff > tol or not abs(loss - loss_t) <= rel * scale:
        fail(f"{cfg.name} forward or loss_fn outside the limit")


def _describe(cfg) -> str:
    if cfg.is_ssm:
        sites = cfg.n_layers // max(cfg.shared_attn_every, 1)
        shared = (f"; the shared attention+MLP block after every "
                  f"{cfg.shared_attn_every}th layer ({sites} sites): "
                  f"{cfg.n_heads} q-heads, {cfg.n_kv_heads} kv-heads, hd "
                  f"{cfg.hd}, ff {cfg.d_ff}" if cfg.shared_attn_every else "")
        return (f"{cfg.n_layers} Mamba2 layers, d {cfg.d_model}, d_inner "
                f"{cfg.d_inner}, N {cfg.ssm_state}, {cfg.ssm_heads} heads of "
                f"{cfg.ssm_head_dim}, conv {cfg.ssm_conv}{shared}")
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
    from repro_torch.exec import graph
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

    # shapes the path gives the kernels: one warm-up generate per dtype,
    # every step eager (the recording reads valid_len on the host)
    with graph.eager():
        launched = _record_shapes(names, lambda: [
            lm.generate(cfg, p, prompt, LM_NEW) for p in params.values()])

    # -- 3. kernel vs plain on the card ----------------------------------
    vls = sorted({a for (n, _, a, _) in launched if n == "decode_attention"})
    # Llama holds every valid length; the others the first, every eighth
    # and the last
    held_vl = set(vls if arch == LM_ARCH else vls[::8] + vls[-1:])
    cases = _held_cases(launched, held_vl) + _extra_cases(cfg)
    print(f"[kernel] {cfg.name}: {len(cases)} cases of {', '.join(names)}: "
          f"shape, dtype, launches per generate | max_abs_err (worst error "
          f"/ its limit) | ms kernel / plain / library / bound (CUDA "
          f"events around 20 calls) | device ms kernel / library "
          f"(torch.profiler, kernels only)"
          + (f"; decode_attention held at valid lengths {sorted(held_vl)} "
             f"of {len(vls)}" if len(held_vl) < len(vls) else ""))
    _print_cases(cases)
    bad = [r for r in cases if not r["ok"]]
    if bad:
        fail(f"{len(bad)} {cfg.name} kernel case(s) disagree with the plain "
             f"version")
    if cfg.shared_attn_every:
        _padding_cost(cfg, cases)

    # -- 5. the path, counted, per dtype ----------------------------------
    want = _want_launches(cfg, names)
    launches, tokens, prefill_ms = {}, {}, {}
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
        pre_ms = prefill_ms[dt] = (time.perf_counter() - t0) / reps * 1e3
        dec_ms = (gen_s * 1e3 - pre_ms) / LM_NEW
        print(f"[slice] {cfg.name} {dt}: generate {gen_s * 1e3:.1f} ms "
              f"({LM_BATCH * LM_NEW / gen_s:.1f} new tokens/s); prefill of "
              f"{LM_PROMPT - 1} tokens x {LM_BATCH} {pre_ms:.2f} ms (mean of "
              f"{reps}); decode {dec_ms:.3f} ms per step of {LM_BATCH} "
              f"tokens (generate less prefill, over {LM_NEW} steps, the "
              f"graph's capture included; host clock around synchronized "
              f"runs)")

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
        busy = _decode_profile(cfg, p, prompt, dt, alone)
        _decode_graph(cfg, p, prompt, dt, tokens[dt], prefill_ms[dt], busy)
    if cfg.shared_attn_every:
        _forward_loss(cfg, params["float32"], prompt, launched)
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
            lib = [total(rows, "library_dev_ms") for rows in (path, bf)]
            lib = ["-" if v is None else f"{v:.4f}" for v in lib]
            dev = total(path, "dev_ms")
            print(f"[kernels] {cfg.name} {name} device time (profiler) "
                  f"over the same launches: fp32 {dev:.4f} "
                  f"({100 * out[name]['bound_ms'] / dev:.1f}% of the "
                  f"bound), library {lib[0]}; bf16 "
                  f"{total(bf, 'dev_ms'):.4f}, library {lib[1]}")
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


def run_embeds(arch: str) -> None:
    """Phases 3 and 5 for the ``embeds`` input mode at full width: seeded
    (B, LM_PROMPT - 1, d) embeddings through ``prefill``, then LM_NEW
    decode steps each fed a seeded (B, d) embedding through a
    ``Decoder`` (the first eager, the rest replayed from its CUDA graph),
    in fp32 and bf16.  The attention kernels are held against their plain
    versions at the path's shapes and counted (reset just before, read
    just after: flash_prefill once a layer, decode_attention once a
    layer and step); logits against ``backend="torch"`` within
    LM_LOGIT_TOL; replays bit-equal to eager ``decode_step``; prefill ms
    and decode ms/step graphed and eager."""
    import torch
    from repro_torch import configs
    from repro_torch.exec import graph
    from repro_torch.models.transformer import model as M
    from repro_torch.serving import lm

    cfg = configs.get(arch)
    names = ("flash_prefill", "decode_attention")
    ops = _kernel_ops()
    params = {dt: M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
        dtype=getattr(torch, dt)) for dt in ("float32", "bfloat16")}
    # the prompt's LM_PROMPT embeddings (its last is the first decode
    # step's input) and the LM_NEW - 1 steps' after it
    xs = torch.randn((LM_BATCH, LM_PROMPT + LM_NEW - 1, cfg.d_model),
                     generator=torch.Generator(device="cuda").manual_seed(1),
                     device="cuda")
    inputs = {dt: xs.to(getattr(torch, dt)) for dt in params}
    print(f"[lm] {cfg.name}: {_describe(cfg)}, input embeddings of d "
          f"{cfg.d_model} (no embedding table), vocab {cfg.vocab_size} "
          f"padded to {cfg.vocab_padded}, {cfg.param_count() / 1e9:.2f} G "
          f"params; batch {LM_BATCH}, {LM_PROMPT - 1} embeddings "
          f"prefilled, {LM_NEW} decode steps fed seeded embeddings")

    def prompt_of(x):
        return x[:, :LM_PROMPT]

    def feeds_of(x):
        return [x[:, LM_PROMPT - 1 + i] for i in range(LM_NEW)]

    def run(p, x, steps_ms=None):
        """Prefill, then LM_NEW steps; the last step's logits.  With
        ``steps_ms`` (a list), appends the mean ms of steps 2..LM_NEW
        (host clock, synchronized)."""
        _, cache = lm.prefill_prompt(cfg, p, prompt_of(x), LM_NEW)
        decoder = lm.Decoder(cfg, p, cache)
        feeds = feeds_of(x)
        logits = decoder(feeds[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in feeds[1:]:
            logits = decoder(f)
        if steps_ms is not None:
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3 / (LM_NEW - 1))
        return logits

    with graph.eager():
        launched = _record_shapes(names, lambda: [
            run(p, inputs[dt]) for dt, p in params.items()])
    cases = _held_cases(launched)
    print(f"[kernel] {cfg.name}: {len(cases)} cases of {', '.join(names)} "
          f"at the embeds path's shapes (columns as above)")
    _print_cases(cases)
    if any(not r["ok"] for r in cases):
        fail(f"{cfg.name} kernel case(s) disagree with the plain version")

    want = {"flash_prefill": cfg.n_layers,
            "decode_attention": cfg.n_layers * LM_NEW}
    for dt, p in params.items():
        x = inputs[dt]
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = run(p, x)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
        got = {n: ops[n].launch_count(n) for n in names}
        print(f"[slice] {cfg.name} {dt} prefill + {LM_NEW} decode steps "
              f"(embeds): " + ", ".join(f"{n} launches {got[n]} (want "
                                       f"{want[n]})" for n in names))
        if got != want:
            fail(f"{cfg.name} {dt} launched {got}, want {want}")
        if tuple(logits.shape) != (LM_BATCH, cfg.vocab_padded) or \
                not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
            fail(f"{cfg.name} {dt} logits {tuple(logits.shape)}, or not "
                 f"finite")
        reps = 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            lm.prefill_prompt(cfg, p, prompt_of(x), LM_NEW)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) / reps * 1e3
        steps = {"graph": [], "eager": []}
        for mode in ("eager", "graph", "graph", "eager"):
            with graph.eager() if mode == "eager" \
                    else contextlib.nullcontext():
                run(p, x, steps[mode])
        print(f"[slice] {cfg.name} {dt}: prefill of {LM_PROMPT - 1} "
              f"embeddings x {LM_BATCH} {pre_ms:.2f} ms (mean of {reps}); "
              f"decode {(run_ms - pre_ms) / LM_NEW:.3f} ms/step (the counted "
              f"run less prefill, over {LM_NEW} steps, the graph's capture "
              f"included); steps 2..{LM_NEW} alone in the turns eager, "
              f"graph, graph, eager: graphed " + " / ".join(
                  f"{v:.3f}" for v in steps["graph"]) + ", eager "
              + " / ".join(f"{v:.3f}" for v in steps["eager"])
              + " ms/step (host clock, synchronized)")
        _lm_agreement(cfg, p, prompt_of(x), None, dt, feeds=feeds_of(x))
        _replays_equal_eager(cfg, p, prompt_of(x), f"[graph] {cfg.name} {dt}",
                             feeds=feeds_of(x))
    del params, inputs
    torch.cuda.empty_cache()


# -- training (phase 6) ---------------------------------------------------

def bwd_case(shape, window, seed=0) -> dict:
    """flash_prefill_bwd (fp32) against flash_prefill_bwd_ref at q shape
    (B, S, K, G, D): each of dq, dk, dv within BWD_TOL x max|ref| per
    element, two calls the same bits.  The library call is SDPA's
    backward (``enable_gqa``, causal or windowed mask): autograd.grad of
    one forward kept with its graph.  The bound counts the five products
    of a backward (Q K^T, dO V^T, P^T dO, dS^T Q, dS K: 10 D FLOP a live
    pair) at the fp32 peak, or q, k, v, o, dO read and dq, dk, dv
    written once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import ops, ref

    b, s, k, g, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(shape, generator=gen, device="cuda")
    kk, vv = (torch.randn((b, s, k, d), generator=gen, device="cuda")
              for _ in range(2))
    do = torch.randn(shape, generator=gen, device="cuda")
    o = ops.flash_prefill(q, kk, vv, sliding_window=window)

    def kernel():
        return ops.flash_prefill_bwd(q, kk, vv, o, do, sliding_window=window)

    got, again = kernel(), kernel()
    want = ref.flash_prefill_bwd_ref(q, kk, vv, o, do, window)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    errs = [(x - y).abs().max().item() for x, y in zip(got, want)]
    of_limit = max(e / (BWD_TOL * y.abs().max().item())
                   for e, y in zip(errs, want))
    finite = all(bool(torch.isfinite(x).all()) for x in got)

    qh = q.reshape(b, s, k * g, d).transpose(1, 2).detach().requires_grad_()
    kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (kk, vv))
    doh = do.reshape(b, s, k * g, d).transpose(1, 2)
    mask = None
    if window:
        pos = torch.arange(s, device="cuda")
        diff = pos[:, None] - pos[None, :]
        mask = (diff >= 0) & (diff < window)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                         is_causal=mask is None,
                                         enable_gqa=True)

    def sdpa_bwd():
        return torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True)

    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: ref.flash_prefill_bwd_ref(q, kk, vv, o, do,
                                                         window), iters=5)
    library_ms = time_ms(sdpa_bwd)
    dev = (device_ms(kernel), device_ms(sdpa_bwd))
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
    nbytes = 4 * 4 * (q.numel() + kk.numel())   # q o do dq, k v dk dv
    del out
    return dict(kernel="flash_prefill_bwd", desc=f"q{tuple(shape)} w{window}"
                + ("" if same else " NOT BIT-REPRODUCIBLE"),
                shape=tuple(shape), dtype="float32", err=max(errs),
                of_limit=of_limit, ok=of_limit <= 1.0 and same and finite,
                per_call=0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                dev_ms=dev[0], library_dev_ms=dev[1],
                **bound(10.0 * b * k * g * d * pairs, nbytes, "float32"))


def moe_bwd_case(shape, seed=0) -> dict:
    """MoeGemm's backward (fp32) at x (E, C, D), w (E, D, F): dx and dw
    of one ``MoeGemm.apply`` (two wrapper launches on transposed copies,
    each in the variant of its own shape, which it must take) against
    autograd of ``moe_gemm_ref`` on the same x, w and dy, each within
    FP32_TOL x max(1, max|ref|); two calls the same bits.  The library
    calls are ``torch.bmm(dy, wᵀ)`` and ``torch.bmm(xᵀ, dy)`` on
    transposed views, no copies.  The bound counts 4 E C D F FLOP at the
    fp32 peak, or x, w and dy read and dx and dw written once."""
    import torch
    from repro_torch.kernels.moe_gemm import ops, ref

    e, c, d, f = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((e, c, d), generator=gen, device="cuda")
    w = torch.randn((e, d, f), generator=gen, device="cuda") / d ** 0.5
    dy = torch.randn((e, c, f), generator=gen, device="cuda")
    leaves = [t.clone().requires_grad_() for t in (x, w)]
    y = ops.MoeGemm.apply(*leaves)

    def kernel():
        return torch.autograd.grad(y, leaves, dy, retain_graph=True)

    plans = [ops._plan(e, c, f, d, torch.float32, True)[0],     # dx
             ops._plan(e, d, c, f, torch.float32, True)[0]]     # dw
    before = dict(ops.variant_counts)
    got = kernel()
    took = {v: ops.variant_counts[v] - before[v] for v in ops.VARIANTS}
    again = kernel()
    plain_leaves = [t.clone().requires_grad_() for t in (x, w)]
    y_ref = ref.moe_gemm_ref(*plain_leaves)

    def plain():
        return torch.autograd.grad(y_ref, plain_leaves, dy,
                                   retain_graph=True)

    want = plain()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    checks = [check_close(a, b, torch.float32) for a, b in zip(got, want)]
    as_planned = took == {v: plans.count(v) for v in ops.VARIANTS}
    xt, wt = x.transpose(1, 2), w.transpose(1, 2)

    def library():
        return torch.bmm(dy, wt), torch.bmm(xt, dy)

    ms = time_ms(kernel)
    plain_ms = time_ms(plain)
    library_ms = time_ms(library)
    dev = (device_ms(kernel), device_ms(library))
    nbytes = 4 * (2 * x.numel() + 2 * w.numel() + dy.numel())
    del y, y_ref, got, again, want
    return dict(kernel="moe_gemm", desc=f"backward x{tuple(shape[:3])} "
                f"F{f} dx {plans[0]}, dw {plans[1]}"
                + ("" if same else " NOT BIT-REPRODUCIBLE")
                + ("" if as_planned else f" TOOK {took}"),
                dtype="float32", err=max(r[0] for r in checks),
                of_limit=max(r[1] for r in checks),
                ok=all(r[2] for r in checks) and same and as_planned,
                per_call=0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                dev_ms=dev[0], library_dev_ms=dev[1],
                **bound(4.0 * e * c * d * f, nbytes, "float32"))


def ssd_bwd_case(shape, overflow=False, seed=0) -> dict:
    """SsdChunk's backward (fp32) at (BC, Q, H, P, N): dx, ddt, dA, dB and
    dC of one ``SsdChunk.apply`` (one ssd_chunk_bwd launch, then the
    wrapper's finish in torch) against autograd of ``ssd_chunk_ref`` on
    the same inputs and seeded dy and dst, each within FP32_TOL x max(1,
    max|ref|) and finite; two calls the same bits.  The inputs have the
    model's ranges, as ``ssd_case``'s; ``overflow`` sets A = -1 and
    dt the softplus of a standard normal (no ``dt_bias``), and requires
    the decays to sum past -100 along each chunk (exp above the diagonal
    would overflow there).  The description names the plan
    (``ops.bwd_plan``), whose shared memory, grid and G must be the C
    side's (``ops.bwd_layout``).  Times: the wrapper (kernel and finish),
    the plain version (``ssd_chunk_bwd_ref``), and as device ms the
    kernel alone and the finish alone on the kernel's partials.  No
    single PyTorch call computes it: no library time.  The bound counts
    dM and M^T dy (4 P a causal pair and head), C B^T, dB and dC (6 N a
    pair, once a chunk) and the state terms (4 Q P N a head) at the fp32
    peak, or the inputs read and the gradients written once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd import ops, ref

    bc, q, h, p, n = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*size):
        return torch.randn(size, generator=gen, device="cuda")

    dt_bias = torch.log(torch.expm1(torch.linspace(1e-3, 0.1, h,
                                                   device="cuda")))
    x = randn(bc, q, h, p)
    # overflow: dt the softplus of a standard normal (about 0.8), A = -1
    dt = F.softplus(randn(bc, q, h) + (0.0 if overflow else dt_bias))
    A = -torch.ones(h, device="cuda") if overflow \
        else -torch.linspace(1.0, 16.0, h, device="cuda")
    Bm, Cm = randn(bc, q, n), randn(bc, q, n)
    dy, dst = randn(bc, q, h, p), randn(bc, h, p, n)
    args = (x, dt, A, Bm, Cm)
    cum_last = torch.cumsum(dt * A, dim=1)[:, -1]
    if overflow and not bool((cum_last < -100).all()):
        fail(f"ssd_chunk_bwd overflow case: cum_last up to "
             f"{cum_last.max().item():.1f}, not past -100")
    pl = ops.bwd_plan(*shape)
    same_layout = ops.bwd_layout(*shape) == (pl.smem, pl.grid, pl.g)
    leaves = [t.clone().requires_grad_() for t in args]
    outs = ops.SsdChunk.apply(*leaves)

    def kernel():
        return torch.autograd.grad(outs, leaves, (dy, dst),
                                   retain_graph=True)

    before = ops.launch_count("ssd_chunk_bwd")
    got = kernel()
    launched = ops.launch_count("ssd_chunk_bwd") - before
    again = kernel()
    plain = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(ref.ssd_chunk_ref(*plain), plain, (dy, dst))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    checks = [check_close(a, b, torch.float32) for a, b in zip(got, want)]
    del outs, leaves, plain, got, again, want

    # the kernel alone on preallocated partials, and the finish alone
    dx = torch.empty_like(x)
    part = [x.new_empty((bc, q, h)) for _ in range(4)]
    dbc = [x.new_empty((pl.grid[0], bc, q, n)) for _ in range(2)]
    ptrs = [t.data_ptr() for t in (*args, dy, dst, dx, *part, *dbc)]

    def launch():
        ops._KERNELS.launch("ssd_chunk_bwd", x, *ptrs, bc, q, h, p, n)

    launch()
    ms = time_ms(lambda: ops.ssd_chunk_bwd(*args, dy, dst))
    plain_ms = time_ms(lambda: ref.ssd_chunk_bwd_ref(*args, dy, dst),
                       iters=5)
    dev = device_ms(lambda: ops.ssd_chunk_bwd(*args, dy, dst))
    kernel_dev = device_ms(launch)
    finish_dev = device_ms(lambda: ops.bwd_finish(dt, A, *part, *dbc))
    pairs = q * (q + 1) // 2
    flops = bc * (4.0 * pairs * p * h + 6.0 * pairs * n + 4.0 * q * p * n * h)
    nbytes = 4 * (3 * x.numel() + 2 * dt.numel() + 2 * A.numel()
                  + 4 * Bm.numel() + dst.numel())
    return dict(kernel="ssd_chunk_bwd",
                desc=f"(BC,Q,H,P,N){tuple(shape)}"
                + (f" A=-1 cum_last {cum_last.max().item():.0f}.."
                   f"{cum_last.min().item():.0f}" if overflow else "")
                + f" PW{pl.pw} NW{pl.nw} G{pl.g} grid{pl.grid} "
                f"smem {pl.smem}; kernel {kernel_dev:.4f} + finish "
                f"{finish_dev:.4f} device ms"
                + ("" if same else " NOT BIT-REPRODUCIBLE")
                + ("" if same_layout else " PLAN AND KERNEL DIFFER")
                + ("" if launched == 1 else f" LAUNCHED {launched}"),
                dtype="float32", err=max(c[0] for c in checks),
                of_limit=max(c[1] for c in checks),
                ok=all(c[2] for c in checks) and same and same_layout
                and launched == 1,
                per_call=0, ms=ms, plain_ms=plain_ms, library_ms=None,
                dev_ms=dev, library_dev_ms=None, kernel_dev_ms=kernel_dev,
                finish_dev_ms=finish_dev, **bound(flops, nbytes, "float32"))


@contextlib.contextmanager
def _routes_recorded(routes: dict):
    """``model.moe`` wrapped to record each call's routing decisions (a
    token's sorted top-k set) in ``routes[backend][layer]``, a layer by
    its router's address (both backends read the same params); remat's
    recompute writes the same sets again."""
    import torch
    from repro_torch.models.transformer import model as M

    real = M.moe

    def recording(p, x, top_k, capacity_factor=1.25, backend="cuda"):
        with torch.no_grad():
            probs = torch.softmax((x @ p.router).float(), dim=-1)
            routes.setdefault(backend, {})[p.router.data_ptr()] = \
                torch.topk(probs, top_k, dim=-1).indices.sort(dim=-1).values
        return real(p, x, top_k, capacity_factor, backend=backend)

    M.moe = recording
    try:
        yield
    finally:
        M.moe = real


def _grad_parity(cfg, params, batch, want: dict) -> None:
    """``loss_fn`` and its gradient on the kernel path, the kernels'
    launches counted (reset just before, read just after) and held to
    ``want``, against ``backend="torch"`` on the same weights and batch:
    the loss within LOSS_TOL relative, every leaf finite and within
    GRAD_TOL x max|g| of its leaf, the worst leaf named.  For an MoE
    arch, the routing decisions that differ between the two paths are
    counted, by layer where there are any, and the peak memory printed.
    Frees ``params``' gradients, not ``params``."""
    import torch

    ops = _kernel_ops()
    routes: dict = {}
    record = _routes_recorded(routes) if cfg.is_moe \
        else contextlib.nullcontext()
    torch.cuda.reset_peak_memory_stats()
    with record:
        _reset_counts()
        loss, grads = _grads(cfg, params, batch, "cuda")
        got = {n: ops[n].launch_count(n) for n in ops}
        loss_t, grads_t = _grads(cfg, params, batch, "torch")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    worst, name, shares = 0.0, "", {}
    for (n, g), (_, gt) in zip(grads, grads_t):
        if not bool(torch.isfinite(g).all()):
            fail(f"gradient of {n} is not finite")
        share = shares[n] = ((g - gt).abs().max()
                             / (GRAD_TOL * gt.abs().max())).item()
        if not share <= worst:
            worst, name = share, n
    del grads, grads_t
    torch.cuda.empty_cache()
    rel = abs(loss - loss_t) / abs(loss_t)
    counted = ", ".join(f"{n} {got[n]}" for n in ops if want.get(n))
    print(f"[train] loss_fn + backward, kernel path ({counted} launches) vs "
          f"backend=\"torch\": loss {loss:.6f} / {loss_t:.6f} ({rel:.2e} "
          f"relative, limit {LOSS_TOL:g}); {len(shares)} gradient leaves, "
          f"all finite; worst leaf {name}: {worst:.3f} of {GRAD_TOL:g} x "
          f"max|g| of its leaf"
          + ("" if cfg.is_moe else f"; peak memory {peak:.2f} GiB"))
    if cfg.is_moe:
        per_layer = [int((routes["cuda"][k] != t).any(dim=-1).sum())
                     for k, t in routes["torch"].items()]
        total = sum(t.shape[0] * t.shape[1] for t in routes["torch"].values())
        print(f"[train] routing decisions that differ between the two "
              f"paths: {sum(per_layer)} of {total} (tokens x layers"
              + (f"; by layer {per_layer}" if any(per_layer) else "")
              + f"); peak memory {peak:.2f} GiB")
        if not worst <= 1.0:
            print("[train] leaves past the limit: " + ", ".join(
                f"{n} {v:.3f}" for n, v in shares.items() if v > 1.0))
    if not rel <= LOSS_TOL or not worst <= 1.0:
        fail("the kernel path's loss or gradients outside the limits")
    if got != want:
        fail(f"loss_fn + backward launched {got}, want {want}")
def _grads(cfg, params, batch, backend):
    """(loss, [(leaf path, gradient)]) of ``loss_fn`` on ``backend``
    (``training.loss_and_grads``: autograd over every leaf, which raises
    if one has no gradient)."""
    from repro_torch.training import loss_and_grads, tree

    loss, grads = loss_and_grads(cfg, params, batch, backend=backend)
    return loss.item(), tree.named_leaves(grads)


def _train_step_profile(cfg, batch, finish_ms=None) -> None:
    """One profiled train step (after one warm-up step) on fresh weights:
    device time by kernel, the backward kernel's share, busy share of the
    step's wall; for an MoE arch, moe_gemm by part
    (:func:`_moe_step_split`); for a Mamba2 arch ssd_chunk_bwd's device
    time and share, and its torch finish at ``finish_ms`` a call (timed
    alone at the path's shape) times its launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.transformer import model as M
    from repro_torch.training import AdamW, make_train_step

    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    opt = AdamW(lr=1e-4)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    params, state, loss = step(params, state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
    busy = sum(ms for _, ms, _ in rows)
    if busy <= 0:
        print(f"[train] profiled step (torch.profiler): the profiler saw no "
              f"device time in {wall:.2f} ms wall; shares not measured")
        del params, state, loss, step
        return
    bwd = sum(ms for k, ms, _ in rows if "flash_prefill_bwd" in k)
    fwd = sum(ms for k, ms, _ in rows
              if "flash_prefill" in k and "bwd" not in k)
    print(f"[train] profiled step (torch.profiler): device busy "
          f"{busy:.2f} of {wall:.2f} ms wall ({100 * busy / wall:.1f}%); "
          f"flash_prefill_bwd kernels {bwd:.3f} ms ({100 * bwd / busy:.2f}% "
          f"of the device time), flash_prefill {fwd:.3f} ms "
          f"({100 * fwd / busy:.2f}%)")
    if cfg.is_ssm:
        sbwd = [(ms, n) for k, ms, n in rows if "ssd_chunk_bwd" in k]
        sfwd = sum(ms for k, ms, _ in rows
                   if "ssd_chunk" in k and "bwd" not in k)
        ms_b, n_b = sum(m for m, _ in sbwd), sum(n for _, n in sbwd)
        glue = f"{finish_ms * n_b:.3f}" if finish_ms is not None \
            else "not measured"
        print(f"[train] ssd_chunk_bwd kernel {ms_b:.3f} ms device in {n_b} "
              f"launches ({100 * ms_b / busy:.2f}% of the device time); "
              f"its finish in torch (reverse cumsum, sums), timed alone at "
              f"the path's shape: {glue} ms for the step "
              f"({finish_ms if finish_ms is not None else 0:.4f} a call); "
              f"ssd_chunk {sfwd:.3f} ms ({100 * sfwd / busy:.2f}%)")
    top = sorted(rows, key=lambda r: -r[1])
    for key, ms, n in top[:8] + [r for r in top[8:] if "flash" in r[0]
                                 or "moe_gemm" in r[0] or "ssd" in r[0]]:
        print(f"[train]   {ms:9.3f} ms  {100 * ms / busy:5.1f}%  x{n:<5d} "
              f"{key[:90]}")
    if cfg.is_moe:
        _moe_step_split(cfg, prof, busy)
    del params, state, loss, step


def _train_launches(cfg, steps: int) -> dict:
    """Each kernel's launches in ``steps`` train steps (or one
    ``loss_and_grads`` for 1), remat on: per attention (a layer, or a
    shared-block site of a hybrid) two flash_prefill (the forward and
    remat's recompute) and one flash_prefill_bwd; with MoE 12 moe_gemm a
    layer (3 forward, 3 recomputed, 6 backward: dx and dw of each
    product); per Mamba2 layer two ssd_chunk and one ssd_chunk_bwd."""
    from repro_torch.models.transformer import model as M

    L = cfg.n_layers
    attn = M.n_shared_apps(cfg) if cfg.shared_attn_every \
        else 0 if cfg.is_ssm else L
    want = dict.fromkeys(_kernel_ops(), 0)
    want["flash_prefill"] = steps * 2 * attn
    want["flash_prefill_bwd"] = steps * attn
    if cfg.is_moe:
        want["moe_gemm"] = steps * 12 * L
    if cfg.is_ssm:
        want["ssd_chunk"] = steps * 2 * L
        want["ssd_chunk_bwd"] = steps * L
    return want


def _train_counted(cfg, rep, label: str) -> dict:
    """A training run's lines and checks: the kernels' launches since
    the last reset against :func:`_train_launches`, finite losses, step
    ms from step 2 on, tokens/s and the peak memory since the last
    reset.  Returns the launches by kernel."""
    import torch

    ops = _kernel_ops()
    got = {n: ops[n].launch_count(n) for n in ops}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = _train_launches(cfg, TRAIN_STEPS)
    print(f"[train] {label}, {TRAIN_STEPS} steps: "
          + ", ".join(f"{n} launches {got[n]} (want {want[n]})" for n in got))
    if got != want:
        fail(f"training launched {got}, want {want}")
    if len(rep.losses) != TRAIN_STEPS or not all(
            x == x and abs(x) < float("inf") for x in rep.losses):
        fail(f"training losses {rep.losses}")
    later = rep.step_s[1:]
    step_ms = 1e3 * sum(later) / len(later)
    print(f"[train] losses {', '.join(f'{x:.4f}' for x in rep.losses)}; "
          f"step ms {', '.join(f'{1e3 * t:.1f}' for t in rep.step_s)} "
          f"(host clock, each ending in the loss read); steps 2-"
          f"{TRAIN_STEPS} {step_ms:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.0f} tokens/s; peak "
          f"memory {peak:.2f} GiB")
    return got


def _moe_step_split(cfg, prof, busy: float) -> None:
    """moe_gemm's device time in one profiled MoE train step, by part,
    from the order of the kernels on the stream: the 3 L forward
    launches come first; then each layer's backward, last layer first,
    runs remat's recompute (3 launches) before its 6 backward ones.  The
    kernel just before each backward launch is the copy of its
    transposed operand (wᵀ for dx, xᵀ for dw)."""
    import torch

    dev = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    at = [i for i, e in enumerate(dev) if "moe_gemm" in e.name]
    L = cfg.n_layers
    if len(at) != 12 * L:
        print(f"[train] moe_gemm by part: not measured (the profiler saw "
              f"{len(at)} of the step's {12 * L} launches)")
        return
    rest = at[3 * L:]
    parts = {"forward": at[:3 * L],
             "recompute": [i for j, i in enumerate(rest) if j % 9 < 3],
             "backward": [i for j, i in enumerate(rest) if j % 9 >= 3]}
    copies = [i - 1 for i in parts["backward"]]

    def ms(idx):
        return sum(dev[i].time_range.elapsed_us() for i in idx) / 1e3

    print(f"[train] moe_gemm device ms of the profiled step: " + ", ".join(
        f"{k} {ms(v):.3f} ({len(v)} launches, {ms(v) / len(v):.4f} each)"
        for k, v in parts.items())
          + f"; {100 * ms(at) / busy:.1f}% of the device time")
    if all("copy" in dev[i].name for i in copies):
        print(f"[train] the backward's transposed copies (wᵀ, xᵀ): "
              f"{ms(copies):.3f} ms device, {len(copies)} copies, "
              f"{100 * ms(copies) / busy:.2f}% of the step's device time, "
              f"{100 * ms(copies) / ms(parts['backward']):.1f}% of the "
              f"backward products'")
    else:
        print(f"[train] the backward's transposed copies: not measured "
              f"(a kernel before a backward launch is not a copy: "
              f"{sorted({dev[i].name[:60] for i in copies})})")


def run_train_moe() -> int:
    """Phase 6 (a')-(c'), granite-moe-3b-a800m in fp32: (a') MoeGemm's
    backward against autograd of the plain version; (b') loss_fn's
    gradients at full depth, kernel path against backend="torch"; (c')
    five steps of ``training.loop.train`` at MOE_TRAIN_LAYERS layers,
    counted, then one profiled step.  Returns the moe_gemm launches of
    (b') and (c')."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models.transformer import model as M
    from repro_torch.training.loop import train

    moe = _kernel_ops()["moe_gemm"]
    cfg = configs.get(MOE_ARCH)
    print(f"[train] {cfg.name}: {_describe(cfg)}, "
          f"{cfg.param_count() / 1e9:.2f} G params, fp32, batch "
          f"{TRAIN_BATCH}, seq {TRAIN_SEQ}, TokenStream seed 0")

    # -- (a') MoeGemm's backward against autograd of the plain version -----
    cases = [moe_bwd_case(shape) for shape in MOE_BWD_CASES]
    print(f"[train] moe_gemm backward (MoeGemm: dx = dy wT, dw = xT dy, "
          f"transposed copies): {len(cases)} cases | max_abs_err (worst of "
          f"dx, dw over {FP32_TOL:g} x max(1, max|ref|)) | ms kernel / plain "
          f"autograd / torch.bmm pair / bound | device ms kernel / "
          f"torch.bmm pair")
    _print_cases(cases)
    torch.cuda.empty_cache()
    if any(not r["ok"] for r in cases):
        fail("MoeGemm's backward disagrees with autograd of the plain "
             "version, is not bit-repeatable or took another variant")

    # -- (b') gradients at full depth: kernel path against backend="torch"
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    batch = TokenStream(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                        device="cuda").batches(1)[0]
    want = _train_launches(cfg, 1)
    _grad_parity(cfg, params, batch, want)
    del params
    torch.cuda.empty_cache()

    # -- (c') five steps at MOE_TRAIN_LAYERS layers, counted ---------------
    small = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rep = train(small, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                lr=3e-3, seed=0, log_every=10, warmup=10, device="cuda")
    variants = dict(moe.variant_counts)
    _train_counted(small, rep, f"training.loop.train at "
                   f"{MOE_TRAIN_LAYERS} of {cfg.n_layers} layers "
                   f"({small.param_count() / 1e9:.2f} G params)")
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    c = TRAIN_BATCH * max(1, int(cfg.capacity_factor * cfg.moe_top_k
                                 * TRAIN_SEQ / e))
    # a layer's products, forward (run twice with remat) then dx and dw
    fwd = [(e, c, d, ff), (e, c, d, ff), (e, c, ff, d)]
    bwd = [s for (e_, c_, d_, f_) in fwd
           for s in ((e_, c_, f_, d_), (e_, d_, c_, f_))]
    want_v = dict.fromkeys(moe.VARIANTS, 0)
    for shape, n in [(s, 2) for s in fwd] + [(s, 1) for s in bwd]:
        want_v[moe._plan(*shape, torch.float32, True)[0]] += \
            n * TRAIN_STEPS * small.n_layers
    print(f"[train] moe_gemm variants: " + ", ".join(
        f"{v} {n}" for v, n in variants.items()) + f" (want {want_v})")
    if variants != want_v:
        fail(f"training's moe_gemm variants {variants}, want {want_v}")
    _train_step_profile(small, batch)
    torch.cuda.empty_cache()
    return want["moe_gemm"] + _train_launches(small, TRAIN_STEPS)["moe_gemm"]


def run_train_ssm() -> tuple[int, dict]:
    """Phase 6 (a″)-(c‴), mamba2-370m and zamba2-2.7b in fp32: (a″)
    SsdChunk's backward against autograd of the plain version; (b″) and
    (b‴) loss_fn's gradients at full depth, kernel path against
    backend="torch"; (c″) five steps of mamba2 through
    ``launch.train.main``, counted, then one profiled step; (c‴) five
    steps of ``training.loop.train`` of zamba2 at HYBRID_TRAIN_LAYERS
    layers, counted.  Returns the ssd_chunk launches of the counted runs
    and the kernels entry of ``ssd_chunk_bwd`` (its times summed over one
    mamba2 train step at the path's shape, its launches phase 6's)."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import train as launcher
    from repro_torch.models.transformer import model as M
    from repro_torch.training.loop import train

    ssd = _kernel_ops()["ssd_chunk_bwd"]
    cfg = configs.get(SSM_ARCH)
    print(f"[train] {cfg.name}: {_describe(cfg)}, "
          f"{cfg.param_count() / 1e9:.2f} G params, fp32, batch "
          f"{TRAIN_BATCH}, seq {TRAIN_SEQ}, TokenStream seed 0")

    # -- (a″) the backward kernel against autograd of the plain version ----
    cases = [ssd_bwd_case(shape, overflow)
             for shape, overflow in SSD_BWD_CASES]
    print(f"[train] ssd_chunk_bwd (SsdChunk's backward: the kernel, then "
          f"its finish in torch): {len(cases)} cases | max_abs_err (worst "
          f"of dx, ddt, dA, dB, dC over {FP32_TOL:g} x max(1, max|ref|)) | "
          f"ms wrapper / plain (ssd_chunk_bwd_ref) / library (none) / "
          f"bound | device ms wrapper")
    _print_cases(cases)
    torch.cuda.empty_cache()
    if any(not r["ok"] for r in cases):
        fail("ssd_chunk_bwd disagrees with autograd of the plain version, "
             "is not bit-repeatable, or its plan is not the kernel's")
    path = cases[0]
    path["per_call"] = cfg.n_layers       # one backward a layer a step

    # -- (b″) mamba2's gradients at full depth -------------------------------
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    batch = TokenStream(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                        device="cuda").batches(1)[0]
    want = _train_launches(cfg, 1)
    _grad_parity(cfg, params, batch, want)
    del params
    torch.cuda.empty_cache()

    # -- (b‴) zamba2's gradients at full depth -------------------------------
    hyb = configs.get(HYBRID_ARCH)
    print(f"[train] {hyb.name}: {_describe(hyb)}, "
          f"{hyb.param_count() / 1e9:.2f} G params, fp32, batch "
          f"{TRAIN_BATCH}, seq {TRAIN_SEQ}, TokenStream seed 0")
    params = M.init_params(hyb, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    hbatch = TokenStream(hyb.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                         device="cuda").batches(1)[0]
    want_h = _train_launches(hyb, 1)
    _grad_parity(hyb, params, hbatch, want_h)
    del params
    torch.cuda.empty_cache()

    # -- (c″) mamba2 through the launcher, counted ---------------------------
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rep = launcher.main(["--arch", SSM_ARCH, "--steps", str(TRAIN_STEPS),
                         "--batch", str(TRAIN_BATCH), "--seq",
                         str(TRAIN_SEQ), "--seed", "0", "--device", "cuda"])
    got = _train_counted(cfg, rep, "launch.train.main")
    _train_step_profile(cfg, batch, path["finish_dev_ms"])
    torch.cuda.empty_cache()

    # -- (c‴) zamba2 at HYBRID_TRAIN_LAYERS layers, counted ------------------
    small = dataclasses.replace(hyb, n_layers=HYBRID_TRAIN_LAYERS)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rep = train(small, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                lr=3e-3, seed=0, log_every=10, warmup=10, device="cuda")
    got_h = _train_counted(small, rep, f"training.loop.train at "
                           f"{HYBRID_TRAIN_LAYERS} of {hyb.n_layers} layers "
                           f"({M.n_shared_apps(small)} shared-block sites, "
                           f"{small.param_count() / 1e9:.2f} G params)")
    torch.cuda.empty_cache()

    runs = (want, want_h, got, got_h)
    t_ops, t_bytes = path["t_ops_ms"], path["t_bytes_ms"]
    n = path["per_call"]
    entry = {"name": "ssd_chunk_bwd", "route": "cuda",
             "source": str(ssd.SOURCES["ssd_chunk_bwd"].relative_to(ROOT)),
             "replaces": REPLACES["ssd_chunk_bwd"],
             "launches": sum(r["ssd_chunk_bwd"] for r in runs),
             "max_abs_err": path["err"],
             **{key: None if path[key] is None else path[key] * n
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
             "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    print(f"[kernels] ssd_chunk_bwd: ms, plain_ms, bound_ms summed over one "
          f"{cfg.name} train step's {n} launches at (BC,Q,H,P,N)"
          f"{SSD_BWD_CASES[0][0]}; device {path['dev_ms'] * n:.3f} ms "
          f"(kernel {path['kernel_dev_ms'] * n:.3f}, finish "
          f"{path['finish_dev_ms'] * n:.3f}), bound "
          f"{path['bound_ms'] * n:.3f} ms ("
          f"{100 * path['bound_ms'] / path['kernel_dev_ms']:.1f}% of the "
          f"kernel's device time); launches: phase 6's {entry['launches']}")
    return sum(r["ssd_chunk"] for r in runs), entry


def run_train() -> tuple[int, int, list[dict]]:
    """Phase 6, training in fp32.  Llama-3.2-1B at full width: (a) the
    backward kernel against its plain version (the path's shape and
    edges); (b) loss_fn's gradients on the kernel path against
    backend="torch" on the same weights and batch, every leaf; (c) five
    steps through ``launch.train.main``, its kernels counted (reset just
    before, read just after).  Then granite (:func:`run_train_moe`), then
    mamba2 and zamba2 (:func:`run_train_ssm`).  Returns the moe_gemm
    launches of granite's counted runs, the ssd_chunk launches of
    mamba2's and zamba2's, and the kernels entries of
    ``flash_prefill_bwd`` (summed over one Llama train step) and
    ``ssd_chunk_bwd``."""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import train as launcher
    from repro_torch.models.transformer import model as M

    cfg = configs.get(LM_ARCH)
    ops = _kernel_ops()
    attn = ops["flash_prefill"]
    print(f"[train] {cfg.name}: {_describe(cfg)}, "
          f"{cfg.param_count() / 1e9:.2f} G params, fp32, batch "
          f"{TRAIN_BATCH}, seq {TRAIN_SEQ}, TokenStream seed 0")

    # -- (a) the backward kernel against its plain version ----------------
    cases = [bwd_case(shape, w) for shape, w in BWD_CASES]
    print(f"[train] flash_prefill_bwd: {len(cases)} cases | max_abs_err "
          f"(worst of dq, dk, dv over {BWD_TOL:g} x max|ref|) | ms kernel / "
          f"plain / SDPA backward / bound | device ms kernel / SDPA "
          f"backward")
    _print_cases(cases)
    if any(not r["ok"] for r in cases):
        fail("flash_prefill_bwd disagrees with its plain version, or is "
             "not bit-repeatable")
    path = cases[0]
    path["per_call"] = cfg.n_layers       # one backward a layer a step

    # -- (b) gradients: kernel path against backend="torch" ---------------
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    batch = TokenStream(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                        device="cuda").batches(1)[0]
    # remat runs each layer again: two flash_prefill a layer
    _grad_parity(cfg, params, batch, _train_launches(cfg, 1))
    del params
    torch.cuda.empty_cache()

    # -- (c) training through the launcher, counted ------------------------
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    rep = launcher.main(["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS),
                         "--batch", str(TRAIN_BATCH), "--seq",
                         str(TRAIN_SEQ), "--seed", "0", "--device", "cuda"])
    got = _train_counted(cfg, rep, "launch.train.main")
    _train_step_profile(cfg, batch)
    torch.cuda.empty_cache()

    # -- (a')-(c') granite: moe_gemm's backward, then training ----------
    moe_launches = run_train_moe()

    # -- (a″)-(c‴) mamba2 and zamba2: ssd_chunk's backward, training ------
    ssd_launches, ssd_entry = run_train_ssm()

    t_ops, t_bytes = path["t_ops_ms"], path["t_bytes_ms"]
    n = path["per_call"]
    entry = {"name": "flash_prefill_bwd", "route": "cuda",
             "source": str(attn.SOURCES["flash_prefill_bwd"]
                           .relative_to(ROOT)),
             "replaces": REPLACES["flash_prefill_bwd"],
             "launches": got["flash_prefill_bwd"],
             "max_abs_err": path["err"],
             **{key: path[key] * n
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
             "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    return moe_launches, ssd_launches, [entry, ssd_entry]


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


def _same(a: dict, b: dict) -> bool:
    """Two dicts of tensors with the same keys and the same bits."""
    import torch
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _cnn_graph(dep, model, frames, reps: int = 10) -> None:
    """``[graph]`` lines of the CNN path, its stages' graphs captured by
    the counted run: each stage's replays against its eager body, bit
    for bit, one frame and the 8-frame stack, fed the eager outputs of
    the stages before; ``dep.run`` ms/frame graphed and with every body
    eager, in turns; parameter sets A, B, A, each against its own eager
    run; outputs handed out, unchanged by the next run."""
    import torch
    from repro_torch.exec import graph

    params = dep.params
    stack = torch.stack(frames)
    for form, image in (("frame", frames[0]), ("frames", stack)):
        produced = {}
        for si, ex in enumerate(dep.runner.stages):
            bnd = ex.boundary_inputs(produced, image)
            cs = ex._executable(bnd)
            run, body = ((cs, cs._run) if form == "frame"
                         else (cs.run_frames, cs._run_frames))
            n_graphs = len(cs._graphs)
            first, second = run(params, bnd), run(params, bnd)
            want = body(params, bnd)
            torch.cuda.synchronize()
            print(f"[graph] cnn stage {si} ({len(ex.nodes)} nodes) "
                  f"{form}: {n_graphs} graph(s) before, two replays vs the "
                  f"eager body: "
                  f"{'equal' if _same(first, want) and _same(second, want) else 'DIFFER'}"
                  f" bit for bit ({', '.join(sorted(want))})")
            if not (_same(first, want) and _same(second, want)):
                fail(f"cnn stage {si} {form}: graph replay differs from "
                     f"the eager body")
            if n_graphs == 0:
                fail(f"cnn stage {si} {form}: the counted run captured no "
                     f"graph")
            produced.update(want)

    times = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        with graph.eager() if mode == "eager" else contextlib.nullcontext():
            dep.run(frames[0])
            dep.run(frames)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                dep.run(frames[0])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(reps):
                dep.run(frames)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        times[mode].append(((t1 - t0) / reps * 1e3,
                            (t2 - t1) / reps / len(frames) * 1e3))
    for mode, rows in times.items():
        print(f"[graph] cnn dep.run {mode}: frame " + " / ".join(
            f"{a:.3f}" for a, _ in rows) + f" ms/frame; [{len(frames)} "
            f"frames] " + " / ".join(f"{b:.3f}" for _, b in rows)
            + f" ms/frame (mean of {reps} runs each, in the turns eager, "
            f"graph, graph, eager; host clock around synchronized runs)")

    pa = params
    pb = model.init(torch.Generator().manual_seed(1),
                    device=frames[0].device)
    outs = []
    for name, p in (("A", pa), ("B", pb), ("A", pa)):
        got = dep.run(frames[0], params=p)
        with graph.eager():
            want = dep.run(frames[0], params=p)
        torch.cuda.synchronize()
        if not _same(got, want):
            fail(f"cnn params {name}: graphed dep.run differs from eager")
        outs.append(got)
    if not _same(outs[0], outs[2]) or _same(outs[0], outs[1]):
        fail("cnn params A, B, A: A's outputs changed, or B gave A's")
    print("[graph] cnn params A, B, A: each graphed dep.run(frame) equals "
          "its own eager run bit for bit; A twice the same, B not A's")

    one = dep.run(frames[0])
    many = dep.run(frames)
    kept = ({k: v.clone() for k, v in one.items()},
            [{k: v.clone() for k, v in o.items()} for o in many])
    dep.run(frames[1])
    dep.run(frames[::-1])
    torch.cuda.synchronize()
    if not (_same(one, kept[0])
            and all(_same(o, k) for o, k in zip(many, kept[1]))):
        fail("cnn: an output handed out changed with the next dep.run")
    print("[graph] cnn outputs handed out by dep.run (one frame, 8 "
          "frames) unchanged after the next runs")


def _launch_plans(dep, frame) -> list[tuple]:
    """(x shape, w shape, stride, pool, relu, bias, plan the launch took,
    the heuristic's plan) of each conv launch of one single-frame runner
    call, every body eager."""
    from repro_torch.exec import graph
    from repro_torch.kernels.conv2d import ops

    seen = []
    real = ops.conv2d_fused

    def recording(x, w, b=None, *, stride=(1, 1), relu=False, pool=None,
                  tile=None, split=None):
        n, h, wd, ci = x.shape
        kh, kw, _, co = w.shape
        stride = ops.normalize_stride(stride)
        pool = None if pool is None else tuple(pool)
        args = (n, h, wd, ci, kh, kw, co, stride, pool)
        seen.append((tuple(x.shape), tuple(w.shape), stride, pool, relu,
                     b is not None, ops.plan(*args, True, tile, split),
                     ops.plan(*args)))
        return real(x, w, b, stride=stride, relu=relu, pool=pool,
                    tile=tile, split=split)

    ops.conv2d_fused = recording
    try:
        with graph.eager():
            dep.run(frame)
    finally:
        ops.conv2d_fused = real
    return seen


def _tuned_case(x_shape, w_shape, stride, pool, relu, bias, plan,
                seed=0) -> tuple[float, float, bool]:
    """The kernel under a tuned ``plan`` against its plain version at one
    launch's shape (inputs as in :func:`conv_case`): (max |error|, error
    over the fp32 limit, within the limit and the plan's variant taken)."""
    import torch
    from repro_torch.kernels.conv2d import ops, ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    kh, kw, ci, co = w_shape
    x = torch.randn(x_shape, generator=g, device="cuda")
    w = torch.randn(w_shape, generator=g, device="cuda") \
        / (kh * kw * ci) ** 0.5
    b = 0.1 * torch.randn((co,), generator=g, device="cuda") if bias \
        else None
    kw_args = dict(stride=stride, relu=relu, pool=pool)
    before = dict(ops.variant_counts)
    y = ops.conv2d_fused(x, w, b, tile=plan.tile, split=plan.split,
                         **kw_args)
    ran = [v for v in ops.VARIANTS if ops.variant_counts[v] != before[v]]
    y_ref = ref.conv2d_fused_ref(x, w, b, **kw_args)
    torch.cuda.synchronize()
    err, of_limit, ok = check_close(y, y_ref, torch.float32)
    return err, of_limit, ok and ran == [plan.variant]


def run_cnn_tuned(model, cluster, dep, frames, ref_t) -> None:
    """Phase 4c: the CNN path compiled with ``ExecSpec(calibrate=True,
    autotune=True)`` on the card (the conv kernel's launch plans tuned,
    the plan's stages timed, the plan re-built on the measured
    CostTable), saved and loaded with the planner, calibrator and tuner
    counted at zero; the loaded deployment's outputs equal the compiled
    one's bit for bit and the ``"torch"`` backend's (``ref_t``) within
    the CNN tolerance; its conv launches counted; ``dep.run`` ms/frame
    under the default and the tuned plans in turns; the ``[graph]``
    checks again under the tuned plans."""
    import torch
    import repro_torch
    from repro_torch.api import deployment as deployment_mod
    from repro_torch.api.specs import ExecSpec, PlanSpec
    from repro_torch.core import planner as planner_mod
    from repro_torch.exec import autotune, calibrate
    from repro_torch.kernels.conv2d import ops

    autotune.clear_installed()
    tuned, reports = [], []
    real_tune, real_cal = autotune.autotune_conv, calibrate.calibrate_plan

    def tune(*a, **kw):
        tuned.append(real_tune(*a, **kw))
        return tuned[-1]

    def cal(*a, **kw):
        reports.append(real_cal(*a, **kw))
        return reports[-1]

    autotune.autotune_conv, calibrate.calibrate_plan = tune, cal
    t0 = time.perf_counter()
    try:
        spec = ExecSpec(backend="cuda", calibrate=True, autotune=True)
        dep_t = repro_torch.compile(model, cluster, PlanSpec(), spec,
                                    params=dep.params)
        torch.cuda.synchronize()
    finally:
        autotune.autotune_conv, calibrate.calibrate_plan = real_tune, real_cal
    print(f"[time] compile(calibrate=True, autotune=True) "
          f"{time.perf_counter() - t0:.1f} s")
    if not tuned or len(reports) != 1:
        fail(f"compile tuned {len(tuned)} shapes, calibrated "
             f"{len(reports)} times")
    x_of = {autotune.shape_key(d["x_shape"], d["w_shape"], d["stride"],
                               d["relu"], d["pool"]): d["x_shape"]
            for d in autotune.conv_shapes(model)}
    for r in tuned:
        win = next(p for p, _ in r.trials
                   if (p.tile, p.split) == (r.tile, r.split))
        fastest, t_min = min(r.trials, key=lambda t: t[1])
        kept = "" if win != r.heuristic or fastest == win else (
            f" (fastest {_plan_text(fastest)} {t_min * 1e6:.2f} us, "
            f"within the spread)")
        print(f"[autotune] {r.key} at x{x_of[r.key]}: winner "
              f"{_plan_text(win)} {r.best_us:.2f} us{kept}, heuristic "
              f"{_plan_text(r.heuristic)} {r.heuristic_us:.2f} us, spread "
              f"{r.spread_us:.2f} us; {len(r.trials)} plans timed (median "
              f"of {autotune.ROUNDS} rounds in turns, CUDA events around "
              f"{spec.autotune_iters} calls each)"
              + ("; entry null: each width keeps its heuristic plan"
                 if win == r.heuristic else ""))
    rep = reports[0]
    print(f"[calibrate] host_flops {rep.host_flops / 1e12:.2f} TFLOP/s "
          f"(fp32 torch.matmul, n 512, best of 5, TF32 off) against the "
          f"card's fp32 peak {PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s "
          f"({100 * rep.host_flops / PEAK_FLOPS['float32']:.1f}%)")
    again = sorted(calibrate.measure_host_flops() for _ in range(10))
    print(f"[calibrate] host_flops measured 10 times more: min "
          f"{again[0] / 1e12:.2f}, median {again[5] / 1e12:.2f}, max "
          f"{again[-1] / 1e12:.2f} TFLOP/s (spread "
          f"{100 * (again[-1] - again[0]) / again[5]:.0f}% of the median); "
          f"every ratio scales with it")
    for st in rep.stages:
        print(f"[calibrate] stage {st.index} ({len(st.nodes)} nodes): "
              f"{st.measured_s * 1e3:.3f} ms (best of "
              f"{spec.calibrate_iters} replays), {st.flops / 1e9:.3f} "
              f"GFLOP, ratio {st.ratio:.3f}")
    print("[calibrate] re-planned on the measured CostTable (default "
          f"ratio {dep_t.cost_table.default:.3f}):")
    print(dep_t.describe())

    # -- save, then load with the planner, calibrator and tuner counted
    path = ROOT / "build" / "smoke_deployment.json"
    path.parent.mkdir(exist_ok=True)
    dep_t.save(path)
    counted = {"plan": 0, "calibrate": 0, "autotune": 0}
    patched = [(deployment_mod, "plan_with_spec", "plan"),
               (planner_mod, "plan_with_spec", "plan"),
               (planner_mod, "plan", "plan"),
               (calibrate, "calibrate_plan", "calibrate"),
               (autotune, "autotune_conv", "autotune"),
               (autotune, "autotune_model", "autotune")]
    saved = [getattr(mod, name) for mod, name, _ in patched]

    def counting(fn, what):
        def wrapper(*a, **kw):
            counted[what] += 1
            return fn(*a, **kw)
        return wrapper

    autotune.clear_installed()
    for (mod, name, what), fn in zip(patched, saved):
        setattr(mod, name, counting(fn, what))
    try:
        dep_l = repro_torch.Deployment.load(path, params=dep_t.params)
    finally:
        for (mod, name, _), fn in zip(patched, saved):
            setattr(mod, name, fn)
    print(f"[tuned] saved {path.stat().st_size} bytes and loaded: planner, "
          f"calibrator and tuner calls {counted}; "
          f"{len(autotune.installed())} tuned plans installed on load")
    if any(counted.values()) or autotune.installed() != {
            k: e for k, e in dep_t.cost_table.kernels.items()
            if k.startswith("conv:cuda:")} or not autotune.installed():
        fail("load re-planned, re-calibrated or re-tuned, or installed "
             "other plans than the compiled deployment's")

    plans = _launch_plans(dep_l, frames[0])
    other = [rec for rec in plans if rec[-2] != rec[-1]]
    print(f"[tuned] {len(other)} of the {len(plans)} launches of a "
          f"single-frame runner call take a plan other than the "
          f"heuristic's, each held against the plain version (fp32 limit "
          f"{FP32_TOL:g} x max(1, max|ref|)):")
    for xs, ws, st, pool, relu, bias, p, h in other:
        err, of_limit, ok = _tuned_case(xs, ws, st, pool, relu, bias, p)
        print(f"  x{xs} w{ws}: {_plan_text(p)} (heuristic "
              f"{_plan_text(h)}): max |err| {err:.3g}, {of_limit:.3f} of "
              f"the limit")
        if not ok:
            fail(f"conv2d_fused under the tuned plan {_plan_text(p)} at "
                 f"x{xs} w{ws} disagrees with its plain version")

    # -- dep.run in turns, default plans against tuned: each switch drops
    # the stages' graphs, and the first call of each form re-captures
    reps = 10
    times = {"default": [], "tuned": []}
    for mode in ("default", "tuned", "tuned", "default"):
        if mode == "default":
            autotune.clear_installed()
        else:
            autotune.install(dep_l.cost_table.kernels)
        dep_l.run(frames[0])
        dep_l.run(frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            dep_l.run(frames[0])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(reps):
            dep_l.run(frames)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        times[mode].append(((t1 - t0) / reps * 1e3,
                            (t2 - t1) / reps / len(frames) * 1e3))
    for mode, rows in times.items():
        print(f"[tuned] dep.run {mode} plans: frame " + " / ".join(
            f"{a:.3f}" for a, _ in rows) + f" ms/frame; [{len(frames)} "
            f"frames] " + " / ".join(f"{b:.3f}" for _, b in rows)
            + f" ms/frame (mean of {reps} runs each, in the turns default, "
            f"tuned, tuned, default; host clock around synchronized runs, "
            f"graphs replayed)")
    for i, what in enumerate(("frame", f"[{len(frames)} frames]")):
        d, t = (sum(r[i] for r in times[m]) / 2 for m in ("default", "tuned"))
        slower = min(r[i] for r in times["tuned"]) \
            > max(r[i] for r in times["default"])
        print(f"[tuned] dep.run {what}: tuned plans {100 * (t / d - 1):+.1f}% "
              f"against the default plans"
              + (" -- SLOWER in both turns: the tuned plans cost time here"
                 if slower else ""))

    # -- the path, counted, under the tuned plans
    autotune.install(dep_l.cost_table.kernels)
    planned = sum(
        sum(model.graph.layers[n].kind == "conv" for n in ex.nodes)
        for ex in dep_l.runner.stages for tp in ex.plans if not tp.empty)
    ops.reset_launches()
    one_l = dep_l.run(frames[0])
    many_l = dep_l.run(frames)
    for _ in range(reps):
        dep_l.run(frames[0])
    torch.cuda.synchronize()
    launches = ops.launch_count()
    calls = reps + 2
    print(f"[tuned] conv2d_fused launches {launches} (plan: {planned} x "
          f"{calls} runner calls)")
    if launches <= 0 or launches != planned * calls:
        fail(f"tuned path: kernel launches {launches} != {planned} x "
             f"{calls}")
    one_t = dep_t.run(frames[0])
    many_t = dep_t.run(frames)
    torch.cuda.synchronize()
    if not (_same(one_l, one_t)
            and all(_same(a, b) for a, b in zip(many_l, many_t))):
        fail("the loaded deployment's outputs differ from the compiled "
             "one's")
    sink = model.graph.sinks()[0]
    logits = torch.stack([o[sink] for o in many_l])
    scale = ref_t.abs().max().item()
    d_t = (logits - ref_t).abs().max().item()
    print(f"[tuned] loaded dep.run equals the compiled deployment's bit for "
          f"bit (one frame, {len(frames)} frames); logits "
          f"{tuple(logits.shape)} max |diff| vs torch backend {d_t:.3g} "
          f"(limit {LOGIT_TOL * scale:.3g})")
    if not bool(torch.isfinite(logits).all()) or d_t > LOGIT_TOL * scale:
        fail("tuned logits not finite or disagree with the torch backend")
    _cnn_graph(dep_l, model, frames, reps=5)
    autotune.clear_installed()


def _held_bytes(frames, saved) -> int:
    """Bytes of the distinct storages that the runtime's frames (their
    inputs and stage outputs) and the dicts of tensors in ``saved``
    hold."""
    tensors = [t for fr in frames for t in [fr.image, *fr.produced.values()]
               if t is not None]
    tensors += [t for d in saved for t in d.values()]
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}.values())


def _runtime_run(dep, spec, churn, frames, gap) -> dict:
    """One real-compute run of ``dep.runtime(spec, churn=churn)`` on
    ``frames`` arriving every ``gap``, with a spy around each stage's
    real compute: what ran (start time, plan, stage, batch, frame ids),
    each frame's stage outputs as they were right after their stage ran,
    the graphs captured and the memory at that moment.  The conv
    kernel's launches are reset just before the run and read just
    after, and so are the refills of frames that resumed after the
    re-plan (the deployment's metrics registry keeps counting across
    runs)."""
    import torch
    from repro_torch.exec import graph
    from repro_torch.kernels.conv2d import ops

    rt = dep.runtime(spec, churn=churn)
    fills = [rt.metrics.value(k) for k in ("runtime.boundary_fills",
                                           "runtime.boundary_fill_layers")]
    if rt.model is None or rt.device != dep.device:
        fail("dep.runtime did not build a real-compute runtime on the "
             "deployment's device")
    runs, saved, latest, mem = [], {}, {}, []
    run_batch = rt._exec_batch

    def spy(t, st, batch):
        run_batch(t, st, batch)
        plan = len(rt.replans)
        runs.append((plan, st.index, len(batch),
                     [fr.fid for fr in batch.frames], t))
        for fr in batch.frames:
            outs = {k: fr.produced[k].clone() for k in st.executor.sinks}
            saved[(plan, st.index, fr.fid)] = outs
            latest.update({(fr.fid, k): v for k, v in outs.items()})
        torch.cuda.synchronize()
        mem.append((plan, graph.captures(), torch.cuda.memory_allocated()
                    - _held_bytes(rt._all_frames, saved.values()),
                    torch.cuda.max_memory_allocated()))

    rt._exec_batch = spy
    cap0 = graph.captures()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = rt.run(inputs=frames, interarrival=gap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_count()
    sizes = {}
    for plan, si, b, _, _ in runs:
        sizes.setdefault((plan, si), set()).add(b)
    fills = [rt.metrics.value(k) - v for k, v in zip(
        ("runtime.boundary_fills", "runtime.boundary_fill_layers"), fills)]
    return dict(rt=rt, rep=rep, runs=runs, saved=saved, latest=latest,
                mem=mem, cap0=cap0, captured=graph.captures() - cap0,
                wall=wall, launches=launches, sizes=sizes, fills=fills)


def _runtime_completed(r, n) -> None:
    rep = r["rep"]
    if rep.completed != n or rep.dropped != 0:
        fail(f"runtime completed {rep.completed} of {n}, dropped "
             f"{rep.dropped}")
    if [x.reason for x in rep.replans] != ["leave"]:
        fail(f"runtime re-plans {[x.reason for x in rep.replans]}, want "
             f"one 'leave'")
    if r["launches"] <= 0:
        fail("the runtime launched no conv kernel")


def _runtime_logits(r, ref, n, sink) -> None:
    """Every frame's logits: shape, finite, and within LOGIT_TOL x
    max |logit| of ``ref`` (the ``"torch"`` backend's monolithic
    forward)."""
    import torch
    rep = r["rep"]
    scale = ref.abs().max().item()
    tol = LOGIT_TOL * scale
    worst = 0.0
    for i in range(n):
        y = rep.outputs[i][sink]
        if y.shape[0] != 1 or y.numel() != 1000:
            fail(f"runtime frame {i}: logits shape {tuple(y.shape)}")
        if not bool(torch.isfinite(y).all()):
            fail(f"runtime frame {i}: logits not finite")
        worst = max(worst, (y.reshape(1, -1) - ref[i].reshape(1, -1))
                    .abs().max().item())
    print(f"[runtime] logits of every frame {tuple(rep.outputs[0][sink].shape)}"
          f" finite; max |diff| vs the torch backend's monolithic forward "
          f"{worst:.3g} (limit {tol:.3g} = {LOGIT_TOL:g} x max |logit| "
          f"{scale:.3g})")
    if worst > tol:
        fail("runtime logits disagree with the torch backend")


def _runtime_kept(r) -> None:
    """Each frame's stage outputs, saved right after its stage last ran,
    are unchanged at the end of the run."""
    import torch
    latest, frames = r["latest"], r["rt"]._all_frames
    changed = [k for k, v in latest.items()
               if not torch.equal(frames[k[0]].produced[k[1]], v)]
    print(f"[runtime] each frame's stage outputs, saved right after the "
          f"stage ran: {len(latest) - len(changed)} of {len(latest)} "
          f"unchanged at the end of the run")
    if changed:
        fail(f"runtime outputs changed after later replays: {changed[:4]}")


def _runtime_virtual(rep, timing) -> None:
    same_time = (timing.completions == rep.completions
                 and timing.makespan == rep.makespan
                 and [(x.time, x.reason, x.old_period, x.new_period)
                      for x in timing.replans]
                 == [(x.time, x.reason, x.old_period, x.new_period)
                     for x in rep.replans])
    print(f"[runtime] virtual time against the timing-only run: completions, "
          f"makespan ({rep.makespan * 1e3:.3f} ms) and re-plan periods "
          f"{'equal' if same_time else 'DIFFER'}")
    if not same_time:
        fail("real compute moved the runtime's virtual time")


def _runtime_graphs_memory(r) -> None:
    """Graphs captured under each plan (no more than the forms run), and
    the memory outside the frames: growth over the stage runs after the
    last capture within RUNTIME_MEM_SLACK."""
    mem, sizes, cap0 = r["mem"], r["sizes"], r["cap0"]
    before = [m_ for m_ in mem if m_[0] == 0]
    cap_before = before[-1][1] - cap0
    cap_after = r["captured"] - cap_before
    print(f"[runtime] CUDA graphs captured: {cap_before} under the first "
          f"plan, {cap_after} under the re-plan ({len(sizes)} (plan, stage) "
          f"pairs, {sum(len(b) for b in sizes.values())} (plan, stage, batch "
          f"size) forms)")
    if cap_before + cap_after > sum(len(b) for b in sizes.values()):
        fail("the runtime captured more graphs than it ran forms")
    settled = [m_ for m_ in mem if m_[1] == cap0 + r["captured"]]
    grown = max(m_[2] for m_ in settled) - settled[0][2]
    print(f"[runtime] max_memory_allocated {before[-1][3] / 2**20:.1f} MiB "
          f"before the churn, {mem[-1][3] / 2**20:.1f} MiB at the end; "
          f"allocated outside the frames' inputs and outputs: "
          f"{before[-1][2] / 2**20:.1f} MiB before the churn, "
          f"{mem[-1][2] / 2**20:.1f} MiB at the end, grown "
          f"{grown / 2**20:.2f} MiB over the last {len(settled)} stage runs "
          f"(no capture among them; limit {RUNTIME_MEM_SLACK / 2**20:.0f} "
          f"MiB)")
    if grown > RUNTIME_MEM_SLACK:
        fail("runtime memory grows with the frames")


def run_cnn_runtime(model, dep) -> tuple[int, str]:
    """Phase 4d: ``Deployment.runtime`` with real compute on the card,
    across a churn-triggered re-plan.  ``RUNTIME_FRAMES`` seeded frames
    arrive at half the plan's period, so stage 0 queues and coalesces
    batches of up to ``RUNTIME_BATCH``; the plan's slowest device leaves
    once a third of them have arrived.  Every stage runs through its
    compiled stage (CUDA graphs, the conv kernel).  Then the abort run
    (``run_cnn_abort``).  Returns the abort run's conv launches and the
    path of its saved trace."""
    import torch
    from repro_torch.api.specs import DeploySpec
    from repro_torch.exec import graph
    from repro_torch.exec.cache import clear_cache
    from repro_torch.runtime import DeviceLeave

    n = RUNTIME_FRAMES
    gap = dep.period / 2
    devices = {d.name: d for st in dep.pipeline.stages for d in st.devices}
    slow = min(devices.values(), key=lambda d: (d.capacity, d.name))
    # between the arrivals of frames n/3 - 1 and n/3
    t_leave = (n // 3 - 0.5) * gap
    spec = DeploySpec(seed=0, max_batch=RUNTIME_BATCH)
    churn = [DeviceLeave(t_leave, slow.name)]
    w, h = model.input_size
    g = torch.Generator(device=dep.device).manual_seed(2)
    frames = list(torch.randn((n, 1, h, w, model.in_channels), generator=g,
                              device=dep.device))
    sink = model.graph.sinks()[0]

    r = _runtime_run(dep, spec, churn, frames, gap)
    rt, rep, runs, saved = r["rt"], r["rep"], r["runs"], r["saved"]

    # -- the run -------------------------------------------------------
    print(f"[runtime] {n} frames every {gap * 1e3:.3f} ms (half the plan's "
          f"period), max_batch {RUNTIME_BATCH}, {slow.name} leaves at "
          f"{t_leave * 1e3:.3f} ms: completed {rep.completed}, dropped "
          f"{rep.dropped}, restarts {rep.restarts}, re-plans "
          + ", ".join(f"{x.reason} at {x.time * 1e3:.3f} ms (period "
                      f"{x.old_period * 1e3:.3f} -> {x.new_period * 1e3:.3f}"
                      f" ms, {x.n_devices} devices)" for x in rep.replans))
    _runtime_completed(r, n)
    sizes = r["sizes"]
    print(f"[runtime] stage runs: {len(runs)} ({sum(1 for x in runs if x[2] > 1)}"
          f" of them batches of 2-{RUNTIME_BATCH} frames); per (plan, stage) "
          f"the batch sizes: " + "; ".join(
              f"{p}/{si} {sorted(b)}" for (p, si), b in sorted(sizes.items())))
    print(f"[runtime] conv2d_fused launches {r['launches']} in the run (reset "
          f"just before, read just after; stages replayed from their CUDA "
          f"graphs); frames that resumed after the re-plan needing a node "
          f"an old stage kept inside, computed from the tensors they kept: "
          f"{r['fills'][0]:.0f}, {r['fills'][1]:.0f} layers that virtual "
          f"time does not charge")
    if not any(x[2] > 1 for x in runs):
        fail("stage 0 coalesced no batch")

    # -- the outputs ---------------------------------------------------
    with graph.eager():
        ref = model.forward(dep.params, torch.cat(frames),
                            backend="torch")[sink]
    _runtime_logits(r, ref, n, sink)

    # single-frame batches of the first plan against dep.run's path:
    # dep.runner's stages (the executors dep.run calls) on the same frame,
    # stage by stage, as long as the frame ran alone under that plan
    compared = whole = 0
    for i, x in enumerate(frames):
        produced = {}
        for si, ex in enumerate(dep.runner.stages):
            if {b for p, s_, b, fids, _ in runs
                    if (p, s_) == (0, si) and i in fids} != {1}:
                break
            produced.update(ex(dep.params, produced, x))
            if not _same({k: produced[k] for k in ex.sinks},
                         saved[(0, si, i)]):
                fail(f"runtime frame {i} stage {si}: a single-frame batch "
                     f"differs from dep.run's stage")
            compared += 1
        else:
            if not _same(dep.run(x), rep.outputs[i]):
                fail(f"runtime frame {i}: differs from dep.run(frame)")
            whole += 1
    torch.cuda.synchronize()
    print(f"[runtime] single-frame batches of the first plan equal "
          f"dep.run's stages bit for bit: {compared} (frame, stage) pairs, "
          f"{whole} whole frames equal to dep.run(frame)")
    if compared == 0:
        fail("no single-frame batch ran before the re-plan")
    _runtime_kept(r)

    # -- virtual time ----------------------------------------------------
    t1 = time.perf_counter()
    timing = dep.runtime(spec, churn=churn, real_compute=False).run(
        n, interarrival=gap)
    t_wall = time.perf_counter() - t1
    _runtime_virtual(rep, timing)

    # -- graphs, memory, times -----------------------------------------
    _runtime_graphs_memory(r)
    dep.run(frames)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dep.run(frames)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t2
    wall = r["wall"]
    print(f"[runtime] wall {wall:.3f} s for the real-compute run, "
          f"{wall / n * 1e3:.3f} ms/frame (capture of its graphs, the "
          f"re-plan and the spy's clones included); dep.run([{n} frames]) "
          f"{t_run / n * 1e3:.3f} ms/frame (its graph captured before); "
          f"timing-only run {t_wall / n * 1e3:.3f} ms/frame (host clock "
          f"around synchronized runs)")
    del r, rt, rep, runs, saved
    clear_cache()                 # the stages' graphs: the abort run
    #                               captures its own
    return run_cnn_abort(model, dep, frames, ref)


def run_cnn_abort(model, dep, frames, ref) -> tuple[int, str]:
    """Phase 4d, second run: a device leaves in the middle of a stage
    run, which the runtime aborts and restarts under the new plan.  The
    leave time comes from a traced timing-only run of the same
    deployment, arrivals and ``max_batch`` (real compute does not move
    virtual time): the midpoint of the first ``stage.compute`` span of
    stage 0 that holds a coalesced batch of 2 or more frames once a
    third of them have arrived (else the first single-frame span of any
    stage after that), on one of that stage's devices.  The run is
    traced; returns its conv launches and the saved trace's path."""
    import torch
    from repro_torch.api.specs import DeploySpec
    from repro_torch.obs.trace import Tracer
    from repro_torch.runtime import DeviceLeave

    n = len(frames)
    gap = dep.period / 2
    sink = model.graph.sinks()[0]
    spec = DeploySpec(seed=0, max_batch=RUNTIME_BATCH)
    traced = DeploySpec(seed=0, max_batch=RUNTIME_BATCH, trace=True)
    lifecycle = dep.tracer
    try:
        dep.tracer = Tracer()
        probe = dep.runtime(traced, real_compute=False).run(
            n, interarrival=gap)
        after = [sp for sp in probe.trace if sp.name == "stage.compute"
                 and sp.ts >= (n // 3 - 1) * gap]
        pick = [sp for sp in after
                if sp.attr("stage") == 0 and sp.attr("frames") >= 2]
        case = "a coalesced batch of stage 0"
        if not pick:
            pick = [sp for sp in after if sp.attr("frames") == 1]
            case = "no coalesced batch of stage 0 after a third of the " \
                   "arrivals: a single-frame run"
        if not pick:
            fail("the timing-only run has no stage run after a third of "
                 "the arrivals")
        span = pick[0]
        t_leave = span.ts + span.dur / 2
        churn = [DeviceLeave(t_leave, span.track)]
        timing = dep.runtime(spec, churn=churn, real_compute=False).run(
            n, interarrival=gap)
        dep.tracer = Tracer()
        r = _runtime_run(dep, traced, churn, frames, gap)
        tracer = dep.tracer
    finally:
        dep.tracer = lifecycle
    rt, rep, runs = r["rt"], r["rep"], r["runs"]
    stage = span.attr("stage")
    aborted = [fids for p, si, _, fids, t in runs
               if (p, si, t) == (0, stage, span.ts)]
    print(f"[runtime] abort run: {case} ({span.attr('frames')} frames) at "
          f"stage {stage} from {span.ts * 1e3:.3f} to "
          f"{span.end * 1e3:.3f} ms in a traced timing-only run; "
          f"{span.track} leaves at its midpoint, {t_leave * 1e3:.3f} ms")
    print(f"[runtime] abort run: completed {rep.completed}, dropped "
          f"{rep.dropped}, restarts {rep.restarts} (timing-only "
          f"{timing.restarts}), re-plans "
          + ", ".join(f"{x.reason} at {x.time * 1e3:.3f} ms (period "
                      f"{x.old_period * 1e3:.3f} -> {x.new_period * 1e3:.3f}"
                      f" ms, {x.n_devices} devices)" for x in rep.replans))
    _runtime_completed(r, n)
    if not rep.restarts >= 1 or rep.restarts != timing.restarts:
        fail(f"abort run: restarts {rep.restarts}, timing-only "
             f"{timing.restarts}, want equal and at least 1")
    if len(aborted) != 1 or len(aborted[0]) != span.attr("frames"):
        fail(f"abort run: the spy saw {aborted} at stage {stage} at "
             f"{span.ts}, want one batch of {span.attr('frames')}")
    # the stage of the new plan that covers the aborted stage's first
    # piece: where each aborted frame must run again
    first = dep.pipeline.stages[stage].first_piece
    new = next(i for i, st in enumerate(rt.pico.pipeline.stages)
               if st.first_piece <= first <= st.last_piece)
    again = {fid for p, si, _, fids, _ in runs if (p, si) == (1, new)
             for fid in fids}
    missing = [fid for fid in aborted[0] if fid not in again
               or rt._all_frames[fid].restarts < 1]
    sizes = r["sizes"]
    print(f"[runtime] abort run: aborted stage {stage}, batch of "
          f"{len(aborted[0])}, frames {aborted[0]}; re-run under the new "
          f"plan at its stage {new}: "
          f"{len(aborted[0]) - len(missing)} of {len(aborted[0])}; per "
          f"(plan, stage) the batch sizes: " + "; ".join(
              f"{p}/{si} {sorted(b)}" for (p, si), b in sorted(sizes.items())))
    if missing:
        fail(f"abort run: frames {missing} did not run again under the "
             f"new plan")
    print(f"[runtime] abort run: conv2d_fused launches {r['launches']} in "
          f"the run (reset just before, read just after); frames that "
          f"resumed needing a node an old stage kept inside: "
          f"{r['fills'][0]:.0f}, {r['fills'][1]:.0f} layers")
    _runtime_logits(r, ref, n, sink)
    _runtime_kept(r)
    _runtime_virtual(rep, timing)
    _runtime_graphs_memory(r)
    print(f"[runtime] abort run: wall {r['wall']:.3f} s, "
          f"{r['wall'] / n * 1e3:.3f} ms/frame (capture of its graphs, the "
          f"re-plan and the spy's clones included; host clock around a "
          f"synchronized run)")
    out = ROOT / "build" / "smoke"
    out.mkdir(parents=True, exist_ok=True)
    path = str(tracer.save(out / "runtime_abort_trace.json"))
    return r["launches"], path


def _dist_equal(a: dict, b: dict) -> bool:
    """Two ``{fid: {sink: ndarray}}`` maps with the same bytes."""
    return a.keys() == b.keys() and all(
        a[f].keys() == b[f].keys()
        and all(a[f][k].tobytes() == b[f][k].tobytes() for k in b[f])
        for f in b)


def _dist_diff(a: dict, b: dict) -> float:
    """Max |a - b| over the frames and sinks of two such maps."""
    import numpy as np
    return max(float(np.max(np.abs(a[f][k].astype(np.float64)
                                   - b[f][k].astype(np.float64))))
               for f in b for k in b[f])


def _dist_run(dep, spec, xs):
    """``dep.fleet(spec)`` started, then run on ``xs``: the report and
    host seconds of the start (workers up, the warm-up probe through)
    and of the run (submit, collect, drain)."""
    launcher = dep.fleet(spec)
    t0 = time.perf_counter()
    launcher.start()
    t1 = time.perf_counter()
    rep = launcher.run(xs)
    t2 = time.perf_counter()
    if rep.completed != len(xs) or rep.dropped:
        fail(f"dist {spec.workers}/{spec.transport}/mb{spec.micro_batch}: "
             f"completed {rep.completed} of {len(xs)}, dropped "
             f"{rep.dropped[:3]}")
    return rep, t1 - t0, t2 - t1


def _dist_lines(label, rep, start_s, run_s, n) -> None:
    """The ``[dist]`` lines of one run: wall, bytes per link, compute
    per stage and the device each worker computed on."""
    links = [f"feed->w0 {rep.link_stats['feed']['bytes_sent']}"]
    for i in range(rep.n_stages):
        out = "sink" if i == rep.n_stages - 1 else f"w{i + 1}"
        links.append(f"w{i}->{out} {rep.worker_stats[f'w{i}']['bytes_out']}")
    comp = rep.stage_compute_s()
    print(f"[dist] {label}: start {start_s * 1e3:.1f} ms (workers up, "
          f"warm-up probe through), run {run_s / n * 1e3:.3f} ms/frame "
          f"({n} frames, host clock around run()); bytes on each link: "
          + ", ".join(links))
    print(f"[dist] {label}: compute_s per stage and frame (ms): "
          + ", ".join(f"s{s} {comp[s] * 1e3:.3f}" for s in sorted(comp))
          + "; worker devices: " + ", ".join(
              f"{w} {st['device']}" for w, st in rep.worker_stats.items()))
    bad = [w for w, st in rep.worker_stats.items()
           if not str(st.get("device")).startswith("cuda")]
    if bad:
        fail(f"dist {label}: workers {bad} did not compute on a CUDA device")


def run_cnn_dist(model, dep, planned: int) -> int:
    """Phase 4e: ``dep.fleet`` on phase 4a's deployment (full-width
    VGG16, the 8-Pi plan, one worker per stage).  Returns the conv
    launches of the counted dist run."""
    import importlib

    import torch
    from repro_torch.api.specs import DistSpec, ExecSpec
    from repro_torch.exec import graph
    from repro_torch.kernels.conv2d import ops
    from repro_torch.pipeline.runner import PipelineRunner
    from repro_torch.runtime.churn import DeviceLeave

    vmod = importlib.import_module("repro_torch.dist.validate")
    n = DIST_FRAMES
    xs = vmod.make_frames(model, n, seed=0)
    stages = len(dep.pipeline.stages)

    # -- validate, thread mode, memory: the dist run counted alone; the
    # in-process oracle starts after the count is read
    real_oracle = vmod.reference_outputs
    window = {}

    def oracle(*args, **kwargs):
        torch.cuda.synchronize()
        window["launches"] = ops.launch_count()
        window["captures"] = graph.captures()
        return real_oracle(*args, **kwargs)

    vmod.reference_outputs = oracle
    try:
        ops.reset_launches()
        cap0 = graph.captures()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        v = vmod.validate(dep, DistSpec(), frames=n)
    finally:
        vmod.reference_outputs = real_oracle
    wall = time.perf_counter() - t0
    launches = window["launches"]
    print(f"[dist] {v.describe()}")
    print(f"[dist] validate, thread mode, memory: {stages} workers, "
          f"observed/modeled compute ratios "
          + ", ".join(f"s{k} {r:.4g}" for k, r in sorted(v.ratios.items()))
          + f"; conv2d_fused launches of the dist run {launches} (want "
          f"{planned} x ({n} frames + the warm-up probe) = "
          f"{planned * (n + 1)}; stages replayed from CUDA graphs "
          f"captured in the workers' threads: "
          f"{window['captures'] - cap0}); validate {wall:.2f} s; launcher "
          f"process max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (v.ok and v.bit_identical and v.dropped == 0):
        fail(f"dist validate: {v.describe()}")
    if launches != planned * (n + 1):
        fail(f"dist run launched {launches} convs, want {planned * (n + 1)}")
    oracle1 = dict(enumerate(real_oracle(dep, xs, 1)))

    # -- the modes, timed, each against the in-process runner ------------
    runs = {}
    for label, spec in [
            ("thread/memory/mb1", DistSpec()),
            ("thread/tcp/mb2", DistSpec(transport="tcp", micro_batch=2)),
            ("process/tcp/mb1", DistSpec(transport="tcp",
                                         workers="process"))]:
        torch.cuda.reset_peak_memory_stats()
        cap0 = graph.captures()
        rep, start_s, run_s = _dist_run(dep, spec, xs)
        runs[label] = rep
        want = (oracle1 if spec.micro_batch == 1 else
                dict(enumerate(real_oracle(dep, xs, spec.micro_batch))))
        same = _dist_equal(rep.outputs, want)
        _dist_lines(label, rep, start_s, run_s, n)
        print(f"[dist] {label}: {n}/{n} completed, 0 dropped; outputs "
              f"{'equal' if same else 'DIFFER FROM'} the in-process runner "
              f"chunked the same way, bit for bit; launcher process "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"CUDA graphs captured in this process "
              f"{graph.captures() - cap0}"
              + (f"; {len(rep.worker_stats)} worker processes"
                 if spec.workers == "process" else ""))
        if not same:
            fail(f"dist {label} outputs differ from the in-process runner")
    if not _dist_equal(runs["process/tcp/mb1"].outputs,
                       runs["thread/memory/mb1"].outputs):
        fail("process-mode outputs differ from the thread-mode run's")
    if not _dist_equal(runs["thread/memory/mb1"].outputs, v.report.outputs):
        fail("thread-mode outputs differ between two runs")
    mb2_same = _dist_equal(runs["thread/tcp/mb2"].outputs, oracle1)
    sink = model.graph.sinks()[0]
    scale = max(float(abs(o[sink]).max()) for o in oracle1.values())
    tol = LOGIT_TOL * scale
    d_mb2 = 0.0 if mb2_same else _dist_diff(runs["thread/tcp/mb2"].outputs,
                                           oracle1)
    print(f"[dist] thread/tcp/mb2 against thread/memory/mb1: "
          + ("equal byte for byte" if mb2_same else
             f"max |diff| {d_mb2:.3g} (two frames a message are one "
             f"batch-folded pass, whose launches may take other split-K "
             f"plans), limit {tol:.3g}"))
    if d_mb2 > tol:
        fail("thread/tcp/mb2 logits disagree with the single-frame run")

    # -- the kernel ran in the workers: the plain version differs ---------
    params = dep.model.init(torch.Generator().manual_seed(0),
                            device=dep.device)
    plain = PipelineRunner(model, dep.pipeline,
                           exec_spec=ExecSpec(backend="torch"))
    with graph.eager():
        ref_t = {i: {k: t.cpu().numpy() for k, t in plain(
            params, torch.as_tensor(x, device=dep.device)).items()}
            for i, x in enumerate(xs)}
    d_t = _dist_diff(runs["process/tcp/mb1"].outputs, ref_t)
    t_same = _dist_equal(runs["process/tcp/mb1"].outputs, ref_t)
    print(f"[dist] the \"torch\" backend's outputs on the same stages and "
          f"weights {'EQUAL' if t_same else 'are not bit-equal to'} the "
          f"kernel path's (max |diff| {d_t:.3g}, limit {tol:.3g}); the "
          f"process-mode workers' outputs equal the in-process kernel "
          f"path's bit for bit, so each worker ran conv2d_fused")
    if t_same or d_t > tol:
        fail("the torch backend's outputs equal the kernel path's, or "
             "disagree past the limit")

    # -- the killed-worker drill ------------------------------------------
    spec = DistSpec(heartbeat_s=0.05, peer_timeout_s=DIST_PEER_TIMEOUT_S)
    launcher = dep.fleet(spec)
    t0 = time.perf_counter()
    launcher.start()
    launcher.kill_worker(1)
    rep = launcher.run(xs)
    dead = {e.device_name for e in rep.churn_events}
    reasons = sorted({r for _, r in rep.dropped})
    print(f"[dist] killed-worker drill (thread mode, peer timeout "
          f"{DIST_PEER_TIMEOUT_S} s): worker w1 killed; churn "
          f"{[type(e).__name__ + ' ' + e.device_name for e in rep.churn_events]}"
          f"; completed {rep.completed}, dropped {len(rep.dropped)} of "
          f"{rep.submitted}; reasons {reasons}")
    if not rep.churn_events or not all(isinstance(e, DeviceLeave)
                                       for e in rep.churn_events):
        fail("the killed worker surfaced no DeviceLeave")
    if dead != set(launcher.workers[1].devices):
        fail(f"churn names {dead}, the killed worker held "
             f"{launcher.workers[1].devices}")
    if (rep.completed + len(rep.dropped) != rep.submitted or not rep.dropped
            or not all("dead" in r or "heartbeat" in r for r in reasons)):
        fail("the drill lost a frame or dropped one without a reason")
    if not _dist_equal(rep.outputs, {f: oracle1[f] for f in rep.outputs}):
        fail("frames completed before the kill differ from the clean run")
    alive = [d for d in dep.cluster.devices if d.name not in dead]
    dep2 = dep.replan(dep.cluster.restricted(alive))
    missing = sorted(set(range(n)) - set(rep.outputs))
    rep2 = dep2.fleet(spec).run([xs[i] for i in missing])
    drill_s = time.perf_counter() - t0
    if rep2.dropped or rep2.completed != len(missing):
        fail(f"resubmission on the survivors: completed {rep2.completed} of "
             f"{len(missing)}, dropped {rep2.dropped[:3]}")
    redo = dict(zip(missing, (rep2.outputs[k] for k in range(len(missing)))))
    want2 = dict(zip(missing, real_oracle(dep2, [xs[i] for i in missing], 1)))
    if not _dist_equal(redo, want2):
        fail("resubmitted frames differ from the re-planned in-process "
             "runner")
    merged = {**rep.outputs, **redo}
    m_same = _dist_equal(merged, oracle1)
    d_m = 0.0 if m_same else _dist_diff(merged, oracle1)
    print(f"[dist] drill recovery: dep.replan onto the {len(alive)} "
          f"survivors ({len(dep2.pipeline.stages)} stages), {len(missing)} "
          f"frames resubmitted, 0 dropped, equal to the re-planned "
          f"in-process runner bit for bit; all {n} frames merged against "
          f"the clean run: "
          + ("equal bit for bit" if m_same else
             f"max |diff| {d_m:.3g} (the new plan's tiles take other "
             f"launch plans), limit {tol:.3g}")
          + f"; drill {drill_s:.2f} s")
    if d_m > tol:
        fail("recovered frames disagree with the clean run")

    # -- dep.run beside the workers --------------------------------------
    frames = [torch.as_tensor(x, device=dep.device) for x in xs]
    dep.run(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        dep.run(frames)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 / n * 1e3
    print(f"[dist] dep.run([{n} frames]) in process: {ms:.3f} ms/frame; "
          f"the workers' runs: " + ", ".join(
              f"{k} {r.wall_s / n * 1e3:.3f} ms/frame with the start"
              for k, r in runs.items()))
    return launches


def _mt_tenants():
    from repro_torch.models.cnn import zoo
    from repro_torch.serving import TenantConfig
    return [TenantConfig(name, zoo.build(name, input_size=MT_SIZE,
                                         scale=MT_SCALE), max_batch=4)
            for name in MT_TENANTS]


def _mt_scenario(kind: str, real: bool, device):
    """One of ``benchmarks/fig_serving_mt.py``'s scenarios at full width:
    ``"saturated"`` (load 2.0, against time-sliced serving) or
    ``"churn"`` (load 0.65, the weakest device leaving at half the
    horizon).  With ``real``, every request carries a seeded frame on
    ``device`` and the scheduler serves there with weights loaded.
    Returns the
    scheduler, the workload, the report and the scenario's figure
    (throughput ratio or churn recovery)."""
    import torch
    from repro_torch.core import make_pi_cluster
    from repro_torch.data.pipeline import Request
    from repro_torch.runtime import DeviceLeave
    from repro_torch.serving import (OpenLoopGenerator, SchedulerConfig,
                                     ServingScheduler, serve_time_sliced)

    tenants, cluster = _mt_tenants(), make_pi_cluster(CLUSTER_GHZ)
    config = (SchedulerConfig() if kind == "saturated" else
              SchedulerConfig(seed=3, migration_bandwidth=1e9))
    sched = ServingScheduler(tenants, cluster, config=config, device=device)
    load, duration = MT_LOADS[kind]
    workload = {}
    for i, ts in enumerate(sched._tenants.values()):
        rate = load / ts.share.pico.period
        reqs = OpenLoopGenerator(rate_per_s=rate, seed=17 + i).generate(
            max(8, int(rate * duration)))
        if real:
            g = torch.Generator(device=device).manual_seed(17 + i)
            xs = torch.randn((len(reqs), 1, MT_SIZE[1], MT_SIZE[0], 3),
                             generator=g, device=device)
            reqs = [Request(r.rid, r.arrival, xs[r.rid]) for r in reqs]
        workload[ts.cfg.name] = reqs
    if real:
        sched.load()
    if kind == "saturated":
        rep = sched.serve(workload)
        base = serve_time_sliced(tenants, cluster, workload)
        return sched, workload, rep, (rep.throughput_per_min
                                      / base.throughput_per_min)
    horizon = max(r.arrival for reqs in workload.values() for r in reqs)
    drop_t = 0.5 * horizon
    weakest = min(cluster.devices, key=lambda d: d.capacity)
    rep = sched.serve(workload, churn=[DeviceLeave(drop_t, weakest.name)])
    mig_end = max((r.time + r.migration_s for r in rep.repartitions
                   if r.reason == "leave"), default=drop_t)
    reqs = [r for rs in workload.values() for r in rs]
    pre = rep.windowed_throughput(0.0, drop_t)
    post = rep.windowed_throughput(mig_end, max(horizon, mig_end + 1e-9))
    off_pre = sum(1 for r in reqs if r.arrival < drop_t) / drop_t
    off_post = (sum(1 for r in reqs if mig_end <= r.arrival < horizon)
                / max(horizon - mig_end, 1e-9))
    return sched, workload, rep, (post / off_post) / (pre / off_pre)


def _virtual(rep) -> dict:
    """What a serve decides on the virtual timeline: host clocks
    (``wall_s``), outputs, the stage cache and metrics left out."""
    import dataclasses
    tenants = {}
    for name, st in rep.tenants.items():
        d = dataclasses.asdict(st)
        d.pop("wall_s")
        tenants[name] = d
    reps = []
    for r in rep.repartitions:
        d = dataclasses.asdict(r)
        d.pop("wall_s")
        reps.append(d)
    return {"tenants": tenants, "completions": rep.completions,
            "repartitions": reps, "makespan": rep.makespan,
            "dropped": rep.dropped_inflight, "busy": rep.device_busy_s,
            "frames": rep.device_frames}


def run_cnn_serving(model, dep) -> int:
    """Phase 4f: the servers over phase 4a's deployment, and the
    multi-tenant scheduler on ``fig_serving_mt``'s two scenarios at full
    width with real compute on the card.  Returns the conv launches."""
    import torch
    from repro_torch.data.pipeline import Request
    from repro_torch.exec import graph
    from repro_torch.kernels.conv2d import ops

    total = 0
    n = SERVE_REQUESTS
    g = torch.Generator(device=dep.device).manual_seed(3)
    w, h = model.input_size
    frames = list(torch.randn((n, 1, h, w, 3), generator=g,
                              device=dep.device))
    reqs = [Request(i, i * dep.period / 2, frames[i]) for i in range(n)]
    want = [dep.run(f) for f in frames]
    sink = model.graph.sinks()[0]
    with graph.eager():
        ref = model.forward(dep.params, torch.cat(frames),
                            backend="torch")[sink]
    tol = LOGIT_TOL * ref.abs().max().item()
    for label, srv in [("dep.server()", dep.server()),
                       ("dep.server(streaming=True)",
                        dep.server(streaming=True))]:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, stats = srv.load().serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_count()
        total += launches
        same = all(_same(o, wnt) for o, wnt in zip(outs, want))
        d = max((o[sink] - ref[i:i + 1]).abs().max().item()
                for i, o in enumerate(outs))
        print(f"[serve] {label}: {stats.served} of {n} requests served, "
              f"outputs {'equal' if same else 'DIFFER FROM'} dep.run's bit "
              f"for bit; logits vs the torch backend's monolithic forward "
              f"max |diff| {d:.3g} (limit {tol:.3g}); conv2d_fused launches "
              f"{launches}; modeled period {stats.period_model_s * 1e3:.3f} "
              f"ms, mean latency {stats.mean_latency_s * 1e3:.3f} ms; wall "
              f"{wall * 1e3:.1f} ms")
        if stats.served != n or not same or d > tol or launches <= 0:
            fail(f"{label} served wrong or launched no conv")

    for kind in ("saturated", "churn"):
        t0 = time.perf_counter()
        _, _, timing, fig0 = _mt_scenario(kind, False, dep.device)
        t1 = time.perf_counter()
        ops.reset_launches()
        sched, workload, rep, fig = _mt_scenario(kind, True, dep.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = ops.launch_count()
        total += launches
        same = _virtual(rep) == _virtual(timing)
        worst, served = 0.0, 0
        for name, outs in rep.outputs.items():
            ts = sched._tenants.get(name) or sched._retired[name]
            m = ts.cfg.model
            tsink = m.graph.sinks()[0]
            rids = sorted(outs)
            xs = torch.cat([workload[name][r].payload for r in rids])
            with graph.eager():
                tref = m.forward(ts.params, xs, backend="torch")[tsink]
            lim = LOGIT_TOL * tref.abs().max().item()
            for i, r in enumerate(rids):
                d = (outs[r][tsink] - tref[i:i + 1]).abs().max().item()
                worst = max(worst, d / lim)
            served += len(rids)
        what = "throughput ratio against time-sliced" if kind == "saturated" \
            else "churn recovery"
        print(f"[serve] scheduler {kind} (load {MT_LOADS[kind][0]}, "
              f"{', '.join(MT_TENANTS)} at {MT_SIZE[0]}, scale {MT_SCALE}, "
              f"8 Pis"
              + (", the weakest leaving at half the horizon"
                 if kind == "churn" else "")
              + f"): served {rep.served} of "
              f"{sum(len(r) for r in workload.values())}, dropped in flight "
              f"{rep.dropped_inflight}; {what} {fig:.4f} (printed, not held "
              f"at full width); repartitions "
              f"{[r.reason for r in rep.repartitions]}; virtual time "
              f"{'equal to' if same else 'DIFFERS FROM'} the timing-only "
              f"run's; every served frame's logits within the limit of the "
              f"torch backend's monolithic forward (worst {worst:.3f} of "
              f"LOGIT_TOL x max |logit|, {served} frames); conv2d_fused "
              f"launches {launches}; wall {t2 - t1:.2f} s (timing-only "
              f"{t1 - t0:.2f} s); stage cache {rep.cache.hits} hits, "
              f"{rep.cache.misses} misses")
        if (rep.dropped_inflight != 0 or not same or worst > 1.0
                or served != rep.served or fig != fig0 or launches <= 0):
            fail(f"scheduler {kind}: dropped, virtual time, logits or "
                 f"launches wrong")
    return total


def _child_env() -> dict:
    """The environment of a child process: this checkout's ``src`` first
    on its path."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    return env


def _tool(argv: list[str], timeout: float):
    """``python -m <argv>`` in a child process from the checkout's root;
    its output lines printed as ``[tools]`` lines."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                          env=_child_env(), capture_output=True, text=True,
                          timeout=timeout)
    print(f"[tools] $ python -m {' '.join(argv)}: rc {proc.returncode}, "
          f"{time.perf_counter() - t0:.1f} s")
    for line in (proc.stdout + proc.stderr).splitlines():
        print(f"[tools]   {line}")
    return proc


def run_cnn_tools(trace_path: str) -> int:
    """Phase 4g: the port's operational CLIs on the card.  (a) the plan
    CLI's ``main`` in this process plans phase 4's configuration
    (full-width VGG16 on the 8 Pis at CLUSTER_GHZ), saves it, and the
    artifact's ``to_json`` must equal ``repro_torch.compile`` with the
    same specs (the planner's wall times zeroed); then ``--load
    --validate --execute`` with the conv kernel's launches counted (reset
    just before the plan, read just after the execute).  (b) the same
    ``--load --validate --execute`` as a command with no ``--device``:
    the entry point runs on the card by default.  (c) the trace tool on
    the abort run's trace (``--validate``, then the summary: the run's
    frames, one per-device row per device that computed, the bubble
    fraction in [0, 1)).  Returns the launches of (a)."""
    import io
    import repro_torch
    from repro_torch.api.specs import ExecSpec, PlanSpec
    from repro_torch.core import make_pi_cluster
    from repro_torch.kernels.conv2d import ops
    from repro_torch.models.cnn import zoo
    from repro_torch.obs.trace import from_chrome_trace
    from repro_torch.tools import plan as plan_cli
    from repro_torch.tools import trace as trace_cli

    out = ROOT / "build" / "smoke"
    out.mkdir(parents=True, exist_ok=True)
    path = str(out / "vgg16_8pi_plan.json")

    def cli(argv):
        print(f"[tools] repro_torch.tools.plan.main({argv}) in this process")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = plan_cli.main(argv)
        print(f"[tools]   rc {rc}, {time.perf_counter() - t0:.1f} s")
        for line in buf.getvalue().splitlines():
            print(f"[tools]   {line}")
        if rc != 0:
            fail(f"plan CLI {argv}: rc {rc}")
        return buf.getvalue()

    # -- (a) plan, save, compare, then load, validate and execute ---------
    ops.reset_launches()
    cli(["--model", "vgg16", "--devices", str(len(CLUSTER_GHZ)), "--freqs",
         ",".join(f"{f:g}" for f in CLUSTER_GHZ), "--out", path])
    saved = repro_torch.Deployment.load(path)
    dep = repro_torch.compile(zoo.build("vgg16", scale=1.0),
                              make_pi_cluster(CLUSTER_GHZ), PlanSpec(),
                              ExecSpec())
    for d in (saved, dep):
        d.pico.partition.wall_time_s = 0.0
        d.pico.pipeline.wall_time_s = 0.0
    same = saved.to_json() == dep.to_json()
    print(f"[tools] the saved artifact's to_json against repro_torch.compile"
          f" with the same specs (wall_time_s zeroed): "
          f"{'equal' if same else 'DIFFERENT'} ({len(dep.to_json())} "
          f"characters)")
    if not same:
        fail("the plan CLI's artifact differs from repro_torch.compile's")
    del saved, dep
    text = cli(["--load", path, "--validate", "--execute"])
    launches = ops.launch_count()
    if "validate: schema v1 ok, round-trip ok" not in text:
        fail("plan CLI: no validate line")
    if "execute: pipelined outputs match monolithic forward ✓ on cuda" \
            not in text:
        fail("plan CLI: no execute line on cuda")
    print(f"[tools] conv2d_fused launches {launches} in the plan CLI's "
          f"in-process plan, load, validate and execute (reset just "
          f"before, read just after)")
    if launches <= 0:
        fail("the plan CLI launched no conv kernel")

    # -- (b) the command, no --device ----------------------------------
    proc = _tool(["repro_torch.tools.plan", "--load", path, "--validate",
                  "--execute"], timeout=600)
    if proc.returncode != 0 or "execute: pipelined outputs match " \
            "monolithic forward ✓ on cuda" not in proc.stdout:
        fail("python -m repro_torch.tools.plan --load --validate --execute "
             "did not match on the card")

    # -- (c) the trace tool on the abort run's trace --------------------
    proc = _tool(["repro_torch.tools.trace", trace_path, "--validate"],
                 timeout=120)
    if proc.returncode != 0:
        fail("the abort run's trace does not validate")
    proc = _tool(["repro_torch.tools.trace", trace_path], timeout=120)
    if proc.returncode != 0:
        fail("the trace tool could not summarize the abort run's trace")
    lines = proc.stdout.splitlines()
    with open(trace_path) as f:
        spans = from_chrome_trace(json.load(f))
    computed = sorted({sp.track for sp in spans
                       if sp.name == "stage.compute"})
    rows = []
    if "per-device compute:" in lines:
        for line in lines[lines.index("per-device compute:") + 1:]:
            if not line.startswith("  "):
                break
            rows.append(line.split()[0])
    bubble = [float(line.rsplit(" ", 1)[1].rstrip("%")) / 100
              for line in lines
              if line.startswith("pipeline bubble fraction: ")]
    fraction = trace_cli.bubble_fraction(spans)
    print(f"[tools] trace summary: {RUNTIME_FRAMES} frames "
          f"{'shown' if f'({RUNTIME_FRAMES} frames)' in lines[0] else 'NOT shown'}"
          f"; per-device rows {rows} against the devices that computed "
          f"{computed}; bubble fraction {bubble} printed, "
          f"{fraction:.6f} from bubble_fraction")
    if f"({RUNTIME_FRAMES} frames)" not in lines[0]:
        fail(f"trace summary: want {RUNTIME_FRAMES} frames, got {lines[0]}")
    if sorted(rows) != computed:
        fail("trace summary: per-device rows differ from the devices that "
             "computed")
    if len(bubble) != 1 or not 0.0 <= bubble[0] < 1.0 \
            or not 0.0 <= fraction < 1.0:
        fail("trace summary: bubble fraction outside [0, 1)")
    return launches


def run_cnn() -> dict:
    """Phases 3-4 for the conv kernel: the CNN main path.  Returns the
    kernel's entry of the ``kernels`` line."""
    import torch
    import repro_torch
    from repro_torch.api.specs import ExecSpec, PlanSpec
    from repro_torch.core import make_pi_cluster
    from repro_torch.exec import graph
    from repro_torch.exec.cache import clear_cache
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

    def recording(x, w, b=None, *, stride=(1, 1), relu=False, pool=None,
                  **plan):
        key = (tuple(x.shape), tuple(w.shape), ops.normalize_stride(stride),
               None if pool is None else tuple(pool), relu, b is not None,
               str(x.dtype).removeprefix("torch."))
        launched[key] = launched.get(key, 0) + 1
        if x.shape[0] == 1:
            order.append(key)
        return real(x, w, b, stride=stride, relu=relu, pool=pool, **plan)

    ops.conv2d_fused = recording
    try:
        with graph.eager():
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

    # -- 4b. the main path, counted: the first call of each form
    # captures the stages' graphs, the timed calls after it replay them
    reps = 10
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dep.run(frames[0])
    dep.run(frames)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        one = dep.run(frames[0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(reps):
        many = dep.run(frames)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = ops.launch_count()
    calls = 2 * reps + 2
    ms_one = (t2 - t1) / reps * 1e3
    ms_many = (t3 - t2) / reps / len(frames) * 1e3
    print(f"[slice] conv2d_fused launches {launches} "
          f"(plan: {planned} x {calls} runner calls)")
    if launches <= 0 or launches != planned * calls:
        fail(f"kernel launches {launches} != {planned} x {calls}")
    print(f"[slice] dep.run(frame): {ms_one:.3f} ms/frame; "
          f"dep.run([{len(frames)} frames]): {ms_many:.3f} ms/frame "
          f"(host clock around synchronized runs, the stages' graphs "
          f"replayed); the first call of each form, which captures "
          f"them: {(t1 - t0) * 1e3:.1f} ms")

    # -- the outputs ----------------------------------------------------
    sink = model.graph.sinks()[0]
    logits = torch.stack([o[sink] for o in many])
    if tuple(logits.shape) != (len(frames), 1, 1, 1, 1000):
        fail(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail("logits not finite")
    dep_t = repro_torch.compile(model, cluster, PlanSpec(),
                                ExecSpec(backend="torch"), params=dep.params)
    with graph.eager():
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
    _cnn_graph(dep, model, frames)
    del dep_t

    # -- 4c. tuned and calibrated on the card, saved and loaded ---------
    t0 = time.perf_counter()
    run_cnn_tuned(model, cluster, dep, frames, ref_t)
    print(f"[time] CNN phase 4c {time.perf_counter() - t0:.1f} s")
    clear_cache()                 # the stages' graphs

    # -- 4d. the event-driven runtime with real compute, then an abort ----
    t0 = time.perf_counter()
    abort_launches, abort_trace = run_cnn_runtime(model, dep)
    print(f"[time] CNN phase 4d {time.perf_counter() - t0:.1f} s")
    clear_cache()                 # the stages' graphs

    # -- 4e. dep.fleet: one worker per stage -----------------------------
    t0 = time.perf_counter()
    dist_launches = run_cnn_dist(model, dep, planned)
    print(f"[time] CNN phase 4e {time.perf_counter() - t0:.1f} s")
    clear_cache()

    # -- 4f. the servers and the multi-tenant scheduler -----------------
    t0 = time.perf_counter()
    serve_launches = run_cnn_serving(model, dep)
    print(f"[time] CNN phase 4f {time.perf_counter() - t0:.1f} s")
    clear_cache()                 # the stages' graphs

    # -- 4g. the plan and trace CLIs ---------------------------------
    t0 = time.perf_counter()
    tool_launches = run_cnn_tools(abort_trace)
    print(f"[time] CNN phase 4g {time.perf_counter() - t0:.1f} s")
    clear_cache()                 # the stages' graphs, before the LMs

    path = [r for r in cases if r["per_call"]]
    t_ops = sum(r["t_ops_ms"] * r["per_call"] for r in path)
    t_bytes = sum(r["t_bytes_ms"] * r["per_call"] for r in path)
    print("[kernels] conv2d_fused: ms, plain_ms, bound_ms, library_ms "
          "summed over the launches of one single-frame runner call; "
          "max_abs_err over those shapes; device time (profiler) over the "
          f"same launches: {sum(r['dev_ms'] * r['per_call'] for r in path):.4f}"
          f", cuDNN {sum(r['library_dev_ms'] * r['per_call'] for r in path):.4f}"
          f"; launches: phase 4b {launches} + 4d's abort run "
          f"{abort_launches} + 4e {dist_launches} + 4f {serve_launches} + "
          f"4g's in-process plan CLI {tool_launches}")
    return {
        "name": "conv2d_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/conv2d/csrc/conv2d_fused.cu",
        "replaces": REPLACES["conv2d_fused"],
        "launches": (launches + abort_launches + dist_launches
                     + serve_launches + tool_launches),
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
    t0 = time.perf_counter()
    run_embeds(EMBEDS_ARCH)
    print(f"[time] {EMBEDS_ARCH} phases {time.perf_counter() - t0:.1f} s")
    kernels += [entries[n] for n in ("flash_prefill", "decode_attention",
                                     "ssd_chunk", "moe_gemm")]
    t0 = time.perf_counter()
    moe_train, ssd_train, bwd_entries = run_train()
    entries["moe_gemm"]["launches"] += moe_train
    entries["ssd_chunk"]["launches"] += ssd_train
    kernels += bwd_entries
    print(f"[time] training phases {time.perf_counter() - t0:.1f} s")
    print(f"[kernels] ssd_chunk: library_ms null: no single PyTorch call "
          f"computes the intra-chunk SSD; its launches mamba2's fp32 "
          f"generate's and phase 6's {ssd_train} (mamba2's and zamba2's "
          f"gradients and train steps); moe_gemm: its times are granite's "
          f"fp32 generate's, library_ms torch.bmm on the same (E, C, D) x "
          f"(E, D, F), its launches that generate's and phase 6's "
          f"{moe_train} (granite's gradients and train steps); "
          f"flash_prefill_bwd: one train step's 16 launches at the path's "
          f"shape, library_ms SDPA's backward; ssd_chunk_bwd: one mamba2 "
          f"train step's 48 launches at the path's shape, library_ms null "
          f"(no single PyTorch call computes it)")
    print(f"[profile] device-ms readings from CUDA events because "
          f"torch.profiler recorded no kernel: {_PROFILER['fallbacks']}")

    # -- 6. result lines -------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
