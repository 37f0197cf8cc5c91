"""Multi-pod dry run: run every (arch x shape x mesh) combo's step once on
fake tensors over a fake process group; the counterpart of the JAX
package's ``launch/dryrun.py``.

The reference lowers and compiles each step with ``ShapeDtypeStruct``
stand-ins under the production mesh and reads the compiled module.  The
port runs the step itself, once, on fake tensors
(``torch._subclasses.fake_tensor``: shapes, dtypes and devices, nothing
allocated or computed) placed as DTensors over a fake process group of
the mesh's size (256 ranks, or 512 with ``--multi-pod``), seen from rank
0, and records what that rank dispatches (the census of
``launch/hlo_analysis.py``), its memory (``MemTracker``) and the
roofline terms at the H100's peaks (``launch/roofline.py``) to
``experiments/dryrun_torch/*.json`` (resumable; one JSON per combo).

The step of each shape: ``train_4k`` the sharded ``make_train_step``
step (AdamW), ``prefill_32k`` ``M.prefill``, the decode shapes
``M.decode_step``; each with ``backend="cuda"`` (the kernels' wrappers
answer fake tensors without launching and count their work), in bf16
(the reference's ``DTYPE``) except the train step, which runs in fp32:
the port trains in fp32 (its kernels' backward are fp32 only, ROADMAP
Queue 1), so a bf16 train step does not exist to count.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape decode_32k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape decode_32k --device cpu          # no card: fake CPU tensors
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from .. import configs
from ..configs.shapes import SHAPES, arch_for_shape, input_specs
from ..models.transformer import model as M
from ..models.transformer.sharded import local
from ..training import tree
from ..training.optim import AdamW
from ..training.steps import make_train_step
from . import sharding
from .hlo_analysis import Census, mem_tracker
from .mesh import batch_axes, make_production_mesh
from .roofline import of_census

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

DTYPE = torch.bfloat16
#: the train step's dtype: the port's kernels have no bf16 backward
TRAIN_DTYPE = torch.float32
OPTS = ("seqshard", "cacheseq", "moeshard", "headpad", "ring")


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks in this process, as rank 0
    (``torch.testing``'s ``FakeStore`` and ``"fake"`` backend: collectives
    return at once and move nothing), destroyed on exit.  Refuses when a
    process group is already started: one default group a process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            f"dry run: a process group of {dist.get_world_size()} ranks is "
            f"already started; the dry run starts its own fake group of "
            f"{world} ranks, one default group a process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _variant(cfg, shape, opts: dict):
    cfg = arch_for_shape(cfg, shape)
    if opts.get("headpad") and cfg.n_heads and cfg.n_heads % 16:
        # pad attention heads to a multiple of the model axis so they
        # shard fully instead of replicating (the layout is what matters)
        pad = lambda h: ((h + 15) // 16) * 16          # noqa: E731
        cfg = replace(cfg, n_heads=pad(cfg.n_heads),
                      n_kv_heads=pad(cfg.n_kv_heads), head_dim=cfg.hd,
                      name=f"{cfg.name}-headpad")
    return cfg


def _local_bytes(t) -> int:
    """Bytes of rank 0's part of a tree's tensors (a DTensor's local
    shard, a plain tensor whole)."""
    total = 0
    for leaf in tree.leaves(t) if not isinstance(t, torch.Tensor) else [t]:
        if isinstance(leaf, torch.Tensor):
            loc = local(leaf)
            total += loc.numel() * loc.element_size()
    return total


def build_step(cfg, shape, mesh, opts: dict | None = None,
               device: str = "cuda", fake_mode: FakeTensorMode | None = None):
    """The step of one combo on fake inputs placed on ``mesh``:
    ``(fn, args, dtype)``, the step run as ``fn(*args)``.  ``cfg`` is the
    arch (the shape's variant taken here); ``opts`` (the perf levers, all
    off by default): ``seqshard`` the (B, S, d) activations' sequence over
    ``model`` (``act_pspec``), ``moeshard`` the MoE dispatch buffer over
    the data axes (``moe_pspec``), ``ring`` ring attention over
    ``model`` (prefill), ``cacheseq`` the decode cache's sequence over
    ``model`` (``cache_pspecs(mode="sequence")``), ``headpad`` heads
    padded to a multiple of 16.  The inputs are made in ``fake_mode``."""
    opts = opts or {}
    cfg = _variant(cfg, shape, opts)
    fake_mode = fake_mode or FakeTensorMode()
    daxes = batch_axes(mesh)
    dtype = TRAIN_DTYPE if shape.kind == "train" else DTYPE
    P = sharding.P
    act_pspec = None
    if opts.get("seqshard") and shape.seq_len % mesh.shape[
            mesh.mesh_dim_names.index("model")] == 0:
        act_pspec = P(daxes, "model", None)
    moe_pspec = P(daxes, None, None, None) if opts.get("moeshard") else None
    ring = (mesh, "model") if opts.get("ring") else None
    specs = input_specs(cfg, shape, dtype, device, fake_mode)
    with fake_mode:
        params = M.init_params(cfg, torch.Generator(device="cpu"),
                               device=device, dtype=dtype)
        params = sharding.distribute(
            params, sharding.param_pspecs(cfg, params, mesh), mesh)
        if shape.kind == "train":
            opt = AdamW(lr=1e-4)
            state = opt.init(params)
            batch = sharding.distribute(
                specs, sharding.batch_pspecs(cfg, specs, mesh, daxes), mesh)
            step = make_train_step(cfg, opt, act_pspec=act_pspec,
                                   moe_pspec=moe_pspec, backend="cuda")
            return step, (params, state, batch), dtype
        if shape.kind == "prefill":
            batch = sharding.distribute(
                specs, sharding.batch_pspecs(cfg, specs, mesh, daxes), mesh)

            def prefill(p, b):
                with torch.no_grad():
                    return M.prefill(cfg, p, b, backend="cuda", ring=ring,
                                     act_pspec=act_pspec,
                                     moe_pspec=moe_pspec)
            return prefill, (params, batch), dtype
        mode = "sequence" if opts.get("cacheseq") else "feature"
        cache = sharding.distribute(
            specs["cache"], sharding.cache_pspecs(cfg, specs["cache"], mesh,
                                                  daxes, mode=mode), mesh)
        inputs = sharding.distribute(
            specs["inputs"], sharding.batch_pspecs(cfg, specs["inputs"], mesh,
                                                   daxes), mesh)

        def decode(p, c, i):
            with torch.no_grad():
                return M.decode_step(cfg, p, c, i, backend="cuda")
        return decode, (params, cache, inputs), dtype


def _peak_bytes(tracker, device) -> int:
    peak = tracker.get_tracker_snapshot("peak")
    return max((v.get("Total", 0) for d, v in peak.items()
                if torch.device(d).type == torch.device(device).type),
               default=0)


def measure(cfg, shape, mesh, opts: dict | None = None,
            device: str = "cuda"):
    """Build one combo's step on ``mesh`` (a mesh over the process group
    that is started) and run it once under the census and the memory
    tracker: ``(fields, census)``, the record's fields from ``n_devices``
    on (see :func:`run_combo`) and the :class:`HloCensus`."""
    t0 = time.time()
    fake_mode = FakeTensorMode()
    fn, args, dtype = build_step(cfg, shape, mesh, opts, device, fake_mode)
    t_lower = time.time() - t0
    arg_bytes = _local_bytes(args)
    tracker = mem_tracker()
    tracker.track_external(*[local(t) for t in tree.leaves(list(args))
                             if isinstance(t, torch.Tensor)])
    with fake_mode, tracker, Census() as c:
        result = fn(*args)
    t_compile = time.time() - t0 - t_lower
    peak = _peak_bytes(tracker, device)
    census = c.census
    var = _variant(cfg, shape, opts or {})
    n_dev = mesh.size()
    # MODEL_FLOPS = 6 N D (train) / 2 N D, N the active params, per device
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    model_flops = ((6 if shape.kind == "train" else 2)
                   * var.active_param_count() * tokens / n_dev)
    fields = {
        "n_devices": n_dev, "kind": shape.kind,
        "params": var.param_count(),
        "active_params": var.active_param_count(),
        "variant": var.name, "device": str(device),
        "ok": True,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _local_bytes(list(result)),
            "temp_bytes": max(peak - arg_bytes, 0),
            "generated_code_bytes": 0,
        },
        "roofline": of_census(census,
                              str(dtype).removeprefix("torch.")).to_dict(),
        "model_flops_per_device": model_flops,
        "useful_flops_ratio": (model_flops / census.flops if census.flops
                               else 0.0),
    }
    return fields, census


def run_combo(arch_name: str, shape_name: str, multi_pod: bool,
              out_dir: Path = OUT_DIR, force: bool = False,
              save_census: bool = False, opts: dict | None = None,
              device: str = "cuda") -> dict:
    """Run one combo in a fake group of its own and write its record
    (``<arch>__<shape>__<pod1|pod2>[__<opts>].json`` in ``out_dir``;
    an existing one is returned unless ``force``).  The record has the
    reference's keys; ``memory.argument_bytes`` is rank 0's local bytes
    of the step's inputs, ``output_bytes`` of its outputs,
    ``temp_bytes`` the step's peak of live bytes (``MemTracker``) less
    the arguments, ``generated_code_bytes`` 0; ``lower_s`` is the time
    to build the fake inputs and ``compile_s`` the fake step's;
    ``roofline`` the census's terms at the H100's peaks (and the step's
    dtype).  A combo that raises is recorded with ``ok: false``, its
    error and traceback.  ``save_census`` also writes the census
    (``.census.json.gz``, for ``launch/profile.py``)."""
    mesh_tag = "pod2" if multi_pod else "pod1"
    opt_tag = ("__" + "+".join(sorted(k for k, v in (opts or {}).items()
                                      if v))) if opts else ""
    out = Path(out_dir) / f"{arch_name}__{shape_name}__{mesh_tag}{opt_tag}.json"
    if out.exists() and not force:
        return json.loads(out.read_text())
    out.parent.mkdir(parents=True, exist_ok=True)
    rec: dict = {"arch": arch_name, "shape": shape_name, "mesh": mesh_tag,
                 "opts": sorted(k for k, v in (opts or {}).items() if v)}
    t0 = time.time()
    try:
        with fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=device)
            fields, census = measure(configs.get(arch_name),
                                     SHAPES[shape_name], mesh, opts, device)
        if save_census:
            with gzip.open(out.with_suffix(".census.json.gz"), "wt") as fh:
                json.dump(census.to_dict(), fh)
        rec["mesh"] = "pod2x16x16" if multi_pod else "16x16"
        rec.update(fields)
    except Exception as e:  # recorded: the sweep goes on
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    rec["wall_s"] = round(time.time() - t0, 2)
    out.write_text(json.dumps(rec, indent=2, default=str))
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=configs.ARCH_NAMES)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep all arch x shape x {1,2} pods")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-census", action="store_true",
                    help="also write each census (.census.json.gz) for "
                         "repro_torch.launch.profile")
    ap.add_argument("--opt", default="",
                    help="comma list of perf levers: " + ",".join(OPTS))
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors and the mesh (default "
                         "cuda; no fallback to cpu)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a dry run "
                         "on fake CPU tensors")
    opts = {k: True for k in args.opt.split(",") if k}
    unknown = sorted(set(opts) - set(OPTS))
    if unknown:
        ap.error(f"unknown --opt {unknown}; choose from {list(OPTS)}")

    if args.all:
        combos = [(a, s, mp) for a in configs.ARCH_NAMES for s in SHAPES
                  for mp in (False, True)]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape, args.multi_pod)]
    else:
        ap.error("--arch and --shape, or --all")

    n_ok = 0
    t0 = time.time()
    for a, s, mp in combos:
        rec = run_combo(a, s, mp, Path(args.out), force=args.force,
                        save_census=args.save_census, opts=opts,
                        device=args.device)
        ok = rec.get("ok")
        n_ok += bool(ok)
        extra = (f"flops={rec['roofline']['flops']:.3g} "
                 f"dom={rec['roofline']['dominant']}" if ok
                 else rec.get("error", ""))
        print(f"[{'OK ' if ok else 'FAIL'}] {a:22s} {s:12s} "
              f"{'pod2' if mp else 'pod1'} ({rec['wall_s']}s) {extra}",
              flush=True)
    print(f"{n_ok}/{len(combos)} combos OK in {time.time() - t0:.1f} s")
    return 0 if n_ok == len(combos) else 1


if __name__ == "__main__":
    raise SystemExit(main())
