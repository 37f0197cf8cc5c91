"""Plan CLI: build, save, load, and validate deployment artifacts.

The offline half of the paper's offline-plan/online-execute split as a
shell command — plan on a workstation, ship ``plan.json`` to the fleet:

    # plan VGG16 across 4 heterogeneous Pis and save the artifact
    python -m repro_torch.tools.plan --model vgg16 --devices 4 --out plan.json

    # on the target: reload and verify without re-planning
    python -m repro_torch.tools.plan --load plan.json --validate

    # ... and run one frame on the card against the monolithic forward
    python -m repro_torch.tools.plan --load plan.json --validate --execute

``--validate`` proves the artifact round-trips (re-serialization is
byte-identical) and prices coherently (simulate matches the plan
period); ``--execute`` runs one seeded frame through the pipelined
stages and holds every output to the monolithic forward within
rtol = atol = 1e-5.  The artifact is the JAX package's document: one
written by either package's CLI loads in the other's.

Everything runs on ``--device`` (default ``cuda``); without a card the
CLI stops unless it is given ``--device cpu``, where the conv kernel's
plain version runs.  ``--backend`` takes the port's names (``cuda``,
``torch``) or the JAX package's (``pallas``, ``xla``).
"""

from __future__ import annotations

import argparse
import json
import sys

DEFAULT_FREQS = (1.5, 1.2, 1.0, 0.8)
# --execute: pipelined outputs against the monolithic forward
EXEC_RTOL = EXEC_ATOL = 1e-5


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.plan", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default=None,
                    help="zoo model name (vgg16, resnet34, squeezenet, ...)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="channel scale for the zoo model")
    ap.add_argument("--input", default=None, metavar="W[,H]",
                    help="input size override, e.g. 128 or 128,96")
    ap.add_argument("--devices", type=int, default=4,
                    help="cluster size (Raspberry-Pi model)")
    ap.add_argument("--freqs", default=None,
                    help="comma-separated device GHz (cycled to --devices); "
                         f"default {','.join(map(str, DEFAULT_FREQS))}")
    ap.add_argument("--bandwidth-mbps", type=float, default=50.0)
    ap.add_argument("--t-lim", type=float, default=float("inf"))
    ap.add_argument("--max-diameter", type=int, default=5)
    ap.add_argument("--n-split", type=int, default=None)
    ap.add_argument("--backend", default=None,
                    help="conv lowering backend (cuda, torch; the JAX "
                         "package's pallas, xla map to them)")
    ap.add_argument("--calibrate", action="store_true",
                    help="time compiled stages and re-plan on measured costs")
    ap.add_argument("--out", default=None, help="write the deployment here")
    ap.add_argument("--load", default=None, metavar="PLAN_JSON",
                    help="load a saved deployment instead of planning")
    ap.add_argument("--validate", action="store_true",
                    help="with --load: verify round-trip + simulate")
    ap.add_argument("--execute", action="store_true",
                    help="with --validate: run one frame and check numerics")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback to cpu)")
    return ap


def _make_cluster(args):
    from ..core import make_pi_cluster
    freqs = ([float(f) for f in args.freqs.split(",")] if args.freqs
             else list(DEFAULT_FREQS))
    freqs = [freqs[i % len(freqs)] for i in range(args.devices)]
    return make_pi_cluster(freqs, bandwidth_mbps=args.bandwidth_mbps)


def _make_model(args):
    from ..models.cnn import zoo
    kw = {"scale": args.scale}
    if args.input:
        parts = [int(x) for x in args.input.split(",")]
        kw["input_size"] = (parts[0], parts[-1] if len(parts) > 1
                            else parts[0])
    return zoo.build(args.model, **kw)


def _cmd_plan(args, device) -> int:
    from ..api.artifacts import backend_from_wire
    from ..api.deployment import compile as compile_deployment
    from ..api.specs import ExecSpec, PlanSpec
    model = _make_model(args)
    cluster = _make_cluster(args)
    dep = compile_deployment(
        model, cluster,
        PlanSpec(t_lim=args.t_lim, max_diameter=args.max_diameter,
                 n_split=args.n_split),
        ExecSpec(backend=backend_from_wire(args.backend),
                 calibrate=args.calibrate),
        device=device)
    print(dep.describe())
    if args.out:
        path = dep.save(args.out)
        print(f"saved deployment artifact -> {path}")
    return 0


def _execute(dep) -> int:
    """One seeded frame through the pipelined stages and the monolithic
    forward on the deployment's device, every output held within
    EXEC_RTOL / EXEC_ATOL."""
    import torch
    w, h = dep.model.input_size
    g = torch.Generator(device=dep.device).manual_seed(1)
    x = torch.randn((1, h, w, dep.model.in_channels), generator=g,
                    device=dep.device)
    out = dep.run(x)
    ref = dep.model.forward(dep.params, x)
    worst, excess = 0.0, 0.0
    for k in ref:
        diff = (out[k] - ref[k]).abs()
        worst = max(worst, diff.max().item())
        excess = max(excess, (diff - EXEC_ATOL - EXEC_RTOL * ref[k].abs())
                     .max().item())
    if excess > 0:
        print(f"FAIL: pipelined outputs differ from the monolithic forward "
              f"by up to {worst:.3g} (limit {EXEC_ATOL:g} + {EXEC_RTOL:g} x "
              f"|ref|)", file=sys.stderr)
        return 1
    print(f"execute: pipelined outputs match monolithic forward ✓ on "
          f"{dep.device} ({len(ref)} output(s), max |diff| {worst:.3g}, "
          f"limit {EXEC_ATOL:g} + {EXEC_RTOL:g} x |ref|)")
    return 0


def _cmd_load(args, device) -> int:
    from ..api.deployment import Deployment
    dep = Deployment.load(args.load, device=device)
    print(dep.describe())
    if not args.validate:
        return 0
    # 1. re-serialization is byte-identical (stable schema)
    s = dep.to_json()
    if Deployment.from_json(s, device=device).to_json() != s:
        print("FAIL: artifact does not re-serialize identically",
              file=sys.stderr)
        return 1
    with open(args.load) as f:
        version = json.load(f).get("version")
    # 2. the priced plan is internally coherent
    rep = dep.simulate(frames=16)
    worst = max(st.cost.total for st in dep.pipeline.stages)
    if abs(rep.period - worst) > 1e-9 * max(1.0, worst):
        print(f"FAIL: simulate period {rep.period} != plan period {worst}",
              file=sys.stderr)
        return 1
    print(f"validate: schema v{version} ok, round-trip ok, "
          f"simulated period {rep.period * 1e3:.2f} ms, "
          f"avg util {rep.avg_utilization:.2f}")
    if args.execute:
        return _execute(dep)
    return 0


def main(argv=None) -> int:
    from ..api.deployment import require_device
    args = _build_parser().parse_args(argv)
    if args.load:
        return _cmd_load(args, require_device(args.device))
    if not args.model:
        print("error: need --model to plan or --load to reload",
              file=sys.stderr)
        return 2
    return _cmd_plan(args, require_device(args.device))


if __name__ == "__main__":
    sys.exit(main())
