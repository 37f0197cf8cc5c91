"""Trace CLI: summarize and validate ``repro_torch.obs`` Perfetto traces.

The online half of the observability story as a shell command — run a
traced deployment (``DeploySpec(trace=True)``), save the trace, then:

    # structural validation (CI runs this on the smoke-bench artifact)
    python -m repro_torch.tools.trace TRACE.json --validate

    # human summary: per-device and per-stage breakdowns, the
    # pipeline-bubble fraction, and the modeled critical path
    python -m repro_torch.tools.trace TRACE.json

The summary is computed purely from the span tree (no re-simulation):
device rows aggregate ``stage.compute`` spans per track, the bubble
fraction is the idle share of each device's busy window, and the
critical path chains the worst compute phase of every stage plus the
inter-stage transfers — the pipeline's latency lower bound as traced.
"""

from __future__ import annotations

import argparse
import json
import sys


def _span_stats(spans) -> dict:
    """Aggregate a span list into the summary's building blocks."""
    from ..obs.metrics import quantile
    compute = [s for s in spans if s.name == "stage.compute"]
    comm = [s for s in spans if s.name in ("stage.comm", "halo.exchange")]
    frames = [s for s in spans if s.name == "frame"]
    t0 = min((s.ts for s in spans), default=0.0)
    t1 = max((s.end for s in spans), default=0.0)
    per_device: dict[str, dict] = {}
    for s in compute:
        d = per_device.setdefault(s.track, {"n": 0, "busy": 0.0})
        d["n"] += 1
        d["busy"] += s.dur
    per_stage: dict[int, list] = {}
    for s in compute:
        per_stage.setdefault(int(s.attr("stage", -1)), []).append(s.dur)
    comm_per_stage: dict[int, list] = {}
    for s in comm:
        comm_per_stage.setdefault(int(s.attr("stage", -1)), []).append(s.dur)
    # critical path: the worst compute phase of every stage, chained,
    # plus the worst transfer after each stage
    critical = (sum(max(d) for d in per_stage.values())
                + sum(max(d) for d in comm_per_stage.values()))
    lat = [s.dur for s in frames]
    return {
        "window": (t0, t1),
        "per_device": per_device,
        "per_stage": per_stage,
        "comm_per_stage": comm_per_stage,
        "critical_path_s": critical,
        "frames": len(frames),
        "frame_lat": {"mean": sum(lat) / len(lat) if lat else 0.0,
                      "p50": quantile(lat, 50.0),
                      "p95": quantile(lat, 95.0)},
    }


def bubble_fraction(spans) -> float:
    """Idle share of the pipeline: 1 - busy/(devices x window), over
    the span window.  0 = perfectly packed, 1 = fully idle."""
    stats = _span_stats(spans)
    t0, t1 = stats["window"]
    window = t1 - t0
    devices = stats["per_device"]
    if window <= 0.0 or not devices:
        return 0.0
    busy = sum(d["busy"] for d in devices.values())
    return max(0.0, 1.0 - busy / (window * len(devices)))


def summarize(spans, out=None) -> None:
    """Print the per-device / per-stage breakdown for a span list to
    ``out`` (default: ``sys.stdout`` as it is at the call)."""
    out = sys.stdout if out is None else out
    st = _span_stats(spans)
    t0, t1 = st["window"]
    window = t1 - t0
    print(f"trace: {len(spans)} spans over {window * 1e3:.3f} ms "
          f"({st['frames']} frames)", file=out)
    if st["frames"]:
        fl = st["frame_lat"]
        print(f"frame latency: mean {fl['mean'] * 1e3:.3f} ms, "
              f"p50 {fl['p50'] * 1e3:.3f} ms, p95 {fl['p95'] * 1e3:.3f} ms",
              file=out)
    if st["per_device"]:
        print("per-device compute:", file=out)
        for track in sorted(st["per_device"]):
            d = st["per_device"][track]
            util = d["busy"] / window if window > 0 else 0.0
            print(f"  {track:<12} {d['n']:>5} phases  "
                  f"busy {d['busy'] * 1e3:9.3f} ms  util {util:6.1%}",
                  file=out)
        print(f"pipeline bubble fraction: {bubble_fraction(spans):.1%}",
              file=out)
    if st["per_stage"]:
        print("per-stage compute:", file=out)
        for s in sorted(st["per_stage"]):
            durs = st["per_stage"][s]
            comm = sum(st["comm_per_stage"].get(s, ()))
            print(f"  stage {s:<3} {len(durs):>5} phases  "
                  f"mean {sum(durs) / len(durs) * 1e3:8.3f} ms  "
                  f"max {max(durs) * 1e3:8.3f} ms  "
                  f"comm {comm * 1e3:8.3f} ms", file=out)
        print(f"critical path (worst chain): "
              f"{st['critical_path_s'] * 1e3:.3f} ms", file=out)
    other = sorted({s.name for s in spans}
                   - {"stage.compute", "stage.comm", "halo.exchange",
                      "frame"})
    if other:
        counts = {n: sum(1 for s in spans if s.name == n) for n in other}
        print("other spans: " + ", ".join(f"{n} x{c}"
                                          for n, c in counts.items()),
              file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.trace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace", help="Chrome-trace JSON from Tracer.save()")
    ap.add_argument("--validate", action="store_true",
                    help="structural validation only (exit 1 on problems)")
    args = ap.parse_args(argv)

    from ..obs.trace import from_chrome_trace, validate_chrome_trace
    with open(args.trace) as f:
        doc = json.load(f)
    errors = validate_chrome_trace(doc)
    if args.validate:
        if errors:
            print(f"INVALID: {len(errors)} problem(s)", file=sys.stderr)
            for e in errors:
                print(f"  {e}", file=sys.stderr)
            return 1
        n = sum(1 for ev in doc["traceEvents"]
                if ev.get("ph") in ("X", "i", "I"))
        print(f"valid chrome trace: {n} events, "
              f"{len({ev.get('pid') for ev in doc['traceEvents']})} tracks")
        return 0
    if errors:
        print(f"cannot summarize: trace has {len(errors)} structural "
              f"problem(s) — run with --validate for the list",
              file=sys.stderr)
        return 1
    summarize(from_chrome_trace(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
