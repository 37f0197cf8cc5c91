"""Demo on PyTorch: an 8-device heterogeneous cluster surviving churn.

The counterpart of ``examples/runtime_churn.py`` in the port
(``repro_torch``).  Streams 240 frames of a VGG16-class workload through
the event-driven runtime while the cluster degrades and recovers around
it:

  * t = 60 periods   the fastest device drops out      (re-plan: leave)
  * t = 120 periods  a device throttles to half clock  (re-plan: drift,
                     detected by the monitor's EWMA — nobody tells the
                     runtime about the throttle)
  * t = 160 periods  the dropped device's replacement joins
  * t = 200 periods  the WLAN hop degrades 2x

The run is timing-only (virtual time, no stage computes); the
deployment is made for ``--device`` (default ``cuda``) all the same.

Run:  PYTHONPATH=src python examples/runtime_churn_torch.py [--device cpu]
"""

import argparse

import repro_torch
from repro_torch.core import Device, make_pi_cluster
from repro_torch.models.cnn import zoo
from repro_torch.runtime import (DeviceJoin, DeviceLeave, FreqScale,
                                 LinkDegrade, validate)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback to cpu)")
    device = repro_torch.require_device(ap.parse_args(argv).device)

    m = zoo.vgg16(input_size=(224, 224), scale=0.25)
    cluster = make_pi_cluster([1.5, 1.5, 1.2, 1.2, 1.0, 1.0, 0.8, 0.8])
    dep = repro_torch.compile(m, cluster, device=device)
    P = dep.period
    print(f"model {m.name}: {len(m.graph.layers)} layers, "
          f"{len(dep.pipeline.stages)} stages, period {P*1e3:.2f} ms, "
          f"{60/P:.0f} frames/min on {len(cluster)} devices")

    # sanity: the event runtime reproduces the closed-form simulator
    v = validate(m.graph, cluster, m.input_size, pico=dep.pico, frames=32)
    print(f"runtime vs simulator: {v}")

    fastest = max(cluster.devices, key=lambda d: d.capacity)
    throttled = cluster.devices[2]
    churn = [
        DeviceLeave(60 * P, fastest.name),
        FreqScale(120 * P, throttled.name, 0.5),
        DeviceJoin(160 * P, Device("pi-spare@1.5GHz", capacity=3e9,
                                   active_power=6.25, idle_power=1.6)),
        LinkDegrade(200 * P, 2.0),
    ]
    rt = dep.runtime(repro_torch.DeploySpec(seed=0), churn=churn,
                     real_compute=False)
    rep = rt.run(240)

    print(f"\ncompleted {rep.completed}/{rep.frames} frames in "
          f"{rep.makespan:.2f}s virtual ({rep.throughput_per_min:.0f}/min "
          f"overall), {rep.restarts} frame restart(s)")
    print("\nre-plans:")
    for r in rep.replans:
        print(f"  t={r.time:7.3f}s  {r.reason:>6}: period "
              f"{r.old_period*1e3:6.2f} -> {r.new_period*1e3:6.2f} ms on "
              f"{r.n_devices} devices; migrated "
              f"{r.migration_bytes/1e6:.2f} MB in {r.migration_s*1e3:.1f} ms "
              f"(plan wall {r.wall_s*1e3:.0f} ms)")

    print("\nthroughput by phase (frames/min):")
    marks = [0.0] + [r.time for r in rep.replans] + [rep.makespan]
    phases = []
    for a, b in zip(marks, marks[1:]):
        if b > a:
            phases.append((a, b, rep.windowed_throughput(a, b) * 60))
            print(f"  [{a:7.3f}, {b:7.3f})  {phases[-1][2]:8.1f}")

    print("\nper-device (busiest first):")
    for d in sorted(rep.devices, key=lambda d: -d.busy_s)[:10]:
        print(f"  {d.device:>16}: util {d.utilization:5.1%}  "
              f"frames {d.frames:3d}  peak mem {d.memory_peak_bytes/1e6:6.1f} MB  "
              f"energy {d.energy_j:7.1f} J")
    return {"period": P, "stages": len(dep.pipeline.stages),
            "validation": str(v), "completed": rep.completed,
            "frames": rep.frames, "makespan": rep.makespan,
            "restarts": rep.restarts,
            "replans": [(r.time, r.reason, r.old_period, r.new_period,
                         r.n_devices, r.migration_bytes, r.migration_s)
                        for r in rep.replans],
            "phases": phases,
            "devices": [(d.device, d.utilization, d.frames,
                         d.memory_peak_bytes, d.energy_j)
                        for d in rep.devices]}


if __name__ == "__main__":
    main()
