"""Multi-tenant serving demo on PyTorch: three CNN tenants share one
heterogeneous Pi cluster through the asynchronous ServingScheduler —
weighted device partitioning, admission control, SLO tracking,
continuous micro-batching, and a device dropping out mid-traffic.

The counterpart of ``examples/serving_multitenant.py`` in the port
(``repro_torch``).  The serve is in virtual time (no tenant's weights
are loaded, so no stage computes); the scheduler is made for
``--device`` (default ``cuda``) all the same.

    PYTHONPATH=src python examples/serving_multitenant_torch.py [--device cpu]
"""

import argparse

import repro_torch
from repro_torch.api import ExecSpec, PlanSpec
from repro_torch.core import make_pi_cluster
from repro_torch.models.cnn import zoo
from repro_torch.runtime import DeviceLeave
from repro_torch.serving import (OpenLoopGenerator, SchedulerConfig,
                                 ServingScheduler, TenantConfig,
                                 serve_time_sliced)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback to cpu)")
    device = repro_torch.require_device(ap.parse_args(argv).device)
    cluster = make_pi_cluster([1.5, 1.5, 1.2, 1.2, 1.0, 1.0, 0.8, 0.8])

    # three tenants: weight = device entitlement, slo_s = per-request
    # deadline, max_queue = admission bound, max_batch = stage-0
    # coalescing; per-tenant planner knobs ride in a PlanSpec
    tenants = [
        TenantConfig("detector",
                     zoo.squeezenet(input_size=(96, 96), scale=0.5),
                     weight=2.0, slo_s=0.5, max_queue=64, max_batch=4,
                     plan_spec=PlanSpec()),
        TenantConfig("classifier", zoo.mobilenetv3(input_size=(96, 96),
                                                   scale=0.5),
                     weight=1.0, slo_s=1.0, max_queue=64, max_batch=4),
        TenantConfig("embedder",
                     zoo.resnet34(input_size=(96, 96), scale=0.25),
                     weight=1.0, slo_s=1.0, max_queue=64, max_batch=4),
    ]

    # params are pre-staged on every device, so re-partitions pay a fast
    # local reload instead of a WLAN push; the execution backend is one
    # ExecSpec shared by every tenant pipeline
    sched = ServingScheduler(tenants, cluster,
                             config=SchedulerConfig(seed=0,
                                                    migration_bandwidth=1e9),
                             exec_spec=ExecSpec(), device=device)
    print("initial device split:")
    split = {ts.cfg.name: [d.name for d in ts.share.cluster.devices]
             for ts in sched._tenants.values()}
    for name, devs in split.items():
        print(f"  {name:11s} -> {devs}")

    # seeded open-loop traffic at ~70% of each tenant's capacity, bursty
    # on the detector; all streams span the same window so they overlap
    workload = {}
    for i, ts in enumerate(sched._tenants.values()):
        rate = 0.7 / ts.share.pico.period
        gen = OpenLoopGenerator(rate_per_s=rate, seed=i,
                                burst_factor=3.0 if i == 0 else 1.0,
                                burst_period_s=1.0)
        workload[ts.cfg.name] = gen.generate(max(8, int(rate * 3.0)))

    # churn during traffic: the weakest Pi drops out halfway through
    horizon = max(r.arrival for rs in workload.values() for r in rs)
    report = sched.serve(workload,
                         churn=[DeviceLeave(0.5 * horizon, "pi7@0.8GHz")])

    print(f"\nserved {report.served} requests in {report.makespan:.2f}s "
          f"virtual ({report.throughput_per_min:.0f}/min aggregate), "
          f"{report.dropped_inflight} in-flight frames lost")
    for name, s in report.tenants.items():
        print(f"  {name:11s} served={s.served:4d} rejected={s.rejected:3d} "
              f"expired={s.expired:3d} p50={s.p50_latency_s * 1e3:6.1f}ms "
              f"p95={s.p95_latency_s * 1e3:6.1f}ms "
              f"miss-rate={s.deadline_miss_rate:.1%}")
    for r in report.repartitions:
        sizes = {n: len(d) for n, d in r.assignment.items()}
        print(f"  re-partition @{r.time:.2f}s ({r.reason}): {sizes}, "
              f"migration {r.migration_s * 1e3:.1f}ms")
    print(f"  stage-executable cache: {report.cache.hits} hits / "
          f"{report.cache.misses} misses across re-plans")

    # the naive alternative: each tenant gets the whole cluster in turn
    base = serve_time_sliced(tenants, cluster, workload)
    ratio = report.throughput_per_min / base.throughput_per_min
    print(f"\ntime-sliced baseline: {base.throughput_per_min:.0f}/min "
          f"-> partitioned scheduler is {ratio:.2f}x faster")
    return {"split": split, "served": report.served,
            "makespan": report.makespan,
            "dropped_inflight": report.dropped_inflight,
            "tenants": {n: (s.served, s.rejected, s.expired, s.p50_latency_s,
                            s.p95_latency_s, s.deadline_miss_rate)
                        for n, s in report.tenants.items()},
            "repartitions": [(r.time, r.reason,
                              {n: sorted(d) for n, d in r.assignment.items()},
                              r.migration_s)
                             for r in report.repartitions],
            "cache": (report.cache.hits, report.cache.misses),
            "baseline_per_min": base.throughput_per_min, "ratio": ratio}


if __name__ == "__main__":
    main()
