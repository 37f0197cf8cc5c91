"""Fleet routing demo on PyTorch's port: two cells (clusters), tenants
admitted through the shared PlanRegistry, one device-churn event
re-planned on the incremental planner hot path, and a registry hit when
a second, identically-shaped cluster joins — plus a watermark autoscale
pass.

The counterpart of ``examples/fleet_routing.py`` in the port
(``repro_torch``).  It only plans: no weights, no device.

    PYTHONPATH=src python examples/fleet_routing_torch.py

Every plan carries honest provenance in ``plan.source``:
``scratch`` (full PICO optimization), ``incremental`` (the per-model
PlannerCache reused segment geometry), ``registry`` (no planning at
all — an identical cluster was planned before, anywhere in the fleet).
"""

import argparse
import dataclasses

from repro_torch.api import FleetSpec, PlanSpec
from repro_torch.core import Cluster, make_pi_cluster
from repro_torch.fleet import Autoscaler, FleetRouter, Tenant
from repro_torch.models.cnn import zoo


def renamed(cluster: Cluster, prefix: str) -> Cluster:
    """Same hardware, fresh device names (a different physical pod)."""
    return Cluster([dataclasses.replace(d, name=f"{prefix}.{d.name}")
                    for d in cluster.devices], bandwidth=cluster.bandwidth)


def provision(rt, decision):
    shape = rt.cells[decision.cell].cluster
    return f"pod-{len(rt.cells)}", renamed(shape, f"x{len(rt.cells)}")


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]
                            ).parse_args(argv)
    admissions = []

    # two cells: a strong 4-Pi pod and a weaker one
    cells = {
        "pod-a": make_pi_cluster([1.5, 1.5, 1.2, 1.2]),
        "pod-b": renamed(make_pi_cluster([1.0, 1.0, 0.8, 0.8]), "b"),
    }
    router = FleetRouter(cells, spec=FleetSpec(routing="least_loaded",
                                               max_clusters=4))

    # admit two tenants: both plans are built from scratch (cold fleet)
    detector = Tenant("detector",
                      zoo.squeezenet(input_size=(96, 96), scale=0.5),
                      weight=2.0, spec=PlanSpec())
    classifier = Tenant("classifier",
                        zoo.mobilenetv3(input_size=(96, 96), scale=0.5))
    for t in (detector, classifier):
        a = router.admit(t)
        admissions.append((a.tenant, a.cell, a.plan.period, a.plan_source))
        print(f"admitted {a.tenant:10s} -> {a.cell}  "
              f"period={a.plan.period * 1e3:7.2f}ms  source={a.plan_source}")

    # churn: pod-a loses a device; the re-plan runs on the incremental hot
    # path (the per-model PlannerCache kept the chain's segment geometry)
    pod_a = router.cells["pod-a"].cluster
    smaller = pod_a.restricted(pod_a.devices[:-1])
    churned = []
    for name, plan in router.churn("pod-a", smaller).items():
        churned.append((name, plan.period, plan.source))
        print(f"churn    {name:10s} -> pod-a  "
              f"period={plan.period * 1e3:7.2f}ms  source={plan.source}")

    # a second pod with pod-b's exact shape joins: admitting the classifier
    # model there is a pure registry hit (name-insensitive cluster
    # signature; the cached plan's devices are rebound onto the new names)
    router.add_cell("pod-c",
                    renamed(make_pi_cluster([1.0, 1.0, 0.8, 0.8]), "c"))
    router.observe("pod-c", 0.0)          # brand new -> least loaded
    twin = Tenant("classifier-2",
                  zoo.mobilenetv3(input_size=(96, 96), scale=0.5))
    a = router.admit(twin)
    admissions.append((a.tenant, a.cell, a.plan.period, a.plan_source))
    print(f"admitted {a.tenant:10s} -> {a.cell}  "
          f"period={a.plan.period * 1e3:7.2f}ms  source={a.plan_source}")
    assert a.plan_source == "registry", a.plan_source
    reg = router.registry
    registry = (reg.hits, reg.misses, len(reg))
    print(f"registry: {reg.hits} hits / {reg.misses} misses "
          f"({reg.hit_rate:.0%} hit rate, {len(reg)} entries)")

    # autoscale: pod-a is hot, pod-b idle; provision clones the hot cell's
    # shape, decommission approves draining (tenants re-route via registry)
    router.observe("pod-a", 0.95)
    router.observe("pod-b", 0.05)
    scaler = Autoscaler(router, provision=provision,
                        decommission=lambda rt, d: True)
    decisions = []
    for d in scaler.evaluate():
        decisions.append((d.cell, d.load, d.action, d.applied, d.detail))
        print(f"autoscale {d.cell:6s} load={d.load:.2f} -> {d.action:10s} "
              f"applied={d.applied} {d.detail}")
    return {"admissions": admissions, "churn": churned,
            "registry": registry,
            "autoscale": decisions}


if __name__ == "__main__":
    main()
