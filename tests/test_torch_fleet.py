"""The port's fleet tier (``fleet/``: registry, store, router, autoscaler)
against the JAX package's.

The fleet tier is framework-free Python, copied, so registry keys,
hit/miss sequences, routing and scaling decisions must be *equal* to
the reference's on the same inputs, and a plan store written by either
package must serve the other.
"""

import dataclasses

import numpy as np
import pytest

from repro.api import FleetSpec as RefFleetSpec
from repro.api import PlanSpec as RefPlanSpec
from repro.core import Cluster as RefCluster
from repro.core import make_pi_cluster as ref_pi_cluster
from repro.fleet import Autoscaler as RefAutoscaler
from repro.fleet import FleetRouter as RefFleetRouter
from repro.fleet import PlanRegistry as RefPlanRegistry
from repro.fleet import PlanStore as RefPlanStore
from repro.fleet import Tenant as RefTenant
from repro.fleet import cluster_signature as ref_cluster_signature
from repro.fleet import fingerprint_model as ref_fingerprint_model
from repro.models.cnn import zoo as ref_zoo
from repro.obs.metrics import MetricsRegistry as RefMetricsRegistry
from repro_torch.api.specs import FleetSpec, PlanSpec
from repro_torch.core import Cluster, make_pi_cluster
from repro_torch.fleet import (Autoscaler, FleetRouter, PlanRegistry,
                               PlanStore, Tenant, cluster_signature,
                               fingerprint_model)
from repro_torch.models.cnn import zoo
from repro_torch.obs.metrics import MetricsRegistry

from _torch_cases import ZOO_TINY

# tiny-zoo models of the tenant mix
MIX = ["vgg16", "squeezenet", "resnet34"]
CELL_FREQS = {"a": [1.5, 1.2, 1.0, 0.8], "b": [1.5, 1.2, 1.0, 0.8],
              "c": [1.0, 1.0, 0.8]}


class _Side:
    """One package's names, so a scenario runs the same code on both."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.pi = ref_pi_cluster if ref else make_pi_cluster
        self.Cluster = RefCluster if ref else Cluster
        self.PlanSpec = RefPlanSpec if ref else PlanSpec
        self.FleetSpec = RefFleetSpec if ref else FleetSpec
        self.Registry = RefPlanRegistry if ref else PlanRegistry
        self.Store = RefPlanStore if ref else PlanStore
        self.Router = RefFleetRouter if ref else FleetRouter
        self.Autoscaler = RefAutoscaler if ref else Autoscaler
        self.Tenant = RefTenant if ref else Tenant
        self.Metrics = RefMetricsRegistry if ref else MetricsRegistry
        self.fingerprint = ref_fingerprint_model if ref else fingerprint_model
        self.signature = ref_cluster_signature if ref else cluster_signature
        z = ref_zoo if ref else zoo
        self.models = {n: z.build(n, **ZOO_TINY[n]) for n in ZOO_TINY}

    def renamed(self, cluster, prefix):
        return self.Cluster([dataclasses.replace(d, name=f"{prefix}.{d.name}")
                             for d in cluster.devices],
                            bandwidth=cluster.bandwidth)

    def cells(self):
        return {name: self.renamed(self.pi(f), name)
                for name, f in CELL_FREQS.items()}


REF, PORT = _Side(True), _Side(False)


def _plan_sig(p) -> tuple:
    """Exact plan identity: no tolerance anywhere."""
    return (p.period, p.latency, p.pipeline.feasible, p.source,
            tuple((sp.first_piece, sp.last_piece,
                   tuple(d.name for d in sp.devices), tuple(sp.fractions),
                   sp.cost.total, sp.cost.t_comp, sp.cost.t_comm)
                  for sp in p.pipeline.stages))


def _clusters(side):
    pi = side.pi([1.5, 1.2, 1.0, 0.8])
    pair = side.Cluster(list(pi.devices), bandwidth=pi.bandwidth,
                        pair_bandwidth={(pi.devices[0].name,
                                         pi.devices[1].name): 1e6})
    return [pi, side.renamed(pi, "podB"), side.pi([1.0, 1.0]),
            side.pi([1.5, 1.2, 1.0, 0.8], bandwidth_mbps=100.0), pair]


def test_fingerprints_and_signatures_equal_the_reference():
    for name in ZOO_TINY:
        assert PORT.fingerprint(PORT.models[name]) \
            == REF.fingerprint(REF.models[name])
    for a, b in zip(_clusters(PORT), _clusters(REF)):
        assert PORT.signature(a) == REF.signature(b)
    # flat links: names do not count; per-pair bandwidth: they do
    got = [PORT.signature(c) for c in _clusters(PORT)]
    assert got[0] == got[1] and got[4] != got[0]


def _registry_sequence(side):
    """A lookup sequence with repeats, renamed clusters, other specs and
    an LRU eviction (capacity 3): each call's source, hit and miss
    counts, and its plan."""
    reg = side.Registry(capacity=3, metrics=side.Metrics())
    cl = _clusters(side)
    steps = [("vgg16", 0, None), ("vgg16", 0, None), ("vgg16", 1, None),
             ("squeezenet", 0, None), ("vgg16", 2, None),
             ("vgg16", 0, 0.5), ("vgg16", 0, None), ("squeezenet", 4, None),
             ("squeezenet", 0, None), ("resnet34", 3, None),
             ("resnet34", 3, None)]
    out = []
    for name, ci, t_lim in steps:
        spec = side.PlanSpec() if t_lim is None else side.PlanSpec(
            t_lim=t_lim)
        plan = reg.get_or_plan(side.models[name], cl[ci], spec)
        out.append((plan.source, reg.hits, reg.misses, len(reg),
                    _plan_sig(plan)))
    return out


def test_registry_hit_miss_sequence_equals_the_reference():
    got, want = _registry_sequence(PORT), _registry_sequence(REF)
    assert got == want
    sources = [s for s, *_ in got]
    assert "registry" in sources and "scratch" in sources


def _tenant_mix(side, seed, routing):
    """A seeded mix of router operations: observe, admit, evict, churn,
    add and remove cells, then the autoscaler's decisions with hooks.
    Returns every decision and the final loads."""
    rng = np.random.default_rng(seed)
    router = side.Router(side.cells(), spec=side.FleetSpec(
        routing=routing, max_clusters=5), metrics=side.Metrics())
    log, admitted, added = [], [], 0
    for step in range(24):
        op = rng.choice(["observe", "admit", "admit", "evict", "churn",
                         "cell"])
        cells = sorted(router.cells)
        if op == "observe":
            cell = cells[int(rng.integers(len(cells)))]
            log.append(("observe", cell,
                        router.observe(cell, float(rng.uniform(0, 1)))))
        elif op == "admit":
            name = MIX[int(rng.integers(len(MIX)))]
            tenant = side.Tenant(f"t{step}", side.models[name],
                                 weight=float(rng.uniform(0.5, 2.0)))
            adm = router.admit(tenant)
            admitted.append(tenant.name)
            log.append(("admit", adm.tenant, adm.cell, adm.plan_source,
                        _plan_sig(adm.plan)))
        elif op == "evict" and admitted:
            name = admitted.pop(int(rng.integers(len(admitted))))
            log.append(("evict", name, router.evict(name) is not None))
        elif op == "churn":
            cell = router.cells[cells[int(rng.integers(len(cells)))]]
            if len(cell.cluster.devices) > 1:
                smaller = cell.cluster.restricted(cell.cluster.devices[:-1])
                plans = router.churn(cell.name, smaller)
                log.append(("churn", cell.name,
                            sorted((t, _plan_sig(p))
                                   for t, p in plans.items())))
        elif op == "cell":
            if len(cells) >= 5 or (len(cells) > 2
                                   and rng.uniform() < 0.5):
                moved = router.remove_cell(cells[-1])
                log.append(("remove", cells[-1],
                            [(m.tenant, m.cell, m.plan_source)
                             for m in moved]))
            else:
                added += 1
                name = f"n{added}"
                router.add_cell(name, side.renamed(side.pi([1.2, 1.0]),
                                                   name))
                log.append(("add", name))
    log.append(("loads", [(c, router.cell_load(c))
                          for c in sorted(router.cells)]))

    def provision(rt, decision):
        name = f"p{len(rt.cells)}"
        return name, side.renamed(side.pi([1.0, 1.0]), name)

    scaler = side.Autoscaler(router, provision=provision,
                             decommission=lambda rt, d: True,
                             metrics=side.Metrics())
    for cell in sorted(router.cells):
        router.observe(cell, float(rng.uniform(0, 1)))
    for _ in range(2):
        log.append(("scale", [dataclasses.astuple(d)
                              for d in scaler.evaluate()]))
    return log


@pytest.mark.parametrize("routing", ["least_loaded", "round_robin"])
@pytest.mark.parametrize("seed", [0, 1])
def test_router_and_autoscaler_decisions_equal_the_reference(seed, routing):
    got = _tenant_mix(PORT, seed, routing)
    want = _tenant_mix(REF, seed, routing)
    assert got == want
    kinds = {entry[0] for entry in got}
    assert {"admit", "scale"} <= kinds


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_plan_store_is_shared_across_packages(writer, tmp_path):
    """A plan store directory written by one package is read by the
    other: each entry a hit, the served plan the writer's."""
    w, r = (REF, PORT) if writer == "ref" else (PORT, REF)
    wreg = w.Registry(store=tmp_path, metrics=w.Metrics())
    written = [_plan_sig(wreg.get_or_plan(w.models[n], w.pi([1.5, 1.0, 0.8])))
               for n in MIX]
    rreg = r.Registry(store=r.Store(tmp_path), metrics=r.Metrics())
    assert len(rreg.store) == len(MIX)
    assert sorted(rreg.store.keys()) == sorted(wreg.store.keys())
    served = [rreg.get_or_plan(r.models[n], r.pi([1.5, 1.0, 0.8]))
              for n in MIX]
    assert [p.source for p in served] == ["registry"] * len(MIX)
    assert rreg.misses == 0
    assert [_plan_sig(p)[:2] for p in served] == [s[:2] for s in written]
    assert [_plan_sig(p)[4] for p in served] == [s[4] for s in written]
