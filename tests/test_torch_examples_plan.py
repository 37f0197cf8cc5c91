"""The examples that only plan or run in virtual time,
``examples/{runtime_churn,serving_multitenant,fleet_routing,
nasnet_dnc}_torch.py``, each run through its ``main`` and held to the
JAX package's library on the same arguments; and every example that
takes ``--device`` refusing ``cuda`` on a machine without a card.

Each example's planner and virtual-time figures must *equal* the
reference's (the planner and the runtime are framework-free copies);
the planner's host clocks (``ReplanRecord.wall_s``) are left out.
About 25 s on one CPU worker (25.2 s alone; 24 s of test time in a run
of the whole suite on six workers of an 8-core CPU).
"""

import dataclasses
import importlib
import sys
from pathlib import Path

import pytest
import torch

import repro
from repro.api import ExecSpec as RefExecSpec
from repro.api import FleetSpec as RefFleetSpec
from repro.api import PlanSpec as RefPlanSpec
from repro.core import Cluster as RefCluster
from repro.core import Device as RefDevice
from repro.core import make_pi_cluster as ref_pi_cluster
from repro.core import partition_graph_dnc as ref_partition_graph_dnc
from repro.core import plan as ref_plan
from repro.fleet import Autoscaler as RefAutoscaler
from repro.fleet import FleetRouter as RefFleetRouter
from repro.fleet import Tenant as RefTenant
from repro.models.cnn import zoo as ref_zoo
from repro.runtime import (DeviceJoin as RefDeviceJoin,
                           DeviceLeave as RefDeviceLeave,
                           FreqScale as RefFreqScale,
                           LinkDegrade as RefLinkDegrade,
                           validate as ref_runtime_validate)
from repro.serving import (OpenLoopGenerator as RefOpenLoopGenerator,
                           SchedulerConfig as RefSchedulerConfig,
                           ServingScheduler as RefServingScheduler,
                           TenantConfig as RefTenantConfig,
                           serve_time_sliced as ref_serve_time_sliced)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

# the examples that take --device (each makes a Deployment, a server,
# a scheduler or a tensor)
DEVICE_EXAMPLES = ("quickstart_torch", "lm_generate_torch",
                   "train_tiny_torch", "pico_pod_pipeline_torch",
                   "serve_pipeline_torch", "dist_pipeline_torch",
                   "runtime_churn_torch", "serving_multitenant_torch")


def example(name):
    return importlib.import_module(name)


@pytest.fixture(autouse=True)
def _one_thread():
    """The examples' small tensors run about as fast on one thread, and the
    other test workers need the cores (eight threads a worker ran these
    tests ten times slower beside two other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stages(pico) -> list:
    return [(s.first_piece, s.last_piece, [d.name for d in s.devices])
            for s in pico.pipeline.stages]


# -- runtime_churn ------------------------------------------------------------

def _ref_runtime_churn() -> dict:
    """``examples/runtime_churn.py``'s steps on the JAX package."""
    m = ref_zoo.vgg16(input_size=(224, 224), scale=0.25)
    cluster = ref_pi_cluster([1.5, 1.5, 1.2, 1.2, 1.0, 1.0, 0.8, 0.8])
    dep = repro.compile(m, cluster)
    P = dep.period
    v = ref_runtime_validate(m.graph, cluster, m.input_size, pico=dep.pico,
                             frames=32)
    fastest = max(cluster.devices, key=lambda d: d.capacity)
    churn = [RefDeviceLeave(60 * P, fastest.name),
             RefFreqScale(120 * P, cluster.devices[2].name, 0.5),
             RefDeviceJoin(160 * P, RefDevice("pi-spare@1.5GHz",
                                              capacity=3e9,
                                              active_power=6.25,
                                              idle_power=1.6)),
             RefLinkDegrade(200 * P, 2.0)]
    rep = dep.runtime(repro.DeploySpec(seed=0), churn=churn,
                      real_compute=False).run(240)
    marks = [0.0] + [r.time for r in rep.replans] + [rep.makespan]
    return {"period": P, "stages": len(dep.pipeline.stages),
            "validation": str(v), "completed": rep.completed,
            "frames": rep.frames, "makespan": rep.makespan,
            "restarts": rep.restarts,
            "replans": [(r.time, r.reason, r.old_period, r.new_period,
                         r.n_devices, r.migration_bytes, r.migration_s)
                        for r in rep.replans],
            "phases": [(a, b, rep.windowed_throughput(a, b) * 60)
                       for a, b in zip(marks, marks[1:]) if b > a],
            "devices": [(d.device, d.utilization, d.frames,
                         d.memory_peak_bytes, d.energy_j)
                        for d in rep.devices]}


def test_runtime_churn_equals_the_reference(capsys):
    got = example("runtime_churn_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert got == _ref_runtime_churn()
    assert got["completed"] == got["frames"] == 240
    assert [r[1] for r in got["replans"]][0] == "leave"
    assert "re-plans:" in out and "per-device (busiest first):" in out


# -- serving_multitenant ------------------------------------------------------

def _ref_serving_multitenant() -> dict:
    """``examples/serving_multitenant.py``'s steps on the JAX package."""
    cluster = ref_pi_cluster([1.5, 1.5, 1.2, 1.2, 1.0, 1.0, 0.8, 0.8])
    tenants = [
        RefTenantConfig("detector",
                        ref_zoo.squeezenet(input_size=(96, 96), scale=0.5),
                        weight=2.0, slo_s=0.5, max_queue=64, max_batch=4,
                        plan_spec=RefPlanSpec()),
        RefTenantConfig("classifier",
                        ref_zoo.mobilenetv3(input_size=(96, 96), scale=0.5),
                        weight=1.0, slo_s=1.0, max_queue=64, max_batch=4),
        RefTenantConfig("embedder",
                        ref_zoo.resnet34(input_size=(96, 96), scale=0.25),
                        weight=1.0, slo_s=1.0, max_queue=64, max_batch=4),
    ]
    sched = RefServingScheduler(
        tenants, cluster,
        config=RefSchedulerConfig(seed=0, migration_bandwidth=1e9),
        exec_spec=RefExecSpec())
    split = {ts.cfg.name: [d.name for d in ts.share.cluster.devices]
             for ts in sched._tenants.values()}
    workload = {}
    for i, ts in enumerate(sched._tenants.values()):
        rate = 0.7 / ts.share.pico.period
        gen = RefOpenLoopGenerator(rate_per_s=rate, seed=i,
                                   burst_factor=3.0 if i == 0 else 1.0,
                                   burst_period_s=1.0)
        workload[ts.cfg.name] = gen.generate(max(8, int(rate * 3.0)))
    horizon = max(r.arrival for rs in workload.values() for r in rs)
    report = sched.serve(workload, churn=[RefDeviceLeave(0.5 * horizon,
                                                         "pi7@0.8GHz")])
    base = ref_serve_time_sliced(tenants, cluster, workload)
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
            "baseline_per_min": base.throughput_per_min,
            "ratio": report.throughput_per_min / base.throughput_per_min}


def test_serving_multitenant_equals_the_reference(capsys):
    got = example("serving_multitenant_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert got == _ref_serving_multitenant()
    # virtual time only: no stage executable was built
    assert got["cache"] == (0, 0) and got["dropped_inflight"] == 0
    assert got["ratio"] > 1.0
    assert "partitioned scheduler is" in out


# -- fleet_routing ------------------------------------------------------------

def _renamed(cluster, prefix):
    return RefCluster([dataclasses.replace(d, name=f"{prefix}.{d.name}")
                       for d in cluster.devices], bandwidth=cluster.bandwidth)


def _ref_fleet_routing() -> dict:
    """``examples/fleet_routing.py``'s steps on the JAX package."""
    admissions = []
    router = RefFleetRouter(
        {"pod-a": ref_pi_cluster([1.5, 1.5, 1.2, 1.2]),
         "pod-b": _renamed(ref_pi_cluster([1.0, 1.0, 0.8, 0.8]), "b")},
        spec=RefFleetSpec(routing="least_loaded", max_clusters=4))
    for t in (RefTenant("detector",
                        ref_zoo.squeezenet(input_size=(96, 96), scale=0.5),
                        weight=2.0, spec=RefPlanSpec()),
              RefTenant("classifier",
                        ref_zoo.mobilenetv3(input_size=(96, 96), scale=0.5))):
        a = router.admit(t)
        admissions.append((a.tenant, a.cell, a.plan.period, a.plan_source))
    pod_a = router.cells["pod-a"].cluster
    churned = [(n, p.period, p.source) for n, p in router.churn(
        "pod-a", pod_a.restricted(pod_a.devices[:-1])).items()]
    router.add_cell("pod-c",
                    _renamed(ref_pi_cluster([1.0, 1.0, 0.8, 0.8]), "c"))
    router.observe("pod-c", 0.0)
    a = router.admit(RefTenant("classifier-2", ref_zoo.mobilenetv3(
        input_size=(96, 96), scale=0.5)))
    admissions.append((a.tenant, a.cell, a.plan.period, a.plan_source))
    reg = router.registry
    registry = (reg.hits, reg.misses, len(reg))
    router.observe("pod-a", 0.95)
    router.observe("pod-b", 0.05)

    def provision(rt, decision):
        shape = rt.cells[decision.cell].cluster
        return f"pod-{len(rt.cells)}", _renamed(shape, f"x{len(rt.cells)}")

    scaler = RefAutoscaler(router, provision=provision,
                           decommission=lambda rt, d: True)
    return {"admissions": admissions, "churn": churned,
            "registry": registry,
            "autoscale": [(d.cell, d.load, d.action, d.applied, d.detail)
                          for d in scaler.evaluate()]}


def test_fleet_routing_equals_the_reference(capsys):
    got = example("fleet_routing_torch").main([])
    out = capsys.readouterr().out
    assert got == _ref_fleet_routing()
    assert [a[3] for a in got["admissions"]] == ["scratch", "scratch",
                                                 "registry"]
    assert all(c[2] == "incremental" for c in got["churn"])
    assert "registry: 1 hits / 3 misses" in out


# -- nasnet_dnc ---------------------------------------------------------------

# the smallest sizes at which D&C still cuts the graph into more than one
# chunk of 24 vertices: 33 vertices (the published 6 cells of width 6,
# 190 vertices, take minutes in each package)
DNC_CELLS, DNC_WIDTH = 3, 3


def test_nasnet_dnc_equals_the_reference(capsys):
    got = example("nasnet_dnc_torch").main([], n_cells=DNC_CELLS,
                                           width=DNC_WIDTH)
    out = capsys.readouterr().out
    model = ref_zoo.nasnet_cells(n_cells=DNC_CELLS, input_size=(128, 128),
                                 scale=0.25, width=DNC_WIDTH,
                                 name="nasnetl-p")
    assert got["n"] == len(model.graph.layers) > 24
    part = ref_partition_graph_dnc(model.graph, model.input_size,
                                   n_split=4, chunk=24)
    pico = ref_plan(model.graph, ref_pi_cluster([1.5, 1.2, 1.0, 0.8]),
                    model.input_size, pieces=part.pieces)
    assert got["pieces"] == [p.nodes for p in part.pieces]
    assert got["objective"] == part.objective
    assert got["stages"] == _stages(pico)
    assert got["period"] == pico.period
    assert "divide & conquer" in out and "frames/min" in out


def test_nasnet_dnc_keeps_the_published_sizes_as_defaults():
    import inspect
    sig = inspect.signature(example("nasnet_dnc_torch").main)
    assert (sig.parameters["n_cells"].default,
            sig.parameters["width"].default) == (6, 6)


# -- the device rule ----------------------------------------------------------

@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]],
                         ids=["default", "cuda"])
@pytest.mark.parametrize("name", DEVICE_EXAMPLES)
def test_example_refuses_a_missing_card(name, argv, capsys, monkeypatch):
    """No card: the default device (cuda) stops the example before it
    plans or draws anything, with the message, and never on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is no refusal here")
    import repro_torch
    import repro_torch.api.deployment as deployment

    def ran(*args, **kwargs):
        raise AssertionError("the example ran without a card")

    monkeypatch.setattr(deployment, "compile", ran)
    monkeypatch.setattr(repro_torch, "compile", ran, raising=False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        example(name).main(argv)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", ("fleet_routing_torch", "nasnet_dnc_torch"))
def test_planning_examples_take_no_device(name):
    with pytest.raises(SystemExit):
        example(name).main(["--device", "cpu"])
