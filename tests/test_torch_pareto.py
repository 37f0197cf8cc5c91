"""The port's Pareto front and baselines against the JAX package's.

``core/pareto.py`` and ``core/baselines.py`` are framework-free copies,
so every front point, metric and plan must be *equal* to the
reference's (no tolerance), and ``to_json`` the same string.  Artifacts
(a front, a plan registry) written by either package load in the other.
"""

import dataclasses

import pytest

import repro
import repro_torch
from repro.api import artifacts as ref_artifacts
from repro.api.specs import OBJECTIVE_PRESETS as REF_PRESETS
from repro.api.specs import DeploySpec as RefDeploySpec
from repro.core import baselines as ref_baselines
from repro.core import make_pi_cluster as ref_pi_cluster
from repro.core import plan_front as ref_plan_front
from repro.core.partition import partition_graph as ref_partition_graph
from repro.core.pareto import ParetoFront as RefParetoFront
from repro.fleet import PlanRegistry as RefPlanRegistry
from repro.models.cnn import zoo as ref_zoo
from repro.obs.metrics import MetricsRegistry as RefMetricsRegistry
from repro_torch.api import artifacts
from repro_torch.api.specs import OBJECTIVE_PRESETS, DeploySpec, PlanSpec
from repro_torch.core import baselines, make_pi_cluster, plan_front
from repro_torch.core.pareto import ParetoFront, dominates
from repro_torch.core.partition import partition_graph
from repro_torch.fleet import PlanRegistry
from repro_torch.models.cnn import zoo
from repro_torch.obs.metrics import MetricsRegistry

from _torch_cases import ZOO_TINY

FREQS = [1.5, 1.2, 1.0, 0.8]
# the tiny-zoo models whose fronts are compared (a chain, fire-module
# concats, residual adds)
FRONT_MODELS = ["vgg16", "squeezenet", "resnet34"]


def _models(name):
    return (ref_zoo.build(name, **ZOO_TINY[name]),
            zoo.build(name, **ZOO_TINY[name]))


def _plan_sig(p) -> tuple:
    """Exact plan identity: no tolerance anywhere."""
    return (p.period, p.latency, p.pipeline.feasible, p.source, p.objective,
            tuple((sp.first_piece, sp.last_piece,
                   tuple(d.name for d in sp.devices), tuple(sp.fractions),
                   sp.cost.total, sp.cost.t_comp, sp.cost.t_comm)
                  for sp in p.pipeline.stages))


def _zero_wall_times(plan):
    """The planner's host clocks (``wall_time_s``), the one field two
    runs of the same plan do not share, set to 0."""
    plan.partition.wall_time_s = 0.0
    plan.pipeline.wall_time_s = 0.0
    return plan


def _front_json(front) -> str:
    for p in front.points:
        _zero_wall_times(p.plan)
    return front.to_json()


def _registry_json(reg) -> str:
    for e in reg._entries.values():
        e["plan"]["partition"]["wall_time_s"] = 0.0
        e["plan"]["pipeline"]["wall_time_s"] = 0.0
    return reg.to_json()


def _front_sig(front) -> list:
    return [(p.metrics.as_tuple(), p.n_devices, p.t_lim, _plan_sig(p.plan))
            for p in front.points]


@pytest.mark.parametrize("profile", sorted(OBJECTIVE_PRESETS))
@pytest.mark.parametrize("name", FRONT_MODELS)
def test_plan_front_equals_the_reference(name, profile):
    """Under each objective profile: the same points with equal metrics,
    the same selection, and the same ``to_json`` string."""
    ref_m, m = _models(name)
    ref_front = ref_plan_front(ref_m, ref_pi_cluster(FREQS),
                               repro.PlanSpec(objective=REF_PRESETS[profile]))
    front = plan_front(m, make_pi_cluster(FREQS),
                       PlanSpec(objective=OBJECTIVE_PRESETS[profile]))
    assert len(front) >= 1
    assert _front_sig(front) == _front_sig(ref_front)
    assert _front_json(front) == _front_json(ref_front)
    got, want = front.select(profile), ref_front.select(profile)
    assert front.points.index(got) == ref_front.points.index(want)
    assert front.points.index(front.throughput_optimum) \
        == ref_front.points.index(ref_front.throughput_optimum)
    for i, p in enumerate(front.points):
        for j, q in enumerate(front.points):
            assert i == j or not dominates(p.metrics, q.metrics)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_front_artifacts_load_across_packages(direction):
    ref_m, m = _models("squeezenet")
    spec = PlanSpec(objective=OBJECTIVE_PRESETS["balanced"])
    ref_front = ref_plan_front(
        ref_m, ref_pi_cluster(FREQS),
        repro.PlanSpec(objective=REF_PRESETS["balanced"]))
    front = plan_front(m, make_pi_cluster(FREQS), spec)
    if direction == "ref_to_port":
        back = ParetoFront.from_json(ref_front.to_json())
        assert back.to_json() == ref_front.to_json()
        assert _front_sig(back) == _front_sig(ref_front)
    else:
        back = RefParetoFront.from_json(front.to_json())
        assert back.to_json() == front.to_json()
        assert _front_sig(back) == _front_sig(front)
    assert back.spec.to_json() == spec.to_json()


@pytest.mark.parametrize("objective", ["battery", "latency", None])
def test_front_deployment_equals_the_reference(objective):
    """``ParetoFront.deployment`` on the CPU: the same plan and
    provenance as the reference's, ``to_json`` the same string."""
    ref_m, m = _models("squeezenet")
    ref_front = ref_plan_front(ref_m, ref_pi_cluster(FREQS))
    front = plan_front(m, make_pi_cluster(FREQS))
    ref_dep = ref_front.deployment(
        ref_m, ref_pi_cluster(FREQS),
        deploy_spec=RefDeploySpec(objective=objective))
    dep = front.deployment(m, make_pi_cluster(FREQS),
                           deploy_spec=DeploySpec(objective=objective),
                           device="cpu")
    assert dep.device.type == "cpu"
    assert dep.pico.objective == ref_dep.pico.objective \
        == (objective or "throughput")
    assert _plan_sig(dep.pico) == _plan_sig(ref_dep.pico)
    _zero_wall_times(dep.pico)
    _zero_wall_times(ref_dep.pico)
    assert dep.to_json() == ref_dep.to_json()


def test_front_deployment_runs_on_cuda_by_default():
    _, m = _models("squeezenet")
    front = plan_front(m, make_pi_cluster(FREQS))
    assert front.deployment(m, make_pi_cluster(FREQS)).device.type == "cuda"


def _scheme_sig(r) -> dict:
    """A baseline's result, its plan (PICO) included, with the host's
    wall clock left out."""
    d = dataclasses.asdict(r)
    d.pop("wall_time_s")
    if "plan" in d["extra"]:
        d["extra"]["plan"].pop("wall_time_s")
    return d


@pytest.mark.parametrize("name", ["vgg16", "squeezenet"])
def test_baselines_equal_the_reference(name):
    """Every baseline scheme gives the same periods, latencies, per-device
    loads and plans as the reference's."""
    ref_m, m = _models(name)
    rc, pc = ref_pi_cluster(FREQS), make_pi_cluster(FREQS)
    ref_pieces = ref_partition_graph(ref_m.graph, ref_m.input_size).pieces
    pieces = partition_graph(m.graph, m.input_size).pieces
    runs = [("layer_wise", (), ()), ("early_fused", (), ()),
            ("optimal_fused", (), ()), ("coedge", (), ()),
            ("pico_scheme", (ref_pieces,), (pieces,))]
    for fn, ref_extra, extra in runs:
        ref_args = (ref_m.graph, *ref_extra, rc, ref_m.input_size)
        args = (m.graph, *extra, pc, m.input_size)
        want = getattr(ref_baselines, fn)(*ref_args)
        got = getattr(baselines, fn)(*args)
        assert _scheme_sig(got) == _scheme_sig(want), fn
    small = make_pi_cluster([1.5, 1.0])
    want = ref_baselines.bfs_optimal(ref_m.graph, ref_pieces[:6],
                                     ref_pi_cluster([1.5, 1.0]),
                                     ref_m.input_size)
    got = baselines.bfs_optimal(m.graph, pieces[:6], small, m.input_size)
    assert _scheme_sig(got) == _scheme_sig(want)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_registry_artifacts_load_across_packages(direction):
    """A plan registry saved by either package loads in the other and
    serves the same plans as hits."""
    ref_m, m = _models("vgg16")
    ref_reg = RefPlanRegistry(capacity=4, metrics=RefMetricsRegistry())
    reg = PlanRegistry(capacity=4, metrics=MetricsRegistry())
    for freqs in (FREQS, [1.0, 1.0]):
        ref_reg.get_or_plan(ref_m, ref_pi_cluster(freqs))
        reg.get_or_plan(m, make_pi_cluster(freqs))
    assert _registry_json(reg) == _registry_json(ref_reg)
    if direction == "ref_to_port":
        loaded = PlanRegistry.from_json(ref_reg.to_json())
        hit = loaded.get(m, make_pi_cluster(FREQS))
        want = ref_reg.get(ref_m, ref_pi_cluster(FREQS))
    else:
        loaded = RefPlanRegistry.from_json(reg.to_json())
        hit = loaded.get(ref_m, ref_pi_cluster(FREQS))
        want = reg.get(m, make_pi_cluster(FREQS))
    assert len(loaded) == 2
    assert hit is not None and hit.source == "registry"
    assert _plan_sig(hit) == _plan_sig(want)


def test_artifact_codecs_write_the_reference_payloads():
    """The front and registry codecs give the reference's dicts."""
    ref_m, m = _models("resnet34")
    ref_front = ref_plan_front(ref_m, ref_pi_cluster(FREQS))
    front = plan_front(m, make_pi_cluster(FREQS))
    _front_json(ref_front), _front_json(front)
    assert artifacts.pareto_front_to_dict(front) \
        == ref_artifacts.pareto_front_to_dict(ref_front)
    assert artifacts.to_json("pareto_front", front) \
        == ref_artifacts.to_json("pareto_front", ref_front)
    assert isinstance(artifacts.from_json("pareto_front",
                                          front.to_json()), ParetoFront)
    reg = PlanRegistry(metrics=MetricsRegistry())
    reg.get_or_plan(m, make_pi_cluster(FREQS))
    assert isinstance(artifacts.from_json("plan_registry", reg.to_json()),
                      PlanRegistry)


def test_package_exports_the_fleet_tier():
    for name in ("FleetSpec", "plan_front", "ParetoFront", "PlanRegistry",
                 "FleetRouter", "fleet"):
        assert name in repro_torch.__all__
        getattr(repro_torch, name)
    assert repro_torch.plan_front is plan_front
    assert repro_torch.PlanRegistry is PlanRegistry
