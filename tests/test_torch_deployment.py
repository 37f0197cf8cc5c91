"""The port's Deployment facade against the JAX package's: ``simulate``,
``replan``, ``save``/``load`` across the two packages, ``to_json`` and
``save_trace``.

The planner and the simulator are framework-free copies, so their
results must be *equal*.  Outputs are compared within the port bit for
bit, and across packages with ``test_torch_pipeline.py``'s CROSS
(rtol 1e-4 / atol 1e-5: XLA and PyTorch sum in different orders).
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import repro
import repro.api.deployment as ref_deployment_mod
import repro.core.planner as ref_planner_mod
import repro.exec.calibrate as ref_calibrate_mod
import repro_torch
import repro_torch.api.deployment as deployment_mod
import repro_torch.core.planner as planner_mod
import repro_torch.exec.autotune as autotune_mod
import repro_torch.exec.calibrate as calibrate_mod
from repro.api import ExecSpec as RefExecSpec
from repro.api import artifacts as ref_artifacts
from repro.core import make_pi_cluster as ref_pi_cluster
from repro.exec.autotune import clear_installed as ref_clear_installed
from repro.models.cnn import zoo as ref_zoo
from repro_torch.api import artifacts
from repro_torch.api.specs import ExecSpec
from repro_torch.core import make_pi_cluster
from repro_torch.exec.autotune import clear_installed
from repro_torch.models.cnn import params_from_numpy, zoo
from repro_torch.obs.trace import validate_chrome_trace

from _torch_cases import ZOO_TINY, image, np_params

CROSS = dict(rtol=1e-4, atol=1e-5)
FREQS = [1.5, 1.2, 1.0, 0.8]
# clusters of a replan chain: shrink, shrink again, grow
HOPS = ([1.5, 1.0, 0.8], [1.2, 1.0], [1.5, 1.2, 1.0, 0.8, 0.6])
WIRE = {"torch": "xla", "cuda": "pallas"}
# the models whose runs cross packages: tiny VGG16 with its head, and two
# tiny-zoo DAGs (residual adds, fire-module concats)
RUN_MODELS = {"vgg16_head": ("vgg16", dict(input_size=(40, 40), scale=0.1,
                                           head=True)),
              "resnet34": ("resnet34", ZOO_TINY["resnet34"]),
              "squeezenet": ("squeezenet", ZOO_TINY["squeezenet"])}


@pytest.fixture(autouse=True)
def _isolate_installed():
    """Tuned plans are process-wide in both packages: each test starts
    and ends with none installed."""
    clear_installed()
    ref_clear_installed()
    yield
    clear_installed()
    ref_clear_installed()


def _np(d):
    return {k: v.numpy() for k, v in d.items()}


def _close(a, b, tol):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), **tol)


@functools.cache
def _pair(name):
    """(reference, port) deployments of the tiny-zoo ``name`` on the
    4-Pi cluster, default specs."""
    ref_m = ref_zoo.build(name, **ZOO_TINY[name])
    m = zoo.build(name, **ZOO_TINY[name])
    return (repro.compile(ref_m, ref_pi_cluster(FREQS)),
            repro_torch.compile(m, make_pi_cluster(FREQS), device="cpu"))


def _boom(*a, **k):
    raise AssertionError("planner, calibrator or tuner ran on load")


def _forbid_port_planning(monkeypatch):
    for mod, name in [(planner_mod, "plan_with_spec"), (planner_mod, "plan"),
                      (deployment_mod, "plan_with_spec"),
                      (calibrate_mod, "calibrate_plan"),
                      (autotune_mod, "autotune_conv"),
                      (autotune_mod, "autotune_model")]:
        monkeypatch.setattr(mod, name, _boom)


def _forbid_ref_planning(monkeypatch):
    for mod, name in [(ref_planner_mod, "plan_with_spec"),
                      (ref_planner_mod, "plan"),
                      (ref_deployment_mod, "plan_with_spec"),
                      (ref_calibrate_mod, "calibrate_plan")]:
        monkeypatch.setattr(mod, name, _boom)


@pytest.mark.parametrize("name", sorted(ZOO_TINY))
def test_simulate_equals_the_reference(name):
    ref_dep, dep = _pair(name)
    for frames in (1, 32):
        assert dataclasses.asdict(dep.simulate(frames)) \
            == dataclasses.asdict(ref_dep.simulate(frames))
    assert dep.simulate(32).avg_utilization \
        == ref_dep.simulate(32).avg_utilization


@pytest.mark.parametrize("name", sorted(ZOO_TINY))
def test_replan_gives_the_reference_stages(name):
    """A chain of three replans: the same stages (nodes, devices,
    fractions), period and latency as the reference at every hop, each
    hop incremental after the first; device and weights carry over."""
    ref_dep, dep = _pair(name)
    params = dep.load_params().params
    for hop, freqs in enumerate(HOPS):
        ref_dep = ref_dep.replan(ref_pi_cluster(freqs))
        dep = dep.replan(make_pi_cluster(freqs))
        a, b = ref_dep.pipeline.stages, dep.pipeline.stages
        assert [s.nodes for s in b] == [s.nodes for s in a]
        assert [[d.name for d in s.devices] for s in b] \
            == [[d.name for d in s.devices] for s in a]
        assert [list(s.fractions) for s in b] \
            == [list(s.fractions) for s in a]
        assert (dep.period, dep.latency) == (ref_dep.period, ref_dep.latency)
        assert [p.nodes for p in dep.partition.pieces] \
            == [p.nodes for p in ref_dep.partition.pieces]
        assert dep.pico.source == ref_dep.pico.source
        if hop > 0:
            assert dep.pico.source == "incremental"
        assert dep.device.type == "cpu" and dep.params is params


def _zero_wall_times(dep):
    dep.pico.partition.wall_time_s = 0.0
    dep.pico.pipeline.wall_time_s = 0.0


@pytest.mark.parametrize("backend", [None, "torch", "cuda"])
@pytest.mark.parametrize("name", ["vgg16", "resnet34", "squeezenet"])
def test_to_json_is_the_references_string(name, backend):
    """For the same model, cluster and specs both packages write the same
    document (the planner's wall times, which no two runs share, set to
    0 in both), the backend in the JAX package's words."""
    ref_dep, dep = _pair(name)
    ref_dep = dataclasses.replace(
        ref_dep, exec_spec=RefExecSpec(backend=WIRE.get(backend)))
    dep = dataclasses.replace(dep, exec_spec=ExecSpec(backend=backend))
    _zero_wall_times(ref_dep)
    _zero_wall_times(dep)
    assert dep.to_json() == ref_dep.to_json()
    assert dep.to_json(indent=1) == ref_dep.to_json(indent=1)


@pytest.mark.parametrize("model", sorted(RUN_MODELS))
def test_reference_artifact_loads_in_the_port(tmp_path, monkeypatch, model):
    """``repro`` saves, ``repro_torch`` loads with no planner, calibrator
    or tuner: the same plan document, and ``run`` within CROSS of the
    reference's on the same weights."""
    name, kw = RUN_MODELS[model]
    ref_m = ref_zoo.build(name, **kw)
    p_np = np_params(ref_m)
    ref_dep = repro.compile(ref_m, ref_pi_cluster(FREQS))
    path = ref_dep.save(tmp_path / "ref.json")
    _forbid_port_planning(monkeypatch)
    dep = repro_torch.Deployment.load(
        path, params=params_from_numpy(p_np, "cpu"), device="cpu")
    assert artifacts.plan_to_dict(dep.pico) \
        == ref_artifacts.plan_to_dict(ref_dep.pico)
    assert dep.simulate(32).period == ref_dep.simulate(32).period
    assert dep.device.type == "cpu" and dep.model.backend is None
    x = image(dep.model)
    _close(_np(dep.run(x)), ref_dep.run(x, params=p_np), CROSS)
    frames = [image(dep.model, seed=s) for s in (2, 3)]
    for got, want in zip(dep.run(frames), ref_dep.run(frames, params=p_np)):
        _close(_np(got), want, CROSS)


@pytest.mark.parametrize("wire", ["xla", "pallas"])
def test_reference_backend_labels_read_as_the_ports(tmp_path, monkeypatch,
                                                    wire):
    """A reference artifact naming its backend (spec and model) loads as
    the port's name and runs on it within CROSS."""
    ref_m = ref_zoo.vgg16(input_size=(40, 40), scale=0.1, head=True)
    ref_m.backend = wire
    p_np = np_params(ref_m)
    ref_dep = repro.compile(ref_m, ref_pi_cluster(FREQS),
                            exec_spec=RefExecSpec(backend=wire))
    path = ref_dep.save(tmp_path / "ref.json")
    _forbid_port_planning(monkeypatch)
    dep = repro_torch.Deployment.load(
        path, params=params_from_numpy(p_np, "cpu"), device="cpu")
    port_name = {v: k for k, v in WIRE.items()}[wire]
    assert dep.exec_spec.backend == port_name == dep.model.backend
    x = image(dep.model)
    _close(_np(dep.run(x)), ref_dep.run(x, params=p_np), CROSS)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_port_artifact_loads_in_the_reference(tmp_path, monkeypatch,
                                              backend):
    """``repro_torch`` saves under either backend label, ``repro`` loads
    with no planner or calibrator and runs within CROSS on the same
    weights: the document names the backend in the JAX package's
    words."""
    m = zoo.vgg16(input_size=(40, 40), scale=0.1, head=True)
    m.backend = backend
    p_np = np_params(m)
    dep = repro_torch.compile(m, make_pi_cluster(FREQS),
                              exec_spec=ExecSpec(backend=backend),
                              params=params_from_numpy(p_np, "cpu"),
                              device="cpu")
    path = dep.save(tmp_path / "port.json")
    payload = json.loads(open(path).read())["payload"]
    assert payload["exec_spec"]["backend"] == WIRE[backend]
    assert payload["model"]["backend"] == WIRE[backend]
    _forbid_ref_planning(monkeypatch)
    ref_dep = repro.Deployment.load(path)
    assert ref_dep.exec_spec.backend == WIRE[backend] \
        == ref_dep.model.backend
    assert ref_artifacts.plan_to_dict(ref_dep.pico) \
        == artifacts.plan_to_dict(dep.pico)
    assert ref_dep.simulate(32) is not None
    x = image(m)
    _close(_np(dep.run(x)), ref_dep.run(x, params=p_np), CROSS)


def test_save_load_within_the_port_is_bit_equal(tmp_path, monkeypatch):
    """A tuned and calibrated deployment saved and loaded: the same plan,
    cost table (ratios and tuned plans), simulation and document, and the
    same bits out of ``run``."""
    m = zoo.build("squeezenet", **ZOO_TINY["squeezenet"])
    params = params_from_numpy(np_params(m), "cpu")
    dep = repro_torch.compile(
        m, make_pi_cluster(FREQS),
        exec_spec=ExecSpec(calibrate=True, calibrate_iters=1, autotune=True,
                           autotune_iters=1),
        params=params, device="cpu")
    x = torch.tensor(image(m))
    want = dep.run(x)
    path = dep.save(tmp_path / "dep.json")
    clear_installed()
    _forbid_port_planning(monkeypatch)
    dep2 = repro_torch.Deployment.load(path, params=params, device="cpu")
    assert dep2.simulate(32) == dep.simulate(32)
    assert artifacts.plan_to_dict(dep2.pico) == artifacts.plan_to_dict(dep.pico)
    assert dep2.cost_table.ratios == dep.cost_table.ratios
    assert dep2.cost_table.default == dep.cost_table.default
    assert dep2.cost_table.kernels == dep.cost_table.kernels
    assert (dep2.exec_spec, dep2.plan_spec) == (dep.exec_spec, dep.plan_spec)
    assert dep2.to_json() == dep.to_json()
    got = dep2.run(x)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k])


def test_load_reattaches_a_model_and_draws_default_weights(tmp_path):
    """``load(model=...)`` keeps the caller's model object; without
    ``params`` the loaded deployment draws ``model.init``'s seed-0
    weights, the compiled one's default."""
    m = zoo.vgg16(input_size=(40, 40), scale=0.1, head=True)
    dep = repro_torch.compile(m, make_pi_cluster(FREQS), device="cpu")
    dep2 = repro_torch.Deployment.load(dep.save(tmp_path / "d.json"),
                                       model=m, device="cpu")
    assert dep2.model is m and dep2.params is None
    x = image(m)
    want, got = dep.run(x), dep2.run(x)
    for k in want:
        assert torch.equal(got[k], want[k])


def test_load_params_with_a_generator_drops_the_runner():
    m = zoo.vgg16(input_size=(40, 40), scale=0.1, head=True)
    dep = repro_torch.compile(m, make_pi_cluster(FREQS), device="cpu")
    dep.load_params()
    runner = dep.runner
    dep.load_params()                   # idempotent: same weights, runner
    assert dep.runner is runner
    dep.load_params(torch.Generator().manual_seed(3))
    assert dep._runner is None and dep.runner is not runner


def test_save_trace_holds_the_lifecycle_spans(tmp_path):
    """The Chrome trace of a tuned, calibrated compile holds its plan
    spans (initial and re-plan), one autotune span per conv shape and
    one calibrate span per stage, and reloads as a valid trace."""
    m = zoo.vgg16(input_size=(40, 40), scale=0.1, head=True)
    dep = repro_torch.compile(
        m, make_pi_cluster(FREQS),
        exec_spec=ExecSpec(calibrate=True, calibrate_iters=1, autotune=True,
                           autotune_iters=1), device="cpu")
    path = dep.save_trace(tmp_path / "trace.json")
    doc = json.loads(open(path).read())
    assert validate_chrome_trace(doc) == []
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] != "M"]
    assert names.count("plan") == 2
    assert names.count("calibrate") == len(dep.pipeline.stages)
    assert names.count("autotune") == len(dep.cost_table.kernels)
    assert names.index("autotune") < names.index("plan") \
        < names.index("calibrate")
