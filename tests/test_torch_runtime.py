"""The port's event-driven runtime (``runtime/``) against the JAX
package's.

Everything that drives virtual time is a framework-free copy, so a
timing-only run must give the reference's report *equal*, field for
field: completions, makespan, period, device reports and re-plan
records.  The one exception is ``ReplanRecord.wall_s``, the host's
clock around a re-plan, held to its sign only.

Real compute runs the stages through the port's compiled stages (on
the CPU here: the conv kernel's plain version).  Its outputs are held
to the reference runtime's on the same weights and frames within
``REAL`` (rtol 1e-5 / atol 1e-5, the reference's own runtime tolerance,
``tests/test_runtime.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import Device as RefDevice
from repro.core import make_pi_cluster as ref_pi_cluster
from repro.core import plan as ref_plan
from repro.models.cnn import zoo as ref_zoo
from repro.obs.metrics import flatten as ref_flatten
from repro.runtime import DeviceJoin as RefDeviceJoin
from repro.runtime import DeviceLeave as RefDeviceLeave
from repro.runtime import Frame as RefFrame
from repro.runtime import FreqScale as RefFreqScale
from repro.runtime import LinkDegrade as RefLinkDegrade
from repro.runtime import PipelineRuntime as RefPipelineRuntime
from repro.runtime import RuntimeConfig as RefRuntimeConfig
from repro.runtime import validate as ref_validate
from repro_torch.api.specs import DeploySpec
from repro_torch.core import Device, make_pi_cluster, plan
from repro_torch.exec import graph
from repro_torch.models.cnn import params_from_numpy, zoo
from repro_torch.obs.metrics import NULL_REGISTRY, flatten
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime import (DeviceJoin, DeviceLeave, FreqScale, Frame,
                                 LinkDegrade, PipelineRuntime,
                                 RuntimeConfig, validate)

from _torch_cases import ZOO_TINY, image, np_params

REAL = dict(rtol=1e-5, atol=1e-5)
FREQS4 = [1.5, 1.2, 1.0, 0.8]


def _models(name):
    kw = ZOO_TINY[name]
    return ref_zoo.build(name, **kw), zoo.build(name, **kw)


def _report_sig(rep) -> dict:
    """A runtime report as a dict, the host clocks (``wall_s``) and the
    outputs and spans left out (compared on their own)."""
    d = dataclasses.asdict(rep)
    for k in ("outputs", "trace"):
        d.pop(k)
    for r in d["replans"]:
        assert r.pop("wall_s") >= 0.0
    return d


def _run_pair(name, freqs, *, churn=lambda pkg, pico: [], frames=120,
              config=None):
    """The same timing-only scenario through both packages: the same
    plan (held equal), config and churn.  Returns (reference, port)
    runtimes and reports."""
    ref_m, m = _models(name)
    rc, pc = ref_pi_cluster(freqs), make_pi_cluster(freqs)
    rp = ref_plan(ref_m.graph, rc, ref_m.input_size)
    pp = plan(m.graph, pc, m.input_size)
    assert (pp.period, pp.latency) == (rp.period, rp.latency)
    cfg = config or {}
    ref_rt = RefPipelineRuntime(ref_m.graph, rc, ref_m.input_size, pico=rp,
                                config=RefRuntimeConfig(**cfg),
                                churn=churn("ref", rp))
    rt = PipelineRuntime(m.graph, pc, m.input_size, pico=pp,
                         config=RuntimeConfig(**cfg), churn=churn("port", pp))
    ref_rep, rep = ref_rt.run(frames), rt.run(frames)
    assert _report_sig(rep) == _report_sig(ref_rep)
    return ref_rt, rt, ref_rep, rep


@pytest.mark.parametrize("freqs", [[1.0] * 4, FREQS4],
                         ids=["homo4", "hetero4"])
@pytest.mark.parametrize("name", ["squeezenet", "mobilenetv3", "resnet34"])
def test_runtime_matches_the_simulator_as_the_reference(name, freqs):
    ref_m, m = _models(name)
    want = ref_validate(ref_m.graph, ref_pi_cluster(freqs),
                        ref_m.input_size, frames=32, tol=0.10)
    got = validate(m.graph, make_pi_cluster(freqs), m.input_size,
                   frames=32, tol=0.10)
    assert got.ok and str(got) == str(want)
    assert (got.period_rel_err, got.latency_rel_err,
            got.utilization_abs_err) == (want.period_rel_err,
                                         want.latency_rel_err,
                                         want.utilization_abs_err)
    assert got.period_rel_err < 1e-6 and got.latency_rel_err < 1e-6
    assert dataclasses.asdict(got.sim) == dataclasses.asdict(want.sim)
    assert _report_sig(got.run) == _report_sig(want.run)


def _leave(pkg, pico):
    drop = max(pico.pipeline.stages[0].devices, key=lambda d: d.capacity)
    cls = RefDeviceLeave if pkg == "ref" else DeviceLeave
    return [cls(pico.period * 20, drop.name)]


def test_device_drop_replans_as_the_reference():
    *_, rep = _run_pair("squeezenet", FREQS4, churn=_leave)
    assert rep.completed == 120
    assert [r.reason for r in rep.replans][:1] == ["leave"]
    assert rep.replans[0].n_devices == 3


def test_frequency_drift_replans_as_the_reference():
    def drift(pkg, pico):
        victim = pico.pipeline.stages[0].devices[0].name
        cls = RefFreqScale if pkg == "ref" else FreqScale
        return [cls(pico.period * 10, victim, 0.5)]

    ref_rt, rt, _, rep = _run_pair("squeezenet", FREQS4, churn=drift)
    assert any(r.reason == "drift" for r in rep.replans)
    victim = rt.pico.pipeline.stages[0].devices[0].name
    assert rt.monitor.device_ratio(victim) \
        == ref_rt.monitor.device_ratio(victim)


def test_link_degradation_as_the_reference():
    def degrade(pkg, pico):
        return [(RefLinkDegrade if pkg == "ref" else LinkDegrade)(0.0, 10.0)]

    cfg = dict(inter_stage_bandwidth=50e6 / 8)
    *_, base = _run_pair("squeezenet", [1.0] * 4, frames=48, config=cfg)
    *_, slow = _run_pair("squeezenet", [1.0] * 4, frames=48, config=cfg,
                         churn=degrade)
    assert slow.makespan > base.makespan


def test_device_join_as_the_reference():
    def join(pkg, pico):
        if pkg == "ref":
            return [RefDeviceJoin(pico.period * 20,
                                  RefDevice("pi-extra@0.6GHz", 0.6 * 2e9))]
        return [DeviceJoin(pico.period * 20,
                           Device("pi-extra@0.6GHz", 0.6 * 2e9))]

    *_, rep = _run_pair("squeezenet", FREQS4, churn=join)
    assert [r.reason for r in rep.replans] == ["join"]


@pytest.mark.parametrize("seed", [7, 8])
def test_seeded_noise_as_the_reference(seed):
    cfg = dict(seed=seed, compute_noise=0.1, link_jitter_s=1e-4,
               inter_stage_bandwidth=50e6 / 8)
    *_, rep = _run_pair("squeezenet", [1.2, 1.0, 0.8], frames=40, config=cfg)
    *_, ideal = _run_pair("squeezenet", [1.2, 1.0, 0.8], frames=40)
    assert rep.makespan > ideal.makespan


def test_memory_budget_as_the_reference():
    *_, rep = _run_pair("squeezenet", [1.0, 1.0], frames=8,
                        config=dict(mem_budget_bytes=1.0))
    assert sum(d.mem_violations for d in rep.devices) > 0


def test_deploy_spec_gives_the_reference_runtime_config():
    for kw in ({}, dict(seed=3, max_batch=4, compute_noise=0.05,
                        inter_stage_bandwidth=1e6, trace=True,
                        metrics=False, replan_on_drift=False)):
        got = DeploySpec(**kw).to_runtime_config()
        want = repro.DeploySpec(**kw).to_runtime_config()
        assert isinstance(got, RuntimeConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_deployment_runtime_timing_only_as_the_reference():
    """``Deployment.runtime(DeploySpec(seed=0)).run(8)`` on a deployment
    with no weights: timing only, the reference's report."""
    ref_m, m = _models("squeezenet")
    ref_dep = repro.compile(ref_m, ref_pi_cluster([1.5, 1.0]))
    dep = repro_torch.compile(m, make_pi_cluster([1.5, 1.0]), device="cpu")
    rt = dep.runtime(DeploySpec(seed=0))
    assert rt.model is None
    rep = rt.run(8)
    assert rep.completed == 8
    assert _report_sig(rep) \
        == _report_sig(ref_dep.runtime(repro.DeploySpec(seed=0)).run(8))


def test_runtime_spans_and_metrics_as_the_reference():
    """A traced timing-only run of tiny VGG16 on 4 Pis at 50 Mb/s: the
    same spans on the virtual timeline (one ``stage.compute`` per stage
    and frame, one ``frame`` per frame) and the same runtime metrics as
    the reference's; untraced runs hold the null singletons."""
    kw = dict(input_size=(64, 64), scale=0.125)
    ref_m, m = ref_zoo.vgg16(**kw), zoo.vgg16(**kw)
    ref_dep = repro.compile(ref_m, ref_pi_cluster(FREQS4,
                                                  bandwidth_mbps=50.0))
    dep = repro_torch.compile(m, make_pi_cluster(FREQS4, bandwidth_mbps=50.0),
                              device="cpu")
    ref_dep.runtime(repro.DeploySpec(trace=True),
                    real_compute=False).run(n_frames=8)
    dep.runtime(DeploySpec(trace=True), real_compute=False).run(n_frames=8)
    got = [s for s in dep.tracer.spans if s.name != "plan"]
    want = [s for s in ref_dep.tracer.spans if s.name != "plan"]
    assert [dataclasses.asdict(s) for s in got] \
        == [dataclasses.asdict(s) for s in want]
    n_stages = len(dep.pipeline.stages)
    compute = [s for s in got if s.name == "stage.compute"]
    assert len(compute) >= n_stages * 8
    assert sum(s.name == "frame" for s in got) == 8
    assert any(s.name == "plan" for s in dep.tracer.spans)
    flat = flatten(dep.metrics_snapshot())
    want_flat = ref_flatten(ref_dep.metrics_snapshot())
    ours = {k: v for k, v in flat.items()
            if k.startswith(("runtime.", "frame.", "monitor."))}
    assert ours == {k: v for k, v in want_flat.items()
                    if k.startswith(("runtime.", "frame.", "monitor."))}
    assert flat["runtime.frames_completed"] == 8.0
    assert flat["frame.latency_s.count"] == 8.0
    rt = dep.runtime(DeploySpec(trace=False, metrics=False),
                     real_compute=False)
    assert rt.tracer is NULL_TRACER and rt.metrics is NULL_REGISTRY


# -- real compute on the CPU ----------------------------------------------

def _real_pair(max_batch, churn):
    """Tiny squeezenet on three Pis, the same weights and 3 frames
    through both runtimes; ``churn`` drops the plan's slowest device
    while the frames are in flight."""
    ref_m, m = _models("squeezenet")
    p_np = np_params(ref_m)
    xs = [image(m, seed=s) for s in range(3)]
    freqs = [1.5, 1.0, 0.8]

    def leave(cls, cluster):
        if not churn:
            return []
        slow = min(cluster.devices, key=lambda d: d.capacity)
        return [cls(0.001, slow.name)]

    rc, pc = ref_pi_cluster(freqs), make_pi_cluster(freqs)
    ref_rep = RefPipelineRuntime(
        model=ref_m, params=p_np, cluster=rc,
        config=RefRuntimeConfig(max_batch=max_batch),
        churn=leave(RefDeviceLeave, rc)).run(inputs=xs)
    rt = PipelineRuntime(model=m, params=params_from_numpy(p_np, "cpu"),
                         cluster=pc, config=RuntimeConfig(max_batch=max_batch),
                         churn=leave(DeviceLeave, pc), device="cpu")
    return ref_rep, rt, xs


@pytest.mark.parametrize("churn", [False, True], ids=["steady", "leave"])
@pytest.mark.parametrize("max_batch", [1, 3])
def test_real_compute_matches_the_reference_runtime(max_batch, churn):
    """Outputs within REAL of the reference runtime's; with a device
    leave, every frame completes after the re-plan; the virtual
    timeline is the reference's."""
    ref_rep, rt, xs = _real_pair(max_batch, churn)
    rep = rt.run(inputs=xs)
    assert rep.completed == 3 and rep.dropped == 0
    assert len(rep.replans) == int(churn)
    assert _report_sig(rep) == _report_sig(ref_rep)
    if churn and max_batch == 1:
        # the leave lands inside a single-frame stage run, which restarts
        assert rep.restarts == ref_rep.restarts >= 1
    for i in range(3):
        assert rep.outputs[i].keys() == ref_rep.outputs[i].keys()
        for k, v in rep.outputs[i].items():
            assert v.device.type == "cpu"
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(ref_rep.outputs[i][k]),
                                       **REAL)


def _coalesced_span(trace, n, gap):
    """The first ``stage.compute`` span of stage 0 that holds a
    coalesced batch (2 frames or more) and starts once a third of the
    ``n`` frames have arrived."""
    return next(sp for sp in trace if sp.name == "stage.compute"
                and sp.attr("stage") == 0 and sp.attr("frames") >= 2
                and sp.ts >= (n // 3 - 1) * gap)


def test_real_compute_aborts_a_coalesced_batch():
    """Tiny squeezenet on three Pis, ``max_batch`` 3, frames at half the
    period: stage 0's device leaves in the middle of a coalesced batch,
    taken from a traced timing-only run of the same arrivals.  Every
    frame of the batch restarts once and re-runs under the new plan
    (the ``reversed``/``appendleft`` branch of the leave); restarts and
    the virtual timeline are the reference's, and the outputs within
    REAL of the reference runtime's, or of its monolithic forward where
    the reference raises (ROADMAP Queue 3)."""
    ref_m, m = _models("squeezenet")
    p_np = np_params(ref_m)
    freqs, n, max_batch = [1.5, 1.0, 0.8], 9, 3
    rc, pc = ref_pi_cluster(freqs), make_pi_cluster(freqs)
    rp = ref_plan(ref_m.graph, rc, ref_m.input_size)
    pp = plan(m.graph, pc, m.input_size)
    gap = pp.period / 2
    probe = PipelineRuntime(m.graph, pc, m.input_size, pico=pp,
                            config=RuntimeConfig(max_batch=max_batch,
                                                 trace=True)).run(
        n, interarrival=gap)
    span = _coalesced_span(probe.trace, n, gap)
    leave = dict(time=span.ts + span.dur / 2, device_name=span.track)
    want = RefPipelineRuntime(ref_m.graph, rc, ref_m.input_size, pico=rp,
                              config=RefRuntimeConfig(max_batch=max_batch),
                              churn=[RefDeviceLeave(**leave)]).run(
        n, interarrival=gap)
    xs = [image(m, seed=s) for s in range(n)]
    rt = PipelineRuntime(model=m, params=params_from_numpy(p_np, "cpu"),
                         cluster=pc, pico=pp,
                         config=RuntimeConfig(max_batch=max_batch),
                         churn=[DeviceLeave(**leave)], device="cpu")
    runs = []
    run_batch = rt._exec_batch

    def spy(t, st, batch):
        run_batch(t, st, batch)
        runs.append((t, len(rt.replans), st.index,
                     [fr.fid for fr in batch.frames]))

    rt._exec_batch = spy
    rep = rt.run(inputs=xs, interarrival=gap)
    assert rep.completed == n and rep.dropped == 0
    assert [r.reason for r in rep.replans] == ["leave"]
    assert rep.restarts == want.restarts >= span.attr("frames") >= 2
    assert _report_sig(rep) == _report_sig(want)
    aborted = [fids for t, p, si, fids in runs if (t, p, si) == (span.ts, 0, 0)]
    assert len(aborted) == 1 and len(aborted[0]) == span.attr("frames")
    again = {fid for _, p, si, fids in runs if (p, si) == (1, 0)
             for fid in fids}
    for fid in aborted[0]:
        assert fid in again and rt._all_frames[fid].restarts == 1
    try:
        ref_rep = RefPipelineRuntime(
            model=ref_m, params=p_np, cluster=rc, pico=rp,
            config=RefRuntimeConfig(max_batch=max_batch),
            churn=[RefDeviceLeave(**leave)]).run(inputs=xs,
                                                 interarrival=gap)
    except KeyError:
        ref_rep = None
    for i, x in enumerate(xs):
        ref = (ref_rep.outputs[i] if ref_rep is not None
               else ref_m.forward(p_np, x))
        assert rep.outputs[i].keys() == ref.keys()
        for k, v in rep.outputs[i].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]),
                                       **REAL)
    if ref_rep is not None:
        assert ref_rep.restarts == rep.restarts


def test_real_compute_frames_keep_their_outputs():
    """Each frame's stage outputs, saved right after its stage ran, are
    unchanged at the end of the run: later frames through the same
    stages do not overwrite them."""
    _, rt, xs = _real_pair(1, False)
    saved = {}
    run_batch = rt._exec_batch

    def spy(t, st, batch):
        run_batch(t, st, batch)
        for fr in batch.frames:
            saved.update({(fr.fid, k): v.clone()
                          for k, v in fr.produced.items()})

    rt._exec_batch = spy
    rt.run(inputs=xs)
    assert len(saved) > 3
    for fr in rt._all_frames:
        for k, v in fr.produced.items():
            assert torch.equal(v, saved[(fr.fid, k)])


def _stream(make, frame_cls, xs):
    """Stream mode as the serving scheduler drives it: numpy frames
    ``admit``-ed at half the plan's period, events popped with ``step``
    until two frames are done, then ``pause``, the batches in flight
    run out, ``harvest`` takes the rest and a second runtime of the same
    plan takes them in with ``admit`` (mid-pipeline frames too) and runs
    them to the end.  Returns both runtimes, the harvested frames and
    the ``on_complete`` records (fid, time, outputs)."""
    done = []

    def hook(fr, t, out):
        done.append((fr.fid, t, out))

    first = make()
    first.on_complete = hook
    first.begin_stream()
    gap = first.pico.period / 2
    for i, x in enumerate(xs):
        first.admit(frame_cls(i, arrival=i * gap, image=x))
    t = 0.0
    while first.completed < 2:
        t = first.step().time
    first.pause()
    while not first.idle:
        t = first.step().time
    left = first.harvest()
    second = make()
    second.on_complete = hook
    second.begin_stream()
    for fr in left:
        second.admit(fr, t=t)
    ev = second.step()
    while ev is not None:
        ev = second.step()
    return first, second, left, done


@pytest.mark.parametrize("max_batch", [1, 3])
def test_stream_mode_matches_the_reference(max_batch):
    """``begin_stream``/``admit``/``step``/``pause``/``harvest`` with
    real compute through both packages: ``admit`` moves each numpy
    frame to the runtime's device, the harvested frames and the virtual
    times of every completion are the reference's, and the outputs are
    within REAL of the reference runtime's."""
    ref_m, m = _models("squeezenet")
    p_np = np_params(ref_m)
    params = params_from_numpy(p_np, "cpu")
    xs = [image(m, seed=s) for s in range(6)]
    freqs = [1.5, 1.0, 0.8]
    rc, pc = ref_pi_cluster(freqs), make_pi_cluster(freqs)
    ref = _stream(lambda: RefPipelineRuntime(
        model=ref_m, params=p_np, cluster=rc,
        config=RefRuntimeConfig(max_batch=max_batch)), RefFrame, xs)
    got = _stream(lambda: PipelineRuntime(
        model=m, params=params, cluster=pc,
        config=RuntimeConfig(max_batch=max_batch), device="cpu"), Frame, xs)
    first, second, left, done = got
    assert [(f.fid, f.next_piece) for f in left] \
        == [(f.fid, f.next_piece) for f in ref[2]]
    assert any(f.next_piece > 0 for f in left)
    assert all(isinstance(f.image, torch.Tensor) and f.image.device.type
               == "cpu" for f in first._all_frames)
    assert [(fid, t) for fid, t, _ in done] \
        == [(fid, t) for fid, t, _ in ref[3]]
    assert sorted(fid for fid, _, _ in done) == list(range(6))
    for rt, want in zip((first, second), ref[:2]):
        assert _report_sig(rt.report()) == _report_sig(want.report())
    for (_, _, out), (_, _, want) in zip(done, ref[3]):
        assert out.keys() == want.keys()
        for k, v in out.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                       **REAL)


def test_real_compute_single_frames_equal_deployment_run():
    """``Deployment.runtime`` with real compute on the CPU: single-frame
    batches give ``Deployment.run``'s outputs bit for bit, and numpy
    frames move to the runtime's device."""
    _, m = _models("squeezenet")
    dep = repro_torch.compile(m, make_pi_cluster([1.5, 1.0, 0.8]),
                              device="cpu")
    dep.load_params(torch.Generator().manual_seed(0))
    xs = [image(m, seed=s) for s in range(3)]
    rt = dep.runtime(DeploySpec(seed=0))
    assert rt.model is m and rt.device == dep.device
    captured = graph.captures()
    rep = rt.run(inputs=xs)
    assert graph.captures() == captured         # the CPU stays eager
    for i, x in enumerate(xs):
        want = dep.run(x)
        assert rep.outputs[i].keys() == want.keys()
        assert all(torch.equal(rep.outputs[i][k], want[k]) for k in want)


def test_real_compute_resumes_where_the_reference_raises():
    """Tiny VGG16 on the 8-Pi cluster, a device leaving while frames are
    between stages: a frame resumes at a new stage that reads a node an
    old stage kept inside, and the reference runtime raises ``KeyError``
    (ROADMAP Queue 3).  The port computes the node from the tensors the
    frame kept, not from its image: every frame completes, within REAL
    of the reference's monolithic forward, the virtual timeline is the
    reference's timing-only one, and each refill is counted and traced
    with fewer layers than the stage's whole prefix."""
    kw = dict(input_size=(64, 64), scale=0.1, head=True)
    ref_m, m = ref_zoo.vgg16(**kw), zoo.vgg16(**kw)
    p_np = np_params(ref_m)
    freqs = [1.5, 1.5, 1.2, 1.2, 1.0, 1.0, 0.8, 0.8]
    rc, pc = ref_pi_cluster(freqs), make_pi_cluster(freqs)
    rp = ref_plan(ref_m.graph, rc, ref_m.input_size)
    pp = plan(m.graph, pc, m.input_size)
    xs = [image(m, seed=s) for s in range(12)]
    leave = dict(time=pp.period * 2, device_name="pi2@1.2GHz")
    gap = pp.period / 2
    with pytest.raises(KeyError):
        RefPipelineRuntime(model=ref_m, params=p_np, cluster=rc, pico=rp,
                           churn=[RefDeviceLeave(**leave)]).run(
            inputs=xs, interarrival=gap)
    want = RefPipelineRuntime(ref_m.graph, rc, ref_m.input_size, pico=rp,
                              churn=[RefDeviceLeave(**leave)]).run(
        len(xs), interarrival=gap)
    for max_batch in (1, 4):
        rt = PipelineRuntime(
            model=m, params=params_from_numpy(p_np, "cpu"), cluster=pc,
            pico=pp, config=RuntimeConfig(max_batch=max_batch, trace=True),
            churn=[DeviceLeave(**leave)], device="cpu")
        rep = rt.run(inputs=xs, interarrival=gap)
        assert rep.completed == len(xs) and len(rep.replans) == 1
        refills = [sp for sp in rep.trace if sp.name == "stage.refill"]
        assert len(refills) == rt.metrics.value("runtime.boundary_fills") >= 1
        assert sum(sp.attr("layers") for sp in refills) \
            == rt.metrics.value("runtime.boundary_fill_layers")
        for sp in refills:
            assert sp.dur == 0.0
            prefix, todo = set(), [p for _, p in
                                   rt.stages[sp.attr("stage")].executor.needs
                                   if p is not None]
            while todo:
                n = todo.pop()
                if n not in prefix:
                    prefix.add(n)
                    todo.extend(m.graph.preds[n])
            assert 0 < sp.attr("layers") < len(prefix)
        if max_batch == 1:
            assert _report_sig(rep) == _report_sig(want)
        for i, x in enumerate(xs):
            ref = ref_m.forward(p_np, x)
            for k, v in rep.outputs[i].items():
                np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]),
                                           **REAL)
