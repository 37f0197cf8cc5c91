"""The port's distributed workers (``repro_torch.dist``) against the JAX
package's ``repro.dist``.

The wire codec is a copy: the same :class:`Message` gives the same bytes
in both packages, and each decodes the other's.  The launcher's routing
(which tensors each link carries) and the worker payloads are the
reference's, the payload with one more key, ``"device"``.  Workers run
on the CPU here (``device="cpu"``); :func:`repro_torch.dist.validate`
holds their outputs bit-identical to the port's in-process runner, in
thread mode over both transports with one and two frames a message, and
in one spawned process-mode run.  On the reference's weights the port's
distributed outputs are within ``REAL`` (rtol 1e-5 / atol 1e-5, the
tolerance of ``tests/test_torch_runtime.py``) of the reference's.
"""

import json
import struct

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.api.specs import DistSpec as RefDistSpec
from repro.core import make_pi_cluster as ref_pi_cluster
from repro.dist import launcher as ref_launcher_mod
from repro.dist import transport as ref_transport
from repro.models.cnn import builder as ref_builder
from repro.models.cnn import zoo as ref_zoo
from repro_torch.api import FleetSpec
from repro_torch.api.specs import DistSpec
from repro_torch.core import make_pi_cluster
from repro_torch.dist import (Message, decode, encode, make_frames,
                              validate)
from repro_torch.dist import launcher as launcher_mod
from repro_torch.dist.validate import reference_outputs
from repro_torch.fleet import FleetRouter
from repro_torch.models.cnn import builder, params_from_numpy, zoo
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.runtime.churn import DeviceLeave

from _torch_cases import ZOO_TINY, np_params

REAL = dict(rtol=1e-5, atol=1e-5)
FREQS = [1.5, 1.2, 1.0]
MODELS = ["squeezenet", "mobilenetv3", "resnet34"]


def _cluster():
    return make_pi_cluster(FREQS, bandwidth_mbps=50.0)


def _dep(name="squeezenet"):
    return repro_torch.compile(zoo.build(name, **ZOO_TINY[name]), _cluster(),
                               device="cpu")


def _ref_dep(name="squeezenet"):
    return repro.compile(ref_zoo.build(name, **ZOO_TINY[name]),
                         ref_pi_cluster(FREQS, bandwidth_mbps=50.0))


@pytest.fixture(scope="module")
def sq_dep():
    return _dep()


def _equal_outputs(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for fid, want in b.items():
        assert a[fid].keys() == want.keys()
        for sink, arr in want.items():
            assert a[fid][sink].tobytes() == arr.tobytes()


# -- the wire codec, across the packages -------------------------------

CODEC_CASES = {
    "fp32": Message("frame", [3, 4],
                    {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
                     "__image__": np.ones((1, 2, 2, 3), np.float32)},
                    {"warmup": False, "note": "x"}),
    "int64": Message("result", [7], {"ids": np.arange(-3, 5, dtype=np.int64)
                                     .reshape(2, 4)}),
    "bool": Message("frame", [0], {"mask": np.array([[True, False, True]])}),
    "zero_length": Message("result", [1],
                           {"empty": np.zeros((0, 5), np.float32),
                            "scalar": np.float32(2.5).reshape(())}),
    "no_tensors": Message("heartbeat", meta={"worker": "w0", "stage": 2}),
    "non_contiguous": Message("frame", [5], {
        "t": np.arange(24, dtype=np.float32).reshape(4, 6)[:, ::2]}),
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_bytes_equal_and_decode_across_packages(case):
    msg = CODEC_CASES[case]
    ref_msg = ref_transport.Message(msg.kind, list(msg.fids),
                                    dict(msg.tensors), dict(msg.meta))
    wire, ref_wire = encode(msg), ref_transport.encode(ref_msg)
    assert wire == ref_wire
    (n,) = struct.unpack_from("<Q", wire)
    assert n == len(wire) - 8
    for got in (decode(ref_wire[8:]), ref_transport.decode(wire[8:])):
        assert (got.kind, got.fids, got.meta) == (msg.kind, msg.fids,
                                                  msg.meta)
        assert got.tensors.keys() == msg.tensors.keys()
        for k, v in msg.tensors.items():
            assert got.tensors[k].dtype == v.dtype
            assert got.tensors[k].shape == v.shape
            assert np.array_equal(got.tensors[k], v)


def test_codec_rejects_garbage():
    with pytest.raises(ValueError):
        decode(b"\x00" * 32)


# -- routing and payloads ---------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_routing_is_the_references(name):
    """Each link carries the tensors the reference's launcher routes on
    it, for the same plan (held equal)."""
    ref, port = _ref_dep(name), _dep(name)
    assert [sorted(s.nodes) for s in port.pipeline.stages] \
        == [sorted(s.nodes) for s in ref.pipeline.stages]
    ref_l = ref.fleet(RefDistSpec())
    got = port.fleet(DistSpec())
    assert got._recv == ref_l._recv
    assert got._recv_img == ref_l._recv_img
    assert [w.devices for w in got.workers] \
        == [w.devices for w in ref_l.workers]


def _strip_wall_times(doc):
    if isinstance(doc, dict):
        return {k: _strip_wall_times(v) for k, v in doc.items()
                if k != "wall_time_s"}
    if isinstance(doc, list):
        return [_strip_wall_times(v) for v in doc]
    return doc


def _payloads(module, monkeypatch):
    made = []
    real = module.build_payload

    def recording(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(module, "build_payload", recording)
    return made


def test_payloads_are_the_references_and_a_device(monkeypatch):
    """The payloads each launcher hands its workers are equal key for
    key, the planner's host clocks and the launch's wall epoch left out,
    but for the port's ``"device"``."""
    ref_made = _payloads(ref_launcher_mod, monkeypatch)
    made = _payloads(launcher_mod, monkeypatch)
    ref, port = _ref_dep(), _dep()
    xs = make_frames(port.model, 1)
    ref.fleet(RefDistSpec()).run(xs)
    port.fleet(DistSpec()).run(xs)
    assert len(made) == len(ref_made) == len(port.pipeline.stages)
    for p, r in zip(made, ref_made):
        p, r = dict(p), dict(r)
        assert p.pop("device") == "cpu"
        assert _strip_wall_times(json.loads(p.pop("deployment"))) \
            == _strip_wall_times(json.loads(r.pop("deployment")))
        assert p.pop("epoch_wall") > 0 and r.pop("epoch_wall") > 0
        assert p == r


# -- validate: distributed == in-process, bit for bit ------------------------

@pytest.mark.parametrize("transport,micro_batch",
                         [("memory", 1), ("memory", 2), ("tcp", 1),
                          ("tcp", 2)])
@pytest.mark.parametrize("name", MODELS)
def test_validate_thread_mode_bit_identical(name, transport, micro_batch):
    dep = _dep(name)
    v = validate(dep, DistSpec(transport=transport, micro_batch=micro_batch),
                 frames=4)
    assert v.ok, v.describe()
    assert v.bit_identical and v.max_abs_diff == 0.0 and v.dropped == 0
    assert v.ratios and all(r > 0 for r in v.ratios.values())
    assert {st["device"] for st in v.report.worker_stats.values()} \
        == {"cpu"}


def test_validate_process_mode_bit_identical():
    """One spawned process per stage (three), over TCP.  Tiny VGG16,
    whose three stages each model about 0.6 ms on their Pi: squeezenet's
    middle stage models a few microseconds, and on a loaded CPU its
    observed/modeled ratio reached validate's band edge (1.2e4 of 1e4)."""
    dep = _dep("vgg16")
    assert len(dep.pipeline.stages) == 3
    v = validate(dep, DistSpec(transport="tcp", workers="process",
                               start_timeout_s=240.0), frames=3)
    assert v.ok, v.describe()
    assert v.report.workers_mode == "process"
    assert {st["device"] for st in v.report.worker_stats.values()} \
        == {"cpu"}


def test_tcp_and_memory_byte_identical(sq_dep):
    xs = make_frames(sq_dep.model, 3)
    mem = sq_dep.fleet(DistSpec(transport="memory")).run(xs)
    tcp = sq_dep.fleet(DistSpec(transport="tcp")).run(xs)
    assert not mem.dropped and not tcp.dropped
    _equal_outputs(tcp.outputs, mem.outputs)


def test_a_cuda_worker_without_a_card_raises(monkeypatch):
    """A payload that asks for ``"cuda"`` on a machine with no card:
    the worker raises, and the launcher reports it; nothing runs on the
    CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = zoo.build("squeezenet", **ZOO_TINY["squeezenet"])
    dep = repro_torch.compile(m, _cluster())
    assert dep.device.type == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dep.fleet(DistSpec(start_timeout_s=30.0)).run(make_frames(m, 1))


@pytest.mark.parametrize("micro_batch", [1, 2])
@pytest.mark.parametrize("name", MODELS)
def test_outputs_match_the_references_dist(name, micro_batch, monkeypatch):
    """Thread workers of both packages on the reference's weights (each
    package's ``CNNDef.init`` handing out the same numpy draws): the
    port's outputs within REAL of the reference's."""
    ref, port = _ref_dep(name), _dep(name)
    p_np = np_params(ref.model)
    monkeypatch.setattr(ref_builder.CNNDef, "init",
                        lambda self, key, dtype=None: p_np)
    monkeypatch.setattr(
        builder.CNNDef, "init",
        lambda self, generator=None, device="cuda", dtype=None:
        params_from_numpy(p_np, device))
    xs = make_frames(port.model, 4, seed=3)
    ref_rep = ref.fleet(RefDistSpec(micro_batch=micro_batch)).run(xs)
    rep = port.fleet(DistSpec(micro_batch=micro_batch)).run(xs)
    assert rep.completed == ref_rep.completed == 4
    for fid in range(4):
        assert rep.outputs[fid].keys() == ref_rep.outputs[fid].keys()
        for k, v in rep.outputs[fid].items():
            np.testing.assert_allclose(v, np.asarray(ref_rep.outputs[fid][k]),
                                       **REAL)


# -- accounting, drain, spans --------------------------------------------

def test_report_accounting_and_telemetry(sq_dep):
    metrics = MetricsRegistry()
    launcher = sq_dep.fleet(DistSpec(), metrics=metrics)
    rep = launcher.run(make_frames(sq_dep.model, 4))
    assert rep.submitted == 4 and rep.completed == 4 and not rep.dropped
    assert rep.n_stages == len(sq_dep.pipeline.stages)
    assert set(rep.worker_stats) == {f"w{i}" for i in range(rep.n_stages)}
    for st in rep.worker_stats.values():
        assert st["frames"] == 4 and st["compute_s"] > 0
        assert st["dead"] is None and st["device"] == "cpu"
    assert set(rep.stage_compute_s()) == set(range(rep.n_stages))
    assert 0.0 < rep.utilization() <= 1.0
    snap = metrics.snapshot()["payload"]
    assert any(c["name"] == "dist.link.bytes_sent"
               for c in snap["counters"])
    router = FleetRouter({"cell": _cluster()}, spec=FleetSpec(),
                         metrics=MetricsRegistry())
    assert router.observe_report("cell", rep) == pytest.approx(
        rep.utilization())


def test_clean_shutdown_drains_all_inflight(sq_dep):
    launcher = sq_dep.fleet(DistSpec(max_inflight=16))
    launcher.start()
    xs = make_frames(sq_dep.model, 5)
    for f in xs:
        launcher.submit(f)
    rep = launcher.shutdown()
    assert rep.submitted == rep.completed == 5 and not rep.dropped
    want = reference_outputs(sq_dep, xs)
    _equal_outputs(rep.outputs, dict(enumerate(want)))
    assert launcher.shutdown() is rep


def test_shutdown_abort_drops_with_reason(sq_dep):
    launcher = sq_dep.fleet(DistSpec(max_inflight=16))
    launcher.start()
    for f in make_frames(sq_dep.model, 3):
        launcher.submit(f)
    rep = launcher.shutdown(abort=True)
    assert rep.completed + len(rep.dropped) == rep.submitted == 3
    for _, reason in rep.dropped:
        assert "abort" in reason


def test_worker_spans_merge_into_launcher_trace(sq_dep):
    tracer = Tracer()
    launcher = sq_dep.fleet(DistSpec(), tracer=tracer)
    launcher.run(make_frames(sq_dep.model, 2))
    tracks = {s.track for s in tracer.spans}
    names = {s.name for s in tracer.spans}
    assert "dist:launcher" in tracks
    assert {f"dist:w{i}" for i in range(len(launcher.workers))} <= tracks
    assert {"dist.launch", "stage.compute", "frame"} <= names


# -- the killed-worker drill ------------------------------------------------

def test_killed_worker_churn_and_recovery(sq_dep):
    """A silently killed worker surfaces as DeviceLeave churn, its
    stranded frames drop with reasons, and a re-plan on the survivors
    recovers every frame bit for bit.  The peer timeout is several
    seconds: a shorter one flakes under CPU load."""
    cluster = _cluster()
    spec = DistSpec(heartbeat_s=0.05, peer_timeout_s=4.0)
    xs = make_frames(sq_dep.model, 6)
    ref = reference_outputs(sq_dep, xs)

    launcher = sq_dep.fleet(spec)
    launcher.start()
    victim = 1
    launcher.kill_worker(victim)
    rep = launcher.run(xs)

    assert rep.churn_events
    assert all(isinstance(e, DeviceLeave) for e in rep.churn_events)
    dead = {e.device_name for e in rep.churn_events}
    assert dead == set(launcher.workers[victim].devices)
    assert rep.completed + len(rep.dropped) == rep.submitted == 6
    assert rep.dropped
    for _, reason in rep.dropped:
        assert "dead" in reason or "heartbeat" in reason

    alive = [d for d in cluster.devices if d.name not in dead]
    dep2 = sq_dep.replan(cluster.restricted(alive))
    assert dep2.device.type == "cpu"
    missing = sorted(set(range(len(xs))) - set(rep.outputs))
    rep2 = dep2.fleet(spec).run([xs[i] for i in missing])
    assert not rep2.dropped and rep2.completed == len(missing)
    merged = dict(rep.outputs)
    for k, fid in enumerate(missing):
        merged[fid] = rep2.outputs[k]
    _equal_outputs(merged, dict(enumerate(ref)))


# -- the facade ---------------------------------------------------------------

def test_fleet_is_exported_at_the_top():
    assert repro_torch.DistLauncher is launcher_mod.DistLauncher
    assert repro_torch.dist.validate is validate
    assert repro_torch.DistSpec is DistSpec
    assert isinstance(_dep().fleet(), launcher_mod.DistLauncher)
