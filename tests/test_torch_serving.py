"""The port's CNN serving (``serving/``: queueing, the two servers and the
multi-tenant scheduler) and ``data/`` against the JAX package's.

Queueing, the arbiter, the arrival generators and everything that drives
virtual time are framework-free copies, so their results must be
*equal*: pick sequences, arrival times, and a timing-only
``ServeReport`` field for field (the host clocks, ``wall_s``, held to
their sign only).  The benchmark ``benchmarks/fig_serving_mt.py``'s two
SMOKE scenarios run timing-only through both packages here, and the
port's meets its bars (throughput ratio against time-sliced serving at
least 1.5, churn recovery at least 0.95, no dropped in-flight frame).

Real compute runs on the CPU (the conv kernel's plain version): the
servers' and the scheduler's outputs on the reference's weights are
within ``REAL`` (rtol 1e-5 / atol 1e-5, the tolerance of
``tests/test_torch_runtime.py``) of the reference's.
"""

import dataclasses
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro import data as ref_data
from repro import serving as ref_serving
from repro.core import make_pi_cluster as ref_pi_cluster
from repro.models.cnn import zoo as ref_zoo
from repro.runtime import DeviceLeave as RefDeviceLeave
from repro.runtime.executor import coalesce as ref_coalesce
from repro_torch import data, serving
from repro_torch.api.specs import DeploySpec, PlanSpec
from repro_torch.core import make_pi_cluster
from repro_torch.data.pipeline import Request
from repro_torch.models.cnn import params_from_numpy, zoo
from repro_torch.runtime import DeviceLeave
from repro_torch.runtime.executor import coalesce

from _torch_cases import ZOO_TINY, image, np_params

REAL = dict(rtol=1e-5, atol=1e-5)
FREQS = [1.5, 1.2, 1.0]
# benchmarks/fig_serving_mt.py
PI8 = [1.5, 1.5, 1.2, 1.2, 1.0, 1.0, 0.8, 0.8]
SMOKE = dict(size=(96, 96), duration_s=1.5, churn_duration_s=3.0)

REF = SimpleNamespace(zoo=ref_zoo, cluster=ref_pi_cluster, s=ref_serving,
                      leave=RefDeviceLeave)
PORT = SimpleNamespace(zoo=zoo, cluster=make_pi_cluster, s=serving,
                       leave=DeviceLeave)


# -- queueing -----------------------------------------------------------------

@dataclasses.dataclass
class _Item:
    rid: int
    deadline: float | None


def test_coalesce_is_the_references():
    """The port's coalesce is the runtime's, and forms the reference's
    batches and expiries over a seeded queue."""
    assert serving.coalesce is coalesce
    rng = np.random.default_rng(0)
    items = [_Item(i, None if rng.random() < 0.3 else float(rng.random()))
             for i in range(40)]
    for now, cap in [(0.0, 4), (0.5, 3), (0.9, 8), (2.0, 1)]:
        got = coalesce(deque(items), now, cap)
        want = ref_coalesce(deque(items), now, cap)
        assert [[x.rid for x in part] for part in got] \
            == [[x.rid for x in part] for part in want]


def test_admission_is_the_references():
    q, rq = serving.TenantQueue(max_queue=3), ref_serving.TenantQueue(
        max_queue=3)
    events = []
    for i in range(16):
        if i % 4 == 3 and q.in_system:
            for queue in (q, rq):
                queue.complete()
            events.append("complete")
        else:
            item = _Item(i, None if i % 3 else 0.02 * i)
            got = q.offer(item)
            assert got == rq.offer(item)
            events.append(got)
        b, e = q.pop_batch(0.05 * i, 1 + i % 2)
        rb, re_ = rq.pop_batch(0.05 * i, 1 + i % 2)
        assert [x.rid for x in b] == [x.rid for x in rb]
        assert [x.rid for x in e] == [x.rid for x in re_]
    for f in ("in_system", "admitted", "rejected", "expired", "completed"):
        assert getattr(q, f) == getattr(rq, f), f
    assert len(q) == len(rq) and False in events


@pytest.mark.parametrize("kw", [dict(rate_per_s=50.0, seed=7),
                                dict(rate_per_s=20.0, seed=1,
                                     burst_factor=8.0, burst_period_s=1.0,
                                     burst_duty=0.3)],
                         ids=["poisson", "bursty"])
def test_open_loop_generator_is_the_references(kw):
    g, rg = serving.OpenLoopGenerator(**kw), ref_serving.OpenLoopGenerator(
        **kw)
    assert g.arrivals(200) == rg.arrivals(200)

    def payload(rng, i):
        return float(rng.standard_normal()) + i

    got, want = g.generate(30, payload), rg.generate(30, payload)
    assert [(r.rid, r.arrival, r.payload) for r in got] \
        == [(r.rid, r.arrival, r.payload) for r in want]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_arbiter_picks_are_the_references(seed):
    """The same picks over seeded weights, eligible sets, a join and a
    leave (the arbiter is copied, fault and all: ROADMAP Queue 3)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    weights = {f"t{i}": float(rng.uniform(0.1, 20.0)) for i in range(n)}
    arb, ref = serving.WeightedArbiter(weights), \
        ref_serving.WeightedArbiter(weights)
    picks, ref_picks = [], []
    for r in range(200):
        if r == 60:
            arb.add("late", 3.0)
            ref.add("late", 3.0)
        if r == 120:
            arb.remove("t0")
            ref.remove("t0")
        names = sorted(arb._stride)
        eligible = {x for x in names if rng.random() < 0.7} or None
        picks.append(arb.pick(eligible))
        ref_picks.append(ref.pick(eligible))
    assert picks == ref_picks
    assert arb.grants == ref.grants


def test_arbiter_keeps_the_references_starvation_fault():
    """The case the reference's ``test_arbiter_no_starvation`` fails on:
    the copy gives the same 7 grants where the bound asks at least 8."""
    w = {"t0": 14.0, "t1": 0.5, "t2": 0.5, "t3": 0.5}
    arb, ref = serving.WeightedArbiter(w), ref_serving.WeightedArbiter(w)
    for _ in range(10):
        arb.pick()
        ref.pick()
    assert arb.grants == ref.grants
    assert arb.grants["t0"] == 7 < int(10 * 14.0 / 15.5) - 1


# -- data -----------------------------------------------------------------------

def test_data_draws_are_the_references():
    ts = data.TokenStream(vocab=97, batch=3, seq=16, seed=4, device="cpu")
    rts = ref_data.TokenStream(vocab=97, batch=3, seq=16, seed=4)
    for got, want in zip(ts.batches(3), rts.batches(3)):
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    frames = data.ImageStream(20, 12, seed=5, device="cpu").frames(3, 2)
    ref_frames = ref_data.ImageStream(20, 12, seed=5).frames(3, 2)
    for got, want in zip(frames, ref_frames):
        assert tuple(got.shape) == (2, 12, 20, 3)
        assert np.array_equal(got.numpy(), np.asarray(want))
    mk = (lambda rng, i: rng.standard_normal(2).tolist())
    got = data.RequestStream(40.0, seed=6).generate(10, mk)
    want = ref_data.RequestStream(40.0, seed=6).generate(10, mk)
    assert [(r.rid, r.arrival, r.payload) for r in got] \
        == [(r.rid, r.arrival, r.payload) for r in want]
    assert data.ImageStream(4, 4).device == "cuda"


# -- servers --------------------------------------------------------------------

def _requests(m, n=5, rate=6.0):
    xs = [image(m, seed=s) for s in range(n)]
    reqs = serving.OpenLoopGenerator(rate_per_s=rate, seed=2).generate(n)
    return [Request(r.rid, r.arrival, xs[r.rid]) for r in reqs]


def _stats_sig(st) -> dict:
    d = dataclasses.asdict(st)
    assert d.pop("wall_s") >= 0.0
    return d


def _server_pair(streaming, name="squeezenet"):
    kw = ZOO_TINY[name]
    ref_m, m = ref_zoo.build(name, **kw), zoo.build(name, **kw)
    p_np = np_params(ref_m)
    rc, pc = ref_pi_cluster(FREQS), make_pi_cluster(FREQS)
    if streaming:
        ref_srv = ref_serving.StreamingPipelineServer(
            ref_m, rc, deploy_spec=repro.DeploySpec(max_batch=2))
        srv = serving.StreamingPipelineServer(
            m, pc, deploy_spec=DeploySpec(max_batch=2), device="cpu")
    else:
        ref_srv = ref_serving.PipelineServer(ref_m, rc)
        srv = serving.PipelineServer(m, pc, device="cpu")
    ref_srv.params = p_np
    srv.params = params_from_numpy(p_np, "cpu")
    return ref_srv, srv, m


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["closed_form", "streaming"])
def test_servers_match_the_references(streaming):
    """Outputs within REAL of the reference server's on its weights, in
    the callers' order; completion times (per-request latencies, the
    modeled period) equal."""
    ref_srv, srv, m = _server_pair(streaming)
    reqs = _requests(m)
    ref_reqs = [ref_data.pipeline.Request(r.rid, r.arrival, r.payload)
                for r in reqs]
    outs, stats = srv.serve(reqs)
    ref_outs, ref_stats = ref_srv.serve(ref_reqs)
    assert _stats_sig(stats) == _stats_sig(ref_stats)
    assert len(outs) == len(ref_outs) == len(reqs)
    for got, want in zip(outs, ref_outs):
        assert got.keys() == want.keys() and got
        for k, v in got.items():
            assert v.device.type == "cpu"
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), **REAL)


def test_server_load_keeps_attached_weights_and_seeds_otherwise():
    _, srv, m = _server_pair(False)
    attached = srv.params
    assert srv.load().params is attached
    srv.load(torch.Generator().manual_seed(0))
    want = m.init(torch.Generator().manual_seed(0), device="cpu")
    for n in want:
        assert torch.equal(srv.params[n]["w"], want[n]["w"])
    fresh = serving.PipelineServer(m, make_pi_cluster(FREQS), device="cpu")
    fresh.load()
    for n in want:
        assert torch.equal(fresh.params[n]["w"], want[n]["w"])


def test_servers_take_specs_only():
    """The JAX package's deprecated ``t_lim=``/``backend=`` keywords are
    not taken (ROADMAP Queue 3)."""
    m = zoo.build("squeezenet", **ZOO_TINY["squeezenet"])
    for cls in (serving.PipelineServer, serving.StreamingPipelineServer):
        with pytest.raises(TypeError):
            cls(m, make_pi_cluster(FREQS), t_lim=1.0, device="cpu")
        with pytest.raises(TypeError):
            cls(m, make_pi_cluster(FREQS), backend="torch", device="cpu")
    with pytest.raises(TypeError):
        serving.ServingScheduler(
            [serving.TenantConfig("a", m)], make_pi_cluster(FREQS),
            backend="torch")


def test_facade_servers_equal_dep_run():
    """``dep.server()`` and ``dep.server(streaming=True)``: the
    deployment's weights carry over, and the closed-form server's
    outputs equal ``dep.run``'s bit for bit; the streaming server's
    equal too (single frames through the same compiled stages)."""
    m = zoo.build("squeezenet", **ZOO_TINY["squeezenet"])
    dep = repro_torch.compile(m, make_pi_cluster(FREQS), device="cpu")
    dep.load_params()
    reqs = _requests(m, n=3)
    want = [dep.run(r.payload) for r in reqs]
    srv = dep.server()
    assert isinstance(srv, serving.PipelineServer)
    assert srv.params is dep.params and srv.device == dep.device
    stream = dep.server(streaming=True)
    assert isinstance(stream, serving.StreamingPipelineServer)
    for s in (srv, stream):
        outs, stats = s.load().serve(reqs)
        assert stats.served == 3
        for got, w in zip(outs, want):
            assert got.keys() == w.keys()
            for k in w:
                assert torch.equal(got[k], w[k])
    with pytest.raises(TypeError):
        dep.server(DeploySpec())
    with pytest.raises(TypeError):
        dep.server(churn=[DeviceLeave(0.1, "pi0")])


# -- the scheduler: fig_serving_mt's SMOKE scenarios, timing-only -----------

def _tenants(ns, size):
    z = ns.zoo
    return [
        ns.s.TenantConfig("squeezenet", z.squeezenet(input_size=size,
                                                     scale=0.5), max_batch=4),
        ns.s.TenantConfig("mobilenetv3", z.mobilenetv3(input_size=size,
                                                       scale=0.5),
                          max_batch=4),
        ns.s.TenantConfig("resnet34", z.resnet34(input_size=size,
                                                 scale=0.25), max_batch=4),
    ]


def _workload(ns, sched, duration_s, load):
    out = {}
    for i, ts in enumerate(sched._tenants.values()):
        rate = load / ts.share.pico.period
        gen = ns.s.OpenLoopGenerator(rate_per_s=rate, seed=17 + i)
        out[ts.cfg.name] = gen.generate(max(8, int(rate * duration_s)))
    return out


def _saturated(ns):
    """fig_serving_mt's first scenario: load 2.0, partitioned against
    time-sliced."""
    tenants, cluster = _tenants(ns, SMOKE["size"]), ns.cluster(PI8)
    sched = ns.s.ServingScheduler(tenants, cluster)
    workload = _workload(ns, sched, SMOKE["duration_s"], 2.0)
    rep = sched.serve(workload)
    base = ns.s.serve_time_sliced(tenants, cluster, workload)
    return rep, base, rep.throughput_per_min / base.throughput_per_min


def _churn(ns):
    """fig_serving_mt's second scenario: load 0.65, the weakest device
    leaving at half the horizon; returns the report and the recovery."""
    tenants, cluster = _tenants(ns, SMOKE["size"]), ns.cluster(PI8)
    sched = ns.s.ServingScheduler(
        tenants, cluster,
        config=ns.s.SchedulerConfig(seed=3, migration_bandwidth=1e9))
    workload = _workload(ns, sched, SMOKE["churn_duration_s"], 0.65)
    horizon = max(r.arrival for reqs in workload.values() for r in reqs)
    drop_t = 0.5 * horizon
    weakest = min(cluster.devices, key=lambda d: d.capacity)
    rep = sched.serve(workload, churn=[ns.leave(drop_t, weakest.name)])
    mig_end = max((r.time + r.migration_s for r in rep.repartitions
                   if r.reason == "leave"), default=drop_t)
    reqs = [r for rs in workload.values() for r in rs]
    pre = rep.windowed_throughput(0.0, drop_t)
    post = rep.windowed_throughput(mig_end, max(horizon, mig_end + 1e-9))
    off_pre = sum(1 for r in reqs if r.arrival < drop_t) / drop_t
    off_post = (sum(1 for r in reqs if mig_end <= r.arrival < horizon)
                / max(horizon - mig_end, 1e-9))
    return rep, (post / off_post) / (pre / off_pre)


def _serve_sig(rep) -> dict:
    """A ServeReport as a dict: host clocks (``wall_s``) held to their
    sign and left out; the metrics registry as its flattened runtime
    series."""
    assert rep.wall_s >= 0.0
    reps = []
    for r in rep.repartitions:
        d = dataclasses.asdict(r)
        assert d.pop("wall_s") >= 0.0
        reps.append(d)
    return {
        "tenants": {n: _stats_sig(st) for n, st in rep.tenants.items()},
        "outputs": {n: sorted(o) for n, o in rep.outputs.items()},
        "completions": list(rep.completions), "repartitions": reps,
        "makespan": rep.makespan, "dropped_inflight": rep.dropped_inflight,
        "device_busy_s": rep.device_busy_s,
        "device_frames": rep.device_frames,
        "cache": (rep.cache.hits, rep.cache.misses, rep.cache.evictions),
        "trace": [dataclasses.asdict(s) for s in rep.trace],
        "metrics": None if rep.metrics is None else {
            c.name: c.value for c in rep.metrics.counters()},
    }


@pytest.fixture(scope="module")
def saturated():
    return _saturated(REF), _saturated(PORT)


@pytest.fixture(scope="module")
def churned():
    return _churn(REF), _churn(PORT)


def test_saturated_scenario_is_the_references(saturated):
    (ref_rep, ref_base, ref_ratio), (rep, base, ratio) = saturated
    assert _serve_sig(rep) == _serve_sig(ref_rep)
    assert _serve_sig(base) == _serve_sig(ref_base)
    assert ratio == ref_ratio


def test_saturated_scenario_meets_the_bar(saturated):
    _, (rep, base, ratio) = saturated
    assert ratio >= 1.5, ratio
    assert rep.dropped_inflight == 0
    assert rep.served > 0 and base.served > 0


def test_churn_scenario_is_the_references(churned):
    (ref_rep, ref_recovery), (rep, recovery) = churned
    assert _serve_sig(rep) == _serve_sig(ref_rep)
    assert recovery == ref_recovery
    assert [r.reason for r in rep.repartitions].count("leave") == 1


def test_churn_scenario_meets_the_bar(churned):
    _, (rep, recovery) = churned
    assert recovery >= 0.95, recovery
    assert rep.dropped_inflight == 0


# -- the scheduler with real compute -----------------------------------------

def _tiny_tenants(ns):
    z = ns.zoo
    return [ns.s.TenantConfig("sq", z.squeezenet(**ZOO_TINY["squeezenet"]),
                              max_batch=2),
            ns.s.TenantConfig("mb", z.mobilenetv3(**ZOO_TINY["mobilenetv3"]),
                              max_batch=2)]


def _tiny_workload(ns, sched, n=4):
    out = {}
    for i, ts in enumerate(sched._tenants.values()):
        m = ts.cfg.model
        gen = ns.s.OpenLoopGenerator(rate_per_s=1.5 / ts.share.pico.period,
                                     seed=5 + i)
        out[ts.cfg.name] = [
            type(r)(r.rid, r.arrival, image(m, seed=10 * i + r.rid))
            for r in gen.generate(n)]
    return out


def test_scheduler_real_compute_matches_the_reference():
    """Two tiny tenants on four Pis, one device leaving mid-stream, on
    the reference's weights: every request served by both, outputs
    within REAL, the virtual timeline equal."""
    freqs = [1.5, 1.2, 1.0, 0.8]
    ref_sched = ref_serving.ServingScheduler(_tiny_tenants(REF),
                                             ref_pi_cluster(freqs))
    sched = serving.ServingScheduler(_tiny_tenants(PORT),
                                     make_pi_cluster(freqs), device="cpu")
    for name, ts in ref_sched._tenants.items():
        p_np = np_params(ts.cfg.model, seed=len(name))
        ts.params = p_np
        sched._tenants[name].params = params_from_numpy(p_np, "cpu")
    ref_wl = _tiny_workload(REF, ref_sched)
    wl = {n: [Request(r.rid, r.arrival, r.payload) for r in rs]
          for n, rs in ref_wl.items()}
    horizon = max(r.arrival for rs in wl.values() for r in rs)
    name = min(make_pi_cluster(freqs).devices, key=lambda d: d.capacity).name
    ref_rep = ref_sched.serve(ref_wl, churn=[RefDeviceLeave(horizon / 2,
                                                            name)])
    rep = sched.serve(wl, churn=[DeviceLeave(horizon / 2, name)])
    assert rep.dropped_inflight == ref_rep.dropped_inflight == 0
    assert rep.completions == ref_rep.completions
    assert rep.served == ref_rep.served == 8
    for tenant, outs in ref_rep.outputs.items():
        assert sorted(rep.outputs[tenant]) == sorted(outs)
        for rid, want in outs.items():
            for k, v in rep.outputs[tenant][rid].items():
                assert v.device.type == "cpu"
                np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                           **REAL)


def test_scheduler_load_seeds_each_tenant_by_name():
    """``load(seed)`` draws each tenant's weights from its own
    ``tenant_seed``: the same weights whoever else is served."""
    tenants = _tiny_tenants(PORT)
    both = serving.ServingScheduler(tenants, make_pi_cluster([1.5, 1.2]),
                                    device="cpu").load(seed=4)
    alone = serving.ServingScheduler(tenants[1:], make_pi_cluster([1.5]),
                                     device="cpu").load(seed=4)
    m = tenants[1].model
    g = torch.Generator().manual_seed(serving.tenant_seed("mb", 4))
    want = m.init(g, device="cpu")
    for params in (both._tenants["mb"].params, alone._tenants["mb"].params):
        for n in want:
            assert torch.equal(params[n]["w"], want[n]["w"])
    assert serving.tenant_seed("mb", 4) != serving.tenant_seed("sq", 4)


def test_facade_scheduler_serves_on_the_deployment_device():
    m = zoo.build("squeezenet", **ZOO_TINY["squeezenet"])
    dep = repro_torch.compile(m, make_pi_cluster([1.5, 1.2, 1.0, 0.8]),
                              PlanSpec(), device="cpu")
    sched = dep.scheduler(_tiny_tenants(PORT))
    assert isinstance(sched, serving.ServingScheduler)
    assert sched.device == dep.device and sched.exec_spec is dep.exec_spec
    sched.load()
    rep = sched.serve(_tiny_workload(PORT, sched, n=2))
    assert rep.served == 4 and rep.dropped_inflight == 0
    for outs in rep.outputs.values():
        for o in outs.values():
            assert all(v.device.type == "cpu" and torch.isfinite(v).all()
                       for v in o.values())
