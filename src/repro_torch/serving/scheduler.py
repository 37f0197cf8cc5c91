"""Multi-tenant asynchronous serving scheduler.

Co-hosts several CNN tenants on one heterogeneous cluster: the device
fleet is split across tenants by :func:`core.planner.partition_cluster`
(weighted by tenant priority x observed load), each tenant's sub-cluster
runs its own PICO-planned pipeline through the deterministic
event-driven runtime, and one shared virtual timeline interleaves all
of them plus the control plane:

* **admission control** — per-tenant bounded in-system occupancy
  (:class:`~repro_torch.serving.queueing.TenantQueue`); overflow requests are
  rejected at arrival;
* **deadlines / SLO** — requests carry ``arrival + slo_s`` deadlines;
  queued requests that expire are dropped at batch-formation time,
  served-but-late requests count as deadline misses;
* **continuous batching** — each tenant's stage 0 coalesces queued
  requests into ``run_frames`` micro-batches on the compiled ``exec``
  path (``RuntimeConfig.max_batch``);
* **re-partitioning** — periodic control ticks track per-tenant load
  (EWMA of offered FLOP/s); when the load split diverges from the
  device split, or on device churn / tenant join/leave, every pipeline
  drains its in-flight batches (nothing is dropped), devices are
  re-split, each sub-cluster is re-planned (``replan`` reuses the piece
  chain; ``exec.cache`` reuses executables for unchanged stages), and
  queued frames resume after a parameter-migration delay.

Everything is virtual-time and seeded, so serving-under-load scenarios
(bursty arrivals, churn mid-traffic) are reproducible and testable.

The port of the JAX package's ``serving/scheduler.py``: the same code
drives virtual time, so a timing-only serve gives the JAX package's
report field for field (``wall_s`` fields are the host's clock).  With
weights loaded (:meth:`ServingScheduler.load`), every tenant's runtime
computes its stages on the scheduler's device (``"cuda"`` unless the
caller passes ``"cpu"``).  Weights are the port's seeded init, one
``torch.Generator`` per tenant seeded by :func:`tenant_seed`, at
``load()`` and at a tenant's join alike.  The scheduler takes
``exec_spec=`` only, not the deprecated ``backend=`` keyword.
"""

from __future__ import annotations

import time as _time
import zlib
from dataclasses import dataclass, field, replace
from typing import Mapping, Sequence

import torch

from ..api.specs import ExecSpec, PlanSpec
from ..core.cost import Cluster, CostTable
from ..core.pipeline_dp import PlannerCache
from ..core.planner import (PicoPlan, partition_cluster, plan_with_spec,
                            split_devices)
from ..data.pipeline import Request
from ..exec.cache import CacheStats, cache_stats
from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry, NULL_REGISTRY
from ..obs.trace import NULL_TRACER, Tracer
from ..runtime import (DeviceJoin, DeviceLeave, PipelineRuntime,
                       RuntimeConfig)
from ..runtime.events import EventKind, EventQueue
from ..runtime.executor import Frame
from .queueing import TenantQueue, WeightedArbiter
from .server import ServeStats


def tenant_seed(name: str, seed: int = 0) -> int:
    """The seed of tenant ``name``'s weights: ``crc32(name) + seed``
    modulo 2**31, so a tenant's weights depend on its name and the
    scheduler's load seed alone, not on who else is served."""
    return (zlib.crc32(name.encode()) + seed) % (2 ** 31)


@dataclass
class TenantConfig:
    """One co-hosted model and its serving policy."""

    name: str
    model: object                   # CNNDef (duck-typed: .graph/.input_size)
    weight: float = 1.0             # relative device entitlement
    slo_s: float = float("inf")     # per-request deadline after arrival
    max_queue: int = 256            # admission bound on in-system requests
    max_batch: int = 4              # stage-0 micro-batch cap
    t_lim: float = float("inf")     # planner latency limit (legacy surface)
    plan_spec: PlanSpec | None = None   # full planner spec; wins over t_lim

    def planner_spec(self) -> PlanSpec:
        return self.plan_spec or PlanSpec(t_lim=self.t_lim)


@dataclass
class SchedulerConfig:
    seed: int = 0
    control_interval_s: float = 0.25    # load-tracking tick
    rebalance_threshold: float = 0.2    # max |desired - actual| device share
    rebalance_cooldown_s: float = 1.0   # min spacing of load re-partitions
    load_beta: float = 0.5              # EWMA on per-tenant offered load
    min_load_frac: float = 0.05         # idle tenants keep this load share
    migration_bandwidth: float | None = None   # None = cluster bandwidth
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)


@dataclass
class TenantJoin:
    """Tenant joins the fleet mid-traffic (devices are re-split)."""

    time: float
    config: TenantConfig
    params: object = None


@dataclass
class TenantLeave:
    time: float
    name: str


@dataclass
class RepartitionRecord:
    time: float
    reason: str
    wall_s: float
    migration_bytes: float
    migration_s: float
    assignment: dict[str, tuple[str, ...]]
    periods: dict[str, float]
    # honest per-tenant plan provenance for this repartition:
    # scratch | incremental | registry (see core.planner.PLAN_SOURCES)
    plan_sources: dict[str, str] = field(default_factory=dict)


@dataclass
class ServeReport:
    tenants: dict[str, ServeStats]
    outputs: dict[str, dict]        # tenant -> request id -> sink tensors
    completions: list[tuple[str, int, float, float]]  # (tenant, rid, arr, done)
    repartitions: list[RepartitionRecord]
    makespan: float
    wall_s: float
    dropped_inflight: int           # admitted frames lost mid-flight (== 0)
    device_busy_s: dict[str, float]
    device_frames: dict[str, int]
    cache: CacheStats               # compile hits/misses during this serve
    metrics: object = None          # shared MetricsRegistry (if enabled)
    trace: list = field(default_factory=list)   # obs.Span records (if traced)

    @property
    def served(self) -> int:
        return sum(s.served for s in self.tenants.values())

    def metrics_snapshot(self, meta: Mapping | None = None) -> dict:
        """Versioned metrics-snapshot document for this serve.

        Merges the scheduler's shared runtime registry (if metrics were
        enabled), per-tenant :meth:`ServeStats.publish` series, report
        scalars, and the process-default registry (executable-cache and
        conv-fallback counters) into one
        :meth:`~repro_torch.obs.metrics.MetricsRegistry.snapshot` envelope.
        """
        from ..obs.metrics import default_registry
        reg = MetricsRegistry()
        if isinstance(self.metrics, MetricsRegistry):
            reg.merge(self.metrics)
        for name, st in self.tenants.items():
            st.publish(reg, tenant=name)
        reg.gauge("serve.makespan_s").set(self.makespan)
        reg.gauge("serve.dropped_inflight").set(self.dropped_inflight)
        reg.gauge("serve.repartitions").set(len(self.repartitions))
        reg.merge(default_registry())
        return reg.snapshot(meta=meta)

    @property
    def throughput_per_min(self) -> float:
        if self.makespan <= 0.0:
            return 0.0
        return 60.0 * self.served / self.makespan

    def windowed_throughput(self, t0: float, t1: float) -> float:
        """Completed requests/s (all tenants) in [t0, t1); the window
        closes at t1 when t1 reaches the makespan."""
        hi_closed = t1 >= self.makespan
        n = sum(1 for _, _, _, d in self.completions
                if t0 <= d and (d < t1 or (hi_closed and d <= t1)))
        return n / (t1 - t0) if t1 > t0 else 0.0

    def utilization(self, device: str) -> float:
        if self.makespan <= 0.0:
            return 0.0
        return self.device_busy_s.get(device, 0.0) / self.makespan


@dataclass
class _TenantState:
    cfg: TenantConfig
    params: object = None
    queue: TenantQueue = None
    share: object = None            # core.planner.TenantShare
    rt: PipelineRuntime | None = None
    stats: ServeStats = field(default_factory=ServeStats)
    outputs: dict = field(default_factory=dict)
    request_of: dict = field(default_factory=dict)   # fid -> Request
    backlog: list = field(default_factory=list)      # frames awaiting a rt
    load_ewma: float | None = None
    arrivals_since_tick: int = 0
    work_per_frame: float = 0.0     # exact FLOPs of one frame
    next_fid: int = 0
    leaving: bool = False

    def __post_init__(self):
        if self.queue is None:
            self.queue = TenantQueue(max_queue=self.cfg.max_queue)
        g = self.cfg.model.graph
        nodes = frozenset(g.layers)
        full = g.forward_sizes(self.cfg.model.input_size)
        out, _ = g.required_sizes(nodes, {}, full, self.cfg.model.input_size)
        self.work_per_frame = g.segment_flops(nodes, out)


class ServingScheduler:
    """Serve several tenants' request streams on one cluster."""

    def __init__(self, tenants: Sequence[TenantConfig], cluster: Cluster,
                 config: SchedulerConfig | None = None,
                 cost_table: CostTable | None = None,
                 exec_spec: ExecSpec | None = None,
                 registry=None, device: str | torch.device = "cuda"):
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        if not tenants:
            raise ValueError("need at least one tenant")
        self.cluster = cluster
        self.config = config or SchedulerConfig()
        self.exec_spec = exec_spec or ExecSpec()
        self.device = torch.device(device)
        self.cost_table = cost_table
        # optional fleet PlanRegistry: repartitions consult it before
        # planning, and publish fresh plans back for the rest of the
        # fleet.  Per-tenant PlannerCaches keep even registry misses on
        # the incremental hot path.
        self.registry = registry
        self._planner_caches: dict[str, PlannerCache] = {}
        rc = self.config.runtime
        # one shared span sink + registry across every tenant runtime,
        # so the whole serve renders on a single Perfetto timeline
        self.tracer = Tracer() if rc.trace else NULL_TRACER
        self.metrics = MetricsRegistry() if rc.metrics else NULL_REGISTRY
        self._devices = list(cluster.devices)
        self._tenants: dict[str, _TenantState] = {
            t.name: _TenantState(t) for t in tenants}
        self._retired: dict[str, _TenantState] = {}
        self.partition = partition_cluster(
            [t.model for t in tenants], cluster,
            weights=[t.weight for t in tenants],
            plan_specs=[t.planner_spec() for t in tenants],
            cost_table=cost_table,
            plan_fn=self._make_plan_fn([t.name for t in tenants]))
        for share, ts in zip(self.partition.shares, self._tenants.values()):
            ts.share = share
        self._loaded = False
        self._load_seed = 0
        self._served = False

    @property
    def backend(self) -> str | None:
        return self.exec_spec.backend

    def _cache_for(self, name: str) -> PlannerCache:
        return self._planner_caches.setdefault(name, PlannerCache())

    def _make_plan_fn(self, names: Sequence[str]):
        """The :func:`~repro_torch.core.planner.partition_cluster` hook:
        registry-first (an identical sub-cluster anywhere in the fleet
        already has this plan), else the incremental planner with the
        tenant's persistent :class:`PlannerCache` and prior piece
        chain.  Fresh plans are published back to the registry."""
        def plan_fn(i, model, sub, spec, prev_i):
            if self.registry is not None:
                hit = self.registry.get(model, sub, spec, self.cost_table)
                if hit is not None:
                    return hit
            pico = plan_with_spec(
                model.graph, sub, model.input_size, spec,
                partition=prev_i.partition if prev_i is not None else None,
                cost_table=self.cost_table,
                planner_cache=self._cache_for(names[i]))
            if self.registry is not None:
                self.registry.put(model, sub, spec, pico, self.cost_table)
            return pico
        return plan_fn

    # ------------------------------------------------------------------

    def load(self, seed: int = 0) -> "ServingScheduler":
        """Initialize every tenant's parameters on the scheduler's device
        (real-numerics mode), each from its :func:`tenant_seed`; skip to
        serve in timing-only mode."""
        self._load_seed = seed
        for ts in self._tenants.values():
            ts.params = self._init_params(ts.cfg)
        self._loaded = True
        return self

    def _init_params(self, cfg: TenantConfig):
        g = torch.Generator().manual_seed(tenant_seed(cfg.name,
                                                      self._load_seed))
        return cfg.model.init(g, device=self.device)

    # ------------------------------------------------------------------
    # runtime (re)construction
    # ------------------------------------------------------------------

    def _runtime_config(self, ts: _TenantState, generation: int
                        ) -> RuntimeConfig:
        return replace(self.config.runtime,
                       seed=(self.config.seed * 1_000_003
                             + zlib.crc32(ts.cfg.name.encode()) % 65_537
                             + generation),
                       max_batch=ts.cfg.max_batch,
                       replan_on_churn=False, replan_on_drift=False)

    def _build_runtime(self, ts: _TenantState, generation: int,
                       paused: bool) -> None:
        kw = dict(cluster=ts.share.cluster, pico=ts.share.pico,
                  plan_spec=ts.cfg.planner_spec(), exec_spec=self.exec_spec,
                  cost_table=self.cost_table,
                  config=self._runtime_config(ts, generation),
                  tracer=self.tracer, metrics=self.metrics,
                  trace_labels={"tenant": ts.cfg.name})
        if ts.params is not None:
            rt = PipelineRuntime(model=ts.cfg.model, params=ts.params,
                                 device=self.device, **kw)
        else:
            rt = PipelineRuntime(g=ts.cfg.model.graph,
                                 input_size=ts.cfg.model.input_size, **kw)
        rt.begin_stream()
        rt.on_complete = self._on_complete_hook(ts)
        rt.on_drop = self._on_drop_hook(ts)
        if paused:
            rt.pause()
        ts.rt = rt
        ts.stats.period_model_s = ts.share.pico.period

    def _on_complete_hook(self, ts: _TenantState):
        def hook(frame: Frame, t: float, out) -> None:
            req = ts.request_of[frame.fid]
            missed = (frame.deadline is not None
                      and t > frame.deadline + 1e-12)
            ts.stats.record(t - frame.arrival, missed_deadline=missed)
            ts.queue.complete()
            if out is not None:
                ts.outputs[req.rid] = out
            self._completions.append((ts.cfg.name, req.rid, frame.arrival, t))
        return hook

    def _on_drop_hook(self, ts: _TenantState):
        def hook(frame: Frame, t: float) -> None:
            ts.queue.expire()
        return hook

    # ------------------------------------------------------------------
    # serve loop
    # ------------------------------------------------------------------

    def serve(self, workload: Mapping[str, Sequence[Request]],
              churn: Sequence = ()) -> ServeReport:
        """Run the full multi-tenant stream to completion.

        ``workload`` maps tenant name -> requests (any order; arrivals
        define the open-loop schedule).  ``churn`` mixes runtime device
        events (:class:`DeviceJoin`/:class:`DeviceLeave`) with
        :class:`TenantJoin`/:class:`TenantLeave`.
        """
        if self._served:
            raise RuntimeError("ServingScheduler.serve is single-use — "
                               "build a fresh scheduler")
        self._served = True
        wall0 = _time.perf_counter()
        cache_mark = cache_stats().snapshot()
        self._completions: list[tuple[str, int, float, float]] = []
        self.repartitions: list[RepartitionRecord] = []
        self._drain_pending: str | None = None
        self._generation = 0
        self._last_rebalance_t = -float("inf")
        self._busy: dict[str, float] = {}
        self._devframes: dict[str, int] = {}
        self._now = 0.0

        control = self._control = EventQueue()
        for name, reqs in workload.items():
            if name not in self._tenants:
                raise KeyError(f"workload for unknown tenant {name!r}")
            for r in reqs:
                control.push(r.arrival, EventKind.REQUEST_ARRIVAL,
                             tenant=name, request=r)
        for ce in churn:
            if isinstance(ce, TenantJoin):
                control.push(ce.time, EventKind.TENANT_JOIN, join=ce)
            elif isinstance(ce, TenantLeave):
                control.push(ce.time, EventKind.TENANT_LEAVE, leave=ce)
            else:
                control.push(ce.time, EventKind.CHURN, churn=ce)
        control.push(self.config.control_interval_s, EventKind.CONTROL_TICK)

        # scope the shared tracer over the whole serve so library-level
        # spans (plan passes, executable-cache lookups/compiles) from
        # every tenant land on this serve's timeline
        with obs_trace.scoped(self.tracer):
            for ts in self._tenants.values():
                self._build_runtime(ts, self._generation, paused=False)

            while True:
                pick = self._next_source()
                if pick is None:
                    if self._drain_pending and self._all_idle():
                        self._finish_repartition(self._now)
                        continue
                    break
                t, _, ts = pick
                self._now = t
                if ts is None:
                    self._handle_control(self._control.pop())
                else:
                    ts.rt.step()
                if self._drain_pending and self._all_idle():
                    self._finish_repartition(self._now)

        return self._report(wall0, cache_mark)

    def _active(self):
        return [ts for ts in self._tenants.values() if not ts.leaving]

    def _next_source(self):
        best = None
        ev = self._control.peek()
        if ev is not None:
            best = (ev.time, -1, None)
        for i, ts in enumerate(self._tenants.values()):
            if ts.rt is None:
                continue
            pt = ts.rt.peek_time()
            if pt is not None and (best is None or (pt, i) < best[:2]):
                best = (pt, i, ts)
        return best

    def _all_idle(self) -> bool:
        return all(ts.rt is None or ts.rt.idle
                   for ts in self._tenants.values())

    # ------------------------------------------------------------------
    # control-plane handlers
    # ------------------------------------------------------------------

    def _handle_control(self, ev) -> None:
        t, k = ev.time, ev.kind
        if k is EventKind.REQUEST_ARRIVAL:
            self._on_request(t, ev.payload["tenant"], ev.payload["request"])
        elif k is EventKind.CONTROL_TICK:
            self._on_tick(t)
        elif k is EventKind.CHURN:
            self._on_device_churn(t, ev.payload["churn"])
        elif k is EventKind.TENANT_JOIN:
            self._on_tenant_join(t, ev.payload["join"])
        elif k is EventKind.TENANT_LEAVE:
            self._on_tenant_leave(t, ev.payload["leave"])
        elif k is EventKind.REPARTITION_DONE:
            # a newer repartition supersedes this event's migration
            # window — resuming early would bypass its migration delay
            if ev.payload.get("generation") == self._generation:
                for ts in self._active():
                    if ts.rt is not None:
                        ts.rt.resume(t)

    def _on_request(self, t: float, name: str, req: Request) -> None:
        ts = self._tenants.get(name) or self._retired.get(name)
        if ts is None or ts.leaving:
            if ts is not None:           # tenant gone: refuse, but account
                ts.queue.rejected += 1
            return
        ts.arrivals_since_tick += 1
        if not ts.queue.offer():
            return                       # admission control: rejected
        fid = ts.next_fid
        ts.next_fid += 1
        deadline = (t + ts.cfg.slo_s
                    if ts.cfg.slo_s != float("inf") else None)
        frame = Frame(fid, arrival=t,
                      image=req.payload if ts.params is not None else None,
                      deadline=deadline)
        ts.request_of[fid] = req
        if ts.rt is None or self._drain_pending:
            ts.backlog.append(frame)
        else:
            ts.rt.admit(frame, t=t)

    def _on_tick(self, t: float) -> None:
        beta = self.config.load_beta
        dt = self.config.control_interval_s
        for ts in self._active():
            inst = ts.arrivals_since_tick / dt * ts.work_per_frame
            ts.arrivals_since_tick = 0
            ts.load_ewma = (inst if ts.load_ewma is None
                            else beta * inst + (1.0 - beta) * ts.load_ewma)
        if (self._drain_pending is None and len(self._active()) > 1
                and t - self._last_rebalance_t
                >= self.config.rebalance_cooldown_s
                and self._load_shift_detected()):
            self._request_repartition(t, "load")
        # keep ticking while there is anything left to schedule
        if self._control.peek() is not None or self._drain_pending \
                or any(ts.queue.in_system > 0 for ts in
                       self._tenants.values()):
            self._control.push(t + dt, EventKind.CONTROL_TICK)

    def _desired_shares(self) -> dict[str, float]:
        active = self._active()
        known = [ts.load_ewma for ts in active if ts.load_ewma is not None]
        peak_known = max(known, default=0.0)
        # a tenant with no EWMA yet (it just joined) gets the peak
        # observed load — i.e. its full weight entitlement — until its
        # own measurements arrive; raw work_per_frame would mix FLOPs
        # into a FLOP/s comparison and collapse it to the floor
        loads = {ts.cfg.name: (ts.load_ewma if ts.load_ewma is not None
                               else peak_known) for ts in active}
        peak = max(loads.values())
        if peak <= 0.0:                 # fleet fully idle: back to weights
            total = sum(ts.cfg.weight for ts in active)
            return {ts.cfg.name: ts.cfg.weight / total for ts in active}
        # normalize by the peak before flooring: the EWMA decays toward
        # denormals on long-idle tenants and 0.05 * denormal underflows
        raw = {ts.cfg.name: ts.cfg.weight
               * max(loads[ts.cfg.name] / peak, self.config.min_load_frac)
               for ts in active}
        total = sum(raw.values())
        return {n: v / total for n, v in raw.items()}

    def _load_shift_detected(self) -> bool:
        desired = self._desired_shares()
        total_cap = sum(d.capacity for d in self._devices)
        shifted = False
        for ts in self._active():
            have = ts.share.capacity / total_cap if ts.share else 0.0
            if abs(desired[ts.cfg.name] - have) \
                    > self.config.rebalance_threshold:
                shifted = True
                break
        if not shifted:
            return False
        # device granularity may make the desired split unreachable —
        # only drain the fleet if the re-split actually changes hands
        active = self._active()
        buckets = split_devices(
            Cluster(self._devices, bandwidth=self.cluster.bandwidth),
            [desired[ts.cfg.name] for ts in active])
        for bucket, ts in zip(buckets, active):
            names = frozenset(d.name for d in bucket)
            if ts.share is None or names != ts.share.device_names:
                return True
        return False

    def _on_device_churn(self, t: float, ce) -> None:
        if isinstance(ce, DeviceLeave):
            survivors = [d for d in self._devices if d.name != ce.device_name]
            if len(survivors) < len(self._active()):
                raise RuntimeError(
                    f"device {ce.device_name} leaving strands "
                    f"{len(self._active())} tenants on {len(survivors)} "
                    f"devices")
            self._devices = survivors
            self._request_repartition(t, "leave")
        elif isinstance(ce, DeviceJoin):
            self._devices.append(ce.device)
            self._request_repartition(t, "join")
        else:
            raise TypeError(f"unsupported churn event for the scheduler: "
                            f"{type(ce).__name__}")

    def _on_tenant_join(self, t: float, ev: TenantJoin) -> None:
        cfg = ev.config
        if cfg.name in self._tenants:
            raise ValueError(f"tenant {cfg.name!r} already active")
        if cfg.name in self._retired:
            raise ValueError(f"tenant {cfg.name!r} already served and left "
                             f"during this serve — rejoin under a fresh "
                             f"name so its stats are not shadowed")
        if len(self._devices) < len(self._active()) + 1:
            raise RuntimeError(f"no device available for joining tenant "
                               f"{cfg.name!r}")
        ts = _TenantState(cfg, params=ev.params)
        if ts.params is None and self._loaded:
            ts.params = self._init_params(cfg)
        self._tenants[cfg.name] = ts
        self._request_repartition(t, "tenant-join")

    def _on_tenant_leave(self, t: float, ev: TenantLeave) -> None:
        ts = self._tenants.get(ev.name)
        if ts is None:
            return
        ts.leaving = True
        self._request_repartition(t, "tenant-leave")

    # ------------------------------------------------------------------
    # re-partitioning
    # ------------------------------------------------------------------

    def _request_repartition(self, t: float, reason: str) -> None:
        if self._drain_pending is not None:
            return                       # already draining; one pass covers it
        self._drain_pending = reason
        self._drain_started_t = t
        for ts in self._tenants.values():
            if ts.rt is not None:
                ts.rt.pause()
        if self._all_idle():
            self._finish_repartition(t)

    def _absorb(self, rt: PipelineRuntime) -> None:
        for a in rt.pool.actors.values():
            self._busy[a.name] = self._busy.get(a.name, 0.0) + a.busy_s
            self._devframes[a.name] = (self._devframes.get(a.name, 0)
                                       + a.frames_done)

    def _finish_repartition(self, t: float) -> None:
        reason, self._drain_pending = self._drain_pending, None
        wall0 = _time.perf_counter()
        harvested: dict[str, list[Frame]] = {}
        old_hosts: dict[str, dict[int, frozenset[str]]] = {}
        for name, ts in self._tenants.items():
            frames: list[Frame] = []
            if ts.rt is not None:
                self._absorb(ts.rt)
                frames = ts.rt.harvest()
                ts.rt = None
            if ts.share is not None:
                hosts: dict[int, frozenset[str]] = {}
                for st in ts.share.pico.pipeline.stages:
                    names = frozenset(d.name for d in st.devices)
                    for p in range(st.first_piece, st.last_piece + 1):
                        hosts[p] = names
                old_hosts[name] = hosts
            frames += ts.backlog
            ts.backlog = []
            harvested[name] = frames

        # retire leaving tenants; their queued frames will never be served
        for name in [n for n, ts in self._tenants.items() if ts.leaving]:
            ts = self._tenants.pop(name)
            for _ in harvested.pop(name):
                ts.queue.expire()
            self._retired[name] = ts

        active = list(self._tenants.values())
        if not active:
            return
        shares = self._desired_shares()
        self._generation += 1
        partition = partition_cluster(
            [ts.cfg.model for ts in active],
            Cluster(self._devices, bandwidth=self.cluster.bandwidth,
                    pair_bandwidth=dict(self.cluster.pair_bandwidth)),
            weights=[shares[ts.cfg.name] for ts in active],
            plan_specs=[ts.cfg.planner_spec() for ts in active],
            cost_table=self.cost_table,
            prev=[ts.share.pico if ts.share is not None else None
                  for ts in active],
            plan_fn=self._make_plan_fn([ts.cfg.name for ts in active]))
        # migration: only stages whose host set actually changed push
        # their parameters (same rule as the runtime's internal re-plan)
        mig_bytes = 0.0
        for share, ts in zip(partition.shares, active):
            hosts = old_hosts.get(ts.cfg.name, {})
            for st in share.pico.pipeline.stages:
                names = frozenset(d.name for d in st.devices)
                if hosts.get(st.first_piece) != names:
                    mig_bytes += st.cost.seg.param_bytes
            ts.share = share
        bw = self.config.migration_bandwidth or self.cluster.bandwidth
        mig_s = mig_bytes / bw
        resume_t = t + mig_s
        for ts in active:
            self._build_runtime(ts, self._generation, paused=True)
            for frame in harvested[ts.cfg.name]:
                ts.rt.admit(frame, t=resume_t)
        self._control.push(resume_t, EventKind.REPARTITION_DONE,
                           generation=self._generation)
        self._last_rebalance_t = t
        self.partition = partition
        if self.tracer:
            drain0 = getattr(self, "_drain_started_t", t)
            if t > drain0:
                self.tracer.emit("sched.drain", drain0, t - drain0,
                                 track="scheduler", reason=reason)
            self.tracer.emit("sched.repartition", t, mig_s,
                             track="scheduler", reason=reason,
                             generation=self._generation,
                             migration_bytes=mig_bytes,
                             tenants=[ts.cfg.name for ts in active])
        for ts in active:
            self.metrics.counter("serve.replans",
                                 source=ts.share.pico.source).inc()
        self.repartitions.append(RepartitionRecord(
            time=t, reason=reason, wall_s=_time.perf_counter() - wall0,
            migration_bytes=mig_bytes, migration_s=mig_s,
            assignment={ts.cfg.name: tuple(d.name for d in
                                           ts.share.cluster.devices)
                        for ts in active},
            periods={ts.cfg.name: ts.share.pico.period for ts in active},
            plan_sources={ts.cfg.name: ts.share.pico.source
                          for ts in active}))

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------

    def _report(self, wall0: float, cache_mark: CacheStats) -> ServeReport:
        for ts in self._tenants.values():
            if ts.rt is not None:
                self._absorb(ts.rt)
        everyone = {**self._retired, **self._tenants}
        dropped_inflight = 0
        for ts in everyone.values():
            ts.stats.rejected = ts.queue.rejected
            ts.stats.expired = ts.queue.expired
            dropped_inflight += ts.queue.in_system
        makespan = max((d for _, _, _, d in self._completions),
                       default=self._now)
        return ServeReport(
            tenants={n: ts.stats for n, ts in everyone.items()},
            outputs={n: ts.outputs for n, ts in everyone.items()},
            completions=list(self._completions),
            repartitions=list(self.repartitions),
            makespan=makespan,
            wall_s=_time.perf_counter() - wall0,
            dropped_inflight=dropped_inflight,
            device_busy_s=dict(self._busy),
            device_frames=dict(self._devframes),
            cache=cache_stats().since(cache_mark),
            metrics=self.metrics if self.metrics else None,
            trace=list(self.tracer.spans),
        )


# ---------------------------------------------------------------------------
# naive baseline: time-sliced single-tenant serving
# ---------------------------------------------------------------------------

def serve_time_sliced(tenants: Sequence[TenantConfig], cluster: Cluster,
                      workload: Mapping[str, Sequence[Request]],
                      quantum_periods: float = 50.0,
                      reload_params: bool = False,
                      cost_table: CostTable | None = None) -> ServeReport:
    """The naive baseline: one tenant at a time owns the WHOLE cluster
    for a quantum (weighted round-robin via the stride arbiter), paying
    a pipeline refill before each slice's steady state — and, with
    ``reload_params=True``, a parameter re-upload over the cluster link
    on every switch (the deployment that cannot keep all tenants
    resident).  Admission control and deadline handling match the
    scheduler, so the comparison isolates the device-partitioning
    decision: whole-cluster pipelines scale sublinearly (WLAN comm), so
    serving every tenant on all devices loses to right-sized
    sub-clusters even before the switching overhead.
    """
    from ..core.planner import plan_with_spec

    plans: dict[str, PicoPlan] = {}
    for tc in tenants:
        plans[tc.name] = plan_with_spec(tc.model.graph, cluster,
                                        tc.model.input_size,
                                        tc.planner_spec(),
                                        cost_table=cost_table)
    arb = WeightedArbiter({tc.name: tc.weight for tc in tenants})
    queues = {tc.name: TenantQueue(max_queue=tc.max_queue)
              for tc in tenants}
    stats = {tc.name: ServeStats(period_model_s=plans[tc.name].period)
             for tc in tenants}
    slos = {tc.name: tc.slo_s for tc in tenants}
    pending = {tc.name: sorted(workload.get(tc.name, ()),
                               key=lambda r: r.arrival)
               for tc in tenants}
    idx = {tc.name: 0 for tc in tenants}
    completions: list[tuple[str, int, float, float]] = []

    @dataclass
    class _Job:
        rid: int
        arrival: float
        deadline: float | None

    def admit_up_to(t: float) -> None:
        for name, reqs in pending.items():
            i = idx[name]
            while i < len(reqs) and reqs[i].arrival <= t:
                r = reqs[i]
                dl = r.arrival + slos[name] \
                    if slos[name] != float("inf") else None
                queues[name].offer(_Job(r.rid, r.arrival, dl))
                i += 1
            idx[name] = i

    def next_arrival() -> float | None:
        times = [pending[n][i].arrival for n, i in idx.items()
                 if i < len(pending[n])]
        return min(times) if times else None

    t = 0.0
    wall0 = _time.perf_counter()
    while True:
        admit_up_to(t)
        eligible = {n for n, q in queues.items() if len(q)}
        if not eligible:
            na = next_arrival()
            if na is None:
                break
            t = na
            continue
        name = arb.pick(eligible)
        pl = plans[name]
        # switch cost: optionally push this tenant's parameters to the
        # cluster, then refill the pipeline (latency - period) before
        # the first steady-state completion
        switch_s = (sum(st.cost.seg.param_bytes
                        for st in pl.pipeline.stages) / cluster.bandwidth
                    if reload_params else 0.0)
        fill_s = max(0.0, pl.latency - pl.period)
        # the slice must fit at least one completion or no tenant with a
        # long pipeline would ever make progress
        t_slice_end = t + switch_s + max(quantum_periods * pl.period,
                                         fill_s + pl.period)
        cur = t + switch_s + fill_s
        while True:
            done_at = cur + pl.period
            if done_at > t_slice_end:
                break
            admit_up_to(cur)
            batch, _ = queues[name].pop_batch(cur, 1)
            if not batch:
                break
            job = batch[0]
            missed = job.deadline is not None and done_at > job.deadline
            stats[name].record(done_at - job.arrival, missed_deadline=missed)
            queues[name].complete()
            completions.append((name, job.rid, job.arrival, done_at))
            cur = done_at
        t = t_slice_end
    for name, q in queues.items():
        stats[name].rejected = q.rejected
        stats[name].expired = q.expired
    makespan = max((d for _, _, _, d in completions), default=t)
    return ServeReport(
        tenants=stats, outputs={n: {} for n in stats},
        completions=completions, repartitions=[], makespan=makespan,
        wall_s=_time.perf_counter() - wall0,
        dropped_inflight=sum(q.in_system for q in queues.values()),
        device_busy_s={}, device_frames={}, cache=CacheStats())
