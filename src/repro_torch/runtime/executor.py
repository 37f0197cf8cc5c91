"""Event-driven heterogeneous-cluster runtime for PICO pipelines.

The closed-form simulator (``core.simulate``) answers "what *should*
this plan do"; this executor answers "what does it do when devices are
actors with their own clocks, queues and memory, transfers take time on
lossy links, and the cluster changes mid-run".  One virtual timeline
drives everything (``events.EventQueue``), so runs are deterministic
and seedable.

Execution semantics per stage ``s`` and frame ``f`` (matching the
pipeline recurrence of Eq. 12 when links are ideal and devices honest):

* ``FRAME_ARRIVAL``   — f's input is available at s;
* compute phase       — every member device runs its tile; the phase
                        lasts max_k of the devices' *true* times
                        (nominal cost / DVFS speed * noise);
* comm phase          — intra-stage scatter/gather (the plan's T_comm,
                        scaled by link degradation) plus the
                        inter-stage hand-off timed by ``LinkModel``;
* ``STAGE_DONE``      — the stage frees and f arrives at s+1.

The monitor records observed-vs-nominal time per device; churn events
(join/leave/DVFS/link) and monitor drift trigger ``core.planner.replan``
on the measured-calibrated cluster at a frame boundary: in-flight
frames drain, re-assigned stages pay a parameter-migration transfer,
then frames resume at the stage covering their next unfinished piece.

Two serving extensions (used by ``serving.scheduler``):

* **continuous micro-batching** — with ``RuntimeConfig.max_batch > 1``
  stage 0 coalesces its queued frames into one batch whenever it goes
  idle; the batch travels the pipeline as a unit, compute/comm phases
  scale with the batch size, and real numerics go through the compiled
  ``StageExecutor.run_frames`` path (the batch folded into one pass).
  Queued frames whose ``deadline`` has passed are dropped at coalesce
  time.
* **stream mode** — ``begin_stream()`` + ``admit()`` + ``step()`` let an
  external driver (the multi-tenant scheduler) feed frames dynamically,
  interleave several runtimes on one virtual timeline, ``pause()``
  launches to drain, and ``harvest()`` queued frames for re-admission
  after a cross-tenant re-partition.

The port of the JAX package's ``runtime/executor.py``: everything that
drives virtual time is the same code, so a timing-only run gives the
same report field for field (``ReplanRecord.wall_s`` is the host's
clock).  Real compute runs each stage through its compiled stage on
the runtime's device (``"cuda"`` unless the caller passes ``"cpu"``):
on a CUDA device a replay of the stage's CUDA graph, through the
hand-written conv kernel.  A frame keeps its stage outputs across later
replays of the same graph, so the runtime takes the compiled stage's
copies of them, never the graph's own.  A frame that resumes after a
re-plan at a stage needing a node it did not keep gets that node
computed from the tensors it kept (:meth:`PipelineRuntime._fill_boundary`),
where the JAX package's runtime raises; virtual time does not charge
that work.
"""

from __future__ import annotations

import time as _time
from collections import deque
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from ..api.specs import ExecSpec, PlanSpec
from ..core.cost import Cluster, CostTable
from ..core.pipeline_dp import PlannerCache, StagePlan
from ..core.planner import PicoPlan, plan_with_spec, recost
from ..core.graph import Graph
from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry, NULL_REGISTRY
from ..obs.trace import NULL_TRACER, Tracer
from .actors import ActorPool
from .churn import (ChurnEvent, DeviceJoin, DeviceLeave, FreqScale,
                    LinkDegrade)
from .events import EventKind, EventQueue, Event
from .links import LinkMap, LinkModel
from .monitor import Monitor


@dataclass
class RuntimeConfig:
    """Knobs for the virtual cluster.  The default is *ideal* — no
    jitter, no noise, free inter-stage hand-off — and reproduces
    ``core.simulate`` exactly; turn knobs up for realism."""

    seed: int = 0
    compute_noise: float = 0.0          # max +/- fraction on true times
    inter_stage_bandwidth: float | None = None  # None = free hand-off
    link_latency_s: float = 0.0
    link_jitter_s: float = 0.0
    mem_budget_bytes: float = float("inf")
    replan_on_churn: bool = True
    replan_on_drift: bool = True
    drift_threshold: float = 0.25
    drift_cooldown: int = 24        # monitor samples between drift re-plans
    ewma_beta: float = 0.3
    migration_bandwidth: float | None = None    # None = cluster bandwidth
    max_batch: int = 1              # stage-0 coalescing cap (1 = no batching)
    trace: bool = False             # record structured spans (repro_torch.obs)
    metrics: bool = True            # publish runtime metrics (repro_torch.obs)

    @classmethod
    def ideal(cls, seed: int = 0) -> "RuntimeConfig":
        return cls(seed=seed)


@dataclass
class Frame:
    fid: int
    arrival: float
    next_piece: int = 0
    done: float | None = None
    restarts: int = 0
    image: object = None                # real-compute input tensor
    produced: dict = field(default_factory=dict)
    deadline: float | None = None       # drop if still queued past this
    dropped: bool = False               # deadline expired before launch


def coalesce(queue: deque, now: float, max_batch: int):
    """Pop up to ``max_batch`` items off ``queue`` (FIFO), expiring any
    whose ``deadline`` attribute is set and already past ``now``.

    Returns ``(batch, expired)``.  Expired items do not count against
    ``max_batch``; arrival order is preserved in both lists.  This is
    the batch-formation primitive for stage-0 continuous batching;
    ``serving.queueing`` re-exports it for the policy-level API.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    batch, expired = [], []
    while queue and len(batch) < max_batch:
        item = queue.popleft()
        deadline = getattr(item, "deadline", None)
        if deadline is not None and now > deadline:
            expired.append(item)
        else:
            batch.append(item)
    return batch, expired


@dataclass
class _Batch:
    """A cohort of frames coalesced at stage 0 that travels the pipeline
    as one scheduling unit (one ``run_frames`` dispatch per stage)."""

    frames: list

    def __len__(self) -> int:
        return len(self.frames)


@dataclass
class ReplanRecord:
    time: float
    reason: str
    wall_s: float
    old_period: float
    new_period: float
    n_devices: int
    migration_bytes: float
    migration_s: float


@dataclass
class RuntimeDeviceReport:
    device: str
    utilization: float
    busy_s: float
    frames: int
    memory_peak_bytes: float
    mem_violations: int
    energy_j: float


@dataclass
class RuntimeReport:
    frames: int
    completed: int
    period: float
    latency_first: float
    latency_mean: float
    makespan: float
    throughput_per_min: float
    devices: list[RuntimeDeviceReport]
    replans: list[ReplanRecord]
    completions: list[tuple[int, float, float]]   # (fid, arrival, done)
    restarts: int = 0
    dropped: int = 0                # deadline-expired while queued
    outputs: dict[int, dict] = field(default_factory=dict)
    trace: list = field(default_factory=list)   # obs.Span records (if traced)

    @property
    def avg_utilization(self) -> float:
        live = [d for d in self.devices if d.frames > 0]
        return sum(d.utilization for d in live) / len(live) if live else 0.0

    @property
    def total_energy_j(self) -> float:
        return sum(d.energy_j for d in self.devices)

    def windowed_throughput(self, t0: float, t1: float) -> float:
        """Completed frames/s inside virtual-time window [t0, t1).

        The window closes at t1 when t1 reaches the makespan — the last
        frame completes exactly at the makespan and must count.
        """
        hi_closed = t1 >= self.makespan
        n = sum(1 for _, _, d in self.completions
                if t0 <= d and (d < t1 or (hi_closed and d <= t1)))
        return n / (t1 - t0) if t1 > t0 else 0.0


@dataclass
class _StageState:
    plan: StagePlan
    index: int
    executor: object = None             # StageExecutor in real-compute mode
    queue: deque = field(default_factory=deque)  # stage 0: Frames; else _Batch
    active: "_Batch | None" = None
    pending: Event | None = None


class PipelineRuntime:
    def __init__(
        self,
        g: Graph | None = None,
        cluster: Cluster | None = None,
        input_size: tuple[int, int] | None = None,
        pico: PicoPlan | None = None,
        config: RuntimeConfig | None = None,
        churn: Sequence[ChurnEvent] = (),
        model=None,                     # CNNDef: real compute per stage
        params=None,
        cost_table: CostTable | None = None,  # measured costs (exec.calibrate)
        plan_spec: PlanSpec | None = None,
        exec_spec: ExecSpec | None = None,
        tracer: "Tracer | None" = None,       # shared span sink (repro_torch.obs)
        metrics: "MetricsRegistry | None" = None,
        trace_labels: dict | None = None,     # attrs on every span (tenant=..)
        device: str | torch.device = "cuda",  # real compute runs here
    ):
        if model is not None:
            g = model.graph
            input_size = model.input_size
        if g is None or cluster is None or input_size is None:
            raise ValueError("need (g, cluster, input_size) or model=")
        self.g = g
        self.input_size = input_size
        self.cluster = cluster
        self.plan_spec = plan_spec or PlanSpec()
        self.exec_spec = exec_spec or ExecSpec()
        self.model = model
        self.params = params
        self.device = torch.device(device)
        if model is not None and self.device.type == "cuda" \
                and not torch.cuda.is_available():
            raise RuntimeError(
                "PipelineRuntime: real compute on 'cuda' but no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        self.cost_table = cost_table
        self.config = config or RuntimeConfig()
        self.rng = np.random.default_rng(self.config.seed)
        # persistent incremental-planner state: churn/drift re-plans
        # reuse the segment geometry of every earlier plan of this model
        self.planner_cache = PlannerCache()
        self.pico = pico or plan_with_spec(g, cluster, input_size,
                                           self.plan_spec,
                                           cost_table=cost_table,
                                           planner_cache=self.planner_cache)
        self.tracer = tracer if tracer is not None else (
            Tracer() if self.config.trace else NULL_TRACER)
        self.metrics = metrics if metrics is not None else (
            MetricsRegistry() if self.config.metrics else NULL_REGISTRY)
        self._labels = dict(trace_labels or {})
        self.monitor = Monitor(beta=self.config.ewma_beta,
                               drift_threshold=self.config.drift_threshold,
                               metrics=self.metrics)
        self.pool = ActorPool(cluster.devices,
                              mem_budget_bytes=self.config.mem_budget_bytes)
        self.links = LinkMap(LinkModel(
            bandwidth=self.config.inter_stage_bandwidth,
            latency_s=self.config.link_latency_s,
            jitter_s=self.config.link_jitter_s))
        self.churn = sorted(churn, key=lambda c: c.time)
        self.replans: list[ReplanRecord] = []
        self._drain_started = 0.0
        # alpha ratios the current plan was built with (drift baseline)
        self._plan_ratios: dict[str, float] = {}
        self._samples_at_replan = 0
        self._build_stages()

    @property
    def t_lim(self) -> float:
        return self.plan_spec.t_lim

    @property
    def backend(self) -> str | None:
        return self.exec_spec.backend

    # ------------------------------------------------------------------
    # plan -> executable stage states
    # ------------------------------------------------------------------

    def _build_stages(self) -> None:
        self.stages = [_StageState(st, i)
                       for i, st in enumerate(self.pico.pipeline.stages)]
        if self.model is not None:
            from ..pipeline.stage import executors_from_plan
            # compiled executors: across re-plans, stages whose segment +
            # tiling survive come straight from the executable cache
            execs = executors_from_plan(self.model, self.pico.pipeline.stages,
                                        spec=self.exec_spec)
            for st, ex in zip(self.stages, execs):
                st.executor = ex

    def _stage_for_piece(self, piece: int) -> int:
        for st in self.stages:
            if st.plan.first_piece <= piece <= st.plan.last_piece:
                return st.index
        return len(self.stages) - 1

    # ------------------------------------------------------------------
    # run loop
    # ------------------------------------------------------------------

    def _begin(self) -> None:
        if getattr(self, "_ran", False):
            raise RuntimeError("PipelineRuntime is single-use: actor clocks, "
                               "monitor state and the churn schedule are "
                               "consumed — build a fresh instance")
        self._ran = True
        self.q = EventQueue()
        self._draining = False
        self._paused = False
        self._drain_reason = ""
        self._deferred_replan: str | None = None
        self._completed = 0
        self._dropped = 0
        self._n_frames = 0
        self._outputs: dict[int, dict] = {}
        self._all_frames: list[Frame] = []
        # stream-mode hooks (set by serving.scheduler): called as
        # on_complete(frame, t, output_dict) / on_drop(frame, t)
        self.on_complete = getattr(self, "on_complete", None)
        self.on_drop = getattr(self, "on_drop", None)

    def run(self, n_frames: int = 64, inputs: Sequence | None = None,
            interarrival: float = 0.0,
            arrivals: Sequence[float] | None = None) -> RuntimeReport:
        if inputs is not None:
            n_frames = len(inputs)
        if arrivals is not None:
            n_frames = len(arrivals)
            if inputs is not None and len(inputs) != n_frames:
                raise ValueError("len(arrivals) != len(inputs)")
        if self.model is not None and self.params is None:
            raise ValueError("real-compute mode needs params")
        if self.model is not None and inputs is None:
            raise ValueError("real-compute mode needs inputs=")
        self._begin()
        self._stream = False
        self._n_frames = n_frames
        frames = [Frame(i, arrival=(arrivals[i] if arrivals is not None
                                    else i * interarrival),
                        image=None if inputs is None
                        else torch.as_tensor(inputs[i], device=self.device))
                  for i in range(n_frames)]
        self._all_frames = frames
        for fr in frames:
            self.q.push(fr.arrival, EventKind.FRAME_ARRIVAL,
                        stage=0, frame=fr)
        for ce in self.churn:
            self.q.push(ce.time, EventKind.CHURN, churn=ce)
        now = 0.0
        # activate this run's tracer so library-level spans (plan
        # passes, executable-cache lookups/compiles) land on it too
        with obs_trace.scoped(self.tracer):
            while self._completed + self._dropped < n_frames:
                ev = self.step()
                if ev is None:
                    raise RuntimeError(
                        f"runtime deadlock: {self._completed}/{n_frames} "
                        f"frames done, draining={self._draining}")
                now = ev.time
        return self._report(now)

    # ------------------------------------------------------------------
    # stream mode: externally driven (serving.scheduler)
    # ------------------------------------------------------------------

    def begin_stream(self) -> "PipelineRuntime":
        """Open the runtime for external driving: frames are ``admit``-ed
        dynamically, the caller pops events via ``step()`` (interleaving
        several runtimes on one virtual timeline), and reads the report
        when it decides the stream is over."""
        if self.model is not None and self.params is None:
            raise ValueError("real-compute mode needs params")
        self._begin()
        self._stream = True
        for ce in self.churn:
            self.q.push(ce.time, EventKind.CHURN, churn=ce)
        return self

    def admit(self, frame: Frame, t: float | None = None) -> None:
        """Schedule a frame's arrival at the stage covering its next
        unfinished piece (stage 0 for fresh frames; mid-pipeline for
        frames harvested from a predecessor runtime)."""
        t = frame.arrival if t is None else t
        if frame.image is not None:
            frame.image = torch.as_tensor(frame.image, device=self.device)
        self._all_frames.append(frame)
        self._n_frames = len(self._all_frames)
        s = self._stage_for_piece(frame.next_piece) if frame.next_piece else 0
        if s == 0:
            self.q.push(t, EventKind.FRAME_ARRIVAL, stage=0, frame=frame)
        else:
            self.q.push(t, EventKind.FRAME_ARRIVAL, stage=s,
                        batch=_Batch([frame]))

    def step(self) -> Event | None:
        """Pop and dispatch the earliest event; None when the queue is
        dry.  ``run()`` is a loop over this."""
        ev = self.q.pop()
        if ev is not None:
            self._dispatch(ev)
        return ev

    def peek_time(self) -> float | None:
        ev = self.q.peek()
        return ev.time if ev is not None else None

    @property
    def idle(self) -> bool:
        """No batch is in flight on any stage (queued frames may remain)."""
        return all(st.active is None for st in self.stages)

    @property
    def completed(self) -> int:
        return self._completed

    def pause(self) -> None:
        """Stop launching new batches; in-flight batches run to
        completion.  Used to drain before a cross-tenant re-partition."""
        self._paused = True

    def resume(self, t: float) -> None:
        self._paused = False
        for s in range(len(self.stages)):
            self._try_start(t, s)

    def harvest(self) -> list[Frame]:
        """Remove and return every queued (not in-flight) frame — stage
        queues AND not-yet-dispatched arrival events — for re-admission
        into a successor runtime.  Requires ``idle``."""
        if not self.idle:
            raise RuntimeError("harvest() while batches are in flight")
        frames = self._collect_inflight()
        ev = self.q.pop()
        while ev is not None:
            if ev.kind is EventKind.FRAME_ARRIVAL:
                item = ev.payload.get("frame") or ev.payload.get("batch")
                frames.extend([item] if isinstance(item, Frame)
                              else item.frames)
            ev = self.q.pop()
        frames.sort(key=lambda f: (f.next_piece == 0, f.fid))
        return frames

    def report(self, now: float | None = None) -> RuntimeReport:
        done = [f.done for f in self._all_frames if f.done is not None]
        return self._report(now if now is not None
                            else (max(done) if done else 0.0))

    def _dispatch(self, ev: Event) -> None:
        k = ev.kind
        if k is EventKind.FRAME_ARRIVAL:
            self._on_arrival(ev.time, ev.payload["stage"],
                             ev.payload.get("frame")
                             or ev.payload.get("batch"))
        elif k is EventKind.COMPUTE_DONE:
            self._on_compute_done(ev.time, ev.payload)
        elif k is EventKind.STAGE_DONE:
            self._on_stage_done(ev.time, ev.payload)
        elif k is EventKind.CHURN:
            self._on_churn(ev.time, ev.payload["churn"])
        elif k is EventKind.MIGRATION_DONE:
            self._on_migration_done(ev.time, ev.payload)

    # ------------------------------------------------------------------
    # handlers
    # ------------------------------------------------------------------

    def _on_arrival(self, t: float, s: int, item) -> None:
        st = self.stages[s]
        st.queue.append(item)
        for d in st.plan.devices:
            if d.name in self.pool:
                self.pool[d.name].enqueue()
        if self.tracer and s == 0:
            fids = ([item.fid] if isinstance(item, Frame)
                    else [f.fid for f in item.frames])
            self.tracer.instant("sched.admit", t, track="pipeline",
                                frames=fids, **self._labels)
        self._try_start(t, s)

    def _coalesce(self, t: float, queue: deque) -> "_Batch | None":
        """Stage-0 continuous batching: pop up to ``max_batch`` queued
        frames, dropping those whose deadline already passed."""
        frames, expired = coalesce(queue, t, self.config.max_batch)
        for fr in expired:
            fr.dropped = True
            self._dropped += 1
            self.metrics.counter("runtime.frames_dropped").inc()
            if self.tracer:
                self.tracer.instant("frame.expired", t, track="pipeline",
                                    frame=fr.fid, **self._labels)
            if self.on_drop is not None:
                self.on_drop(fr, t)
        if self.tracer and len(frames) > 1:
            self.tracer.instant("sched.coalesce", t, track="pipeline",
                                frames=[f.fid for f in frames],
                                **self._labels)
        return _Batch(frames) if frames else None

    def _try_start(self, t: float, s: int) -> None:
        st = self.stages[s]
        if (st.active is not None or not st.queue or self._draining
                or self._paused):
            return
        if s == 0:
            batch = self._coalesce(t, st.queue)
            if batch is None:
                return
        else:
            batch = st.queue.popleft()
        st.active = batch
        b = len(batch)
        seg = st.plan.cost.seg
        durs, modeled = [], []
        for k, dev in enumerate(st.plan.devices):
            act = self.pool[dev.name]
            nominal = act.device.t_comp(seg.per_device_flops[k]) * b
            noise = (float(self.rng.uniform(-1.0, 1.0))
                     * self.config.compute_noise)
            true_dur = act.compute_time(nominal, noise)
            mem = seg.param_bytes + seg.feature_bytes[k]
            act.start_work(t, true_dur, mem)
            durs.append(true_dur)
            modeled.append(nominal)
            if self.tracer:
                self.tracer.emit("stage.compute", t, true_dur,
                                 track=dev.name, stage=s, frames=b,
                                 modeled_s=nominal, observed_s=true_dur,
                                 **self._labels)
        dur = max(durs)
        if st.executor is not None:
            self._exec_batch(t, st, batch)
        st.pending = self.q.push(t + dur, EventKind.COMPUTE_DONE,
                                 stage=s, batch=batch,
                                 modeled=modeled, observed=durs)

    def _exec_batch(self, t: float, st: _StageState,
                    batch: "_Batch") -> None:
        """Real numerics for one batch: single frames keep the seed's
        bit-exact ``__call__`` path; larger batches stack the boundary
        tensors and go through the compiled ``run_frames`` pass (unless
        ``ExecSpec.scan_batch`` turned that path off).  The executors
        hand out copies of a replay's outputs (``copy_out``), which the
        frames keep."""
        self._fill_boundary(t, st, batch.frames)
        if len(batch) == 1 or not self.exec_spec.scan_batch:
            for fr in batch.frames:
                outs = st.executor(self.params, fr.produced, fr.image)
                fr.produced.update(outs)
            return
        frames = batch.frames
        produced: dict[str, object] = {}
        images = None
        for (_, p) in st.executor.needs:
            if p is None:
                if images is None:
                    images = torch.stack([fr.image for fr in frames])
            elif p not in produced:
                produced[p] = torch.stack([fr.produced[p] for fr in frames])
        outs = st.executor.run_frames(self.params, produced, images)
        for i, fr in enumerate(frames):
            fr.produced.update({k: v[i] for k, v in outs.items()})

    def _fill_boundary(self, t: float, st: _StageState, frames) -> None:
        """Boundary tensors a frame lacks, computed from those it keeps.

        A frame that resumes after a re-plan enters the new stage that
        covers its next piece.  That stage may begin at an earlier piece
        and read nodes that were inside an old stage, which a frame does
        not keep (the JAX package's runtime raises ``KeyError`` there).
        The missing nodes are computed here, with the ancestors the frame
        does not hold either, from the tensors it holds: the outputs of
        the stages it went through and its image.  That is the old
        stage's own inputs onward, in one full-width pass through the
        stage's backend.  Virtual time does not charge this work, so a
        timing-only report understates such frames; each one counts in
        ``runtime.boundary_fills``, its layers in
        ``runtime.boundary_fill_layers``, and it leaves a
        ``stage.refill`` instant at the compute start."""
        g = self.model.graph
        for fr in frames:
            lack = {p for _, p in st.executor.needs
                    if p is not None and p not in fr.produced}
            if not lack:
                continue
            seg, todo = set(), list(lack)
            while todo:
                n = todo.pop()
                if n not in seg and n not in fr.produced:
                    seg.add(n)
                    todo.extend(g.preds[n])
            inputs = {}
            for n in seg:
                for p in g.preds[n] or (None,):
                    if p is None:
                        inputs[(n, None)] = fr.image
                    elif p not in seg:
                        inputs[(n, p)] = fr.produced[p]
            outs = self.model.run_segment(self.params, seg, inputs,
                                          backend=st.executor.backend)
            fr.produced.update({p: outs[p] for p in lack})
            self.metrics.counter("runtime.boundary_fills").inc()
            self.metrics.counter("runtime.boundary_fill_layers").inc(len(seg))
            if self.tracer:
                self.tracer.instant("stage.refill", t, track="pipeline",
                                    stage=st.index, frame=fr.fid,
                                    layers=len(seg), **self._labels)

    def _on_compute_done(self, t: float, payload: dict) -> None:
        s, batch = payload["stage"], payload["batch"]
        st = self.stages[s]
        for dev, m, o in zip(st.plan.devices, payload["modeled"],
                             payload["observed"]):
            self.monitor.record(s, dev.name, m, o)
        hop = self.links.hop(s)
        b = len(batch)
        intra = st.plan.cost.t_comm * hop.degradation * b
        inter = hop.transfer_time(sum(st.plan.cost.seg.out_bytes) * b,
                                  self.rng)
        if self.tracer:
            if intra > 0:
                self.tracer.emit("halo.exchange", t, intra,
                                 track=st.plan.devices[0].name, stage=s,
                                 **self._labels)
            if inter > 0:
                self.tracer.emit("stage.comm", t + intra, inter,
                                 track=f"link:{s}", stage=s,
                                 frames=b, **self._labels)
        st.pending = self.q.push(t + intra + inter, EventKind.STAGE_DONE,
                                 stage=s, batch=batch)

    def _on_stage_done(self, t: float, payload: dict) -> None:
        s, batch = payload["stage"], payload["batch"]
        st = self.stages[s]
        st.active = None
        st.pending = None
        for frame in batch.frames:
            frame.next_piece = st.plan.last_piece + 1
        if s + 1 < len(self.stages):
            self.q.push(t, EventKind.FRAME_ARRIVAL, stage=s + 1, batch=batch)
        else:
            sinks = (self.model.graph.sinks() if self.model is not None
                     else ())
            for frame in batch.frames:
                frame.done = t
                self._completed += 1
                self.metrics.counter("runtime.frames_completed").inc()
                self.metrics.histogram("frame.latency_s").observe(
                    t - frame.arrival)
                if self.tracer:
                    self.tracer.emit("frame", frame.arrival,
                                     t - frame.arrival, track="pipeline",
                                     frame=frame.fid, **self._labels)
                out = None
                if frame.produced and self.model is not None:
                    out = {k: frame.produced[k] for k in sinks}
                    self._outputs[frame.fid] = out
                if self.on_complete is not None:
                    self.on_complete(frame, t, out)
        if self._draining:
            if self._all_idle():
                self._do_replan(t)
            return
        if (self.config.replan_on_drift and self.monitor.samples
                and self._drift_detected()):
            self._request_replan(t, "drift")
            return
        self._try_start(t, s)

    def _drift_detected(self) -> bool:
        # let the EWMA converge before (re-)acting on it
        if (self.monitor.samples - self._samples_at_replan
                < self.config.drift_cooldown):
            return False
        # drift is relative to the ratios the current plan was built
        # with — a device *recovering* to 1.0 after a throttled plan is
        # drift too, so check every measured device, not just those far
        # from nominal
        for name, ew in self.monitor.ratio.items():
            if not ew.n:
                continue
            base = self._plan_ratios.get(name, 1.0)
            if abs(ew.value / base - 1.0) > self.config.drift_threshold:
                return True
        return False

    def _on_churn(self, t: float, ce: ChurnEvent) -> None:
        self.metrics.counter("runtime.churn_events",
                             kind=type(ce).__name__).inc()
        if self.tracer:
            self.tracer.instant("churn", t, track="control",
                                kind=type(ce).__name__, **self._labels)
        if isinstance(ce, LinkDegrade):
            self.links.degrade(ce.factor, ce.hop)
            return                       # plan unchanged; costs just grew
        if isinstance(ce, FreqScale):
            self.pool[ce.device_name].speed = ce.factor
            return                       # monitor will notice the drift
        if isinstance(ce, DeviceJoin):
            self.pool.add(ce.device,
                          mem_budget_bytes=self.config.mem_budget_bytes)
            if self.config.replan_on_churn:
                self._request_replan(t, "join")
            return
        if isinstance(ce, DeviceLeave):
            self.pool.remove(ce.device_name)
            self.monitor.reset_device(ce.device_name)
            # abort any in-flight work that involved the dead device
            aborted: list[int] = []
            for st in self.stages:
                if st.active is not None and any(
                        d.name == ce.device_name for d in st.plan.devices):
                    if st.pending is not None:
                        st.pending.cancelled = True
                        st.pending = None
                    for fr in st.active.frames:
                        fr.restarts += 1
                    if st.index == 0:
                        for fr in reversed(st.active.frames):
                            st.queue.appendleft(fr)
                    else:
                        st.queue.appendleft(st.active)
                    st.active = None
                    aborted.append(st.index)
            if not self.pool.live():
                raise RuntimeError("all devices left the cluster")
            if self.config.replan_on_churn:
                self._request_replan(t, "leave")
            else:
                # no re-plan: keep executing the stale plan (the dead
                # actor's slot still ticks at its modeled rate) — the
                # aborted frames must restart here or nothing ever will
                for s_idx in aborted:
                    self._try_start(t, s_idx)

    # ------------------------------------------------------------------
    # re-planning
    # ------------------------------------------------------------------

    def _all_idle(self) -> bool:
        return all(st.active is None for st in self.stages)

    def _request_replan(self, t: float, reason: str) -> None:
        if self._draining:
            # churn landed mid-drain/mid-migration: replay it afterwards
            self._deferred_replan = self._deferred_replan or reason
            return
        self._draining = True
        self._drain_reason = reason
        self._drain_started = t
        if self._all_idle():
            self._do_replan(t)

    def _do_replan(self, t: float) -> None:
        wall0 = _time.perf_counter()
        alive = self.pool.alive_devices()
        next_cluster = Cluster(alive, bandwidth=self.cluster.bandwidth,
                               pair_bandwidth=dict(self.cluster.pair_bandwidth))
        calibrated = self.monitor.calibrated_cluster(next_cluster)
        old = self.pico
        # which devices used to host each piece (for migration cost)
        old_hosts: dict[int, frozenset[str]] = {}
        for st in old.pipeline.stages:
            names = frozenset(d.name for d in st.devices)
            for p in range(st.first_piece, st.last_piece + 1):
                old_hosts[p] = names
        with obs_trace.scoped(self.tracer):
            new = plan_with_spec(self.g, calibrated, self.input_size,
                                 self.plan_spec, partition=old.partition,
                                 cost_table=self.cost_table,
                                 planner_cache=self.planner_cache)
            # keep the incumbent plan if it is still runnable and wins
            # when both are priced with measured costs (the DP must use
            # every device, so a fresh plan can lose — e.g. after a
            # weak join)
            alive_names = {d.name for d in alive}
            incumbent_ok = all(
                d.name in alive_names
                for st in old.pipeline.stages for d in st.devices)
            if incumbent_ok:
                old_rc = recost(old.pipeline, calibrated, self.g,
                                self.input_size, cost_table=self.cost_table)
                if old_rc.period <= new.period:
                    new = PicoPlan(old.partition, old_rc)
        mig_bytes = 0.0
        for st in new.pipeline.stages:
            names = frozenset(d.name for d in st.devices)
            if old_hosts.get(st.first_piece) != names:
                mig_bytes += st.cost.seg.param_bytes
        bw = self.config.migration_bandwidth or self.cluster.bandwidth
        mig_s = mig_bytes / bw + self.config.link_latency_s
        wall = _time.perf_counter() - wall0
        self.replans.append(ReplanRecord(
            t, self._drain_reason, wall, old.period, new.period,
            len(alive), mig_bytes, mig_s))
        self.metrics.counter("runtime.replans",
                             reason=self._drain_reason).inc()
        if self.tracer:
            if t > self._drain_started:
                self.tracer.emit("sched.drain", self._drain_started,
                                 t - self._drain_started, track="control",
                                 reason=self._drain_reason, **self._labels)
            self.tracer.emit("replan", t, mig_s, track="control",
                             reason=self._drain_reason, wall_s=wall,
                             old_period=old.period, new_period=new.period,
                             migration_bytes=mig_bytes, **self._labels)
        self.pico = new
        self._plan_ratios = {d.name: self.monitor.device_ratio(d.name)
                             for d in alive}
        self._samples_at_replan = self.monitor.samples
        self.q.push(t + mig_s, EventKind.MIGRATION_DONE)

    def _collect_inflight(self) -> list[Frame]:
        """Harvest queued frames from the old stage states.

        Must run at MIGRATION_DONE time (not at re-plan time): hand-off
        arrivals scheduled in the same instant as the drain's last
        STAGE_DONE land in the old queues first.
        """
        frames: list[Frame] = []
        for st in self.stages:
            for item in st.queue:
                frames.extend([item] if isinstance(item, Frame)
                              else item.frames)
            st.queue.clear()
        frames.sort(key=lambda f: (f.next_piece == 0, f.fid))
        return frames

    def _on_migration_done(self, t: float, payload: dict) -> None:
        inflight = self._collect_inflight()
        self._build_stages()
        self._draining = False
        for frame in inflight:
            s = self._stage_for_piece(frame.next_piece)
            if s == 0:
                self.q.push(t, EventKind.FRAME_ARRIVAL, stage=0, frame=frame)
            else:
                self.q.push(t, EventKind.FRAME_ARRIVAL, stage=s,
                            batch=_Batch([frame]))
        if self._deferred_replan is not None:
            reason, self._deferred_replan = self._deferred_replan, None
            self._request_replan(t, reason)

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------

    def _report(self, now: float) -> RuntimeReport:
        done = sorted((f.fid, f.arrival, f.done) for f in self._all_frames
                      if f.done is not None)
        times = [d for _, _, d in done]
        makespan = max(times) if times else now
        if len(times) >= 2:
            period = (times[-1] - times[0]) / (len(times) - 1)
        else:
            period = times[0] if times else 0.0
        lat = [d - a for _, a, d in done]
        devs = [RuntimeDeviceReport(
            a.name, a.utilization(makespan), a.busy_s, a.frames_done,
            a.mem_peak_bytes, a.mem_violations, a.energy_j(makespan))
            for a in self.pool.actors.values()]
        return RuntimeReport(
            frames=self._n_frames,
            completed=self._completed,
            period=period,
            latency_first=lat[0] if lat else 0.0,
            latency_mean=sum(lat) / len(lat) if lat else 0.0,
            makespan=makespan,
            throughput_per_min=60.0 / period if period > 0 else 0.0,
            devices=devs,
            replans=list(self.replans),
            completions=done,
            restarts=sum(f.restarts for f in self._all_frames),
            dropped=self._dropped,
            outputs=self._outputs,
            trace=list(self.tracer.spans),
        )
