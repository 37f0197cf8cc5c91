"""``DistLauncher`` — real pipeline execution of a shipped Deployment.

The launcher turns one :class:`~repro_torch.api.deployment.Deployment` into a
running pipeline of real workers (one per planned stage — the stage's
device tiles execute inside its compiled segment, exactly as in the
single-process path), wires them into a chain of
:mod:`~repro_torch.dist.transport` links, feeds frames in at the head and
collects sink tensors at the tail::

    launcher -> w0(stage0) -> w1(stage1) -> ... -> launcher(sink)

Workers get *no* live Python state: each receives a JSON worker payload
embedding the full versioned Deployment artifact (``dep.to_json()``)
plus its stage index and link roles, and rebuilds model/plan/params
from it (:mod:`repro_torch.dist.worker`).  ``DistSpec.workers`` picks the
substrate — persistent threads (CI mode) or real OS processes via the
multiprocessing *spawn* context, since CUDA cannot be forked — and
``DistSpec.transport`` the link kind; every combination moves the
identical encoded bytes.  Each worker computes on the deployment's
device (the payload's ``"device"``); on a CUDA device the launcher
builds the conv kernel's library once before it starts them, so N
workers do not each run ``nvcc`` inside ``start_timeout_s``.

Loss accounting mirrors the runtime's zero-dropped-in-flight
guarantee: every submitted frame ends in ``report.outputs`` or in
``report.dropped`` with a reason.  A clean :meth:`shutdown` drains by
sending ``stop`` behind the last data message (FIFO links), so nothing
is lost; a dead worker (heartbeat silence past ``peer_timeout_s``,
control-link EOF, or a worker-reported error) is surfaced as
:class:`~repro_torch.runtime.churn.DeviceLeave` churn events — the same
vocabulary the runtime's drain-and-repartition path reacts to — and
the frames it stranded are reported dropped, ready for resubmission on
a re-planned deployment (``dep.replan(cluster.restricted(alive))``).
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..api.specs import DistSpec
from ..obs import metrics as obs_metrics
from ..obs.trace import Tracer
from ..runtime.churn import DeviceLeave
from .transport import (Message, TCPListener, TCPTransport, memory_pair)
from .worker import StageWorker, build_payload, worker_main


@dataclass
class DistReport:
    """Outcome of one distributed run: every submitted frame is in
    ``outputs`` or in ``dropped`` (fid, reason) — never silently lost."""

    outputs: dict[int, dict[str, np.ndarray]]
    dropped: list[tuple[int, str]]
    submitted: int
    churn_events: list = field(default_factory=list)
    worker_stats: dict[str, dict] = field(default_factory=dict)
    link_stats: dict[str, dict] = field(default_factory=dict)
    wall_s: float = 0.0
    transport: str = "memory"
    workers_mode: str = "thread"
    n_stages: int = 0

    @property
    def completed(self) -> int:
        return len(self.outputs)

    def stage_compute_s(self) -> dict[int, float]:
        """Observed mean compute seconds per frame, by stage index."""
        out = {}
        for st in self.worker_stats.values():
            if st.get("frames"):
                out[st["stage"]] = st["compute_s"] / st["frames"]
        return out

    def utilization(self) -> float:
        """Mean worker busy fraction over the run wall-clock — the
        telemetry sample :meth:`FleetRouter.observe_report` feeds into
        the load-EWMA."""
        if not self.worker_stats or self.wall_s <= 0:
            return 0.0
        busy = sum(st.get("compute_s", 0.0)
                   for st in self.worker_stats.values())
        return min(1.0, busy / (len(self.worker_stats) * self.wall_s))


class _Worker:
    """Launcher-side handle for one worker (either substrate)."""

    def __init__(self, name: str, stage: int, devices: list[str]):
        self.name = name
        self.stage = stage
        self.devices = devices
        self.thread: threading.Thread | None = None
        self.proc = None
        self.ctrl_out = None          # worker -> launcher transport
        self.ctrl_in = None           # launcher -> worker transport
        self.data_port: int | None = None
        self.last_seen: float | None = None
        self.ready = False
        self.device: str | None = None    # what its ready message names
        self.stats: dict | None = None
        self.dead_reason: str | None = None

    @property
    def dead(self) -> bool:
        return self.dead_reason is not None


class DistLauncher:
    """Real multi-worker pipeline execution of one Deployment.

    Usage::

        launcher = dep.fleet(DistSpec(workers="thread"))
        report = launcher.run(frames)        # start + execute + drain

    or incrementally: :meth:`start`, :meth:`submit`, then
    :meth:`shutdown` (which returns the :class:`DistReport`).
    """

    def __init__(self, deployment, spec: DistSpec | None = None, *,
                 metrics=None, tracer=None):
        self.dep = deployment
        self.spec = spec or DistSpec()
        self.metrics = (metrics if metrics is not None
                        else getattr(deployment, "metrics", None)
                        or obs_metrics.default_registry())
        self.tracer = (tracer if tracer is not None
                       else getattr(deployment, "tracer", None) or Tracer())
        self.stages = deployment.pico.pipeline.stages
        self.model = deployment.model
        self.churn_events: list[DeviceLeave] = []
        self.workers: list[_Worker] = [
            _Worker(f"w{i}", i, [d.name for d in st.devices])
            for i, st in enumerate(self.stages)]
        self._routing()
        self._feed = None
        self._sink = None
        self._ctrl_q: "queue.Queue[tuple]" = queue.Queue()
        self._reader_threads: list[threading.Thread] = []
        self._stop_readers = False
        self._started = False
        self._closed = False
        self._epoch = None
        self._t_start = None
        self._tmpdir = None
        self._next_fid = 0
        self._pending: dict[int, np.ndarray] = {}   # submitted, unresolved
        self._submit_ts: dict[int, float] = {}
        self.outputs: dict[int, dict[str, np.ndarray]] = {}
        self.dropped: list[tuple[int, str]] = []
        self._submitted = 0
        self._report: DistReport | None = None

    # ------------------------------------------------------------------
    # routing: which tensors each inter-stage link must carry
    # ------------------------------------------------------------------
    def _routing(self) -> None:
        model, stages = self.model, self.stages
        n = len(stages)
        sinks = list(model.graph.sinks())
        needs = [model.boundary_needs(st.nodes) for st in stages]
        owner = {nd: i for i, st in enumerate(stages) for nd in st.nodes}
        # recv[i] = tensors the link *entering* stage i must carry: every
        # boundary pred some stage >= i still needs but an earlier stage
        # produced, plus early-produced graph sinks riding through to the
        # collector; recv[n] is the sink link (final outputs only).
        recv: list[set] = [set() for _ in range(n + 1)]
        recv_img = [False] * (n + 1)
        for i in range(n):
            for j in range(i, n):
                for _, p in needs[j]:
                    if p is None:
                        recv_img[i] = True
                    elif owner[p] < i:
                        recv[i].add(p)
            for s in sinks:
                if owner[s] < i:
                    recv[i].add(s)
        recv[n] = set(sinks)
        recv_img[0] = True              # the head link always feeds frames
        self._recv = [sorted(r) for r in recv]
        self._recv_img = recv_img

    # ------------------------------------------------------------------
    # startup
    # ------------------------------------------------------------------
    def start(self) -> "DistLauncher":
        if self._started:
            return self
        spec = self.spec
        self._epoch = time.time()
        self._t_start = time.perf_counter()
        dep_json = self.dep.to_json()
        device = str(getattr(self.dep, "device", "cuda"))
        self._prebuild(device)
        payloads = [
            build_payload(
                dep_json, i, worker=w.name, devices=w.devices,
                recv_nodes=self._recv[i], recv_image=self._recv_img[i],
                forward=self._recv[i + 1],
                forward_image=self._recv_img[i + 1],
                last=(i == len(self.stages) - 1), seed=spec.seed,
                heartbeat_s=spec.heartbeat_s,
                start_timeout_s=spec.start_timeout_s,
                chunk_bytes=spec.chunk_bytes, epoch_wall=self._epoch,
                trace=spec.trace, device=device)
            for i, w in enumerate(self.workers)]
        with self.tracer.wall_span("dist.launch", track="dist:launcher",
                                   workers=len(self.workers),
                                   mode=spec.workers,
                                   transport=spec.transport):
            if spec.workers == "process":
                self._start_processes(payloads)
            else:
                self._start_threads(payloads)
            self._started = True
            for w in self.workers:
                self._spawn_reader(w)
            self._await_ready()
            self._probe()
        return self

    def _prebuild(self, device: str) -> None:
        """Build (or find built) the conv kernel's library before any
        worker starts, where the workers will launch it.  Without a
        card nothing is built: the workers raise, and are reported."""
        import torch

        from ..exec.backends import DEFAULT_BACKEND
        backend = (self.dep.exec_spec.backend
                   or getattr(self.model, "backend", None) or DEFAULT_BACKEND)
        if (torch.device(device).type == "cuda" and backend == "cuda"
                and torch.cuda.is_available()):
            from ..kernels._build import library
            from ..kernels.conv2d.ops import SOURCE
            library(SOURCE)

    def _start_threads(self, payloads: list[dict]) -> None:
        spec = self.spec
        n = len(self.workers)
        if spec.transport == "tcp":
            listeners = [TCPListener() for _ in range(n)]
            sink_l = TCPListener()

            def pair(i):
                # sender connects, receiver accepts — same as process mode
                to = (listeners[i].addr if i < n else sink_l.addr)
                label = self._link_label(i)
                s = TCPTransport.connect(to, link=label,
                                         chunk_bytes=spec.chunk_bytes,
                                         metrics=self.metrics)
                lst = listeners[i] if i < n else sink_l
                r = lst.accept(link=label, chunk_bytes=spec.chunk_bytes,
                               metrics=self.metrics)
                lst.close()
                return s, r
        else:
            def pair(i):
                return memory_pair(self._link_label(i),
                                   chunk_bytes=spec.chunk_bytes,
                                   metrics=self.metrics)
        sends, recvs = [], []
        for i in range(n + 1):
            s, r = pair(i)
            sends.append(s)
            recvs.append(r)
        self._feed, self._sink = sends[0], recvs[n]
        for i, w in enumerate(self.workers):
            co_s, co_r = memory_pair(f"ctrl:{w.name}")
            ci_s, ci_r = memory_pair(f"ctrl-in:{w.name}")
            w.ctrl_out, w.ctrl_in = co_r, ci_s
            # the worker parses the payload back from JSON — even on
            # threads, only serialized artifacts cross the boundary
            sw = StageWorker(json.loads(json.dumps(payloads[i])),
                             recvs[i], sends[i + 1], co_s, ci_r)
            w.thread = threading.Thread(target=sw.run, daemon=True,
                                        name=f"dist-{w.name}")
            w.thread.start()

    def _start_processes(self, payloads: list[dict]) -> None:
        import multiprocessing as mp
        spec = self.spec
        ctx = mp.get_context("spawn")
        ctrl_l = TCPListener()
        sink_l = TCPListener()
        self._tmpdir = tempfile.mkdtemp(prefix="repro-dist-")
        for w, payload in zip(self.workers, payloads):
            path = os.path.join(self._tmpdir, f"{w.name}.json")
            with open(path, "w") as f:
                json.dump(payload, f)
            w.proc = ctx.Process(target=worker_main,
                                 args=(path, ctrl_l.addr[0], ctrl_l.port),
                                 name=f"dist-{w.name}", daemon=True)
            w.proc.start()
        deadline = time.monotonic() + spec.start_timeout_s
        hellos = 0
        by_name = {w.name: w for w in self.workers}
        while hellos < len(self.workers):
            ctrl = ctrl_l.accept(link="ctrl",
                                 timeout=max(0.1,
                                             deadline - time.monotonic()))
            msg = ctrl.recv(timeout=max(0.1, deadline - time.monotonic()))
            if msg is None or msg.kind != "hello":
                raise TimeoutError("dist: worker handshake failed "
                                   f"(got {msg and msg.kind!r})")
            w = by_name[msg.meta["worker"]]
            w.ctrl_out = w.ctrl_in = ctrl
            ctrl.link = f"ctrl:{w.name}"
            w.data_port = int(msg.meta["data_port"])
            hellos += 1
        ctrl_l.close()
        host = "127.0.0.1"
        for i, w in enumerate(self.workers):
            if i + 1 < len(self.workers):
                down = [host, self.workers[i + 1].data_port]
            else:
                down = [host, sink_l.port]
            w.ctrl_in.send(Message("wire", meta={
                "downstream": down, "link_in": self._link_label(i),
                "link_out": self._link_label(i + 1)}))
        self._feed = TCPTransport.connect((host, self.workers[0].data_port),
                                          link=self._link_label(0),
                                          chunk_bytes=spec.chunk_bytes,
                                          metrics=self.metrics,
                                          timeout=spec.start_timeout_s)
        self._sink = sink_l.accept(link=self._link_label(len(self.workers)),
                                   chunk_bytes=spec.chunk_bytes,
                                   metrics=self.metrics,
                                   timeout=spec.start_timeout_s)
        sink_l.close()

    def _link_label(self, i: int) -> str:
        n = len(self.workers)
        if i == 0:
            return "feed"
        if i == n:
            return "sink"
        return f"s{i - 1}->s{i}"

    def _spawn_reader(self, w: _Worker) -> None:
        def read():
            while not self._stop_readers:
                try:
                    msg = w.ctrl_out.recv(timeout=0.2)
                except ConnectionError as e:
                    if not self._stop_readers:
                        self._ctrl_q.put((w.name, "gone", str(e)))
                    return
                if msg is not None:
                    self._ctrl_q.put((w.name, "msg", msg))
        t = threading.Thread(target=read, daemon=True,
                             name=f"dist-ctrl-{w.name}")
        t.start()
        self._reader_threads.append(t)

    def _await_ready(self) -> None:
        deadline = time.monotonic() + self.spec.start_timeout_s
        while not all(w.ready for w in self.workers):
            if time.monotonic() > deadline:
                missing = [w.name for w in self.workers if not w.ready]
                raise TimeoutError(f"dist: workers {missing} not ready "
                                   f"within {self.spec.start_timeout_s}s")
            self._drain_control(block_s=0.1)
            self._raise_if_dead("startup")

    def _probe(self) -> None:
        """Push one all-zeros frame (fid -1) through the whole pipeline
        so every worker compiles its stage executable before real
        traffic — end of start() means warm caches everywhere."""
        h, wdt = self.model.input_size[1], self.model.input_size[0]
        ch = getattr(self.model, "in_channels", 3)
        nb = self.spec.micro_batch
        zeros = np.zeros((h, wdt, ch), np.float32)[None]
        fids = list(range(-nb, 0))
        frames = (zeros if nb == 1
                  else np.stack([zeros] * nb))
        self._feed.send(Message("frame", fids, {"__image__": frames},
                                {"warmup": True}))
        deadline = time.monotonic() + self.spec.start_timeout_s
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError("dist: warmup probe did not complete "
                                   f"within {self.spec.start_timeout_s}s")
            self._drain_control(block_s=0.0)
            self._raise_if_dead("warmup")
            msg = self._sink.recv(timeout=0.1)
            if msg is not None and msg.meta.get("warmup"):
                return

    def _raise_if_dead(self, phase: str) -> None:
        for w in self.workers:
            if w.dead:
                raise RuntimeError(f"dist: worker {w.name} died during "
                                   f"{phase}: {w.dead_reason}")

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def submit(self, frame: np.ndarray) -> int:
        """Queue one frame; returns its fid.  Applies back-pressure via
        ``DistSpec.max_inflight`` (collects while the pipe is full)."""
        self.start()
        while len(self._pending) >= self.spec.max_inflight:
            if not self._step(timeout=0.2):
                break                   # a worker died; run() will abort
        fid = self._next_fid
        self._next_fid += 1
        arr = np.asarray(frame)
        self._pending[fid] = arr
        self._submit_ts[fid] = time.time()
        self._submitted += 1
        self._feed.send(Message("frame", [fid], {"__image__": arr}))
        return fid

    def run(self, frames) -> DistReport:
        """Start, execute ``frames`` end-to-end, drain, and report.

        Frames are submitted in ``micro_batch`` cohorts with
        ``max_inflight`` back-pressure; the returned report accounts
        for every frame (outputs or dropped-with-reason)."""
        self.start()
        frames = [np.asarray(f) for f in frames]
        nb = self.spec.micro_batch
        i = 0
        alive = True
        while i < len(frames) and alive:
            batch = frames[i:i + nb]
            while (len(self._pending) >= max(self.spec.max_inflight,
                                             len(batch))
                   and (alive := self._step(timeout=0.2))):
                pass
            if not alive:
                break
            fids = list(range(self._next_fid, self._next_fid + len(batch)))
            self._next_fid += len(batch)
            now = time.time()
            for fid, f in zip(fids, batch):
                self._pending[fid] = f
                self._submit_ts[fid] = now
            self._submitted += len(batch)
            arr = batch[0] if len(batch) == 1 else np.stack(batch)
            self._feed.send(Message("frame", fids, {"__image__": arr}))
            i += len(batch)
        return self.shutdown()

    def _step(self, timeout: float = 0.2) -> bool:
        """One collect iteration: drain control, check liveness, pull
        at most one sink message.  Returns False once any worker is
        dead (the pipeline cannot complete)."""
        self._drain_control(block_s=0.0)
        self._check_liveness()
        if any(w.dead for w in self.workers):
            return False
        try:
            msg = self._sink.recv(timeout=timeout)
        except ConnectionError as e:
            last = self.workers[-1]
            self._mark_dead(last, f"sink link failed: {e}")
            return False
        if msg is None:
            return True
        if msg.kind == "result" and not msg.meta.get("warmup"):
            self._resolve(msg)
        return msg.kind != "stop"

    def _resolve(self, msg: Message) -> None:
        n = len(msg.fids)
        for k, fid in enumerate(msg.fids):
            if fid < 0 or fid not in self._pending:
                continue
            self.outputs[fid] = {name: np.asarray(t[k] if n > 1 else t)
                                 for name, t in msg.tensors.items()}
            self._pending.pop(fid)
            t0 = self._submit_ts.pop(fid, None)
            if t0 is not None and self.spec.trace:
                now = time.time()
                self.tracer.emit("frame", t0 - self._epoch, now - t0,
                                 track="dist:launcher", fid=fid)

    def _drain_control(self, block_s: float = 0.0) -> None:
        deadline = time.monotonic() + block_s
        by_name = {w.name: w for w in self.workers}
        while True:
            try:
                remaining = max(0.0, deadline - time.monotonic())
                item = self._ctrl_q.get(block=remaining > 0,
                                        timeout=remaining or None)
            except queue.Empty:
                return
            name, kind, payload = item
            w = by_name[name]
            if kind == "gone":
                if w.stats is None and not w.dead:
                    self._mark_dead(w, f"control link lost: {payload}")
                continue
            msg: Message = payload
            w.last_seen = time.monotonic()
            if msg.kind == "ready":
                w.ready = True
                w.device = msg.meta.get("device")
            elif msg.kind == "stats":
                w.stats = dict(msg.meta)
            elif msg.kind == "error":
                self._mark_dead(w, f"worker error: "
                                   f"{msg.meta.get('detail', '?')}")
            if self._ctrl_q.empty() and time.monotonic() >= deadline:
                return

    def _check_liveness(self) -> None:
        now = time.monotonic()
        for w in self.workers:
            if w.dead or w.stats is not None or w.last_seen is None:
                continue
            if now - w.last_seen > self.spec.peer_timeout_s:
                self._mark_dead(w, f"heartbeat silent for "
                                   f"{self.spec.peer_timeout_s}s")

    def _mark_dead(self, w: _Worker, reason: str) -> None:
        if w.dead:
            return
        w.dead_reason = reason
        t = time.time() - (self._epoch or time.time())
        for dev in w.devices:
            self.churn_events.append(DeviceLeave(t, dev))
            self.metrics.counter("dist.churn.device_leave").inc()
        self.tracer.instant("dist.churn", t, track="dist:launcher",
                            worker=w.name, reason=reason)

    def kill_worker(self, index: int) -> None:
        """Churn drill: make one worker crash *silently* (no stop, no
        stats) so peer-timeout detection and drop accounting can be
        exercised.  Thread workers honor a ``die`` control message;
        process workers are killed outright."""
        w = self.workers[index]
        if w.proc is not None:
            w.proc.terminate()
        elif w.ctrl_in is not None:
            w.ctrl_in.send(Message("die"))

    # ------------------------------------------------------------------
    # teardown
    # ------------------------------------------------------------------
    def shutdown(self, abort: bool = False) -> DistReport:
        """Drain and stop the pipeline; every in-flight frame either
        completes during the drain or is reported dropped with a
        reason.  Idempotent; returns the final :class:`DistReport`."""
        if self._report is not None:
            return self._report
        if not self._started:
            self._report = self._build_report()
            return self._report
        anyone_dead = any(w.dead for w in self.workers)
        if not abort and not anyone_dead:
            try:
                self._feed.send(Message("stop"))
            except (ConnectionError, OSError):
                anyone_dead = True
            deadline = time.monotonic() + self.spec.shutdown_timeout_s
            draining = not anyone_dead
            while draining and time.monotonic() < deadline:
                self._drain_control(block_s=0.0)
                self._check_liveness()
                if any(w.dead for w in self.workers):
                    break
                try:
                    msg = self._sink.recv(timeout=0.2)
                except ConnectionError:
                    break
                if msg is None:
                    continue
                if msg.kind == "stop":
                    draining = False    # every data message was ahead of it
                elif msg.kind == "result" and not msg.meta.get("warmup"):
                    self._resolve(msg)
            if draining and not any(w.dead for w in self.workers):
                # deadline hit with frames still unresolved
                for fid in sorted(self._pending):
                    self.dropped.append(
                        (fid, f"shutdown drain timed out after "
                              f"{self.spec.shutdown_timeout_s}s"))
                self._pending.clear()
            # stats messages trail the forwarded stop; give them a beat
            stats_deadline = time.monotonic() + 2.0
            while (any(w.stats is None and not w.dead
                       for w in self.workers)
                   and time.monotonic() < stats_deadline):
                self._drain_control(block_s=0.05)
        for w in self.workers:
            if w.dead:
                for fid in sorted(self._pending):
                    self.dropped.append(
                        (fid, f"worker {w.name} dead: {w.dead_reason}"))
                self._pending.clear()
                break
        if abort:
            for fid in sorted(self._pending):
                self.dropped.append((fid, "aborted by shutdown(abort=True)"))
            self._pending.clear()
        self._teardown()
        self._report = self._build_report()
        return self._report

    def _teardown(self) -> None:
        self._stop_readers = True
        for t in (self._feed, self._sink):
            if t is not None:
                try:
                    t.close()
                except Exception:
                    pass
        for w in self.workers:
            for t in (w.ctrl_in, w.ctrl_out):
                if t is not None:
                    try:
                        t.close()
                    except Exception:
                        pass
            if w.thread is not None:
                w.thread.join(timeout=5.0)
            if w.proc is not None:
                w.proc.join(timeout=5.0)
                if w.proc.is_alive():
                    w.proc.kill()
                    w.proc.join(timeout=5.0)
        for t in self._reader_threads:
            t.join(timeout=2.0)
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
        self._closed = True

    def _build_report(self) -> DistReport:
        wall = (time.perf_counter() - self._t_start
                if self._t_start is not None else 0.0)
        worker_stats = {}
        for w in self.workers:
            st = {"stage": w.stage, "devices": w.devices,
                  "dead": w.dead_reason, "device": w.device}
            if w.stats is not None:
                st.update({k: w.stats[k] for k in
                           ("frames", "compute_s", "bytes_in", "bytes_out",
                            "send_s") if k in w.stats})
                self._merge_spans(w, w.stats.get("spans") or [])
                self.metrics.gauge("dist.worker.compute_s",
                                   worker=w.name).set(
                    st.get("compute_s", 0.0))
                self.metrics.gauge("dist.worker.frames", worker=w.name).set(
                    st.get("frames", 0))
            worker_stats[w.name] = st
        link_stats = {}
        for t in (self._feed, self._sink):
            if t is not None:
                link_stats[t.link] = {"bytes_sent": t.bytes_sent,
                                      "bytes_recv": t.bytes_recv,
                                      "sends": t.sends, "recvs": t.recvs,
                                      "send_s": t.send_s}
        self.metrics.counter("dist.frames.completed").inc(len(self.outputs))
        self.metrics.counter("dist.frames.dropped").inc(len(self.dropped))
        return DistReport(
            outputs=self.outputs, dropped=self.dropped,
            submitted=self._submitted,
            churn_events=list(self.churn_events),
            worker_stats=worker_stats, link_stats=link_stats,
            wall_s=wall, transport=self.spec.transport,
            workers_mode=self.spec.workers, n_stages=len(self.stages))

    def _merge_spans(self, w: _Worker, spans: list) -> None:
        """Re-emit worker-side spans on this launcher's tracer, one
        track (= Perfetto process row) per real worker."""
        if not self.spec.trace:
            return
        for name, ts, dur, attrs in spans:
            self.tracer.emit(name, ts, dur, track=f"dist:{w.name}",
                             **{str(k): v for k, v in attrs.items()})
