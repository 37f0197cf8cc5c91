"""Distributed stage worker: one pipeline stage, one persistent loop.

A worker never sees live Python objects from the launcher: its whole
configuration is one JSON *worker payload* — the versioned Deployment
artifact (plan + specs + model graph + CostTable, exactly what
``Deployment.save`` writes) plus this worker's stage index and link
roles, and the device it computes on.  Rebuilding from the artifact is
the hand-off contract: ``Deployment.from_json`` re-installs the
CostTable's tuned conv launch plans (``conv:cuda:`` entries)
process-wide, and model weights are re-initialized deterministically
from the payload seed with the port's seeded init (``model.init`` from
a ``torch.Generator``, as ``repro_torch.compile`` draws them), so every
worker — thread or spawned process — holds bit-identical state, and
the same bits as ``dep.run`` and :func:`~repro_torch.dist.validate.
validate`.

A worker computes on its payload's device (``"cuda"`` when the key is
missing, as in the JAX package's payloads); a CUDA worker that finds
no card raises, and the launcher reports it as any worker error.  Its
``ready`` message names the device it computes on.

The loop is ``recv -> StageExecutor compiled segment -> send``:
micro-batched messages go through the batch-folded ``run_frames`` path,
heartbeats are emitted on the control link between frames, and a
``stop`` received from upstream is forwarded downstream *after* all
data messages (links are FIFO), which is what makes the launcher's
drain lossless.  ``die`` simulates a crash: the worker exits silently
— no stop forwarded, no stats, links left dangling — so peer-timeout
detection can be drilled.  A worker whose launcher has closed the
control link ends its loop too (the JAX package's keeps polling until
its process ends, and the launcher's teardown waits on each such
thread for 5 s).
"""

from __future__ import annotations

import json
import time
import traceback

import numpy as np
import torch

from .transport import Message, TCPListener, TCPTransport


def build_payload(deployment_json: str, stage: int, *, worker: str,
                  devices: list[str], recv_nodes: list[str],
                  recv_image: bool, forward: list[str], forward_image: bool,
                  last: bool, seed: int, heartbeat_s: float,
                  start_timeout_s: float, chunk_bytes: int,
                  epoch_wall: float, trace: bool,
                  device: str = "cuda") -> dict:
    """The JSON-safe worker payload (see module docstring): the JAX
    package's keys, and ``"device"``."""
    return {"deployment": deployment_json, "stage": stage, "worker": worker,
            "devices": list(devices), "recv_nodes": list(recv_nodes),
            "recv_image": bool(recv_image), "forward": list(forward),
            "forward_image": bool(forward_image), "last": bool(last),
            "seed": int(seed), "heartbeat_s": float(heartbeat_s),
            "start_timeout_s": float(start_timeout_s),
            "chunk_bytes": int(chunk_bytes),
            "epoch_wall": float(epoch_wall), "trace": bool(trace),
            "device": str(device)}


class StageWorker:
    """Persistent stage loop over abstract transports (thread or
    process substrate — the code path is identical)."""

    def __init__(self, payload: dict, upstream, downstream,
                 control_out, control_in=None):
        self.payload = payload
        self.upstream = upstream
        self.downstream = downstream
        self.control_out = control_out
        self.control_in = control_in
        self.name = payload["worker"]
        self.stage_index = payload["stage"]
        self.frames = 0
        self.compute_s = 0.0
        self.spans: list[list] = []
        self._silent = False          # die received: simulate a crash

    # -- lifecycle -------------------------------------------------------
    def run(self) -> None:
        try:
            self._setup()
            self._send_ctrl("ready", device=str(self.device))
            self._loop()
        except ConnectionError as e:
            self._send_error(f"link failure: {e}")
        except Exception:
            self._send_error(traceback.format_exc())
        finally:
            if not self._silent:
                self._close()

    def _setup(self) -> None:
        from ..api.deployment import Deployment
        from ..pipeline.stage import StageExecutor

        p = self.payload
        device = torch.device(p.get("device", "cuda"))
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"worker {self.name}: its payload asks "
                                   f"for {device}, and no CUDA device is "
                                   f"available")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        # the artifact round-trip IS the hand-off: from_json re-applies
        # the exec-spec cache bound and installs the shipped CostTable's
        # tuned conv launch plans
        dep = Deployment.from_json(p["deployment"], device=device)
        st = dep.pico.pipeline.stages[self.stage_index]
        spec = dep.exec_spec
        # built exactly the way PipelineRunner builds its executors
        # (backend, mode, fuse), so the stage-cache key — and the
        # numerics — match the single-process compiled path bit-for-bit
        self.executor = StageExecutor(
            dep.model, st.nodes, list(st.fractions),
            name=f"stage{self.stage_index}", backend=spec.backend,
            mode=spec.mode, fuse=spec.fuse)
        # the boundary tensors this stage reads; others only pass through
        self._reads = {q for _, q in self.executor.needs if q is not None}
        self._reads_image = any(q is None for _, q in self.executor.needs)
        self.params = dep.model.init(
            torch.Generator().manual_seed(p["seed"]), device=device)
        self.heartbeat_s = p["heartbeat_s"]
        self.epoch = p["epoch_wall"]
        self.trace = p["trace"]
        self.forward = list(p["forward"])
        self.forward_image = p["forward_image"]
        self.last = p["last"]
        self._last_hb = 0.0

    def _loop(self) -> None:
        while True:
            self._heartbeat()
            if self._poll_control():
                return              # die (a simulated crash), or no launcher
            msg = self.upstream.recv(timeout=self.heartbeat_s)
            if msg is None:
                continue
            if msg.kind == "stop":
                # FIFO links: every data message is already behind us,
                # so forwarding stop completes the lossless drain
                self.downstream.send(msg)
                self._send_stats()
                return
            if msg.kind == "frame":
                self._frame(msg)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # decoded arrays are read-only views into the message bytes: one
        # copy, onto the worker's device
        return torch.tensor(a, device=self.device)

    def _frame(self, msg: Message) -> None:
        arrays = {k: v for k, v in msg.tensors.items() if k != "__image__"}
        image_np = msg.tensors.get("__image__")
        t_wall = time.time()
        t0 = time.perf_counter()
        produced = {k: self._to_device(v) for k, v in arrays.items()
                    if k in self._reads}
        image = (self._to_device(image_np) if self._reads_image
                 and image_np is not None else None)
        # the executor's copies of a replay's outputs (copy_out), never a
        # graph's own: the next replay overwrites those
        if len(msg.fids) > 1:
            outs = self.executor.run_frames(self.params, produced, image)
        else:
            outs = self.executor(self.params, produced, image)
        outs = {k: v.cpu().numpy() for k, v in outs.items()}   # blocks
        dt = time.perf_counter() - t0
        if not msg.meta.get("warmup"):
            # the probe's wall is dominated by the stage compile — keep
            # it out of the steady-state compute stats validate() rates
            self.frames += len(msg.fids)
            self.compute_s += dt
        if self.trace:
            self.spans.append(["stage.compute", t_wall - self.epoch, dt,
                               {"stage": self.stage_index,
                                "worker": self.name,
                                "frames": len(msg.fids),
                                "fid": msg.fids[0]}])
        avail = dict(arrays)
        avail.update(outs)
        out = {n: avail[n] for n in self.forward}
        if self.forward_image:
            out["__image__"] = image_np
        self.downstream.send(Message("result" if self.last else "frame",
                                     msg.fids, out, msg.meta))

    # -- control ---------------------------------------------------------
    def _heartbeat(self) -> None:
        now = time.monotonic()
        if now - self._last_hb >= self.heartbeat_s:
            self._last_hb = now
            self._send_ctrl("heartbeat")

    def _poll_control(self) -> bool:
        """Whether the loop ends: on ``die``, or once the launcher has
        closed the control link (its teardown), so a worker stranded
        behind a dead peer does not outlive its launcher."""
        if self.control_in is None:
            return False
        try:
            msg = self.control_in.recv(timeout=0.0)
        except ConnectionError:
            return True
        if msg is not None and msg.kind == "die":
            self._silent = True
            return True
        return False

    def _send_ctrl(self, kind: str, **meta) -> None:
        meta.setdefault("worker", self.name)
        meta.setdefault("stage", self.stage_index)
        try:
            self.control_out.send(Message(kind, meta=meta))
        except (ConnectionError, OSError):
            pass                    # launcher gone: nothing to tell

    def _send_stats(self) -> None:
        self._send_ctrl(
            "stats", frames=self.frames, compute_s=self.compute_s,
            bytes_in=self.upstream.bytes_recv,
            bytes_out=self.downstream.bytes_sent,
            send_s=self.downstream.send_s, spans=self.spans)

    def _send_error(self, detail: str) -> None:
        self._send_ctrl("error", detail=detail, frames=self.frames)

    def _close(self) -> None:
        for t in (self.upstream, self.downstream):
            try:
                t.close()
            except Exception:
                pass


def worker_main(payload_path: str, control_host: str,
                control_port: int) -> None:
    """Spawned-process entry point: handshake over the control link,
    wire up the data links, then run the stage loop.

    Protocol: bind an ephemeral data listener -> connect the control
    socket -> ``hello`` (carrying the data port) -> receive ``wire``
    (the downstream address) -> connect downstream -> accept upstream
    -> :meth:`StageWorker.run`.
    """
    with open(payload_path) as f:
        payload = json.load(f)
    chunk = payload["chunk_bytes"]
    start_timeout = payload["start_timeout_s"]
    name = payload["worker"]
    listener = TCPListener()
    control = TCPTransport.connect((control_host, control_port),
                                   link=f"ctrl:{name}", chunk_bytes=chunk,
                                   timeout=start_timeout)
    control.send(Message("hello", meta={"worker": name,
                                        "stage": payload["stage"],
                                        "data_port": listener.port}))
    wire = control.recv(timeout=start_timeout)
    if wire is None or wire.kind != "wire":
        raise TimeoutError(f"worker {name}: no wiring from launcher")
    host, port = wire.meta["downstream"]
    downstream = TCPTransport.connect((host, int(port)),
                                      link=wire.meta["link_out"],
                                      chunk_bytes=chunk,
                                      timeout=start_timeout)
    upstream = listener.accept(link=wire.meta["link_in"], chunk_bytes=chunk,
                               timeout=start_timeout)
    listener.close()
    StageWorker(payload, upstream, downstream, control, control).run()
