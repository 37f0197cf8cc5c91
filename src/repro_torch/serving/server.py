"""Pipelined CNN inference server — PICO's deployment form.

Plans the pipeline with the PICO optimizer, builds per-stage executors,
and serves a stream of frame requests with dynamic batching.  The
scheduler is event-driven: each stage is busy for its modeled time
T(S); the executor computes the true numerics (bit-exact with the
monolithic network).  Throughput/latency statistics reproduce the
paper's runtime metrics on simulated clusters, while the numerics prove
the deployment artifact is correct.

The port of the JAX package's ``serving/server.py``.  The numerics run
on the server's device (``"cuda"`` unless the caller passes ``"cpu"``),
through the compiled stages and, on a CUDA device, their CUDA graphs
and the hand-written conv kernel.  The servers take ``plan_spec=`` and
``exec_spec=`` only, not the JAX package's deprecated ``t_lim=`` /
``backend=`` keywords, and :meth:`PipelineServer.load` draws the port's
seeded init (``model.init`` from a ``torch.Generator``, seed 0 unless
one is given).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..api.specs import DeploySpec, ExecSpec, PlanSpec
from ..core import Cluster, plan_with_spec
from ..obs.metrics import quantile
from ..models.cnn.builder import CNNDef
from ..pipeline.runner import PipelineRunner
from ..data.pipeline import Request


def _load_params_idempotent(srv, generator):
    """Shared server ``load()`` body: params attached beforehand (e.g.
    by ``Deployment.server()``) survive unless ``generator`` forces a
    re-init.  The init is ``model.init``'s, as ``repro_torch.compile``
    and ``Deployment.load_params`` draw it (seed 0 without a
    generator), on the server's device."""
    if srv.params is None or generator is not None:
        srv.params = srv.model.init(generator, device=srv.device)
    return srv


@dataclass
class ServeStats:
    """Shared serving accounting: every server front-end (closed-form
    replay, runtime-backed streaming, multi-tenant scheduler) records
    per-request completions through :meth:`record` instead of keeping
    its own accumulation loop."""

    served: int = 0
    total_latency_model_s: float = 0.0
    period_model_s: float = 0.0
    wall_s: float = 0.0
    per_request: list = field(default_factory=list)
    # admission / SLO accounting (multi-tenant scheduler)
    rejected: int = 0           # refused at admission (queue full)
    expired: int = 0            # deadline passed while still queued
    deadline_misses: int = 0    # served, but past the deadline

    def record(self, latency_s: float, missed_deadline: bool = False) -> None:
        """Account one served request."""
        self.served += 1
        self.total_latency_model_s += latency_s
        self.per_request.append(latency_s)
        if missed_deadline:
            self.deadline_misses += 1

    @property
    def offered(self) -> int:
        return self.served + self.rejected + self.expired

    @property
    def model_throughput_per_min(self) -> float:
        """Steady-state throughput from the modeled pipeline period;
        robust to zero-duration serves (empty streams, single-request
        serves, degenerate plans) instead of dividing by zero."""
        if self.period_model_s and self.period_model_s > 0.0:
            return 60.0 / self.period_model_s
        return 0.0

    @property
    def mean_latency_s(self) -> float:
        return (self.total_latency_model_s / self.served
                if self.served else 0.0)

    def latency_percentile(self, q: float) -> float:
        """Nearest-rank percentile of per-request latency — well-defined
        for any window size (``np.percentile``'s linear interpolation
        degenerates below three samples: p50 of ``[a, b]`` lands between
        the order statistics instead of on one).  Shares the estimator
        with :class:`repro_torch.obs.metrics.Histogram` so server stats and
        metrics snapshots quote identical numbers."""
        return quantile(self.per_request, q)

    @property
    def p50_latency_s(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p95_latency_s(self) -> float:
        return self.latency_percentile(95.0)

    @property
    def p99_latency_s(self) -> float:
        return self.latency_percentile(99.0)

    @property
    def deadline_miss_rate(self) -> float:
        """Fraction of admitted requests that blew their deadline —
        expired-in-queue requests count as misses too."""
        admitted = self.served + self.expired
        if not admitted:
            return 0.0
        return (self.deadline_misses + self.expired) / admitted

    def publish(self, registry, **labels) -> None:
        """Mirror this accounting into a
        :class:`~repro_torch.obs.metrics.MetricsRegistry` (``serve.*`` gauges
        plus a ``serve.latency_s`` histogram), labelled e.g. by tenant.
        Idempotent per registry: gauges overwrite, the histogram is
        rebuilt from ``per_request`` only when its count lags."""
        for name, v in (("serve.served", self.served),
                        ("serve.rejected", self.rejected),
                        ("serve.expired", self.expired),
                        ("serve.deadline_misses", self.deadline_misses),
                        ("serve.deadline_miss_rate",
                         self.deadline_miss_rate),
                        ("serve.mean_latency_s", self.mean_latency_s),
                        ("serve.period_model_s", self.period_model_s),
                        ("serve.wall_s", self.wall_s)):
            registry.gauge(name, **labels).set(v)
        h = registry.histogram("serve.latency_s", **labels)
        for lat in self.per_request[h.count:]:
            h.observe(lat)


class PipelineServer:
    def __init__(self, model: CNNDef, cluster: Cluster, cost_table=None,
                 plan_spec: PlanSpec | None = None,
                 exec_spec: ExecSpec | None = None, pico=None,
                 device: str | torch.device = "cuda"):
        plan_spec = plan_spec or PlanSpec()
        exec_spec = exec_spec or ExecSpec()
        self.model = model
        self.cluster = cluster
        self.exec_spec = exec_spec
        self.device = torch.device(device)
        self.pico = pico or plan_with_spec(model.graph, cluster,
                                           model.input_size, plan_spec,
                                           cost_table=cost_table)
        # built as Deployment.runner builds it, so outputs equal dep.run's
        self.runner = PipelineRunner(model, self.pico.pipeline,
                                     exec_spec=exec_spec)
        self.params = None

    def load(self, generator: torch.Generator | None = None):
        """Initialize weights (idempotent — see
        :func:`_load_params_idempotent`)."""
        return _load_params_idempotent(self, generator)

    def serve(self, requests: list[Request]) -> tuple[list, ServeStats]:
        """Run the request stream through the pipeline.

        Returns (outputs, stats).  Completion times follow the pipeline
        model (stage s starts request i when stage s finished i-1 and
        stage s-1 finished i); numerics come from the real executors.
        """
        assert self.params is not None, "call load() first"
        t0 = time.perf_counter()
        stages = self.runner.stages
        T = [st.cost.total for st in self.pico.pipeline.stages]
        S = len(stages)
        finish = np.zeros((len(requests), S))
        outputs = []
        stats = ServeStats(period_model_s=max(T) if T else 0.0)
        for i, req in enumerate(requests):
            produced = {}
            image = (None if req.payload is None
                     else torch.as_tensor(req.payload, device=self.device))
            for s, ex in enumerate(stages):
                prev_stage = finish[i][s - 1] if s > 0 else req.arrival
                prev_req = finish[i - 1][s] if i > 0 else 0.0
                finish[i][s] = max(prev_stage, prev_req) + T[s]
                outs = ex(self.params, produced, image)
                produced.update(outs)
            sinks = self.model.graph.sinks()
            outputs.append({k: produced[k] for k in sinks})
            stats.record(finish[i][-1] - req.arrival)
        stats.wall_s = time.perf_counter() - t0
        return outputs, stats


class StreamingPipelineServer:
    """Serving front-end over the event-driven cluster runtime.

    Where :class:`PipelineServer` replays the closed-form pipeline
    recurrence, this feeds a request stream through
    ``runtime.PipelineRuntime``: per-device virtual clocks, timed
    links, optional churn injection and dynamic re-planning — with the
    real per-stage numerics on the server's device.  The deployment form
    of the paper's testbed runs.
    """

    def __init__(self, model: CNNDef, cluster: Cluster, config=None,
                 churn=(), cost_table=None,
                 plan_spec: PlanSpec | None = None,
                 exec_spec: ExecSpec | None = None,
                 deploy_spec: DeploySpec | None = None, pico=None,
                 device: str | torch.device = "cuda"):
        from ..runtime import RuntimeConfig
        plan_spec = plan_spec or PlanSpec()
        exec_spec = exec_spec or ExecSpec()
        if deploy_spec is not None and config is not None:
            raise TypeError("pass either deploy_spec= or config=, not both")
        if deploy_spec is not None:
            config = deploy_spec.to_runtime_config()
        self.model = model
        self.cluster = cluster
        self.device = torch.device(device)
        self._runtime_kw = dict(
            cluster=cluster, plan_spec=plan_spec, exec_spec=exec_spec,
            config=config or RuntimeConfig(), churn=churn,
            cost_table=cost_table, pico=pico, device=self.device)
        self.params = None

    def load(self, generator: torch.Generator | None = None):
        """Initialize weights (idempotent — see
        :func:`_load_params_idempotent`)."""
        return _load_params_idempotent(self, generator)

    def serve(self, requests: list[Request]) -> tuple[list, ServeStats]:
        assert self.params is not None, "call load() first"
        from ..runtime import PipelineRuntime
        t0 = time.perf_counter()
        rt = PipelineRuntime(model=self.model, params=self.params,
                             **self._runtime_kw)
        # the runtime admits frames in arrival order; remember which
        # original request each frame id maps to so outputs/latencies
        # come back in the caller's order (same contract as
        # PipelineServer.serve: outputs[i] answers requests[i])
        order = sorted(range(len(requests)),
                       key=lambda i: requests[i].arrival)
        rep = rt.run(inputs=[requests[i].payload for i in order],
                     arrivals=[requests[i].arrival for i in order])
        done_at = {fid: done for fid, _, done in rep.completions}
        stats = ServeStats(period_model_s=rep.period)
        outputs = [{} for _ in requests]
        fid_of = {orig: fid for fid, orig in enumerate(order)}
        for orig, req in enumerate(requests):
            fid = fid_of[orig]
            outputs[orig] = rep.outputs.get(fid, {})
            stats.record(max(0.0, done_at[fid] - req.arrival))
        stats.wall_s = time.perf_counter() - t0
        return outputs, stats
