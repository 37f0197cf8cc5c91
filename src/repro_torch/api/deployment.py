"""``repro_torch.compile(model, cluster) -> Deployment`` — the public facade.

The paper's split into an offline optimizer and an online executor:

    dep = repro_torch.compile(model, cluster, plan_spec, exec_spec)
    dep.run(frame)                   # one (N, H, W, C) frame
    dep.run(frames)                  # a list of frames, batch-folded

Planning is the JAX package's planner (framework-free, copied);
execution runs every stage on one device, ``"cuda"`` unless the caller
passes ``device="cpu"``.  Not ported yet: ``save``/``load``,
``simulate``, calibration, autotune, the event-driven runtime, the
servers and scheduler, distributed workers and ``replan``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

import torch

from ..core.cost import Cluster, CostTable
from ..core.pipeline_dp import PlannerCache
from ..core.planner import PicoPlan, plan_with_spec
from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry, default_registry
from ..obs.trace import Tracer
from .specs import ExecSpec, PlanSpec


def compile(model, cluster: Cluster,
            plan_spec: PlanSpec | None = None,
            exec_spec: ExecSpec | None = None, *,
            cost_table: CostTable | None = None,
            params=None, generator: torch.Generator | None = None,
            device: str | torch.device = "cuda") -> "Deployment":
    """Plan ``model`` on ``cluster`` and return the deployment that runs
    the plan on ``device``.

    ``model`` is a graph carrier (:class:`~repro_torch.models.cnn.
    builder.CNNDef`).  ``params`` are the weights for later ``run()``
    calls; without them ``generator`` (default: seed 0) seeds
    ``model.init`` on first use.  ``cost_table`` supplies measured
    segment ratios for the planner.
    """
    plan_spec = plan_spec or PlanSpec()
    exec_spec = exec_spec or ExecSpec()
    if exec_spec.calibrate or exec_spec.autotune:
        raise NotImplementedError("ExecSpec.calibrate / autotune are not "
                                  "ported to repro_torch yet")
    if params is None and generator is not None:
        params = model.init(generator, device=device)
    # the deployment's tracer captures its lifecycle, starting with the
    # offline plan's spans
    tracer = Tracer()
    with obs_trace.scoped(tracer):
        pico = plan_with_spec(model.graph, cluster, model.input_size,
                              plan_spec, cost_table=cost_table,
                              planner_cache=PlannerCache())
    return Deployment(model, cluster, plan_spec, exec_spec, pico,
                      cost_table=cost_table, params=params,
                      device=torch.device(device), tracer=tracer)


@dataclass
class Deployment:
    """A planned pipeline, ready to execute on one device."""

    model: object
    cluster: Cluster
    plan_spec: PlanSpec
    exec_spec: ExecSpec
    pico: PicoPlan
    cost_table: CostTable | None = None
    params: object = field(default=None, repr=False, compare=False)
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))
    _runner: object = field(default=None, repr=False, compare=False)
    #: span sink for the deployment lifecycle (plan spans from
    #: :func:`compile`).  Export with ``tracer.save(path)``.
    tracer: object = field(default=None, repr=False, compare=False)
    #: deployment-scoped metrics registry
    metrics: object = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        # the cache bound is process-global; a deployment carrying one
        # applies it when it is built
        self.exec_spec.apply_cache_limit()
        if self.tracer is None:
            self.tracer = Tracer()
        if self.metrics is None:
            self.metrics = MetricsRegistry()

    # ---------------- plan views ----------------

    @property
    def pipeline(self):
        return self.pico.pipeline

    @property
    def partition(self):
        return self.pico.partition

    @property
    def period(self) -> float:
        return self.pico.period

    @property
    def latency(self) -> float:
        return self.pico.latency

    @property
    def throughput(self) -> float:
        return self.pico.throughput

    def describe(self) -> str:
        """One-paragraph human summary (CLI/report helper)."""
        st = self.pico.pipeline.stages
        lines = [f"{getattr(self.model, 'name', 'model')}: "
                 f"{len(self.pico.partition.pieces)} pieces -> "
                 f"{len(st)} stages on {len(self.cluster)} devices; "
                 f"period {self.period * 1e3:.2f} ms "
                 f"({60.0 / self.period:.1f} frames/min), "
                 f"latency {self.latency * 1e3:.2f} ms; runs on "
                 f"{self.device}"]
        for s in st:
            lines.append(
                f"  stage pieces {s.first_piece}-{s.last_piece} on "
                f"{[d.name for d in s.devices]}  "
                f"T={s.cost.total * 1e3:.2f} ms")
        if self.cost_table is not None:
            lines.append(f"  calibrated: {len(self.cost_table)} segment "
                         f"ratio(s)")
        return "\n".join(lines)

    # ---------------- execution ----------------

    def load_params(self, generator: torch.Generator | None = None
                    ) -> "Deployment":
        """Initialize model weights on the deployment's device
        (idempotent unless ``generator`` is given)."""
        if self.params is None or generator is not None:
            self.params = self.model.init(generator, device=self.device)
        return self

    @property
    def runner(self):
        """Lazy :class:`~repro_torch.pipeline.runner.PipelineRunner` over
        the plan's stages (compiled per ``exec_spec``)."""
        if self._runner is None:
            from ..pipeline.runner import PipelineRunner
            self._runner = PipelineRunner(self.model, self.pico.pipeline,
                                          exec_spec=self.exec_spec)
        return self._runner

    def run(self, frames, params=None):
        """Execute frame(s) through the pipelined stages.  A single
        (N, H, W, C) array returns one sink dict; a sequence returns a
        list of sink dicts.  Multi-frame sequences go through the
        batch-folded ``run_frames`` path (one pass per stage) unless
        ``exec_spec.scan_batch`` is off.  Frames are moved to the
        deployment's device."""
        if params is None:
            params = self.load_params().params
        if hasattr(frames, "ndim"):
            return self.runner(params, torch.as_tensor(frames,
                                                       device=self.device))
        frames = [torch.as_tensor(f, device=self.device) for f in frames]
        if self.exec_spec.scan_batch and len(frames) > 1:
            outs = self.runner.run_frames(params, torch.stack(frames))
            return [{k: v[i] for k, v in outs.items()}
                    for i in range(len(frames))]
        return [self.runner(params, x) for x in frames]

    # ---------------- observability ----------------

    def metrics_snapshot(self, meta: Mapping | None = None) -> dict:
        """Versioned metrics-snapshot document for this deployment: the
        deployment-scoped registry merged with the process-default one
        (stage-cache hits/misses/evictions, per-stage build times)."""
        reg = MetricsRegistry()
        reg.merge(self.metrics)
        reg.merge(default_registry())
        base = {"model": getattr(self.model, "name", "model"),
                "devices": len(self.cluster),
                "stages": len(self.pico.pipeline.stages)}
        base.update(meta or {})
        return reg.snapshot(meta=base)
