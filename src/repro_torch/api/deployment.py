"""``repro_torch.compile(model, cluster) -> Deployment`` — the public facade.

One object owns the plan → calibrate → execute lifecycle that the paper
splits into an offline optimizer and an online executor:

    dep = repro_torch.compile(model, cluster, plan_spec, exec_spec)
    dep.run(frame)                   # one (N, H, W, C) frame
    dep.run(frames)                  # a list of frames, batch-folded
    dep.simulate()                   # closed-form steady-state report
    dep.replan(cluster2)             # the same pieces on another cluster
    dep.runtime(deploy_spec, churn=[...]).run(inputs=frames)  # event-driven
    dep.server(streaming=True)       # serving front-end
    dep.scheduler(tenants=[...])     # multi-tenant co-hosting
    dep.fleet(DistSpec())            # one real worker per stage
    dep.save("plan.json")            # durable, versioned artifact
    dep2 = repro_torch.Deployment.load("plan.json")  # no re-plan or re-tune

Planning is the JAX package's planner (framework-free, copied);
execution runs every stage on one device, ``"cuda"`` unless the caller
passes ``device="cpu"``.  With ``ExecSpec(autotune=True)`` the conv
kernel's launch plans are tuned first, and with ``calibrate=True`` each
stage is timed on the device and the plan re-built on the measured
:class:`CostTable`.  The artifact is the JAX package's document: one
written by either package loads in the other, and neither the planner,
the calibrator nor the tuner runs on load.  :meth:`Deployment.runtime`
runs the plan on the event-driven cluster runtime,
:meth:`Deployment.server` serves requests through it or through the
closed-form pipeline, :meth:`Deployment.scheduler` co-hosts several
tenants on the cluster, and :meth:`Deployment.fleet` runs each stage in
a worker of its own (threads or spawned processes), all with real
compute on the deployment's device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import torch

from ..core.cost import Cluster, CostTable
from ..core.pipeline_dp import PlannerCache
from ..core.planner import PicoPlan, plan_with_spec
from ..obs import trace as obs_trace
from ..obs.metrics import MetricsRegistry, default_registry
from ..obs.trace import Tracer
from . import artifacts
from .specs import DeploySpec, ExecSpec, PlanSpec


def require_device(device: str | torch.device) -> torch.device:
    """``device`` as a :class:`torch.device`, for a command-line entry
    point (the examples): a CUDA device on a machine without one stops
    the program with a message (``SystemExit``) rather than run on the
    CPU instead."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions on the CPU")
    return device


def compile(model, cluster: Cluster,
            plan_spec: PlanSpec | None = None,
            exec_spec: ExecSpec | None = None, *,
            cost_table: CostTable | None = None,
            params=None, generator: torch.Generator | None = None,
            device: str | torch.device = "cuda") -> "Deployment":
    """Plan (and optionally tune and calibrate) ``model`` on ``cluster``
    and return the deployment that runs the plan on ``device``.

    ``model`` is a graph carrier (:class:`~repro_torch.models.cnn.
    builder.CNNDef`).  With ``exec_spec.autotune`` the conv kernel's
    launch plans are tuned on ``device`` first; with
    ``exec_spec.calibrate`` every stage of the initial plan is timed on
    ``device`` through its compiled stage and the plan is re-built on
    the measured :class:`CostTable` (piece chain reused).  ``params``
    are the weights for calibration and later ``run()`` calls; without
    them ``generator`` (default: seed 0) seeds ``model.init``.
    ``cost_table`` supplies a previously measured table up front.
    """
    plan_spec = plan_spec or PlanSpec()
    exec_spec = exec_spec or ExecSpec()
    if params is None and generator is not None:
        params = model.init(generator, device=device)
    # the deployment's tracer captures its lifecycle: the offline plan,
    # tuning and calibration spans
    tracer = Tracer()
    with obs_trace.scoped(tracer):
        if exec_spec.autotune:
            # tune launch plans first so calibration (and with it the
            # planner's cost ratios) measures the tuned kernel; winners
            # merge into the same CostTable artifact as the ratios
            from ..exec.autotune import autotune_model
            cost_table, _ = autotune_model(
                model,
                backend=exec_spec.backend
                or getattr(model, "backend", None) or "cuda",
                table=cost_table, iters=exec_spec.autotune_iters,
                device=device)
        # one PlannerCache for the deployment's lifetime: the post-
        # calibration re-plan and any later .replan() hops reuse the
        # initial plan's segment geometry (incremental hot path)
        cache = PlannerCache()
        pico = plan_with_spec(model.graph, cluster, model.input_size,
                              plan_spec, cost_table=cost_table,
                              planner_cache=cache)
        if exec_spec.calibrate:
            from ..exec.calibrate import calibrate_plan
            if params is None:
                params = model.init(device=device)
            report = calibrate_plan(model, params, pico.pipeline.stages,
                                    backend=exec_spec.backend,
                                    iters=exec_spec.calibrate_iters,
                                    device=device)
            tuned = cost_table.kernels if cost_table is not None else {}
            cost_table = report.table()
            cost_table.kernels.update(tuned)  # ratios + tunings, one store
            pico = plan_with_spec(model.graph, cluster, model.input_size,
                                  plan_spec, partition=pico.partition,
                                  cost_table=cost_table,
                                  planner_cache=cache)
    dep = Deployment(model, cluster, plan_spec, exec_spec, pico,
                     cost_table=cost_table, params=params,
                     device=torch.device(device), tracer=tracer)
    dep._planner_cache = cache
    return dep


@dataclass
class Deployment:
    """A planned (and optionally tuned and calibrated) pipeline, ready to
    execute on one device, re-plan, or ship as a JSON artifact."""

    model: object
    cluster: Cluster
    plan_spec: PlanSpec
    exec_spec: ExecSpec
    pico: PicoPlan
    cost_table: CostTable | None = None
    params: object = field(default=None, repr=False, compare=False)
    device: torch.device = field(default_factory=lambda: torch.device("cuda"))
    _runner: object = field(default=None, repr=False, compare=False)
    #: span sink for the deployment lifecycle (plan, autotune and
    #: calibrate spans from :func:`compile`).  Export with
    #: :meth:`save_trace`.
    tracer: object = field(default=None, repr=False, compare=False)
    #: deployment-scoped metrics registry
    metrics: object = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        # the cache bound is process-global; a deployment carrying one
        # applies it the same way on compile and on load
        self.exec_spec.apply_cache_limit()
        # tuned launch plans ride in the cost table; install them
        # process-wide so a loaded artifact re-arms them with zero
        # re-tuning (the same compile/load symmetry as the cache bound)
        if self.cost_table is not None and self.cost_table.kernels:
            from ..exec.autotune import install
            install(self.cost_table.kernels)
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
            if self.cost_table.kernels:
                lines.append(f"  autotuned: {len(self.cost_table.kernels)} "
                             f"kernel shape(s)")
        return "\n".join(lines)

    # ---------------- execution ----------------

    def load_params(self, generator: torch.Generator | None = None
                    ) -> "Deployment":
        """Initialize model weights on the deployment's device
        (idempotent unless ``generator`` is given)."""
        if self.params is None or generator is not None:
            self.params = self.model.init(generator, device=self.device)
            self._runner = None
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

    def simulate(self, frames: int = 64):
        """Closed-form steady-state report for the plan (Table 5
        quantities)."""
        from ..core.simulate import simulate
        return simulate(self.pico.pipeline, frames, cluster=self.cluster)

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

    def save_trace(self, path: str | os.PathLike) -> str:
        """Write the lifecycle trace as Perfetto-loadable Chrome-trace
        JSON (one process row per device); returns the path."""
        return self.tracer.save(path)

    # ---------------- online forms ----------------

    def runtime(self, deploy_spec: DeploySpec | None = None, *,
                churn: Sequence = (), real_compute: bool | None = None):
        """Event-driven cluster runtime over this plan (no re-planning
        up front), with real compute on the deployment's device.

        ``real_compute`` defaults to "yes iff params are loaded"; pass
        ``False`` for a timing-only run on a deployment that has
        weights."""
        from ..runtime.executor import PipelineRuntime
        spec = deploy_spec or DeploySpec()
        real = (self.params is not None if real_compute is None
                else real_compute)
        if real and self.params is None:
            self.load_params()
        kw = dict(cluster=self.cluster, pico=self.pico,
                  config=spec.to_runtime_config(), churn=churn,
                  plan_spec=self.plan_spec, exec_spec=self.exec_spec,
                  cost_table=self.cost_table)
        if spec.trace:
            kw["tracer"] = self.tracer       # append to the lifecycle trace
        if spec.metrics:
            kw["metrics"] = self.metrics     # publish into this deployment
        if real:
            return PipelineRuntime(model=self.model, params=self.params,
                                   device=self.device, **kw)
        return PipelineRuntime(g=self.model.graph,
                               input_size=self.model.input_size, **kw)

    def server(self, deploy_spec: DeploySpec | None = None, *,
               streaming: bool = False, churn: Sequence = ()):
        """Serving front-end over this plan on the deployment's device:
        the closed-form :class:`~repro_torch.serving.server.PipelineServer`,
        or (with ``streaming=True``) the runtime-backed streaming
        server.  Weights loaded here carry over; ``load()`` draws the
        seeded default otherwise."""
        from ..serving.server import PipelineServer, StreamingPipelineServer
        kw = dict(plan_spec=self.plan_spec, exec_spec=self.exec_spec,
                  cost_table=self.cost_table, pico=self.pico,
                  device=self.device)
        if streaming:
            srv = StreamingPipelineServer(
                self.model, self.cluster, deploy_spec=deploy_spec
                or DeploySpec(), churn=churn, **kw)
        else:
            if deploy_spec is not None:
                raise TypeError("deploy_spec applies to the runtime-backed "
                                "server; pass streaming=True (the "
                                "closed-form PipelineServer has no deploy "
                                "knobs)")
            if churn:
                raise TypeError("churn applies to the runtime-backed "
                                "server; pass streaming=True")
            srv = PipelineServer(self.model, self.cluster, **kw)
        if self.params is not None:
            srv.params = self.params
        return srv

    def fleet(self, dist_spec=None, **kw):
        """Real distributed execution of this deployment
        (:class:`~repro_torch.dist.launcher.DistLauncher`): one worker per
        pipeline stage — persistent threads or spawned processes per
        :class:`~repro_torch.api.specs.DistSpec` — each rebuilt from
        this deployment's versioned JSON artifact and computing on its
        device.  ``launcher.run(frames)`` executes and drains;
        ``repro_torch.dist.validate(dep)`` pins the outputs bit-identical
        to the in-process runner.

        Workers re-initialize weights deterministically from
        ``DistSpec.seed`` (the artifact ships no weights), so results
        match :meth:`run` under the same seeded params."""
        from ..dist.launcher import DistLauncher
        return DistLauncher(self, dist_spec, **kw)

    def scheduler(self, tenants: Sequence, config=None):
        """Multi-tenant scheduler co-hosting ``tenants``
        (:class:`~repro_torch.serving.scheduler.TenantConfig`) on this
        deployment's cluster and device, inheriting its exec spec and
        cost table."""
        from ..serving.scheduler import ServingScheduler
        return ServingScheduler(tenants, self.cluster, config=config,
                                exec_spec=self.exec_spec,
                                cost_table=self.cost_table,
                                device=self.device)

    # ---------------- re-planning ----------------

    def replan(self, cluster: Cluster) -> "Deployment":
        """Re-plan onto a changed cluster, reusing Algorithm 1's piece
        chain and any measured cost table (old deployment + new cluster
        -> new one, on the same device with the same weights).

        A :class:`~repro_torch.core.pipeline_dp.PlannerCache` is carried
        across the replan chain, so every hop after the first is the
        incremental hot path (``pico.source == "incremental"``)."""
        cache = getattr(self, "_planner_cache", None)
        if cache is None:
            cache = self._planner_cache = PlannerCache()
        pico = plan_with_spec(self.model.graph, cluster,
                              self.model.input_size, self.plan_spec,
                              partition=self.pico.partition,
                              cost_table=self.cost_table,
                              planner_cache=cache)
        dep = Deployment(self.model, cluster, self.plan_spec,
                         self.exec_spec, pico, cost_table=self.cost_table,
                         params=self.params, device=self.device)
        dep._planner_cache = cache
        return dep

    # ---------------- persistence ----------------

    def _payload(self) -> dict:
        return {
            "plan_spec": self.plan_spec.to_dict(),
            "exec_spec": artifacts.exec_spec_to_dict(self.exec_spec),
            "model": artifacts.model_to_dict(self.model),
            "cluster": artifacts.cluster_to_dict(self.cluster),
            "pico": artifacts.plan_to_dict(self.pico),
            "cost_table": (None if self.cost_table is None
                           else artifacts.cost_table_to_dict(self.cost_table)),
        }

    def to_dict(self) -> dict:
        return artifacts.envelope("deployment", self._payload())

    @classmethod
    def _from_payload(cls, p: Mapping, model=None, params=None,
                      device: str | torch.device = "cuda") -> "Deployment":
        return cls(
            model if model is not None else artifacts.model_from_dict(
                p["model"]),
            artifacts.cluster_from_dict(p["cluster"]),
            PlanSpec.from_dict(p["plan_spec"]),
            artifacts.exec_spec_from_dict(p["exec_spec"]),
            artifacts.plan_from_dict(p["pico"]),
            cost_table=(None if p.get("cost_table") is None
                        else artifacts.cost_table_from_dict(p["cost_table"])),
            params=params, device=torch.device(device))

    @classmethod
    def from_dict(cls, d: Mapping, model=None, params=None,
                  device: str | torch.device = "cuda") -> "Deployment":
        return cls._from_payload(artifacts.open_envelope(d, "deployment"),
                                 model=model, params=params, device=device)

    def to_json(self, **dump_kw) -> str:
        return artifacts.dumps_payload("deployment", self._payload(),
                                       **dump_kw)

    @classmethod
    def from_json(cls, s: str, model=None, params=None,
                  device: str | torch.device = "cuda") -> "Deployment":
        return cls._from_payload(artifacts.loads_payload("deployment", s),
                                 model=model, params=params, device=device)

    def save(self, path: str | os.PathLike) -> str:
        """Write the deployment artifact (plan + specs + model def +
        cluster + cost table) as versioned JSON; returns the path.

        Model *weights* are not part of the artifact — the plan ships as
        data, weights ship as checkpoints: reattach them with
        ``Deployment.load(path, params=...)``, or the loaded deployment
        draws ``model.init``'s seeded default on first use.  Neither is
        the device: ``load`` takes it."""
        with open(path, "w") as f:
            f.write(self.to_json(indent=1))
            f.write("\n")
        return os.fspath(path)

    @classmethod
    def load(cls, path: str | os.PathLike, model=None, params=None,
             device: str | torch.device = "cuda") -> "Deployment":
        """Rebuild a deployment from :meth:`save` output — this
        package's or the JAX package's — to run on ``device``.  Neither
        the planner, the calibrator nor the tuner runs: the plan, its
        measured cost table (tuned launch plans included, installed on
        construction) and the model definition all come from the
        artifact.  Pass ``model=`` to attach an existing model object
        instead of rebuilding one from the serialized graph, and
        ``params=`` to reattach weights (see :meth:`save`)."""
        with open(path) as f:
            return cls.from_json(f.read(), model=model, params=params,
                                 device=device)
