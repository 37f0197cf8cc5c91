"""Multi-objective planning: the Pareto front over PICO plans.

The single-objective planner (Algorithms 1-3) returns *the*
throughput-optimal plan.  This module sweeps the configuration space —
device-count subsets (largest devices first) x latency budgets — prices
every candidate with the simulate-derived steady-state metrics
(:func:`~repro_torch.core.simulate.plan_metrics`: period, latency, energy,
peak per-device memory), dominance-filters, and returns the whole
:class:`ParetoFront`.  A deployment then *selects* a point by objective
(:data:`~repro_torch.api.specs.OBJECTIVE_PRESETS` or a custom
:class:`~repro_torch.api.specs.ObjectiveSpec`) instead of baking one
objective into the planner.

The sweep is cheap by construction: every candidate shares one
Algorithm 1 piece chain and one
:class:`~repro_torch.core.pipeline_dp.PlannerCache`, so segment geometry —
the dominant planning cost — is computed once and every subsequent
candidate runs the vectorized incremental DP path.

Why the sweep axes create genuine trade-offs: fewer (large) devices
means fewer stages — less idle energy and no boundary traffic, at the
price of a longer period (throughput); tighter latency budgets force
the DP off the throughput optimum toward shallower pipelines.  Front
points therefore trade period against latency, energy and memory in
exactly the directions the paper's DVFS/ battery discussion predicts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Sequence

from ..api.specs import ObjectiveSpec, PlanSpec
from ..obs import trace as obs_trace
from .cost import Cluster, CostTable
from .pipeline_dp import PlannerCache
from .planner import PicoPlan, plan_with_spec
from .simulate import PlanMetrics, plan_metrics


def dominates(a: PlanMetrics, b: PlanMetrics) -> bool:
    """Pareto dominance (all metrics minimized): ``a`` is no worse on
    every axis and strictly better on at least one."""
    at, bt = a.as_tuple(), b.as_tuple()
    return all(x <= y for x, y in zip(at, bt)) and \
        any(x < y for x, y in zip(at, bt))


@dataclass(frozen=True)
class FrontPoint:
    """One non-dominated plan: the plan itself, its steady-state
    metrics, and the sweep coordinates that produced it."""

    plan: PicoPlan
    metrics: PlanMetrics
    n_devices: int
    t_lim: float = float("inf")

    @property
    def period(self) -> float:
        return self.metrics.period

    @property
    def latency(self) -> float:
        return self.metrics.latency

    @property
    def energy_j(self) -> float:
        return self.metrics.energy_j

    @property
    def memory_bytes(self) -> float:
        return self.metrics.memory_bytes


@dataclass
class ParetoFront:
    """Mutually non-dominated plans for one (model, cluster), sorted by
    (period, latency, energy, memory) — best throughput first, so
    ``points[0]`` is always the single-objective optimum."""

    points: list[FrontPoint] = field(default_factory=list)
    spec: PlanSpec = field(default_factory=PlanSpec)

    def __len__(self) -> int:
        return len(self.points)

    def __iter__(self):
        return iter(self.points)

    @property
    def throughput_optimum(self) -> FrontPoint:
        """The pure-throughput point (min period; ties on latency) —
        bit-identical to what ``plan_with_spec`` returns on its own.
        Metric ties break toward the full-cluster unconstrained sweep
        candidate (most devices, loosest budget), i.e. the plan the
        single-objective planner itself would return."""
        return min(self.points,
                   key=lambda p: (p.metrics.period, p.metrics.latency,
                                  -p.n_devices, -p.t_lim))

    def _utopia(self) -> PlanMetrics:
        """Elementwise minimum across the front — the normalization
        reference that makes objective weights unit-free."""
        return PlanMetrics(
            min(p.metrics.period for p in self.points),
            min(p.metrics.latency for p in self.points),
            min(p.metrics.energy_j for p in self.points),
            min(p.metrics.memory_bytes for p in self.points))

    def select(self, objective: ObjectiveSpec | str | None = None
               ) -> FrontPoint:
        """Pick the front point a given objective prefers.

        ``objective`` is an :class:`ObjectiveSpec`, a preset name
        (``"battery"``, ``"latency"``, ...), or ``None`` (throughput).
        Hard constraints filter first; an empty feasible set raises
        ``ValueError`` (the caller decides whether to relax).  Scoring
        normalizes every metric by the front's elementwise minimum so
        the weights compare like-for-like; ties break toward the
        lexicographically best metrics tuple.
        """
        if not self.points:
            raise ValueError("empty Pareto front")
        if objective is None:
            obj = ObjectiveSpec.named("throughput")
        elif isinstance(objective, str):
            obj = ObjectiveSpec.named(objective)
        else:
            obj = objective
        feasible = [p for p in self.points if obj.feasible(p.metrics)]
        if not feasible:
            raise ValueError(
                f"no front point satisfies the {obj.label()!r} objective's "
                f"constraints (front size {len(self.points)}); relax the "
                f"constraints or re-sweep with a tighter spec")
        ref = self._utopia()
        return min(feasible, key=lambda p: (obj.score(p.metrics, ref),
                                            p.metrics.as_tuple()))

    def deployment(self, model, cluster: Cluster, deploy_spec=None,
                   exec_spec=None, *, objective=None,
                   cost_table: CostTable | None = None,
                   device="cuda"):
        """Ship one front point as a ready
        :class:`~repro_torch.api.deployment.Deployment` that runs on
        ``device`` (``"cuda"`` unless the caller passes ``"cpu"``, as
        :func:`~repro_torch.api.deployment.compile`).

        The point is chosen by ``objective`` (spec, preset name, or
        ``None``), defaulting to ``deploy_spec.objective`` when the
        deploy spec names a profile.  The chosen plan carries the
        objective label as provenance (``PicoPlan.objective``), visible
        in ``describe()`` and the saved artifact.
        """
        import torch

        from ..api.deployment import Deployment   # lazy: avoid cycle
        from ..api.specs import ExecSpec
        if objective is None and deploy_spec is not None:
            objective = deploy_spec.objective
        point = self.select(objective)
        if objective is None:
            label = "throughput"
        elif isinstance(objective, str):
            label = objective
        else:
            label = objective.label()
        pico = _dc_replace(point.plan, objective=label)
        plan_spec = (self.spec if not math.isfinite(point.t_lim)
                     else self.spec.replace(t_lim=point.t_lim))
        dep = Deployment(model, cluster, plan_spec,
                         exec_spec or ExecSpec(), pico,
                         cost_table=cost_table, device=torch.device(device))
        return dep

    # -- persistence (versioned pareto_front artifact) ------------------
    def to_json(self, **dump_kw) -> str:
        from ..api import artifacts
        return artifacts.to_json("pareto_front", self, **dump_kw)

    @classmethod
    def from_json(cls, s: str) -> "ParetoFront":
        from ..api import artifacts
        return artifacts.from_json("pareto_front", s)


def _non_dominated(points: Sequence[FrontPoint]) -> list[FrontPoint]:
    """Dedup (identical metric tuples collapse to their first plan)
    then dominance-filter."""
    seen: dict[tuple, FrontPoint] = {}
    for p in points:
        seen.setdefault(p.metrics.as_tuple(), p)
    uniq = list(seen.values())
    return [p for p in uniq
            if not any(dominates(q.metrics, p.metrics) for q in uniq)]


def plan_front(
    model,
    cluster: Cluster,
    spec: PlanSpec | None = None,
    *,
    cost_table: CostTable | None = None,
    planner_cache: PlannerCache | None = None,
    t_lim_fractions: Sequence[float] = (0.85, 0.7, 0.55),
    min_devices: int = 1,
) -> ParetoFront:
    """Sweep the configuration space and return the Pareto front.

    Candidates: for every device count ``d`` from ``len(cluster)`` down
    to ``min_devices`` (keeping the ``d`` largest devices), the
    throughput-optimal plan plus one plan per latency budget in
    ``t_lim_fractions`` (fractions of that subset's unconstrained
    latency).  All candidates share ``spec``'s partition knobs, one
    piece chain, and one :class:`PlannerCache`, so everything after the
    first plan runs the incremental vectorized DP path.  The full-
    cluster unconstrained candidate is planned on ``cluster`` exactly
    as :func:`~repro_torch.core.planner.plan_with_spec` would, so the front
    always contains the single-objective optimum bit-identically.
    """
    spec = spec or PlanSpec()
    base = spec.replace(objective=None) if spec.objective is not None \
        else spec
    cache = planner_cache if planner_cache is not None else PlannerCache()
    g, input_size = model.graph, model.input_size
    D = len(cluster)
    lo = max(1, min(min_devices, D))
    with obs_trace.current().wall_span(
            "plan_front", n_devices=D, n_layers=len(g.layers),
            t_lims=len(t_lim_fractions)):
        by_cap = cluster.sorted_by_capacity()
        part = None
        candidates: list[FrontPoint] = []
        for d in range(D, lo - 1, -1):
            sub = cluster if d == D else cluster.restricted(by_cap[:d])
            pico = plan_with_spec(g, sub, input_size, base,
                                  partition=part, cost_table=cost_table,
                                  planner_cache=cache)
            if part is None:
                part = pico.partition
            candidates.append(FrontPoint(pico, plan_metrics(pico.pipeline),
                                         d, base.t_lim))
            for frac in t_lim_fractions:
                t = pico.latency * frac
                if not (t > 0 and math.isfinite(t)):
                    continue
                t = min(t, base.t_lim)
                tight = plan_with_spec(g, sub, input_size,
                                       base.replace(t_lim=t),
                                       partition=part,
                                       cost_table=cost_table,
                                       planner_cache=cache)
                if not tight.pipeline.feasible:
                    continue
                candidates.append(
                    FrontPoint(tight, plan_metrics(tight.pipeline), d, t))
        points = _non_dominated(candidates)
        points.sort(key=lambda p: p.metrics.as_tuple())
    return ParetoFront(points, spec)
