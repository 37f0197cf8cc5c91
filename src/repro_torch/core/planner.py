"""PICO facade: model graph + cluster -> executable PipelinePlan.

The two-step optimization of the paper:
  1. Algorithm 1: orchestrate the DAG into a chain of pieces.
  2. Algorithm 2 on the homogenized cluster (Eq. 14), then Algorithm 3
     to adapt to the true heterogeneous devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..api._compat import _UNSET, pick, unset, warn_legacy
from ..api.specs import PlanSpec
from ..obs import trace as obs_trace
from .graph import Graph
from .cost import Cluster, CostTable, stage_cost
from .partition import (Piece, PartitionResult, partition_graph,
                        partition_graph_dnc)
from .pipeline_dp import PipelineDP, PipelinePlan, PlannerCache, StagePlan
from .hetero import adjust_stages

# Provenance of a PicoPlan (threaded through ServeReport's repartition
# audit and the fleet registry):
#   scratch     — full Algorithm 1 + 2 + 3 run, nothing reused
#   incremental — piece chain and/or PlannerCache state reused; only
#                 device-dependent work re-ran
#   registry    — an identical (model, cluster, spec) plan was served
#                 from a fleet PlanRegistry without planning at all
PLAN_SOURCES = ("scratch", "incremental", "registry")


@dataclass
class PicoPlan:
    partition: PartitionResult
    pipeline: PipelinePlan
    source: str = "scratch"
    # objective provenance: the ObjectiveSpec label this plan was scored
    # under (None = legacy pure-throughput planning).  Rides through the
    # plan artifact codec and Deployment.describe().
    objective: str | None = None

    def __post_init__(self):
        if self.source not in PLAN_SOURCES:
            raise ValueError(f"source must be one of {PLAN_SOURCES}, "
                             f"got {self.source!r}")
        if self.objective is not None and not isinstance(self.objective, str):
            raise ValueError("objective must be None or a label string, "
                             f"got {self.objective!r}")

    @property
    def period(self) -> float:
        return self.pipeline.period

    @property
    def latency(self) -> float:
        return self.pipeline.latency

    @property
    def throughput(self) -> float:
        return self.pipeline.throughput


def plan_with_spec(
    g: Graph,
    cluster: Cluster,
    input_size: tuple[int, int],
    spec: PlanSpec | None = None,
    *,
    pieces: Sequence[Piece] | None = None,
    partition: PartitionResult | None = None,
    cost_table: CostTable | None = None,
    planner_cache: PlannerCache | None = None,
) -> PicoPlan:
    """Run the full PICO optimization under a :class:`PlanSpec`.

    This is the one implementation every entry point (the ``repro.api``
    facade, the legacy :func:`plan`/:func:`replan` shims, the runtime's
    churn re-planner, the serving scheduler) funnels into.

    Algorithm 1 may be skipped by supplying either raw ``pieces`` (an
    honest :class:`PartitionResult` is derived via
    :meth:`PartitionResult.from_pieces`) or a full ``partition`` whose
    search stats are carried through — re-plans reuse the piece chain
    without fabricating degenerate partition metadata.  ``cost_table``
    (from ``exec.calibrate``) substitutes measured per-segment compute
    costs for the analytic alpha model in every stage costing.

    ``planner_cache`` (a :class:`~repro.core.pipeline_dp.PlannerCache`
    owned by the caller and passed to every re-plan of the same model)
    turns Algorithm 2 into the incremental hot path: segment geometry
    survives device churn, and the resulting plan's ``source`` is
    ``"incremental"`` whenever cached work was actually reused.

    ``spec.objective`` (an :class:`~repro.api.specs.ObjectiveSpec`)
    makes the DP score candidates by the weighted multi-objective
    scalarization and enforce its hard constraints: a finite
    ``max_latency_s`` tightens ``t_lim``, a finite ``max_memory_bytes``
    prunes memory-violating stage shapes inside the DP.  The default
    (``None`` / pure-throughput) leaves planning bit-identical to the
    legacy single-objective path.
    """
    spec = spec or PlanSpec()
    obj = spec.objective
    t_lim = spec.t_lim
    if obj is not None:
        t_lim = min(t_lim, obj.max_latency_s)
    with obs_trace.current().wall_span(
            "plan", n_devices=len(cluster), n_layers=len(g.layers),
            reuse_partition=partition is not None or pieces is not None,
            measured_costs=cost_table is not None):
        if partition is not None:
            if pieces is not None:
                raise ValueError("pass pieces= or partition=, not both")
            part = PartitionResult.from_pieces(
                partition.pieces, states_explored=partition.states_explored,
                wall_time_s=partition.wall_time_s)
        elif pieces is not None:
            part = PartitionResult.from_pieces(pieces)
        else:
            n_split = spec.resolve_n_split(len(cluster))
            if len(g.layers) > spec.dnc_threshold:
                part = partition_graph_dnc(g, input_size, n_split,
                                           spec.max_diameter)
            else:
                part = partition_graph(g, input_size, n_split,
                                       spec.max_diameter)

        # a cache is "warm" when it already holds geometry for this
        # exact chain — only then is the plan genuinely incremental
        warm = (planner_cache is not None and len(planner_cache) > 0
                and planner_cache.sig == PlannerCache.chain_signature(
                    g, part.pieces, input_size))
        homo = cluster.homogenized()
        dp = PipelineDP(g, part.pieces, homo, input_size, t_lim,
                        cost_table=cost_table, cache=planner_cache,
                        objective=obj)
        homo_plan = dp.build()
        final = adjust_stages(homo_plan, cluster, g, input_size,
                              cost_table=cost_table)
    return PicoPlan(part, final,
                    source="incremental" if warm else "scratch",
                    objective=obj.label() if obj is not None else None)


def plan(
    g: Graph,
    cluster: Cluster,
    input_size: tuple[int, int],
    t_lim: float = _UNSET,
    max_diameter: int = _UNSET,
    n_split: int | None = _UNSET,
    dnc_threshold: int = _UNSET,
    pieces: Sequence[Piece] | None = None,
    cost_table: CostTable | None = None,
    spec: PlanSpec | None = None,
) -> PicoPlan:
    """Run the full PICO optimization.

    Planner knobs live in ``spec`` (:class:`~repro.api.specs.PlanSpec`);
    the individual ``t_lim``/``max_diameter``/``n_split``/
    ``dnc_threshold`` keywords are a deprecated compatibility surface
    that maps onto an equivalent spec.  ``pieces`` skips Algorithm 1
    with a caller-supplied chain; ``cost_table`` substitutes measured
    per-segment compute costs for the analytic alpha model.
    """
    legacy = not unset(t_lim, max_diameter, n_split, dnc_threshold)
    if spec is not None:
        if legacy:
            raise TypeError("pass either spec= or the legacy planner "
                            "kwargs, not both")
    else:
        if legacy:
            warn_legacy("repro.core.plan",
                        "plan(g, cluster, input_size, spec=PlanSpec(...))")
        spec = PlanSpec(t_lim=pick(t_lim, float("inf")),
                        max_diameter=pick(max_diameter, 5),
                        n_split=pick(n_split, None),
                        dnc_threshold=pick(dnc_threshold, 120))
    return plan_with_spec(g, cluster, input_size, spec, pieces=pieces,
                          cost_table=cost_table)


def replan(
    g: Graph,
    cluster: Cluster,
    input_size: tuple[int, int],
    prev: PicoPlan,
    t_lim: float = _UNSET,
    cost_table: CostTable | None = None,
    spec: PlanSpec | None = None,
    planner_cache: PlannerCache | None = None,
) -> PicoPlan:
    """Incremental re-plan after a cluster change (runtime feedback loop).

    Algorithm 1's piece chain depends only on the graph, so it is reused
    from ``prev`` verbatim (search stats carried through); only the
    device-dependent steps re-run (Algorithm 2's DP over the homogenized
    cluster + Algorithm 3's heterogeneous adjustment).  ``cluster`` is
    expected to carry *measured* costs — e.g.
    ``Monitor.calibrated_cluster`` scales each device's alpha by its
    observed/modeled EWMA — so successive re-plans optimize against the
    cluster as it behaves, not as it was specced.
    """
    if spec is not None:
        if not unset(t_lim):
            raise TypeError("pass either spec= or t_lim=, not both")
    else:
        if not unset(t_lim):
            warn_legacy("repro.core.replan",
                        "replan(..., spec=PlanSpec(...))")
        spec = PlanSpec(t_lim=pick(t_lim, float("inf")))
    return plan_with_spec(g, cluster, input_size, spec,
                          partition=prev.partition, cost_table=cost_table,
                          planner_cache=planner_cache)


@dataclass
class TenantShare:
    """One tenant's slice of a partitioned cluster."""

    index: int
    cluster: Cluster
    pico: PicoPlan

    @property
    def capacity(self) -> float:
        return self.cluster.total_capacity

    @property
    def device_names(self) -> frozenset[str]:
        return frozenset(d.name for d in self.cluster.devices)


@dataclass
class ClusterPartition:
    shares: list[TenantShare]
    weights: list[float]

    @property
    def aggregate_throughput(self) -> float:
        """Modeled frames/s summed across tenants (each sub-pipeline
        saturated)."""
        return sum(1.0 / s.pico.period for s in self.shares
                   if s.pico.period > 0)

    def assignment(self) -> dict[int, tuple[str, ...]]:
        return {s.index: tuple(d.name for d in s.cluster.devices)
                for s in self.shares}


def split_devices(cluster: Cluster, weights: Sequence[float]) -> list[list]:
    """Device-split step of :func:`partition_cluster` (no planning):
    every tenant gets one device (biggest devices to biggest weights),
    then each remaining device goes largest-first to the tenant most
    below its weighted capacity target.  Cheap enough for a control
    loop to test whether a re-partition would change anything."""
    n = len(weights)
    w = [float(x) for x in weights]
    if n == 0 or any(x <= 0 for x in w):
        raise ValueError("weights must be positive, one per tenant")
    if len(cluster.devices) < n:
        raise ValueError(f"{n} tenants need >= {n} devices, cluster has "
                         f"{len(cluster.devices)}")
    total_w = sum(w)
    total_cap = cluster.total_capacity
    devs = cluster.sorted_by_capacity()
    order = sorted(range(n), key=lambda i: -w[i])
    buckets: list[list] = [[] for _ in range(n)]
    cap = [0.0] * n
    for slot, ti in enumerate(order):
        buckets[ti].append(devs[slot])
        cap[ti] += devs[slot].capacity
    for d in devs[n:]:
        ti = min(range(n), key=lambda i: (cap[i] / (w[i] / total_w
                                                    * total_cap), i))
        buckets[ti].append(d)
        cap[ti] += d.capacity
    return buckets


def partition_cluster(
    models: Sequence,
    cluster: Cluster,
    weights: Sequence[float] | None = None,
    t_lims: Sequence[float] | None = None,
    cost_table: CostTable | None = None,
    prev: Sequence[PicoPlan | None] | None = None,
    plan_specs: Sequence[PlanSpec | None] | None = None,
    plan_fn=None,
) -> ClusterPartition:
    """Split one cluster's devices across several co-hosted models and
    run the PICO optimization on each sub-cluster (the many-to-many
    mapping lifted to multi-tenant serving).

    ``models`` are graph carriers (``CNNDef`` or anything with
    ``.graph`` and ``.input_size``); ``weights`` are relative capacity
    entitlements (tenant priority x observed load), defaulting to equal.
    Every tenant gets at least one device; remaining devices go
    largest-first to the tenant most below its weighted capacity
    target.  ``prev[i]`` (a prior :class:`PicoPlan` for model ``i``)
    reuses Algorithm 1's piece chain so load-shift re-partitions only
    redo the device-dependent planning steps.  ``plan_specs[i]`` carries
    tenant ``i``'s planner knobs; ``t_lims`` is the legacy equivalent
    (ignored where a spec is given).

    ``plan_fn(i, model, sub_cluster, spec, prev_plan) -> PicoPlan``
    overrides how each share is planned — the hook the serving scheduler
    and fleet tier use to route through per-tenant
    :class:`~repro.core.pipeline_dp.PlannerCache` instances or a fleet
    :class:`~repro.fleet.registry.PlanRegistry`.
    """
    n = len(models)
    if n == 0:
        raise ValueError("partition_cluster needs at least one model")
    w = [1.0] * n if weights is None else [float(x) for x in weights]
    if len(w) != n:
        raise ValueError("weights must be positive, one per model")
    buckets = split_devices(cluster, w)

    shares = []
    for i, bucket in enumerate(buckets):
        sub = cluster.restricted(bucket)
        m = models[i]
        spec = plan_specs[i] if plan_specs is not None else None
        if spec is None:
            t_lim = t_lims[i] if t_lims is not None else float("inf")
            spec = PlanSpec(t_lim=t_lim)
        prev_i = prev[i] if prev is not None else None
        if plan_fn is not None:
            pico = plan_fn(i, m, sub, spec, prev_i)
        else:
            pico = plan_with_spec(
                m.graph, sub, m.input_size, spec,
                partition=prev_i.partition if prev_i is not None else None,
                cost_table=cost_table)
        shares.append(TenantShare(i, sub, pico))
    return ClusterPartition(shares, w)


def recost(
    pipeline: PipelinePlan,
    cluster: Cluster,
    g: Graph,
    input_size: tuple[int, int],
    cost_table: CostTable | None = None,
) -> PipelinePlan:
    """Re-price an existing plan under new device costs, keeping the
    stage -> device assignment.  Lets a re-planner compare the incumbent
    plan against a fresh one on equal (measured) footing — the DP must
    use every device, so e.g. after a DeviceJoin the fresh plan can
    legitimately lose to the incumbent."""
    full = g.forward_sizes(input_size)
    by_name = {d.name: d for d in cluster.devices}
    stages = []
    for st in pipeline.stages:
        devs = [by_name.get(d.name, d) for d in st.devices]
        sc = stage_cost(g, st.nodes, full, input_size, devs, cluster,
                        list(st.fractions), cost_table=cost_table)
        stages.append(StagePlan(st.first_piece, st.last_piece, devs,
                                st.nodes, sc, list(st.fractions)))
    period = max(s.cost.total for s in stages)
    latency = sum(s.cost.total for s in stages)
    return PipelinePlan(stages, period, latency, pipeline.wall_time_s)
