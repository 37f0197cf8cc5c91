"""Fleet admission/routing: tenants -> cells, driven by load-EWMA.

A *cell* is one cluster that a :class:`~repro_torch.serving.scheduler.
ServingScheduler` (or the discrete-event runtime) would operate; the
router owns many and decides where each tenant lands.  Load per cell is
an EWMA of observed utilization samples — the same smoothing convention
the serving scheduler applies per tenant — normalized by cell capacity
so heterogeneous cells compare fairly.  Plans come from the shared
:class:`~repro_torch.fleet.registry.PlanRegistry`: admitting the same model
onto an identical cell anywhere in the fleet is a registry hit, and
device churn re-plans through the per-model incremental planner cache.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..api.specs import FleetSpec, PlanSpec
from ..core.cost import Cluster, CostTable
from ..core.planner import PicoPlan
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .registry import PlanRegistry


@dataclass
class Tenant:
    """One admitted workload: a graph carrier + its planner knobs."""

    name: str
    model: object                      # .graph / .input_size carrier
    weight: float = 1.0                # relative demand (frames/s share)
    spec: PlanSpec | None = None


@dataclass
class Cell:
    """One cluster plus its routing state."""

    name: str
    cluster: Cluster
    tenants: list[Tenant] = field(default_factory=list)
    load_ewma: float | None = None     # smoothed utilization in [0, ~1]

    @property
    def capacity(self) -> float:
        return self.cluster.total_capacity

    @property
    def load(self) -> float:
        return self.load_ewma if self.load_ewma is not None else 0.0


@dataclass
class Admission:
    """Outcome of routing one tenant."""

    tenant: str
    cell: str
    plan: PicoPlan

    @property
    def plan_source(self) -> str:
        return self.plan.source


class FleetRouter:
    """Routes tenant admissions across cells and keeps their plans.

    ``observe(cell, utilization)`` feeds the load-EWMA (wire it to the
    serving tier's utilization signal); ``admit`` places a tenant by
    the :class:`~repro_torch.api.specs.FleetSpec` policy and returns the
    plan with honest provenance (``registry`` on a registry hit,
    ``incremental``/``scratch`` otherwise).  ``churn`` swaps a cell's
    cluster (device join/leave) and re-plans its tenants through the
    registry — the incremental planner path.
    """

    def __init__(self, clusters: dict[str, Cluster],
                 spec: FleetSpec | None = None,
                 registry: PlanRegistry | None = None,
                 cost_table: CostTable | None = None,
                 metrics=None):
        if not clusters:
            raise ValueError("FleetRouter needs at least one cluster")
        self.spec = spec or FleetSpec()
        self._metrics = (metrics if metrics is not None
                         else obs_metrics.default_registry())
        self.registry = (registry if registry is not None
                         else PlanRegistry(self.spec.registry_capacity,
                                           metrics=self._metrics))
        self.cost_table = cost_table
        self.cells: dict[str, Cell] = {name: Cell(name, c)
                                       for name, c in clusters.items()}
        self.plans: dict[str, PicoPlan] = {}      # tenant name -> plan
        # round-robin cursor: the last cell *name* served.  Keying on
        # the name (not an integer index into sorted(cells)) keeps the
        # rotation stable across add_cell/remove_cell — an index would
        # silently land on a different cell once the sorted sequence
        # shifts, skewing or repeating placements.
        self._rr_last: str | None = None

    # -- load signal ----------------------------------------------------
    def observe(self, cell: str, utilization: float) -> float:
        """Feed one utilization sample into a cell's load-EWMA."""
        c = self.cells[cell]
        beta = self.spec.ewma_beta
        c.load_ewma = (utilization if c.load_ewma is None
                       else beta * utilization + (1.0 - beta) * c.load_ewma)
        self._metrics.gauge("fleet.cell.load", cell=cell).set(c.load_ewma)
        return c.load_ewma

    def observe_report(self, cell: str, report) -> float:
        """Feed *real execution telemetry* into a cell's load-EWMA.

        Accepts either online tier's end-of-run report and derives the
        utilization sample the router's smoothing expects:

        * a :class:`~repro_torch.dist.launcher.DistReport` (or anything with
          a ``utilization()`` method) — worker compute seconds over
          worker wall capacity;
        * a :class:`~repro_torch.serving.scheduler.ServeReport` — summed
          ``device_busy_s`` over ``len(devices) * makespan``.

        This closes the plan/route/execute loop: the same artifact that
        validates an execution also steers where the next tenant lands.
        """
        util = getattr(report, "utilization", None)
        if callable(util):
            sample = float(util())
        elif (hasattr(report, "device_busy_s")
              and hasattr(report, "makespan")):
            busy = report.device_busy_s
            span = report.makespan
            sample = (sum(busy.values()) / (len(busy) * span)
                      if busy and span > 0 else 0.0)
        else:
            raise TypeError(
                f"observe_report wants a DistReport/ServeReport-like "
                f"object, got {type(report).__name__}")
        return self.observe(cell, min(1.0, max(0.0, sample)))

    def _demand_load(self, cell: Cell) -> float:
        """Static fallback load when no utilization was observed yet:
        admitted tenant weight per unit capacity, fleet-normalized.
        A degraded/empty cell (zero capacity) is infinitely loaded —
        never a routing target, never a ZeroDivisionError."""
        if cell.capacity <= 0:
            return float("inf")
        total_cap = sum(c.capacity for c in self.cells.values())
        scale = total_cap / len(self.cells)
        return sum(t.weight for t in cell.tenants) / (cell.capacity / scale)

    def cell_load(self, cell: str) -> float:
        c = self.cells[cell]
        return c.load_ewma if c.load_ewma is not None else self._demand_load(c)

    # -- routing --------------------------------------------------------
    def _pick(self, tenant: Tenant) -> Cell:
        # zero-capacity cells (degraded/empty clusters) are not routable:
        # they cannot host a plan, and pricing one divides by capacity
        names = [n for n in sorted(self.cells)
                 if self.cells[n].capacity > 0]
        if not names:
            raise ValueError(
                f"no routable cell for tenant {tenant.name!r}: all "
                f"{len(self.cells)} cell(s) have zero capacity")
        if self.spec.routing == "round_robin":
            # resume after the last *name* served (wrapping), so the
            # rotation survives topology changes
            if self._rr_last is None:
                name = names[0]
            else:
                name = next((n for n in names if n > self._rr_last),
                            names[0])
            self._rr_last = name
            return self.cells[name]
        # least_loaded: smoothed load, capacity-normalized; name breaks ties
        return self.cells[min(names, key=lambda n: (self.cell_load(n), n))]

    def admit(self, tenant: Tenant) -> Admission:
        """Place a tenant on a cell and plan it (registry-first)."""
        cell = self._pick(tenant)
        with obs_trace.current().wall_span(
                "fleet.route", tenant=tenant.name, cell=cell.name,
                policy=self.spec.routing):
            plan = self.registry.get_or_plan(
                tenant.model, cell.cluster, tenant.spec,
                cost_table=self.cost_table)
            cell.tenants.append(tenant)
            self.plans[tenant.name] = plan
            self._metrics.counter("fleet.admissions",
                                  source=plan.source).inc()
        return Admission(tenant.name, cell.name, plan)

    def evict(self, tenant_name: str) -> Tenant | None:
        """Remove a tenant from whichever cell holds it."""
        for cell in self.cells.values():
            for t in cell.tenants:
                if t.name == tenant_name:
                    cell.tenants.remove(t)
                    self.plans.pop(tenant_name, None)
                    return t
        return None

    # -- churn / topology -----------------------------------------------
    def churn(self, cell_name: str, cluster: Cluster) -> dict[str, PicoPlan]:
        """Replace a cell's cluster (device join/leave/degrade) and
        re-plan its tenants.  Known cluster signatures are registry
        hits; new ones re-plan incrementally off the per-model
        :class:`~repro_torch.core.pipeline_dp.PlannerCache`."""
        cell = self.cells[cell_name]
        cell.cluster = cluster
        replanned = {}
        # same observability contract as admit: one fleet.route span per
        # re-planned tenant (policy="churn") and a plan-source counter,
        # so repartition audits see churn-driven plans too
        with obs_trace.current().wall_span(
                "fleet.churn", cell=cell_name, tenants=len(cell.tenants)):
            for t in cell.tenants:
                with obs_trace.current().wall_span(
                        "fleet.route", tenant=t.name, cell=cell_name,
                        policy="churn"):
                    plan = self.registry.get_or_plan(
                        t.model, cluster, t.spec,
                        cost_table=self.cost_table)
                    self.plans[t.name] = plan
                    replanned[t.name] = plan
                    self._metrics.counter("fleet.replans",
                                          source=plan.source).inc()
        return replanned

    def add_cell(self, name: str, cluster: Cluster) -> Cell:
        if name in self.cells:
            raise ValueError(f"cell {name!r} already exists")
        if (self.spec.max_clusters is not None
                and len(self.cells) >= self.spec.max_clusters):
            raise ValueError(f"fleet is at max_clusters="
                             f"{self.spec.max_clusters}")
        cell = Cell(name, cluster)
        self.cells[name] = cell
        return cell

    def remove_cell(self, name: str) -> list[Admission]:
        """Drain a cell: its tenants are re-admitted elsewhere."""
        if len(self.cells) <= self.spec.min_clusters:
            raise ValueError(f"fleet is at min_clusters="
                             f"{self.spec.min_clusters}")
        cell = self.cells.pop(name)
        moved = []
        for t in cell.tenants:
            self.plans.pop(t.name, None)
            moved.append(self.admit(t))
        return moved
