"""``repro_torch.fleet`` — the tier above one :class:`ServingScheduler`.

Production scale is thousands of clusters serving the same handful of
models: planning must not be redone per cluster.  This package supplies

* :class:`~repro_torch.fleet.registry.PlanRegistry` — an LRU cache of
  finished :class:`~repro_torch.core.planner.PicoPlan` artifacts keyed by
  ``(model fingerprint, cluster signature, PlanSpec, CostTable)``, so
  an identical cluster anywhere in the fleet gets its plan without
  running the optimizer (DynO's serialized plan hand-off, fleet-wide),
  optionally backed by a :class:`~repro_torch.fleet.store.PlanStore` — a
  shared directory of versioned artifacts (atomic-rename writes) that
  makes hits survive process boundaries;
* :class:`~repro_torch.fleet.router.FleetRouter` — admission/routing of
  tenants across cells driven by the same load-EWMA convention the
  serving scheduler uses, with device-churn handling that re-plans
  through per-model :class:`~repro_torch.core.pipeline_dp.PlannerCache`
  instances (the incremental planner hot path);
* :class:`~repro_torch.fleet.autoscale.Autoscaler` — watermark policy over
  smoothed cell load with provision/decommission hooks.

Everything is configured by one frozen
:class:`~repro_torch.api.specs.FleetSpec` and observable through
``repro_torch.obs`` (``fleet.*`` metrics, ``registry.lookup`` /
``fleet.route`` / ``fleet.autoscale`` spans).
"""

from .registry import PlanRegistry, cluster_signature, fingerprint_model
from .router import Admission, Cell, FleetRouter, Tenant
from .autoscale import Autoscaler, ScaleDecision
from .store import PlanStore

__all__ = [
    "Admission", "Autoscaler", "Cell", "FleetRouter", "PlanRegistry",
    "PlanStore", "ScaleDecision", "Tenant", "cluster_signature",
    "fingerprint_model",
]
