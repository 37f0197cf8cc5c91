"""Watermark autoscaling over smoothed cell load.

The policy is deliberately simple and deterministic: a cell whose
load-EWMA exceeds :attr:`~repro_torch.api.specs.FleetSpec.scale_up_load`
wants capacity, one below
:attr:`~repro_torch.api.specs.FleetSpec.scale_down_load` is a drain
candidate.  The *mechanism* is delegated to hooks so the same policy
drives simulation and a real control plane:

* ``provision(router, decision) -> (name, Cluster) | None`` — supply a
  new cell (e.g. spin up hardware, or clone the overloaded cell's
  shape); returning ``None`` declines;
* ``decommission(router, decision) -> bool`` — approve draining the
  named cell (its tenants re-route through the registry, so the move
  costs admissions, not plans).

``evaluate()`` returns every decision (including holds) for the audit
trail and applies the approved ones, bounded by ``min_clusters`` /
``max_clusters``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .router import FleetRouter


@dataclass(frozen=True)
class ScaleDecision:
    cell: str
    action: str          # "scale_up" | "scale_down" | "hold"
    load: float
    applied: bool = False
    detail: str = ""


class Autoscaler:
    def __init__(self, router: FleetRouter, provision=None,
                 decommission=None, metrics=None):
        self.router = router
        self.provision = provision
        self.decommission = decommission
        self._metrics = (metrics if metrics is not None
                         else obs_metrics.default_registry())

    def evaluate(self) -> list[ScaleDecision]:
        spec = self.router.spec
        decisions: list[ScaleDecision] = []
        with obs_trace.current().wall_span(
                "fleet.autoscale", n_cells=len(self.router.cells)):
            for name in sorted(self.router.cells):
                load = self.router.cell_load(name)
                if load > spec.scale_up_load:
                    decisions.append(self._scale_up(name, load))
                elif load < spec.scale_down_load:
                    decisions.append(self._scale_down(name, load))
                else:
                    decisions.append(ScaleDecision(name, "hold", load))
        for d in decisions:
            if d.action != "hold":
                self._metrics.counter("fleet.autoscale.decisions",
                                      action=d.action,
                                      applied=str(d.applied).lower()).inc()
        return decisions

    def _scale_up(self, name: str, load: float) -> ScaleDecision:
        spec = self.router.spec
        if (spec.max_clusters is not None
                and len(self.router.cells) >= spec.max_clusters):
            return ScaleDecision(name, "scale_up", load,
                                 detail="at max_clusters")
        if self.provision is None:
            return ScaleDecision(name, "scale_up", load,
                                 detail="no provision hook")
        d = ScaleDecision(name, "scale_up", load)
        supplied = self.provision(self.router, d)
        if supplied is None:
            return ScaleDecision(name, "scale_up", load,
                                 detail="provision declined")
        new_name, cluster = supplied
        self.router.add_cell(new_name, cluster)
        return ScaleDecision(name, "scale_up", load, applied=True,
                             detail=f"added cell {new_name}")

    def _scale_down(self, name: str, load: float) -> ScaleDecision:
        spec = self.router.spec
        if len(self.router.cells) <= spec.min_clusters:
            return ScaleDecision(name, "scale_down", load,
                                 detail="at min_clusters")
        if self.decommission is None:
            return ScaleDecision(name, "scale_down", load,
                                 detail="no decommission hook")
        d = ScaleDecision(name, "scale_down", load)
        if not self.decommission(self.router, d):
            return ScaleDecision(name, "scale_down", load,
                                 detail="decommission declined")
        moved = self.router.remove_cell(name)
        return ScaleDecision(name, "scale_down", load, applied=True,
                             detail=f"drained {len(moved)} tenants")
