"""Runtime monitor: EWMA of observed stage times -> calibrated cluster.

Every finished compute phase reports (device, modeled seconds, observed
seconds).  The per-device EWMA of observed/modeled is exactly the
correction the cost model's regression coefficient alpha_k (Eq. 7)
should absorb: ``calibrated_cluster`` returns a cluster whose devices
carry ``alpha * ewma`` so that the *next* ``planner.plan`` call
optimizes against measured, not assumed, compute rates — the DynO-style
feedback loop (PAPERS.md).

The monitor publishes every sample into a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (``monitor.samples``
counter, per-stage ``stage.observed_s`` histograms, per-device
``monitor.ratio`` gauges) instead of keeping the numbers to itself —
the EWMA cells stay as the planner-facing view, the registry is the
export surface.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..core.cost import Cluster
from ..obs.metrics import NULL_REGISTRY


@dataclass
class EWMA:
    beta: float = 0.3           # weight of the newest sample
    value: float = 1.0
    n: int = 0

    def update(self, x: float) -> float:
        self.value = x if self.n == 0 else (
            self.beta * x + (1.0 - self.beta) * self.value)
        self.n += 1
        return self.value


@dataclass
class Monitor:
    beta: float = 0.3
    drift_threshold: float = 0.25   # |ewma - 1| beyond this = re-plan signal
    ratio: dict[str, EWMA] = field(default_factory=dict)
    stage_time: dict[int, EWMA] = field(default_factory=dict)
    samples: int = 0
    metrics: object = NULL_REGISTRY     # MetricsRegistry (or the no-op)

    def record(self, stage: int, device_name: str,
               modeled_s: float, observed_s: float) -> None:
        """Fold one (modeled, observed) compute sample into the EWMAs
        and publish it to the metrics registry.  ``modeled_s <= 0``
        contributes no ratio (there is nothing to normalize by) but
        still counts as a sample and a stage-time observation."""
        self.samples += 1
        if modeled_s > 0:
            ew = self.ratio.setdefault(device_name, EWMA(self.beta))
            ew.update(observed_s / modeled_s)
            self.metrics.gauge("monitor.ratio", device=device_name).set(
                ew.value)
        self.stage_time.setdefault(stage, EWMA(self.beta)).update(observed_s)
        m = self.metrics
        if m:
            m.counter("monitor.samples").inc()
            m.histogram("stage.observed_s", stage=stage).observe(observed_s)
            m.histogram("stage.modeled_s", stage=stage).observe(modeled_s)

    def device_ratio(self, name: str) -> float:
        ew = self.ratio.get(name)
        return ew.value if ew and ew.n else 1.0

    def drifted_devices(self) -> list[str]:
        return [n for n, ew in self.ratio.items()
                if ew.n and abs(ew.value - 1.0) > self.drift_threshold]

    def calibrated_cluster(self, cluster: Cluster) -> Cluster:
        """Cluster with alpha_k scaled by each device's measured ratio."""
        devs = [replace(d, alpha=d.alpha * self.device_ratio(d.name))
                for d in cluster.devices]
        return Cluster(devs, bandwidth=cluster.bandwidth,
                       pair_bandwidth=dict(cluster.pair_bandwidth))

    def reset_device(self, name: str) -> None:
        self.ratio.pop(name, None)
