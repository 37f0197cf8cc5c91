"""Wireless-link models: bandwidth + latency + jitter per stage hop.

The planner's cost model (Eq. 9-10) charges each stage for its *intra*
stage scatter/gather from the stage head device d_f; the hand-off of
the gathered output to the next stage's head is what these links time.
The closed-form simulator treats that hand-off as free, so the default
("ideal") link reproduces the simulator exactly; realistic links expose
the cost the analytic model hides — jitter on a lossy WLAN, per-hop
latency, and mid-run degradation (churn).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class LinkModel:
    """One stage-to-stage hop.

    ``bandwidth`` is bytes/s for the inter-stage tensor transfer
    (``None`` = ideal hand-off, matching ``core.simulate``);
    ``latency_s`` is the fixed per-transfer cost; ``jitter_s`` the max
    of a uniform random extra delay.  ``degradation`` multiplies every
    transfer time (1.0 = healthy link); churn events raise it.
    """

    bandwidth: float | None = None
    latency_s: float = 0.0
    jitter_s: float = 0.0
    degradation: float = 1.0

    def transfer_time(self, nbytes: float, rng: np.random.Generator) -> float:
        t = self.latency_s
        if self.bandwidth:
            t += nbytes / self.bandwidth
        if self.jitter_s > 0.0:
            t += float(rng.uniform(0.0, self.jitter_s))
        return t * self.degradation


@dataclass
class LinkMap:
    """Per-hop link table with a shared default.

    Hop ``s`` connects stage ``s`` to stage ``s+1``; hop ``-1`` is the
    source -> stage 0 ingress (free by default, like the simulator).
    """

    default: LinkModel = field(default_factory=LinkModel)
    hops: dict[int, LinkModel] = field(default_factory=dict)

    def hop(self, s: int) -> LinkModel:
        return self.hops.get(s, self.default)

    def degrade(self, factor: float, hop: int | None = None) -> None:
        """Multiply transfer times by ``factor`` on one hop or all."""
        if hop is not None:
            lm = self.hops.setdefault(
                hop, LinkModel(self.default.bandwidth, self.default.latency_s,
                               self.default.jitter_s, self.default.degradation))
            lm.degradation *= factor
        else:
            self.default.degradation *= factor
            for lm in self.hops.values():
                lm.degradation *= factor
