"""Request queues, admission control and tenant arbitration.

Pure scheduling-policy building blocks shared by the multi-tenant
:mod:`repro_torch.serving.scheduler`, the runtime's stage-0 continuous
batching, and the time-sliced baseline:

* :func:`coalesce` — pop up to ``max_batch`` items from a FIFO deque,
  dropping the ones whose ``deadline`` already passed (single source of
  truth for batch formation + deadline expiry);
* :class:`TenantQueue` — per-tenant admission control (bounded
  in-system occupancy) plus a standalone pending queue for drivers that
  do their own batching;
* :class:`WeightedArbiter` — stride scheduler: starvation-free,
  deterministic weighted selection across tenants;
* :class:`OpenLoopGenerator` — seeded open-loop arrival process
  (Poisson, optionally bursty) for serving-under-load experiments.

No torch imports here: everything is host-side and cheap enough to sit
on the event loop's hot path.

A copy of the JAX package's ``serving/queueing.py``.  ``WeightedArbiter``
is copied as it is, with the fault that the JAX package's
``test_arbiter_no_starvation`` finds (ROADMAP Queue 3): every tenant
starts at pass 0, so each light tenant takes a grant before a heavy
one's second, and over a short horizon the heavy tenant lags its share
by more than one grant (weights 14, 0.5, 0.5, 0.5 over 10 rounds: 7
grants where the bound asks at least 8).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..data.pipeline import Request
# the batch-formation primitive lives with the event executor (runtime
# must not import serving); this module is its policy-facing home
from ..runtime.executor import coalesce

__all__ = ["coalesce", "TenantQueue", "WeightedArbiter",
           "OpenLoopGenerator"]


@dataclass
class TenantQueue:
    """Admission-controlled request queue for one tenant.

    ``in_system`` counts requests admitted but not yet completed or
    expired (queued *or* in flight); :meth:`offer` rejects when it would
    exceed ``max_queue``.  The ``pending`` deque is for standalone
    drivers (the time-sliced baseline, property tests) that pop batches
    themselves — the event scheduler instead admits straight into its
    runtime and only uses the occupancy accounting.
    """

    max_queue: float = float("inf")
    in_system: int = 0
    admitted: int = 0
    rejected: int = 0
    expired: int = 0
    completed: int = 0
    pending: deque = field(default_factory=deque)

    def offer(self, item=None) -> bool:
        """Admit or reject one request; admitted requests (when given)
        are appended to ``pending``."""
        if self.in_system >= self.max_queue:
            self.rejected += 1
            return False
        self.in_system += 1
        self.admitted += 1
        if item is not None:
            self.pending.append(item)
        return True

    def complete(self) -> None:
        assert self.in_system > 0, "complete() without a matching offer()"
        self.in_system -= 1
        self.completed += 1

    def expire(self) -> None:
        assert self.in_system > 0, "expire() without a matching offer()"
        self.in_system -= 1
        self.expired += 1

    def pop_batch(self, now: float, max_batch: int):
        """Standalone-mode batch formation over ``pending`` (admission
        accounting updated for the expired items)."""
        batch, expired = coalesce(self.pending, now, max_batch)
        for _ in expired:
            self.expire()
        return batch, expired

    def __len__(self) -> int:
        return len(self.pending)


class WeightedArbiter:
    """Stride scheduler over a set of named tenants.

    Each tenant advances a virtual ``pass`` by ``1/weight`` per grant;
    :meth:`pick` selects the eligible tenant with the lowest pass, so
    grants converge to weight proportions and every eligible tenant with
    positive weight is granted within a bounded interval (no
    starvation).  Deterministic: ties break by registration order.
    """

    def __init__(self, weights: dict[str, float] | None = None):
        self._stride: dict[str, float] = {}
        self._pass: dict[str, float] = {}
        self._order: dict[str, int] = {}
        self.grants: dict[str, int] = {}
        for name, w in (weights or {}).items():
            self.add(name, w)

    def add(self, name: str, weight: float) -> None:
        if weight <= 0 or not math.isfinite(weight):
            raise ValueError(f"weight for {name!r} must be finite > 0")
        self._stride[name] = 1.0 / weight
        # join at the current minimum pass so a new tenant neither
        # monopolizes nor waits out everyone else's accumulated credit
        floor = min(self._pass.values(), default=0.0)
        self._pass[name] = max(self._pass.get(name, floor), floor)
        self._order.setdefault(name, len(self._order))
        self.grants.setdefault(name, 0)

    def remove(self, name: str) -> None:
        self._stride.pop(name, None)
        self._pass.pop(name, None)

    def pick(self, eligible=None) -> str | None:
        names = [n for n in self._stride
                 if eligible is None or n in eligible]
        if not names:
            return None
        name = min(names, key=lambda n: (self._pass[n], self._order[n]))
        self._pass[name] += self._stride[name]
        self.grants[name] = self.grants.get(name, 0) + 1
        return name


@dataclass
class OpenLoopGenerator:
    """Seeded open-loop arrival process (arrivals do not wait for
    completions — the load the paper's camera would offer).

    Base process is Poisson at ``rate_per_s``; with ``burst_period_s``
    set, the first ``burst_duty`` fraction of each period runs at
    ``rate_per_s * burst_factor`` (bursty traffic for admission-control
    and rebalance experiments).
    """

    rate_per_s: float
    seed: int = 0
    burst_factor: float = 1.0
    burst_period_s: float = 0.0
    burst_duty: float = 0.5

    def _rate_at(self, t: float) -> float:
        if self.burst_period_s <= 0.0 or self.burst_factor == 1.0:
            return self.rate_per_s
        phase = (t % self.burst_period_s) / self.burst_period_s
        return self.rate_per_s * (self.burst_factor
                                  if phase < self.burst_duty else 1.0)

    def arrivals(self, n: int, start: float = 0.0) -> list[float]:
        rng = np.random.default_rng(self.seed)
        t, out = start, []
        for _ in range(n):
            t += rng.exponential(1.0 / self._rate_at(t))
            out.append(t)
        return out

    def generate(self, n: int, make_payload=None,
                 start: float = 0.0) -> list[Request]:
        rng = np.random.default_rng(self.seed + 1)
        return [Request(i, t, None if make_payload is None
                        else make_payload(rng, i))
                for i, t in enumerate(self.arrivals(n, start))]
