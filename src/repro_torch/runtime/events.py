"""Deterministic discrete-event core for the cluster runtime.

A single virtual timeline: events are ordered by (time, seq) where
``seq`` is the insertion order, so two events at the same instant fire
in the order they were scheduled — runs are bit-reproducible for a
fixed seed regardless of host timing.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from enum import Enum, auto
from typing import Any


class EventKind(Enum):
    FRAME_ARRIVAL = auto()      # frame becomes available at a stage's input
    COMPUTE_DONE = auto()       # a stage finished the compute phase
    STAGE_DONE = auto()         # compute + comm done; stage frees, data moves
    CHURN = auto()              # injected cluster change (join/leave/...)
    MIGRATION_DONE = auto()     # re-plan state transfer finished
    # multi-tenant serving control plane (serving.scheduler)
    REQUEST_ARRIVAL = auto()    # a tenant request reaches admission control
    CONTROL_TICK = auto()       # periodic load / rebalance check
    TENANT_JOIN = auto()        # a tenant joins the serving fleet
    TENANT_LEAVE = auto()       # a tenant leaves; its devices are reclaimed
    REPARTITION_DONE = auto()   # cross-tenant device migration finished


@dataclass(order=True)
class Event:
    time: float
    seq: int
    kind: EventKind = field(compare=False)
    payload: dict[str, Any] = field(compare=False, default_factory=dict)
    cancelled: bool = field(compare=False, default=False)


class EventQueue:
    """Min-heap of events with lazy cancellation."""

    def __init__(self):
        self._heap: list[Event] = []
        self._seq = itertools.count()

    def push(self, time: float, kind: EventKind, **payload) -> Event:
        ev = Event(time, next(self._seq), kind, payload)
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event | None:
        while self._heap:
            ev = heapq.heappop(self._heap)
            if not ev.cancelled:
                return ev
        return None

    def peek(self) -> Event | None:
        """Earliest live event without removing it (cancelled entries are
        discarded on the way — heap order is unaffected)."""
        while self._heap:
            if self._heap[0].cancelled:
                heapq.heappop(self._heap)
                continue
            return self._heap[0]
        return None

    def __len__(self) -> int:
        return sum(1 for e in self._heap if not e.cancelled)

    def __bool__(self) -> bool:
        return len(self) > 0
