"""Injected cluster-condition changes (the paper testbed's failure modes).

A churn schedule is a list of timestamped events; the executor applies
each at its virtual time.  DeviceLeave/DeviceJoin change membership and
force a re-plan at the next frame boundary; FreqScale models DVFS or
thermal throttling (the monitor detects the drift and triggers a
re-plan once its EWMA crosses the threshold); LinkDegrade models a
congested/lossy WLAN hop.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.cost import Device


@dataclass(frozen=True)
class ChurnEvent:
    time: float


@dataclass(frozen=True)
class DeviceLeave(ChurnEvent):
    device_name: str


@dataclass(frozen=True)
class DeviceJoin(ChurnEvent):
    device: Device


@dataclass(frozen=True)
class FreqScale(ChurnEvent):
    """Scale a device's clock: ``factor`` 0.5 = throttled to half speed."""
    device_name: str
    factor: float


@dataclass(frozen=True)
class LinkDegrade(ChurnEvent):
    """Multiply transfer times on one hop (or all, hop=None)."""
    factor: float
    hop: int | None = None
