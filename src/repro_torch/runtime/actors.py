"""Device actors: per-device virtual clock, queues, memory and energy.

Each physical device in the cluster becomes a :class:`DeviceActor`.
Actors do not run threads — the event loop advances their virtual
clocks — but they own all per-device state: dynamic speed (DVFS churn
scales it), accumulated busy time, queue occupancy, peak memory against
a budget, and the energy integral of the paper's Fig. 16.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.cost import Device


@dataclass
class DeviceActor:
    device: Device
    speed: float = 1.0                  # DVFS factor: 0.5 = half clock
    mem_budget_bytes: float = float("inf")
    alive: bool = True

    clock: float = 0.0                  # virtual time this actor is free
    busy_s: float = 0.0
    frames_done: int = 0
    mem_peak_bytes: float = 0.0
    mem_violations: int = 0
    queue_peak: int = 0
    _queued: int = 0

    @property
    def name(self) -> str:
        return self.device.name

    @property
    def effective_capacity(self) -> float:
        return self.device.capacity * self.speed

    def compute_time(self, modeled_s: float, noise: float = 0.0) -> float:
        """Wall time for work modeled at nominal speed.

        ``noise`` is a multiplicative perturbation (measured vs modeled
        mismatch); the monitor's EWMA recovers ``(1 + noise) / speed``.
        """
        return modeled_s / max(self.speed, 1e-12) * (1.0 + noise)

    def enqueue(self) -> None:
        self._queued += 1
        self.queue_peak = max(self.queue_peak, self._queued)

    def start_work(self, start: float, duration: float,
                   mem_bytes: float) -> None:
        self._queued = max(0, self._queued - 1)
        self.busy_s += duration
        self.clock = start + duration
        self.frames_done += 1
        self.mem_peak_bytes = max(self.mem_peak_bytes, mem_bytes)
        if mem_bytes > self.mem_budget_bytes:
            self.mem_violations += 1

    def energy_j(self, makespan: float) -> float:
        return (self.device.active_power * self.busy_s
                + self.device.idle_power * max(0.0, makespan - self.busy_s))

    def utilization(self, makespan: float) -> float:
        return self.busy_s / makespan if makespan > 0 else 0.0


class ActorPool:
    """All actors of the cluster, live and departed, keyed by name."""

    def __init__(self, devices: list[Device],
                 mem_budget_bytes: float = float("inf")):
        self.actors: dict[str, DeviceActor] = {
            d.name: DeviceActor(d, mem_budget_bytes=mem_budget_bytes)
            for d in devices}

    def __getitem__(self, name: str) -> DeviceActor:
        return self.actors[name]

    def __contains__(self, name: str) -> bool:
        return name in self.actors

    def add(self, device: Device,
            mem_budget_bytes: float = float("inf")) -> DeviceActor:
        prev = self.actors.get(device.name)
        if prev is not None and prev.alive:
            raise ValueError(f"device {device.name!r} already in pool")
        if prev is not None:
            # rejoin after a leave: revive, keep accumulated stats
            prev.device = device
            prev.alive = True
            prev.speed = 1.0
            prev.mem_budget_bytes = mem_budget_bytes
            return prev
        act = DeviceActor(device, mem_budget_bytes=mem_budget_bytes)
        self.actors[device.name] = act
        return act

    def remove(self, name: str) -> DeviceActor:
        if name not in self.actors:
            raise KeyError(f"unknown device {name!r} "
                           f"(have: {sorted(self.actors)})")
        act = self.actors[name]
        act.alive = False
        return act

    def alive_devices(self) -> list[Device]:
        """Live devices at *nominal* capacity.

        DVFS drift is deliberately not applied here: the re-planner must
        see measured costs through the monitor's alpha calibration, not
        the actor's ground-truth speed (which a real deployment cannot
        read directly).
        """
        return [a.device for a in self.actors.values() if a.alive]

    def live(self) -> list[DeviceActor]:
        return [a for a in self.actors.values() if a.alive]
