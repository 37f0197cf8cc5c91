"""Discrete pipeline simulator: runtime metrics for a PipelinePlan.

Simulates a stream of frames through the stages (stage s starts frame f
when both the previous stage finished f and itself finished f-1) and
derives throughput, per-device utilization, redundancy ratio, memory
footprint and energy — the quantities of the paper's Figs. 13-16 and
Table 5.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from .cost import Cluster, BYTES_PER_ELEM
from .pipeline_dp import PipelinePlan


@dataclass
class DeviceReport:
    device: str
    stage: int
    utilization: float          # busy / makespan-per-frame
    redundancy: float           # redundant / total FLOPs on this device
    memory_bytes: float         # params + live features
    energy_j: float


@dataclass
class SimReport:
    period: float
    latency: float
    throughput_per_min: float
    frames: int
    makespan: float
    devices: list[DeviceReport] = field(default_factory=list)

    @property
    def avg_utilization(self) -> float:
        return sum(d.utilization for d in self.devices) / len(self.devices)

    @property
    def avg_redundancy(self) -> float:
        return sum(d.redundancy for d in self.devices) / len(self.devices)

    @property
    def avg_memory(self) -> float:
        return sum(d.memory_bytes for d in self.devices) / len(self.devices)

    @property
    def total_energy_j(self) -> float:
        return sum(d.energy_j for d in self.devices)


@dataclass(frozen=True)
class PlanMetrics:
    """Steady-state per-frame metrics of one plan — the four axes the
    multi-objective planner trades (:mod:`repro_torch.core.pareto`).

    ``period`` and ``latency`` come straight off the plan;
    ``energy_j`` is the steady-state per-frame energy (the
    ``frames -> inf`` limit of :func:`simulate`'s energy accounting:
    every device pays active power while busy and idle power for the
    rest of each period); ``memory_bytes`` is the peak per-device
    footprint (params + live features, the same quantity
    ``DeviceReport.memory_bytes`` reports).
    """

    period: float
    latency: float
    energy_j: float
    memory_bytes: float

    def as_tuple(self) -> tuple[float, float, float, float]:
        """(period, latency, energy_j, memory_bytes) — all minimized."""
        return (self.period, self.latency, self.energy_j, self.memory_bytes)


def plan_metrics(plan: PipelinePlan) -> PlanMetrics:
    """Simulate-derived :class:`PlanMetrics` for a priced plan.

    Exact closed form of the steady state :func:`simulate` converges
    to: per frame, device ``k`` of a stage is busy ``per_device_comp[k]``
    seconds and idle for the remainder of the pipeline period.
    """
    period = plan.period
    energy = 0.0
    memory = 0.0
    for st in plan.stages:
        seg = st.cost.seg
        for k, dev in enumerate(st.devices):
            busy = st.cost.per_device_comp[k]
            energy += (dev.active_power * busy
                       + dev.idle_power * max(0.0, period - busy))
            memory = max(memory, seg.param_bytes + seg.feature_bytes[k])
    return PlanMetrics(period, plan.latency, energy, memory)


def simulate(plan: PipelinePlan, frames: int = 64,
             cluster: Cluster | None = None) -> SimReport:
    S = len(plan.stages)
    T = [st.cost.total for st in plan.stages]
    finish = [[0.0] * S for _ in range(frames)]
    for f in range(frames):
        for s in range(S):
            prev_stage = finish[f][s - 1] if s > 0 else 0.0
            prev_frame = finish[f - 1][s] if f > 0 else 0.0
            finish[f][s] = max(prev_stage, prev_frame) + T[s]
    makespan = finish[-1][-1]
    # steady-state period from the simulated stream (tail minus warm-up)
    if frames >= 2:
        period_meas = (finish[-1][-1] - finish[0][-1]) / (frames - 1)
    else:
        period_meas = T and max(T) or 0.0

    reports: list[DeviceReport] = []
    for si, st in enumerate(plan.stages):
        seg = st.cost.seg
        for k, dev in enumerate(st.devices):
            busy = st.cost.per_device_comp[k] * frames
            util = busy / makespan if makespan > 0 else 0.0
            tot = seg.per_device_flops[k]
            exact_share = seg.exact_flops * (st.fractions[k]
                                             if st.fractions else 1 / len(st.devices))
            red = max(0.0, (tot - exact_share) / tot) if tot > 0 else 0.0
            mem = seg.param_bytes + seg.feature_bytes[k]
            energy = (dev.active_power * busy
                      + dev.idle_power * max(0.0, makespan - busy))
            reports.append(DeviceReport(dev.name, si, util, red, mem, energy))
    return SimReport(
        period=period_meas,
        latency=plan.latency,
        throughput_per_min=60.0 / period_meas if period_meas > 0 else 0.0,
        frames=frames,
        makespan=makespan,
        devices=reports,
    )
