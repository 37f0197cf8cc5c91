"""Algorithm 3 — adapt a homogeneous-optimal pipeline to real devices.

Greedy: sort devices by capacity (desc); repeatedly give the next device
to the stage with the highest remaining per-slot average compute demand
Θ'/|D'|.  When a stage's slots fill up, rebalance its output-tile widths
proportionally to the assigned devices' capacities (the paper's
divide-and-conquer feature re-partition).
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Sequence

from .cost import Cluster, CostTable, Device, stage_cost
from .pipeline_dp import PipelinePlan, StagePlan


def adjust_stages(
    plan: PipelinePlan,
    cluster: Cluster,
    g,
    input_size: tuple[int, int],
    cost_table: CostTable | None = None,
) -> PipelinePlan:
    """Algorithm 3.  ``plan`` comes from PipelineDP on cluster.homogenized()."""
    t0 = time.perf_counter()
    full = g.forward_sizes(input_size)

    # remaining slots + per-slot demand for every homogeneous stage
    slots = [st.n_devices for st in plan.stages]
    demand = [sum(st.cost.seg.per_device_flops) / max(st.n_devices, 1)
              for st in plan.stages]
    assigned: list[list[Device]] = [[] for _ in plan.stages]

    for dev in cluster.sorted_by_capacity():
        # stage with max remaining average demand (paper text §5.1.2)
        cand = [k for k in range(len(plan.stages)) if slots[k] > 0]
        if not cand:
            break
        k = max(cand, key=lambda q: demand[q])
        assigned[k].append(dev)
        slots[k] -= 1

    stages: list[StagePlan] = []
    period = 0.0
    latency = 0.0
    for si, (st, devs) in enumerate(zip(plan.stages, assigned)):
        if not devs:
            # The seed silently fell back to the homogenized *placeholder*
            # devices here, leaking fictitious "avgN" devices into the
            # final plan whenever the cluster had fewer devices than the
            # plan had slots.  That plan is unexecutable — fail loudly;
            # callers must re-plan on the cluster they actually have.
            raise ValueError(
                f"adjust_stages: stage {si} received no devices — the plan "
                f"needs {sum(s.n_devices for s in plan.stages)} device slots "
                f"but the cluster has {len(cluster.devices)}; re-plan on the "
                "current cluster instead of adjusting a stale pipeline")
        total = sum(d.capacity for d in devs)
        fracs = [d.capacity / total for d in devs]
        sc = stage_cost(g, st.nodes, full, input_size, devs, cluster, fracs,
                        cost_table=cost_table)
        stages.append(StagePlan(st.first_piece, st.last_piece, devs,
                                st.nodes, sc, fracs))
        period = max(period, sc.total)
        latency += sc.total
    return PipelinePlan(stages, period, latency,
                        plan.wall_time_s + (time.perf_counter() - t0))
