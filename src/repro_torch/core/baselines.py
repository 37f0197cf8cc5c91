"""Baseline parallelization schemes the paper compares against (§6.1).

* LW  — layer-wise (MoDNN [4]): every layer split over all devices,
        scatter/gather each layer.
* EFL — early-fused-layer (DeepThings [5]): fuse the first K conv
        layers, split over all devices; the rest runs on one device.
* OFL — optimal fused-layer (AOFL [6]): DP over fusion boundaries; all
        devices execute every fused segment, synchronizing in between.
* CE  — CoEdge [22]: layer-wise with a *dynamic* per-layer device count
        and neighbor-limited halo communication.
* BFS — exhaustive search for the true optimal pipeline (used in the
        paper's Tables 6-7 to show PICO ~ optimal at tiny cost).

All schemes share the cost model of :mod:`repro_torch.core.cost`, and report
(period, latency, per-device compute) so they can be compared with PICO.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Sequence

from .graph import Graph, tile_widths
from .cost import (BYTES_PER_ELEM, Cluster, Device, SegmentCost, StageCost,
                   segment_cost, stage_cost)
from .partition import Piece
from .pipeline_dp import PipelineDP, PipelinePlan, StagePlan
from .hetero import adjust_stages


@dataclass
class SchemeResult:
    name: str
    period: float                 # time between finished frames
    latency: float                # per-frame latency
    per_device_flops: dict[str, float] = field(default_factory=dict)
    per_device_busy: dict[str, float] = field(default_factory=dict)
    redundant_flops: float = 0.0
    total_flops: float = 0.0
    memory_bytes: dict[str, float] = field(default_factory=dict)
    wall_time_s: float = 0.0
    extra: dict = field(default_factory=dict)

    @property
    def throughput(self) -> float:
        return 1.0 / self.period if self.period > 0 else float("inf")

    @property
    def redundancy_ratio(self) -> float:
        return self.redundant_flops / self.total_flops if self.total_flops else 0.0


def _chain(g: Graph) -> list[str]:
    return list(g.topo_order)


def _acc(res: SchemeResult, devices: Sequence[Device], seg: SegmentCost,
         comp: Sequence[float]):
    for d, f, c in zip(devices, seg.per_device_flops, comp):
        res.per_device_flops[d.name] = res.per_device_flops.get(d.name, 0.0) + f
        res.per_device_busy[d.name] = res.per_device_busy.get(d.name, 0.0) + c
    res.redundant_flops += seg.redundant_flops
    res.total_flops += sum(seg.per_device_flops)


# ---------------------------------------------------------------------------
# LW — layer-wise
# ---------------------------------------------------------------------------

def layer_wise(g: Graph, cluster: Cluster,
               input_size: tuple[int, int]) -> SchemeResult:
    t0 = time.perf_counter()
    full = g.forward_sizes(input_size)
    devs = cluster.devices
    res = SchemeResult("LW", 0.0, 0.0)
    total = 0.0
    for n in g.topo_order:
        if g.layers[n].kind in ("input", "output"):
            continue
        sc = stage_cost(g, frozenset({n}), full, input_size, devs, cluster)
        total += sc.total
        _acc(res, devs, sc.seg, sc.per_device_comp)
    res.period = res.latency = total
    # every device holds the full model + its feature slice
    params = g.segment_params(g.layers)
    for d in devs:
        res.memory_bytes[d.name] = params + 2 * _max_feature_bytes(g, full) / len(devs)
    res.wall_time_s = time.perf_counter() - t0
    return res


def _max_feature_bytes(g: Graph, full) -> float:
    return max((full[n][0] * full[n][1] * g.layers[n].out_channels
                * BYTES_PER_ELEM for n in g.layers), default=0.0)


# ---------------------------------------------------------------------------
# EFL — early fused layers
# ---------------------------------------------------------------------------

def early_fused(g: Graph, cluster: Cluster, input_size: tuple[int, int],
                n_fused: int | None = None) -> SchemeResult:
    t0 = time.perf_counter()
    order = _chain(g)
    full = g.forward_sizes(input_size)
    n_fused = n_fused if n_fused is not None else max(1, len(order) * 2 // 3)
    head = frozenset(order[:n_fused])
    tail = frozenset(order[n_fused:])
    devs = cluster.devices
    res = SchemeResult("EFL", 0.0, 0.0)
    sc = stage_cost(g, head, full, input_size, devs, cluster)
    total = sc.total
    _acc(res, devs, sc.seg, sc.per_device_comp)
    if tail:
        best = max(devs, key=lambda d: d.capacity)
        sc2 = stage_cost(g, tail, full, input_size, [best], cluster)
        total += sc2.total
        # hand-off of the head output to `best`
        boundary = sc.seg.out_bytes
        total += sum(boundary) / cluster.b(best, devs[0])
        _acc(res, [best], sc2.seg, sc2.per_device_comp)
    res.period = res.latency = total
    params = g.segment_params(g.layers)
    for d in devs:
        res.memory_bytes[d.name] = params + 2 * _max_feature_bytes(g, full) / len(devs)
    res.wall_time_s = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# OFL — optimal fused layers (AOFL-style DP, no pipelining)
# ---------------------------------------------------------------------------

def optimal_fused(g: Graph, cluster: Cluster, input_size: tuple[int, int],
                  pieces: Sequence[Piece] | None = None) -> SchemeResult:
    """DP over fusion boundaries on the chain of pieces; all devices run
    every fused segment and synchronize at the boundaries."""
    t0 = time.perf_counter()
    full = g.forward_sizes(input_size)
    if pieces is None:
        units = [frozenset({n}) for n in _chain(g)]
    else:
        units = [p.nodes for p in pieces]
    L = len(units)
    devs = cluster.devices

    costs: dict[tuple[int, int], StageCost] = {}

    def seg_cost(i, j) -> StageCost:
        if (i, j) not in costs:
            nodes = frozenset().union(*units[i:j + 1])
            costs[(i, j)] = stage_cost(g, nodes, full, input_size, devs, cluster)
        return costs[(i, j)]

    INF = float("inf")
    best = [INF] * (L + 1)
    back = [-1] * (L + 1)
    best[0] = 0.0
    for j in range(1, L + 1):
        for i in range(j):
            c = best[i] + seg_cost(i, j - 1).total
            if c < best[j]:
                best[j], back[j] = c, i
    # reconstruct
    bounds = []
    j = L
    while j > 0:
        bounds.append((back[j], j - 1))
        j = back[j]
    bounds.reverse()
    res = SchemeResult("OFL", best[L], best[L])
    for i, j in bounds:
        sc = seg_cost(i, j)
        _acc(res, devs, sc.seg, sc.per_device_comp)
    params = g.segment_params(g.layers)
    for d in devs:
        res.memory_bytes[d.name] = params + 2 * _max_feature_bytes(g, full) / len(devs)
    res.extra["segments"] = bounds
    res.wall_time_s = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# CE — CoEdge
# ---------------------------------------------------------------------------

def coedge(g: Graph, cluster: Cluster,
           input_size: tuple[int, int]) -> SchemeResult:
    """Layer-wise with per-layer dynamic device count (greedy over the
    capacity-sorted prefix) and neighbor-only halo traffic."""
    t0 = time.perf_counter()
    full = g.forward_sizes(input_size)
    devs_sorted = cluster.sorted_by_capacity()
    res = SchemeResult("CE", 0.0, 0.0)
    total = 0.0
    for n in g.topo_order:
        spec = g.layers[n]
        if spec.kind in ("input", "output"):
            continue
        best_t, best = float("inf"), None
        for m in range(1, len(devs_sorted) + 1):
            devs = devs_sorted[:m]
            capsum = sum(d.capacity for d in devs)
            fracs = [d.capacity / capsum for d in devs]
            seg = segment_cost(g, frozenset({n}), full, input_size, fracs)
            comp = [d.t_comp(f) for d, f in zip(devs, seg.per_device_flops)]
            # neighbor-only: each device ships just its halo strip
            halo_bytes = []
            for k in range(m):
                extra = seg.in_bytes[k] - (seg.in_bytes[k] * fracs[k])
                halo_bytes.append(max(0.0, extra) * 0.25)
            t_comm = sum(h / cluster.b(devs[0], devs[k])
                         for k, h in enumerate(halo_bytes) if k > 0)
            t = max(comp) + t_comm
            if t < best_t:
                best_t, best = t, (devs, seg, comp)
        total += best_t
        _acc(res, best[0], best[1], best[2])
    res.period = res.latency = total
    params = g.segment_params(g.layers)
    for d in cluster.devices:
        res.memory_bytes[d.name] = params + _max_feature_bytes(g, full) / len(cluster)
    res.wall_time_s = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# BFS — exhaustive optimal pipeline
# ---------------------------------------------------------------------------

def bfs_optimal(
    g: Graph,
    pieces: Sequence[Piece],
    cluster: Cluster,
    input_size: tuple[int, int],
    t_lim: float = float("inf"),
    budget_s: float = 3600.0,
) -> SchemeResult:
    """Enumerate every (stage boundary, device multiset) assignment.

    For heterogeneous clusters this enumerates ordered set-partitions of
    the actual devices; it explodes combinatorially — which is the
    paper's point (Tables 6-7).  ``budget_s`` caps the search.
    """
    t0 = time.perf_counter()
    full = g.forward_sizes(input_size)
    units = [p.nodes for p in pieces]
    L, D = len(units), len(cluster)
    devices = cluster.devices
    homogeneous = len({d.capacity for d in devices}) == 1

    seg_nodes: dict[tuple[int, int], frozenset] = {}

    def nodes_of(i, j):
        if (i, j) not in seg_nodes:
            seg_nodes[(i, j)] = frozenset().union(*units[i:j + 1])
        return seg_nodes[(i, j)]

    best = SchemeResult("BFS", float("inf"), float("inf"))
    best.extra["complete"] = True
    count = 0

    def boundaries():
        # ways to split 0..L-1 into 1..min(L, D) contiguous stages
        for k in range(1, min(L, D) + 1):
            for cut in itertools.combinations(range(1, L), k - 1):
                segs, prev = [], 0
                for c in cut:
                    segs.append((prev, c - 1))
                    prev = c
                segs.append((prev, L - 1))
                yield segs

    def device_splits(n_stages):
        if homogeneous:
            # only counts matter
            def comp(total, parts):
                if parts == 1:
                    yield (total,)
                    return
                for first in range(1, total - parts + 2):
                    for rest in comp(total - first, parts - 1):
                        yield (first,) + rest
            for counts in comp(D, n_stages):
                yield [devices[sum(counts[:i]):sum(counts[:i + 1])]
                       for i in range(n_stages)]
        else:
            # ordered set partitions of the device list
            def parts(items, k):
                if k == 1:
                    yield [list(items)]
                    return
                if len(items) < k:
                    return
                # assign each item to one of k groups, groups nonempty
                for assign in itertools.product(range(k), repeat=len(items)):
                    groups = [[] for _ in range(k)]
                    for it, a in zip(items, assign):
                        groups[a].append(it)
                    if all(groups):
                        yield groups
            yield from parts(list(devices), n_stages)

    for segs in boundaries():
        for groups in device_splits(len(segs)):
            if time.perf_counter() - t0 > budget_s:
                best.extra["complete"] = False
                best.wall_time_s = time.perf_counter() - t0
                return best
            count += 1
            period, latency = 0.0, 0.0
            detail = []
            ok = True
            for (i, j), devs in zip(segs, groups):
                sc = stage_cost(g, nodes_of(i, j), full, input_size, devs, cluster)
                period = max(period, sc.total)
                latency += sc.total
                detail.append((devs, sc))
                if latency > t_lim or period >= best.period:
                    ok = False
                    break
            if ok and latency <= t_lim and period < best.period:
                best.period, best.latency = period, latency
                best.per_device_flops.clear()
                best.per_device_busy.clear()
                best.redundant_flops = best.total_flops = 0.0
                for devs, sc in detail:
                    _acc(best, devs, sc.seg, sc.per_device_comp)
                best.extra["stages"] = [(i, j, [d.name for d in devs])
                                        for (i, j), devs in zip(segs, groups)]
    best.extra["configs_evaluated"] = count
    best.wall_time_s = time.perf_counter() - t0
    return best


# ---------------------------------------------------------------------------
# PICO wrapper producing a SchemeResult (for apples-to-apples tables)
# ---------------------------------------------------------------------------

def pico_scheme(g: Graph, pieces: Sequence[Piece], cluster: Cluster,
                input_size: tuple[int, int],
                t_lim: float = float("inf")) -> SchemeResult:
    t0 = time.perf_counter()
    dp = PipelineDP(g, list(pieces), cluster.homogenized(), input_size, t_lim)
    plan = adjust_stages(dp.build(), cluster, g, input_size)
    res = SchemeResult("PICO", plan.period, plan.latency)
    for st in plan.stages:
        _acc(res, st.devices, st.cost.seg, st.cost.per_device_comp)
        for k, d in enumerate(st.devices):
            res.memory_bytes[d.name] = (st.cost.seg.param_bytes
                                        + st.cost.seg.feature_bytes[k])
    res.extra["plan"] = plan
    res.wall_time_s = time.perf_counter() - t0
    return res
