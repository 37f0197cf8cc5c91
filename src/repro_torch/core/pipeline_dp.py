"""Algorithm 2 — many-to-many mapping of pieces x devices to pipeline stages.

DP of Eq. 15 over states (i, j, p): the optimal pipeline for pieces
i..j with p homogeneous devices is either a single stage, or an optimal
sub-pipeline over i..s with p-m devices followed by one stage s+1..j
replicated over m devices:

    P[i][j][p] = min_{i<=s<j} min_{1<=m<p} max(P[i][s][p-m], Ts[s+1][j][m])

Latency (sum of stage times) is tracked alongside and solutions whose
latency exceeds ``T_lim`` are pruned, matching the paper's pseudocode.

Two solvers share the class: the scalar top-down reference (`solve`)
and an incremental hot path used when a :class:`PlannerCache` is
attached.  Planning cost is dominated by segment *geometry*
(:func:`~repro.core.cost.segment_cost` graph walks per ``(i, j, m)``
state), which is device-independent — the cache persists it across
re-plans, so single-device churn only redoes cheap device-time
arithmetic, and a solved DP table is reused outright when the
homogenized cluster signature is unchanged.  Candidate stage costs
are evaluated batch-vectorized with numpy over all split ranges; the
elementwise operation order mirrors the scalar path exactly, so
incremental plans are bit-identical to from-scratch plans (pinned in
tests).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .graph import Graph
from .cost import (Cluster, CostTable, Device, StageCost, segment_cost,
                   stage_cost_from_segment)
from .partition import Piece


@dataclass
class StagePlan:
    """One pipeline stage: pieces [i..j] on ``devices``."""

    first_piece: int
    last_piece: int
    devices: list[Device]
    nodes: frozenset[str]
    cost: StageCost
    fractions: list[float] = field(default_factory=list)

    @property
    def n_devices(self) -> int:
        return len(self.devices)


@dataclass
class PipelinePlan:
    stages: list[StagePlan]
    period: float               # P(G, D, S)  (Eq. 12)
    latency: float              # T(G, D, S)
    wall_time_s: float = 0.0
    feasible: bool = True       # False: no config satisfied T_lim;
                                # the returned plan is the unconstrained
                                # optimum (best effort)

    @property
    def throughput(self) -> float:
        return 1.0 / self.period if self.period > 0 else float("inf")

    def __iter__(self):
        return iter(self.stages)


class PlannerCache:
    """Persistent planner state for one (graph, piece chain, input size).

    Owned by whoever re-plans repeatedly — a fleet registry entry, a
    serving tenant, a runtime's churn loop — and threaded into
    :class:`PipelineDP` (via ``plan_with_spec(planner_cache=)``).
    Three reuse tiers, cheapest first:

    * ``solutions`` — fully solved DP tables keyed by the homogenized
      cluster signature ``(L, D, capacity, alpha, bandwidth, t_lim,
      cost-table content)``; an exact signature match skips straight to
      plan reconstruction (zero ``solve(i, j, p)`` work);
    * ``segments`` — device-independent :class:`SegmentCost` geometry
      per ``(i, j, m)`` state (the graph walks that dominate planning);
      always valid across device churn, so a changed cluster only redoes
      arithmetic;
    * ``comm`` — the per-state communication-time scalar per bandwidth
      (kept scalar, summed in the same left-to-right order as
      :func:`~repro.core.cost.stage_cost_from_segment`, which is what
      keeps cached and from-scratch plans bit-identical).

    The cache self-invalidates when the chain signature changes
    (:meth:`ensure`), so holding one across a model/partition swap is
    safe, just useless.
    """

    def __init__(self):
        self.sig = None
        self.segments: dict[tuple[int, int, int], "SegmentCost"] = {}
        self.max_flops: dict[tuple[int, int, int], float] = {}
        self.mem: dict[tuple[int, int, int], float] = {}
        self.comm: dict[tuple, float] = {}
        self.nodes: dict[tuple[int, int], frozenset] = {}
        self.solutions: dict[tuple, tuple] = {}
        self.hits = 0
        self.misses = 0
        self.solution_hits = 0

    def __len__(self) -> int:
        return len(self.segments)

    def clear(self) -> None:
        self.segments.clear()
        self.max_flops.clear()
        self.mem.clear()
        self.comm.clear()
        self.nodes.clear()
        self.solutions.clear()

    def ensure(self, sig) -> "PlannerCache":
        """Validate the cache against a chain signature; a mismatch
        clears everything (a different graph/piece chain invalidates
        all geometry)."""
        if sig != self.sig:
            self.clear()
            self.sig = sig
        return self

    @staticmethod
    def chain_signature(g: Graph, pieces: Sequence[Piece],
                        input_size: tuple[int, int]) -> tuple:
        """Content signature of everything the geometry depends on."""
        layers = tuple(
            (s.name, s.kind, tuple(s.kernel), tuple(s.stride),
             tuple(s.padding), s.in_channels, s.out_channels,
             s.flops_coeff, s.global_rf, s.tile_independent_flops)
            for s in g.layers.values())
        chain = tuple(tuple(sorted(p.nodes)) for p in pieces)
        return (layers, tuple(g.edges), chain, tuple(input_size))


class PipelineDP:
    """Eq. 15 solver for a *homogeneous* cluster (use hetero.adjust after).

    With ``cache=`` (a :class:`PlannerCache`) the solver switches to the
    incremental hot path: segment geometry and communication scalars are
    reused across builds, candidate stage costs are evaluated
    numpy-vectorized over all split ranges, and an unchanged homogenized
    signature reuses the solved DP table outright.  Plans from the two
    paths are bit-identical (same arithmetic, same tie-breaking).

    ``objective`` (an :class:`~repro.api.specs.ObjectiveSpec`) makes the
    DP multi-objective-aware on both paths: a finite
    ``max_memory_bytes`` prunes stage candidates whose peak per-device
    footprint exceeds the budget (computed from the same cached segment
    geometry, so the vectorized path stays hot), and a positive
    ``latency`` weight replaces the lexicographic (period, latency)
    comparison with the weighted scalarization.  An objective that does
    not shape the DP (the pure-throughput default) is normalized to
    ``None``, keeping the legacy paths — and their bit-identity pins —
    untouched.
    """

    def __init__(
        self,
        g: Graph,
        pieces: Sequence[Piece],
        cluster: Cluster,
        input_size: tuple[int, int],
        t_lim: float = float("inf"),
        cost_table: CostTable | None = None,
        cache: PlannerCache | None = None,
        objective=None,
    ):
        self.g = g
        self.pieces = list(pieces)
        self.cluster = cluster
        self.input_size = input_size
        self.t_lim = t_lim
        self.cost_table = cost_table
        self.cache = cache
        self.objective = (objective if objective is not None
                          and objective.shapes_dp else None)
        if cache is not None:
            cache.ensure(PlannerCache.chain_signature(g, self.pieces,
                                                      input_size))
        self.full = g.forward_sizes(input_size)
        self._stage_cache: dict[tuple[int, int, int], StageCost] = {}
        # memo[(i, j, p)] = (period, latency, split) where split is either
        # None (single stage) or (s, m)
        self.memo: dict[tuple[int, int, int], tuple[float, float, object]] = {}

    # -- Ts(i, j, m): one stage over pieces i..j with m devices ---------
    def _nodes(self, i: int, j: int) -> frozenset:
        if self.cache is not None:
            nodes = self.cache.nodes.get((i, j))
            if nodes is None:
                nodes = frozenset().union(*(p.nodes
                                            for p in self.pieces[i:j + 1]))
                self.cache.nodes[(i, j)] = nodes
            return nodes
        return frozenset().union(*(p.nodes for p in self.pieces[i:j + 1]))

    def _segment(self, i: int, j: int, m: int):
        """Device-independent geometry of one stage state (cached)."""
        key = (i, j, m)
        if self.cache is not None:
            seg = self.cache.segments.get(key)
            if seg is not None:
                self.cache.hits += 1
                return seg
        seg = segment_cost(self.g, self._nodes(i, j), self.full,
                           self.input_size, [1.0 / m] * m)
        if self.cache is not None:
            self.cache.segments[key] = seg
            self.cache.misses += 1
        return seg

    def stage(self, i: int, j: int, m: int) -> StageCost:
        key = (i, j, m)
        hit = self._stage_cache.get(key)
        if hit is None:
            seg = self._segment(i, j, m)
            devs = self.cluster.devices[:m]
            ratio = (self.cost_table.ratio(seg.nodes)
                     if self.cost_table is not None else 1.0)
            hit = stage_cost_from_segment(seg, devs, self.cluster, ratio)
            self._stage_cache[key] = hit
        return hit

    def _stage_mem(self, i: int, j: int, m: int) -> float:
        """Peak per-device memory of one stage state: segment params +
        the largest halo-extended live-feature footprint.  Pure geometry
        (device-independent), so it persists in the PlannerCache."""
        key = (i, j, m)
        if self.cache is not None:
            v = self.cache.mem.get(key)
            if v is not None:
                return v
        seg = self._segment(i, j, m)
        v = seg.param_bytes + (max(seg.feature_bytes)
                               if seg.feature_bytes else 0.0)
        if self.cache is not None:
            self.cache.mem[key] = v
        return v

    def _mem_ok(self, i: int, j: int, m: int) -> bool:
        if self.objective is None:
            return True
        return self._stage_mem(i, j, m) <= self.objective.max_memory_bytes

    def _obj_key(self, per: float, lat: float) -> tuple:
        """Comparison key under the scalarized objective (ties broken
        exactly like the pure-throughput solver: period, then latency)."""
        o = self.objective
        return (o.throughput * per + o.latency * lat, per, lat)

    def solve(self, i: int, j: int, p: int) -> tuple[float, float]:
        """Returns (period, latency) for pieces i..j with p devices."""
        if self.objective is not None:
            return self._solve_obj(i, j, p)
        key = (i, j, p)
        if key in self.memo:
            per, lat, _ = self.memo[key]
            return per, lat
        # option A: a single stage with all p devices (feasible only if
        # its latency fits the budget; infinite period marks infeasible)
        sc = self.stage(i, j, p)
        if sc.total <= self.t_lim:
            best = (sc.total, sc.total, None)
        else:
            best = (float("inf"), sc.total, None)
        if p > 1 and j > i:
            for s in range(i, j):
                for m in range(1, p):
                    tail = self.stage(s + 1, j, m).total
                    if tail > best[0]:
                        # period = max(head, tail) >= tail: cannot improve
                        continue
                    head_p, head_l = self.solve(i, s, p - m)
                    lat = head_l + tail
                    if lat > self.t_lim:
                        continue
                    per = max(head_p, tail)
                    if per < best[0] or (per == best[0] and lat < best[1]):
                        best = (per, lat, (s, m))
        self.memo[key] = best
        return best[0], best[1]

    def _solve_obj(self, i: int, j: int, p: int) -> tuple[float, float]:
        """Objective-aware scalar solver: memory-pruned stage
        candidates, scalarized comparison.  Mirrors the vectorized
        path's selection order exactly (option A first, then earliest
        (s, m) in s-major/m-minor order)."""
        inf = float("inf")
        key = (i, j, p)
        if key in self.memo:
            per, lat, _ = self.memo[key]
            return per, lat
        sc = self.stage(i, j, p)
        if sc.total <= self.t_lim and self._mem_ok(i, j, p):
            best = (sc.total, sc.total, None)
        else:
            best = (inf, sc.total, None)
        best_key = (self._obj_key(*best[:2]) if best[0] < inf
                    else (inf, inf, inf))
        if p > 1 and j > i:
            for s in range(i, j):
                for m in range(1, p):
                    if not self._mem_ok(s + 1, j, m):
                        continue
                    tail = self.stage(s + 1, j, m).total
                    head_p, head_l = self._solve_obj(i, s, p - m)
                    lat = head_l + tail
                    if lat > self.t_lim:
                        continue
                    per = max(head_p, tail)
                    if per == inf:       # infeasible head: not a candidate
                        continue
                    cand_key = self._obj_key(per, lat)
                    if cand_key < best_key:
                        best = (per, lat, (s, m))
                        best_key = cand_key
        self.memo[key] = best
        return best[0], best[1]

    def build(self) -> PipelinePlan:
        if self.cache is not None:
            usig = self._uniform_sig()
            if usig is not None:
                return self._build_fast(usig)
        return self._build_scalar()

    def _build_scalar(self) -> PipelinePlan:
        t0 = time.perf_counter()
        L, D = len(self.pieces), len(self.cluster)
        per, lat = self.solve(0, L - 1, D)
        if per == float("inf"):
            # T_lim infeasible: fall back to the unconstrained optimum
            # and flag it (paper: the limit is a soft preference)
            fallback = PipelineDP(self.g, self.pieces, self.cluster,
                                  self.input_size,
                                  cost_table=self.cost_table,
                                  cache=self.cache,
                                  objective=(self.objective.relaxed()
                                             if self.objective is not None
                                             else None)).build()
            fallback.feasible = False
            fallback.wall_time_s += time.perf_counter() - t0
            return fallback
        stages: list[StagePlan] = []

        def walk(i: int, j: int, p: int):
            _, _, split = self.memo[(i, j, p)]
            if split is None:
                sc = self.stage(i, j, p)
                nodes = frozenset().union(*(x.nodes for x in self.pieces[i:j + 1]))
                stages.append(StagePlan(i, j, list(self.cluster.devices[:p]),
                                        nodes, sc, [1.0 / p] * p))
            else:
                s, m = split
                walk(i, s, p - m)
                sc = self.stage(s + 1, j, m)
                nodes = frozenset().union(*(x.nodes for x in self.pieces[s + 1:j + 1]))
                stages.append(StagePlan(s + 1, j, list(self.cluster.devices[:m]),
                                        nodes, sc, [1.0 / m] * m))

        walk(0, L - 1, D)
        # assign *distinct* device slices to stages (the DP only cares
        # about counts; Algorithm 3 re-maps real heterogeneous devices)
        off = 0
        for st in stages:
            st.devices = list(self.cluster.devices[off:off + st.n_devices])
            off += st.n_devices
        return PipelinePlan(stages, per, lat, time.perf_counter() - t0)

    # -- incremental / vectorized hot path ------------------------------
    def _uniform_sig(self) -> tuple | None:
        """(capacity, alpha, bandwidth) when all devices are
        indistinguishable and the link is flat — the invariant the
        vectorized solver exploits (always true for ``homogenized()``
        clusters, i.e. the Algorithm 2 input).  ``None`` otherwise."""
        if self.cluster.pair_bandwidth:
            return None
        d0 = self.cluster.devices[0]
        for d in self.cluster.devices[1:]:
            if d.capacity != d0.capacity or d.alpha != d0.alpha:
                return None
        return (d0.capacity, d0.alpha, self.cluster.bandwidth)

    def _ratio_sig(self):
        ct = self.cost_table
        if ct is None:
            return None
        return (ct.default, tuple(sorted((tuple(sorted(k)), v)
                                         for k, v in ct.ratios.items())))

    def _max_flops(self, a: int, j: int, m: int) -> float:
        key = (a, j, m)
        v = self.cache.max_flops.get(key)
        if v is None:
            v = max(self._segment(a, j, m).per_device_flops)
            self.cache.max_flops[key] = v
        return v

    def _comm_scalar(self, a: int, j: int, m: int, bw: float) -> float:
        # left-to-right scalar sum, exactly as stage_cost_from_segment,
        # so the cached value is bit-identical to the fresh one (numpy
        # pairwise reduction would not be)
        key = (a, j, m, bw)
        v = self.cache.comm.get(key)
        if v is None:
            seg = self._segment(a, j, m)
            v = 0.0
            for k in range(1, m):
                v = v + (seg.in_bytes[k] + seg.out_bytes[k]) / bw
            self.cache.comm[key] = v
        return v

    def _solve_fast(self, L: int, D: int, cap: float, alpha: float,
                    bw: float) -> tuple:
        """Bottom-up vectorized Eq. 15.  Only ``i == 0`` head states are
        reachable from ``solve(0, L-1, D)``, so the table is 2-D over
        (j, p); tails Ts(s+1, j, m) are priced in batch from cached
        segment geometry.  Tie-breaking replicates the scalar solver:
        lexicographic (period, latency), single-stage option first, then
        earliest (s, m) in s-major/m-minor order.  Under an objective,
        memory-violating stage states are masked to inf (so both option
        A and tails drop out through the ordinary feasibility machinery)
        and the selection key becomes the weighted scalarization with
        the same (period, latency, first-index) tie-breaking."""
        inf = float("inf")
        obj = self.objective
        mem_lim = (obj.max_memory_bytes
                   if obj is not None and np.isfinite(obj.max_memory_bytes)
                   else None)
        # TT[a, j, m] = stage total for pieces a..j on m devices.
        # a == 0 serves option A (m up to D); a >= 1 serves tails (m < D).
        TT = np.full((L, L, D + 1), inf)
        for j in range(L):
            for a in range(j + 1):
                mmax = D if a == 0 else D - 1
                if mmax < 1:
                    continue
                ratio = (self.cost_table.ratio(self._nodes(a, j))
                         if self.cost_table is not None else 1.0)
                max_f = np.array([self._max_flops(a, j, m)
                                  for m in range(1, mmax + 1)])
                comm = np.array([self._comm_scalar(a, j, m, bw)
                                 for m in range(1, mmax + 1)])
                # elementwise ops in the same order as Device.t_comp()*ratio
                # (max over identical devices commutes with the positive
                # scaling, so max_flops stands in for max(per-device comp))
                TT[a, j, 1:mmax + 1] = ((alpha * max_f) / cap) * ratio + comm
                if mem_lim is not None:
                    for m in range(1, mmax + 1):
                        if self._stage_mem(a, j, m) > mem_lim:
                            TT[a, j, m] = inf

        t_lim = self.t_lim
        P = np.full((L, D + 1), inf)
        Lat = np.full((L, D + 1), inf)
        S = np.full((L, D + 1), -1, dtype=np.int64)
        M = np.zeros((L, D + 1), dtype=np.int64)
        for p in range(1, D + 1):
            for j in range(L):
                # option A: single stage over all p devices
                per_a = TT[0, j, p]
                if per_a <= t_lim:
                    best_per, best_lat = per_a, per_a
                else:
                    best_per, best_lat = inf, per_a
                bs, bm = -1, 0
                if p > 1 and j > 0:
                    # candidate grid: rows s in [0, j), cols c -> m = c+1
                    heads_per = P[0:j, 1:p][:, ::-1]     # P[s, p-m]
                    heads_lat = Lat[0:j, 1:p][:, ::-1]
                    tails = TT[1:j + 1, j, 1:p]          # Ts(s+1, j, m)
                    cand_per = np.maximum(heads_per, tails)
                    cand_lat = heads_lat + tails
                    valid = cand_lat <= t_lim
                    if valid.any() and obj is None:
                        per_m = np.where(valid, cand_per, inf)
                        lat_m = np.where(valid, cand_lat, inf)
                        min_per = per_m.min()
                        min_lat = np.where(per_m == min_per, lat_m, inf).min()
                        if (min_per < best_per
                                or (min_per == best_per
                                    and min_lat < best_lat)):
                            first = int(np.argmax((per_m == min_per)
                                                  & (lat_m == min_lat)))
                            s_idx, c_idx = divmod(first, p - 1)
                            best_per, best_lat = min_per, min_lat
                            bs, bm = s_idx, c_idx + 1
                    elif valid.any():
                        # scalarized selection: min weighted score, ties
                        # broken per -> lat -> first (s, m) index, exactly
                        # like _solve_obj.  Infeasible candidates carry
                        # inf (a zero weight would turn 0*inf into NaN,
                        # and inf <= t_lim holds for an unbounded t_lim),
                        # so mask them out of the score entirely.
                        w_t, w_l = obj.throughput, obj.latency
                        valid &= np.isfinite(cand_per)
                        per_m = np.where(valid, cand_per, inf)
                        lat_m = np.where(valid, cand_lat, inf)
                        score_m = np.where(
                            valid,
                            w_t * np.where(valid, cand_per, 0.0)
                            + w_l * np.where(valid, cand_lat, 0.0),
                            inf)
                        min_score = score_m.min()
                        if min_score < inf:
                            sel = score_m == min_score
                            min_per = np.where(sel, per_m, inf).min()
                            sel &= per_m == min_per
                            min_lat = np.where(sel, lat_m, inf).min()
                            sel &= lat_m == min_lat
                            if best_per < inf:
                                best_key = (w_t * best_per + w_l * best_lat,
                                            best_per, best_lat)
                            else:
                                best_key = (inf, inf, inf)
                            if (min_score, min_per, min_lat) < best_key:
                                first = int(np.argmax(sel))
                                s_idx, c_idx = divmod(first, p - 1)
                                best_per, best_lat = min_per, min_lat
                                bs, bm = s_idx, c_idx + 1
                P[j, p] = best_per
                Lat[j, p] = best_lat
                S[j, p] = bs
                M[j, p] = bm
        return P, Lat, S, M

    def _build_fast(self, usig: tuple) -> PipelinePlan:
        t0 = time.perf_counter()
        L, D = len(self.pieces), len(self.cluster)
        cap, alpha, bw = usig
        key = (L, D, cap, alpha, bw, self.t_lim, self._ratio_sig(),
               None if self.objective is None
               else self.objective.dp_signature())
        sol = self.cache.solutions.get(key)
        if sol is None:
            sol = self._solve_fast(L, D, cap, alpha, bw)
            self.cache.solutions[key] = sol
        else:
            self.cache.solution_hits += 1
        P, Lat, S, M = sol
        per, lat = float(P[L - 1, D]), float(Lat[L - 1, D])
        if per == float("inf"):
            fallback = PipelineDP(self.g, self.pieces, self.cluster,
                                  self.input_size,
                                  cost_table=self.cost_table,
                                  cache=self.cache,
                                  objective=(self.objective.relaxed()
                                             if self.objective is not None
                                             else None)).build()
            fallback.feasible = False
            fallback.wall_time_s += time.perf_counter() - t0
            return fallback
        stages: list[StagePlan] = []

        def walk(j: int, p: int):
            s, m = int(S[j, p]), int(M[j, p])
            if s < 0:
                sc = self.stage(0, j, p)
                stages.append(StagePlan(0, j, list(self.cluster.devices[:p]),
                                        sc.seg.nodes, sc, [1.0 / p] * p))
            else:
                walk(s, p - m)
                sc = self.stage(s + 1, j, m)
                stages.append(StagePlan(s + 1, j,
                                        list(self.cluster.devices[:m]),
                                        sc.seg.nodes, sc, [1.0 / m] * m))

        walk(L - 1, D)
        off = 0
        for st in stages:
            st.devices = list(self.cluster.devices[off:off + st.n_devices])
            off += st.n_devices
        return PipelinePlan(stages, per, lat, time.perf_counter() - t0)


def plan_pipeline(
    g: Graph,
    pieces: Sequence[Piece],
    cluster: Cluster,
    input_size: tuple[int, int],
    t_lim: float = float("inf"),
    cost_table: CostTable | None = None,
    cache: PlannerCache | None = None,
    objective=None,
) -> PipelinePlan:
    return PipelineDP(g, pieces, cluster, input_size, t_lim,
                      cost_table=cost_table, cache=cache,
                      objective=objective).build()
