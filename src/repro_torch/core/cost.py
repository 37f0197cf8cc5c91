"""Cost model (paper §3.2, Eq. 4-12).

Quantifies per-device compute time, per-stage communication, pipeline
period/latency, redundancy and memory.  Devices are generic: a
Raspberry-Pi (paper repro) is a :class:`Device` instance, and so is any
other device with a FLOP/s capacity.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Mapping, Sequence

from .graph import Graph, LayerSpec, tile_widths, proportional_widths

BYTES_PER_ELEM = 4.0  # fp32 features, as in the paper's PyTorch testbed


@dataclass(frozen=True)
class Device:
    """One compute device.  ``capacity`` is FLOP/s (paper: ϑ(d_k))."""

    name: str
    capacity: float
    alpha: float = 1.0          # regression coefficient α_k (Eq. 7)
    active_power: float = 4.0   # Watts, for the energy benchmark (Fig. 16)
    idle_power: float = 1.6

    def t_comp(self, flops: float) -> float:
        return self.alpha * flops / self.capacity


@dataclass
class Cluster:
    """A set of devices + link model.

    The paper assumes a uniform WLAN bandwidth ``b`` (bytes/s); we also
    support per-pair overrides (two-tier fabrics).
    """

    devices: list[Device]
    bandwidth: float = 50e6 / 8          # 50 Mbps WLAN -> bytes/s
    pair_bandwidth: dict[tuple[str, str], float] = field(default_factory=dict)

    def __post_init__(self):
        self.devices = list(self.devices)

    def __len__(self) -> int:
        return len(self.devices)

    def b(self, a: Device | str, c: Device | str) -> float:
        ka = a.name if isinstance(a, Device) else a
        kc = c.name if isinstance(c, Device) else c
        return self.pair_bandwidth.get((ka, kc),
               self.pair_bandwidth.get((kc, ka), self.bandwidth))

    def sorted_by_capacity(self, reverse: bool = True) -> list[Device]:
        return sorted(self.devices, key=lambda d: d.capacity, reverse=reverse)

    @property
    def total_capacity(self) -> float:
        return sum(d.capacity for d in self.devices)

    def homogenized(self) -> "Cluster":
        """D' of Eq. 14: same count, average capacity."""
        avg = self.total_capacity / len(self.devices)
        devs = [Device(f"avg{i}", avg) for i in range(len(self.devices))]
        return Cluster(devs, bandwidth=self.bandwidth)

    def restricted(self, devices: "Sequence[Device]") -> "Cluster":
        """Sub-cluster over ``devices``, keeping only the pair-bandwidth
        overrides internal to the subset (tenant shares, re-partitions)."""
        names = {d.name for d in devices}
        pairs = {k: v for k, v in self.pair_bandwidth.items()
                 if k[0] in names and k[1] in names}
        return Cluster(list(devices), bandwidth=self.bandwidth,
                       pair_bandwidth=pairs)


def make_pi_cluster(freqs_ghz: Sequence[float],
                    bandwidth_mbps: float = 50.0) -> Cluster:
    """Paper testbed: Raspberry-Pi 4B, one Cortex-A73 core.

    We model capacity as ~2 FLOP/cycle/core (NEON fp32 MAC) so a 1.5 GHz
    Pi is ~3 GFLOP/s — matches the order of magnitude implied by the
    paper's VGG16 (~15.5 GFLOP/frame, seconds per frame on one Pi).
    """
    devs = [Device(f"pi{i}@{f:g}GHz", capacity=f * 2e9,
                   active_power=4.0 + 1.5 * f, idle_power=1.6)
            for i, f in enumerate(freqs_ghz)]
    return Cluster(devs, bandwidth=bandwidth_mbps * 1e6 / 8)


# ---------------------------------------------------------------------------
# Measured cost corrections
# ---------------------------------------------------------------------------

@dataclass
class CostTable:
    """Measured per-segment compute-cost corrections.

    ``ratios[nodes]`` is observed/analytic seconds for the fused segment
    ``nodes``, as timed by ``exec.calibrate`` on its *compiled*
    executable.  ``stage_cost`` multiplies each device's analytic
    compute time by the segment's ratio, replacing the purely analytic
    alpha with measured numbers.  Segments never calibrated fall back to
    ``default`` (typically the mean measured ratio), or 1.0.
    """

    ratios: dict[frozenset[str], float] = field(default_factory=dict)
    default: float | None = None
    # autotuned kernel winners keyed by ``exec.autotune.shape_key`` —
    # {"block_ci", "block_co", "best_us", "backend"} per entry, so
    # calibration ratios and kernel tunings share one versioned store
    kernels: dict[str, dict] = field(default_factory=dict)

    def ratio(self, nodes) -> float:
        r = self.ratios.get(frozenset(nodes))
        if r is not None:
            return r
        if self.default is not None:
            return self.default
        if self.ratios:
            return sum(self.ratios.values()) / len(self.ratios)
        return 1.0

    def __len__(self) -> int:
        return len(self.ratios)


# ---------------------------------------------------------------------------
# Segment / stage costing
# ---------------------------------------------------------------------------

@dataclass
class SegmentCost:
    """Costs of one fused segment executed by ``m`` devices.

    ``per_device_flops[k]`` includes halo redundancy; ``exact_flops`` is
    the no-redundancy total; ``in_bytes[k]``/``out_bytes[k]`` are the
    scatter/gather feature volumes of device k (Eq. 9).
    """

    nodes: frozenset[str]
    per_device_flops: list[float]
    exact_flops: float
    in_bytes: list[float]
    out_bytes: list[float]
    param_bytes: int
    feature_bytes: list[float]   # peak live feature memory per device

    @property
    def redundant_flops(self) -> float:
        return max(0.0, sum(self.per_device_flops) - self.exact_flops)

    @property
    def redundancy_ratio(self) -> float:
        tot = sum(self.per_device_flops)
        return self.redundant_flops / tot if tot > 0 else 0.0


def segment_cost(
    g: Graph,
    nodes: frozenset[str] | set[str],
    full_sizes: Mapping[str, tuple[int, int]],
    input_size: tuple[int, int],
    fractions: Sequence[float],
) -> SegmentCost:
    """Cost a fused segment whose sink outputs are tile-split along width.

    ``fractions`` are per-device output-width shares (sum to 1).  Each
    device k computes the whole segment on its halo-extended input tile
    (fused-layer scheme inside a stage, paper §2.4.2).
    """
    nodes = frozenset(nodes)
    sinks = g.sinks(nodes)
    sources = g.sources(nodes)

    # exact (un-tiled) cost of the segment
    exact_out, _ = g.required_sizes(nodes, {}, full_sizes, input_size)
    exact = g.segment_flops(nodes, exact_out)

    m = len(fractions)
    per_flops, in_b, out_b, feat_b = [], [], [], []
    sink_ws = {s: full_sizes[s][0] for s in sinks}
    # integer tile widths per device per sink
    widths = {s: proportional_widths(w, fractions) if m > 1 else [w]
              for s, w in sink_ws.items()}
    for k in range(m):
        tiles = {s: (widths[s][k], full_sizes[s][1]) for s in sinks}
        if all(t[0] == 0 for t in tiles.values()):
            # device got no slice of any sink: fully idle
            per_flops.append(0.0)
            in_b.append(0.0)
            out_b.append(0.0)
            feat_b.append(0.0)
            continue
        tiles = {s: (max(t[0], 0), t[1]) for s, t in tiles.items()}
        req_out, req_in = g.required_sizes(nodes, tiles, full_sizes, input_size)
        fl = 0.0
        for n in nodes:
            spec = g.layers[n]
            if spec.tile_independent_flops:
                # attention-like: full input gathered but each output row
                # computed once -> FLOPs follow the *tile*, not the halo
                fl += spec.flops(tiles.get(n, req_out[n]))
            else:
                fl += spec.flops(req_out[n])
        per_flops.append(fl)
        ib = sum(req_in[s][0] * req_in[s][1] * g.layers[s].in_channels
                 * BYTES_PER_ELEM for s in sources)
        ob = sum(req_out[s][0] * req_out[s][1] * g.layers[s].out_channels
                 * BYTES_PER_ELEM for s in sinks)
        in_b.append(ib)
        out_b.append(ob)
        # live features: inputs + the two largest intermediate outputs
        inter = sorted((req_out[n][0] * req_out[n][1]
                        * g.layers[n].out_channels * BYTES_PER_ELEM
                        for n in nodes), reverse=True)
        feat_b.append(ib + sum(inter[:2]))
    return SegmentCost(nodes, per_flops, exact, in_b, out_b,
                       g.segment_params(nodes), feat_b)


def grid_redundant_flops(
    g: Graph,
    nodes: frozenset[str] | set[str],
    full_sizes: Mapping[str, tuple[int, int]],
    input_size: tuple[int, int],
    n_split: int,
) -> float:
    """Redundant FLOPs of a fused segment under a 2-D reference tiling.

    The paper's feature partition (Fig. 4) splits both width and height;
    this is what makes the Fig. 6 example (7x1 then 1x7 kernels) show
    redundancy when fused.  The grid is the most-square factorization of
    ``n_split``.  Used by Algorithm 1's C(M); the 1-D stage costing is
    used for the actual pipeline execution model.
    """
    nodes = frozenset(nodes)
    sinks = g.sinks(nodes)
    exact_out, _ = g.required_sizes(nodes, {}, full_sizes, input_size)
    exact = g.segment_flops(nodes, exact_out)

    # most-square factorization gw * gh == n_split
    gw = int(math.sqrt(n_split))
    while n_split % gw:
        gw -= 1
    gh = n_split // gw

    total = 0.0
    w_parts = {s: tile_widths(full_sizes[s][0], gw) for s in sinks}
    h_parts = {s: tile_widths(full_sizes[s][1], gh) for s in sinks}
    for iw in range(gw):
        for ih in range(gh):
            # a feature smaller than the grid leaves some cells idle
            # (zero tile), NOT duplicated
            tiles = {s: (w_parts[s][iw] if iw < len(w_parts[s]) else 0,
                         h_parts[s][ih] if ih < len(h_parts[s]) else 0)
                     for s in sinks}
            if all(t[0] == 0 or t[1] == 0 for t in tiles.values()):
                continue
            req_out, _ = g.required_sizes(nodes, tiles, full_sizes, input_size)
            for n in nodes:
                spec = g.layers[n]
                if spec.tile_independent_flops:
                    total += spec.flops(tiles.get(n, req_out[n]))
                else:
                    total += spec.flops(req_out[n])
    return max(0.0, total - exact)


@dataclass
class StageCost:
    """T(S) = T_comp + T_comm of one stage (Eq. 8-11)."""

    t_comp: float
    t_comm: float
    per_device_comp: list[float]
    seg: SegmentCost

    @property
    def total(self) -> float:
        return self.t_comp + self.t_comm


def stage_cost_from_segment(
    seg: SegmentCost,
    devices: Sequence[Device],
    cluster: Cluster,
    ratio: float = 1.0,
) -> StageCost:
    """Price a (possibly cached) :class:`SegmentCost` on ``devices``.

    This is the exact arithmetic tail of :func:`stage_cost` — the
    geometry (:func:`segment_cost`) is the expensive, device-independent
    part, so the incremental planner caches :class:`SegmentCost` objects
    across re-plans and re-prices them here.  Both paths share these
    lines, which is what makes cached and from-scratch stage costs
    bit-identical.
    """
    comp = [d.t_comp(f) * ratio for d, f in zip(devices, seg.per_device_flops)]
    t_comp = max(comp)
    # d_f = the first device distributes/gathers (Eq. 9-10)
    d_f = devices[0]
    t_comm = sum((seg.in_bytes[k] + seg.out_bytes[k]) / cluster.b(d_f, devices[k])
                 for k in range(1, len(devices)))
    return StageCost(t_comp, t_comm, comp, seg)


def stage_cost(
    g: Graph,
    nodes: frozenset[str] | set[str],
    full_sizes: Mapping[str, tuple[int, int]],
    input_size: tuple[int, int],
    devices: Sequence[Device],
    cluster: Cluster,
    fractions: Sequence[float] | None = None,
    cost_table: CostTable | None = None,
) -> StageCost:
    """Cost a stage: ``devices`` tile-split the segment's output.

    If ``fractions`` is None, widths are proportional to capacities
    (Algorithm 3's divide-and-conquer rebalancing; equal for homogeneous
    devices, reproducing Algorithm 2's equal split).  ``cost_table``
    scales the analytic compute times by the segment's measured ratio
    (see :class:`CostTable`).
    """
    if fractions is None:
        total = sum(d.capacity for d in devices)
        fractions = [d.capacity / total for d in devices]
    seg = segment_cost(g, nodes, full_sizes, input_size, fractions)
    ratio = cost_table.ratio(nodes) if cost_table is not None else 1.0
    return stage_cost_from_segment(seg, devices, cluster, ratio)
