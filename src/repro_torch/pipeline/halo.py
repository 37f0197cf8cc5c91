"""Overlap-aware feature split / stitch (paper §5.3 'Feature split and stitch').

Given a stage's fused segment and the per-device output fractions, this
module computes the exact per-device sink ranges and the halo-extended
source input ranges, and provides the split/stitch tensor ops.  Splitting
is positional (width axis 2 of NHWC), so stitching is a plain
concatenation — the tiles never overlap on the *output* side.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

from ..core.graph import Graph, proportional_widths


@dataclass
class TilePlan:
    """Exact ranges for one device's tile of a fused segment."""

    device_index: int
    sink_ranges: dict[str, tuple[int, int]]   # output range per sink
    out_ranges: dict[str, tuple[int, int]]    # req_out per node
    in_ranges: dict[str, tuple[int, int]]     # req_in per node

    @property
    def empty(self) -> bool:
        return all(a >= b for a, b in self.sink_ranges.values())

    def signature(self) -> tuple:
        """Hashable form of the exact ranges (executable-cache key part)."""
        return (self.device_index,
                tuple(sorted(self.sink_ranges.items())),
                tuple(sorted(self.out_ranges.items())),
                tuple(sorted(self.in_ranges.items())))


def tile_signature(plans: Sequence["TilePlan"]) -> tuple:
    """Hashable fingerprint of a whole stage's tiling."""
    return tuple(tp.signature() for tp in plans)


def plan_tiles(
    g: Graph,
    nodes: frozenset[str] | set[str],
    full_sizes: Mapping[str, tuple[int, int]],
    input_size: tuple[int, int],
    fractions: Sequence[float],
) -> list[TilePlan]:
    """Partition every sink's output width proportionally to ``fractions``
    and back-propagate exact ranges for each device."""
    nodes = frozenset(nodes)
    sinks = g.sinks(nodes)
    m = len(fractions)
    widths = {s: proportional_widths(full_sizes[s][0], fractions) if m > 1
              else [full_sizes[s][0]] for s in sinks}
    plans: list[TilePlan] = []
    for k in range(m):
        sink_ranges = {}
        for s in sinks:
            a = sum(widths[s][:k])
            sink_ranges[s] = (a, a + widths[s][k])
        if all(a >= b for a, b in sink_ranges.values()):
            plans.append(TilePlan(k, sink_ranges, {}, {}))
            continue
        req_out, req_in = g.required_ranges(nodes, sink_ranges,
                                            full_sizes, input_size)
        plans.append(TilePlan(k, sink_ranges, req_out, req_in))
    return plans


def split_inputs(
    plans: Sequence[TilePlan],
    needs: Sequence[tuple[str, str | None]],
    boundary: Mapping[tuple[str, str | None], torch.Tensor],
) -> list[dict[tuple[str, str | None], torch.Tensor]]:
    """Slice each boundary tensor into per-device halo tiles.

    ``needs`` lists (node, outside_pred) pairs (see
    ``CNNDef.boundary_needs``); ``boundary[(n, p)]`` must cover the full
    width of predecessor p's output (NHWC).  The slice for node n is its
    req_in range (a view, no copy).
    """
    out: list[dict[tuple[str, str | None], torch.Tensor]] = []
    for tp in plans:
        if tp.empty:
            out.append({})
            continue
        tiles = {}
        for (n, p) in needs:
            a, b = tp.in_ranges[n]
            tiles[(n, p)] = boundary[(n, p)][:, :, a:b, :]
        out.append(tiles)
    return out


def stitch_outputs(
    plans: Sequence[TilePlan],
    sinks: Sequence[str],
    tiles: Sequence[Mapping[str, torch.Tensor]],
) -> dict[str, torch.Tensor]:
    """Concatenate per-device sink tiles back to full tensors.

    Each device's returned tile covers req_out[sink]; the stitcher crops
    it down to the device's *assigned* sink range before concatenating,
    so overlapping halo is discarded exactly once.
    """
    out: dict[str, torch.Tensor] = {}
    for s in sinks:
        parts = []
        for tp, t in zip(plans, tiles):
            if tp.empty or s not in t:
                continue
            a, b = tp.sink_ranges[s]
            if a >= b:
                continue
            ra, _ = tp.out_ranges[s]
            parts.append(t[s][:, :, a - ra: b - ra, :])
        out[s] = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
    return out
