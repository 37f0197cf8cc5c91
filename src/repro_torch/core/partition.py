"""Algorithm 1 — partition a CNN DAG into a chain of *pieces*.

Dynamic programming over *ending pieces* (Definition 4: suffix-closed
vertex subsets), memoized on the frozenset of remaining vertices, with
the chain-constraint of §4.2 (every vertex adjacent to the removed part
must join the next ending piece) and the diameter bound of Definition 5.

State transfer (Eq. 13):

    F(G) = min over ending pieces M_E of max(F(G - M_E), C(M_E))

where C(M) is the redundant-FLOPs cost of piece M under a reference
``n_split``-way output tiling.

A divide-and-conquer driver (``partition_graph_dnc``) handles very wide
NAS-style graphs as described in §6.2.3.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Mapping, Sequence

from .graph import Graph, tile_widths
from .cost import grid_redundant_flops


@dataclass
class Piece:
    """One element of the resulting chain."""

    nodes: frozenset[str]
    redundancy: float           # C(M) under the reference split
    index: int = -1

    def __len__(self) -> int:
        return len(self.nodes)


@dataclass
class PartitionResult:
    pieces: list[Piece]
    objective: float            # F(G): worst piece redundancy
    states_explored: int
    wall_time_s: float

    def __iter__(self):
        return iter(self.pieces)

    def __len__(self):
        return len(self.pieces)

    @classmethod
    def from_pieces(cls, pieces: Sequence[Piece], *,
                    states_explored: int = 0,
                    wall_time_s: float = 0.0) -> "PartitionResult":
        """Honest result for a reused/caller-supplied piece chain.

        Pieces are re-indexed to their chain position and the objective
        is the true F(G) of the chain (worst piece redundancy).
        ``states_explored``/``wall_time_s`` default to 0 — nothing was
        searched — but a re-planner can carry the original search stats
        through so downstream audits (e.g. the serving scheduler's
        repartition records) see the partition's real provenance.
        """
        pieces = list(pieces)
        if not pieces:
            raise ValueError("from_pieces needs at least one piece")
        pieces = [p if p.index == i else replace(p, index=i)
                  for i, p in enumerate(pieces)]
        return cls(pieces, max(p.redundancy for p in pieces),
                   states_explored, wall_time_s)


def piece_redundancy(
    g: Graph,
    nodes: frozenset[str],
    full_sizes: Mapping[str, tuple[int, int]],
    input_size: tuple[int, int],
    n_split: int,
) -> float:
    """C(M): extra FLOPs of an ``n_split``-way 2-D tiled execution vs
    exact (the paper's Fig. 4 reference partition)."""
    return grid_redundant_flops(g, nodes, full_sizes, input_size, n_split)


class _Partitioner:
    def __init__(self, g: Graph, input_size: tuple[int, int],
                 n_split: int, max_diameter: int,
                 max_candidates: int = 512, max_states: int = 20000):
        self.g = g
        self.input_size = input_size
        self.n_split = n_split
        self.d = max_diameter
        self.full = g.forward_sizes(input_size)
        self.F: dict[frozenset, float] = {}
        self.R: dict[frozenset, frozenset] = {}
        self.C_cache: dict[frozenset, float] = {}
        self.states = 0
        # pragmatic pruning for very wide graphs (the paper's diameter
        # bound alone does not tame w>=6 NAS graphs in pure Python):
        # cap candidate ending pieces per state and total DP states;
        # beyond the caps, fall back to the smallest valid piece.
        self.max_candidates = max_candidates
        self.max_states = max_states

    # -- redundancy with memo ------------------------------------------
    def C(self, nodes: frozenset[str]) -> float:
        hit = self.C_cache.get(nodes)
        if hit is None:
            hit = piece_redundancy(self.g, nodes, self.full,
                                   self.input_size, self.n_split)
            self.C_cache[nodes] = hit
        return hit

    # -- must-set: vertices of `remaining` adjacent to removed part -----
    def must(self, remaining: frozenset[str]) -> frozenset[str]:
        g = self.g
        out = set()
        for n in remaining:
            if any(s not in remaining for s in g.succs[n]):
                out.add(n)
        return frozenset(out)

    # -- enumerate ending pieces -----------------------------------------
    def ending_pieces(self, remaining: frozenset[str]):
        """All suffix-closed S ⊆ remaining with must ⊆ S, diameter ≤ d.

        Enumeration band: only vertices whose longest path to a sink of
        ``remaining`` is ≤ d can appear in a bounded-diameter ending
        piece together with that sink; we enumerate order ideals of the
        reversed DAG restricted to that band.
        """
        g = self.g
        must = self.must(remaining)
        # height = longest path to any sink of `remaining`
        height: dict[str, int] = {}
        order = [n for n in g.topo_order if n in remaining]
        for n in reversed(order):
            hs = [height[s] + 1 for s in g.succs[n] if s in remaining]
            height[n] = max(hs, default=0)
        band = [n for n in order if height[n] <= self.d]
        band_set = set(band)
        if not must <= band_set:
            # the forced vertices are too deep: take everything reachable
            # down from them (single fallback piece = rest of the graph)
            yield remaining
            return

        # Grow suffix-closed sets over `band`, processed in reverse topo
        # order so a vertex may be added only after all its successors.
        # ``depth[n]`` = longest path from n inside the selection; since
        # selections are suffix-closed, max depth == piece diameter, so we
        # prune incrementally instead of checking at the leaves.
        rev = list(reversed(band))

        def rec(i: int, sel: set[str], depth: dict[str, int]):
            if i == len(rev):
                if sel:
                    yield frozenset(sel)
                return
            n = rev[i]
            succs_in = [s for s in g.succs[n] if s in remaining]
            can_add = all(s in sel for s in succs_in)
            dn = 0
            if can_add:
                dn = 1 + max((depth[s] for s in succs_in), default=-1)
                if dn > self.d:
                    can_add = False
            # choice 1: skip n (only legal if n not forced)
            if n not in must:
                yield from rec(i + 1, sel, depth)
            elif not can_add:
                return  # forced vertex cannot be added -> dead branch
            # choice 2: add n
            if can_add:
                sel.add(n)
                depth[n] = dn
                yield from rec(i + 1, sel, depth)
                sel.discard(n)
                del depth[n]

        yield from rec(0, set(), {})

    # -- the DP -----------------------------------------------------------
    def solve(self, remaining: frozenset[str]) -> float:
        if not remaining:
            return 0.0
        if remaining in self.F:
            return self.F[remaining]
        self.states += 1
        best, best_piece = float("inf"), None
        budget = (self.max_candidates
                  if self.states <= self.max_states else 1)
        for me in self.ending_pieces(remaining):
            budget -= 1
            c = self.C(me)
            rest = remaining - me
            cur = max(self.solve(rest), c)
            if cur < best:
                best, best_piece = cur, me
            if budget <= 0:
                break
        if best_piece is None:  # no bounded piece: swallow everything
            best_piece = remaining
            best = self.C(remaining)
        self.F[remaining] = best
        self.R[remaining] = best_piece
        return best

    def obtain(self) -> list[frozenset[str]]:
        out: list[frozenset[str]] = []
        remaining = frozenset(self.g.layers)
        while remaining:
            piece = self.R[remaining]
            out.append(piece)
            remaining = remaining - piece
        out.reverse()  # ending pieces are peeled from the back
        return out


def partition_graph(
    g: Graph,
    input_size: tuple[int, int],
    n_split: int = 2,
    max_diameter: int = 5,
) -> PartitionResult:
    """Run Algorithm 1 on the whole graph."""
    t0 = time.perf_counter()
    p = _Partitioner(g, input_size, n_split, max_diameter)
    obj = p.solve(frozenset(g.layers))
    node_sets = p.obtain()
    pieces = [Piece(ns, p.C(ns), i) for i, ns in enumerate(node_sets)]
    return PartitionResult(pieces, obj, p.states, time.perf_counter() - t0)


def partition_graph_dnc(
    g: Graph,
    input_size: tuple[int, int],
    n_split: int = 2,
    max_diameter: int = 5,
    chunk: int = 40,
    keep_margin: int = 2,
) -> PartitionResult:
    """Divide-and-conquer driver for very wide/deep graphs (§6.2.3).

    Cut a ~``chunk``-vertex prefix (closed under predecessors), run
    Algorithm 1 on it, keep all result pieces except the last
    ``keep_margin`` (those may straddle the cut line), remove the kept
    vertices and repeat on the rest.
    """
    t0 = time.perf_counter()
    full = g.forward_sizes(input_size)
    remaining = list(g.topo_order)
    kept: list[frozenset[str]] = []
    states = 0
    while remaining:
        take = remaining[: min(chunk, len(remaining))]
        take_set = set(take)
        # close under predecessors within remaining (should already hold
        # for a topo prefix, but be safe)
        sub = _induced_subgraph(g, take_set)
        p = _Partitioner(sub, input_size, n_split, max_diameter)
        # the sub-partitioner needs sizes consistent with the full graph
        p.full = {n: full[n] for n in take_set}
        # sources of the chunk need their true input sizes
        p.input_size = input_size
        p.solve(frozenset(sub.layers))
        pieces = _obtain_from(p, frozenset(sub.layers))
        states += p.states
        if len(remaining) > len(take):  # not the last chunk: drop margin
            drop = min(keep_margin, max(0, len(pieces) - 1))
            pieces = pieces[: len(pieces) - drop] if drop else pieces
        kept.extend(pieces)
        used = set().union(*pieces) if pieces else take_set
        remaining = [n for n in remaining if n not in used]
    cobj = 0.0
    out: list[Piece] = []
    pp = _Partitioner(g, input_size, n_split, max_diameter)
    for i, ns in enumerate(kept):
        c = pp.C(ns)
        cobj = max(cobj, c)
        out.append(Piece(ns, c, i))
    return PartitionResult(out, cobj, states, time.perf_counter() - t0)


def _obtain_from(p: _Partitioner, root: frozenset[str]) -> list[frozenset[str]]:
    out = []
    remaining = root
    while remaining:
        piece = p.R[remaining]
        out.append(piece)
        remaining = remaining - piece
    out.reverse()
    return out


def _induced_subgraph(g: Graph, nodes: set[str]) -> Graph:
    sub = Graph()
    for n in g.topo_order:
        if n in nodes:
            sub.layers[n] = g.layers[n]
    sub.edges = [(u, v) for u, v in g.edges if u in nodes and v in nodes]
    sub._invalidate()
    return sub


def chain_pieces(g: Graph) -> list[frozenset[str]]:
    """Trivial partition for chain graphs: every vertex its own piece."""
    return [frozenset({n}) for n in g.topo_order]


def block_pieces(g: Graph, blocks: Sequence[Sequence[str]]) -> list[Piece]:
    """Baseline of [6]/[17]: treat whole blocks as pieces."""
    return [Piece(frozenset(b), 0.0, i) for i, b in enumerate(blocks)]
