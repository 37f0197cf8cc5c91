"""Segment compiler: one StagePlan's fused segment -> one callable.

The JAX package lowers a whole stage — split, every device tile's
sub-DAG, stitch — into one ``jax.jit`` executable.  Here a
:class:`CompiledStage` is the stage resolved once (tile plans, boundary
needs, conv->pool chains to fuse), with a body of straight-line tensor
code, the convs going through the backend's fused lowering.  On a CUDA
device the body is captured once as a CUDA graph and replayed
(:mod:`.graph`); on the CPU it runs eagerly.

Two bodies, under the JAX package's names, and an entry point each:

* ``_run`` / ``__call__(params, boundary)`` — one frame;
* ``_run_frames`` / ``run_frames(params, boundary)`` — a stack of
  frames with a leading frame axis.  It folds the frame axis into the
  batch axis and makes one pass, so each conv is one kernel launch with
  a larger M.  That replaces the JAX package's ``lax.scan``; every
  output element is computed as in a per-frame loop.

A graph reads the weights at the addresses it captured, so a stage
keeps one graph per (body, boundary shapes, :func:`params_key`), the
last :data:`GRAPHS_PER_STAGE` of them; they are freed with the stage
when the stage cache drops it.  A graph also holds the conv launch plans
of its capture, so a stage drops its graphs when the installed tuned
plans change (``exec.autotune.generation``); the stage itself resolves
no plan and stays in the cache.  A replay overwrites the graph's outputs,
so the entry points hand out copies unless the caller asks for the
graph's own (``copy_out=False``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, Sequence

import torch

from ..pipeline.halo import TilePlan, split_inputs, stitch_outputs
from . import autotune
from . import graph as cuda_graph
from .backends import DEFAULT_BACKEND, has_fused

#: graphs one stage keeps, least recently replayed dropped first
GRAPHS_PER_STAGE = 4


def fusable_chains(graph, nodes) -> dict[str, str]:
    """conv -> pool pairs in ``nodes`` lowerable as one fused kernel.

    A pool is fusable into its producing conv when the chain is private
    and the pool collapses onto the conv's output grid:

    * the pool is VALID (no padding) and non-overlapping
      (kernel == stride — e.g. the zoo's 2x2/s2 pools), which is the
      shape the kernel epilogue implements;
    * its only predecessor is an in-segment conv;
    * that conv feeds nothing else — no other in-segment successor and
      not a segment sink — so skipping its materialization is safe.

    Together with ``Graph.required_ranges``'s width-range arithmetic
    these conditions also pin the tile geometry: the conv tile is
    exactly the pool's input and starts on the pool grid, which
    ``run_segment`` re-checks per tile before fusing.
    """
    nodes = frozenset(nodes)
    sinks = set(graph.sinks(nodes))
    chains: dict[str, str] = {}
    for n in nodes:
        spec = graph.layers[n]
        if spec.kind != "pool":
            continue
        if (tuple(spec.kernel) != tuple(spec.stride)
                or tuple(spec.padding) != (0, 0)):
            continue
        ps = graph.preds[n]
        if len(ps) != 1 or ps[0] not in nodes:
            continue
        conv = ps[0]
        if graph.layers[conv].kind != "conv" or conv in sinks:
            continue
        if [s for s in graph.succs[conv] if s in nodes] != [n]:
            continue
        chains[conv] = n
    return chains


def segment_signature(graph, nodes, input_size) -> tuple:
    """Hashable fingerprint of a fused segment's geometry + weights.

    Two models whose segments agree on this signature lower to the same
    executable, so cache entries survive re-plans and model rebuilds.
    """
    nodes = frozenset(nodes)
    layers = tuple(sorted(
        (n, s.kind, s.kernel, s.stride, s.padding, s.in_channels,
         s.out_channels, s.flops_coeff, s.global_rf)
        for n, s in ((n, graph.layers[n]) for n in nodes)))
    edges = tuple(sorted((u, v) for u, v in graph.edges
                         if u in nodes and v in nodes))
    return (layers, edges, tuple(input_size))


def params_key(params, nodes) -> tuple:
    """The identity of the weights that the stage of ``nodes`` reads:
    (node, name, address, dtype, shape, strides) of each tensor of their
    params.  A graph reads its weights where it captured them, so equal
    keys mean that the same memory holds this parameter set."""
    key = []
    for n in sorted(nodes):
        for name, t in sorted((params.get(n) or {}).items()):
            if isinstance(t, torch.Tensor):
                key.append((n, name, t.data_ptr(), t.dtype, tuple(t.shape),
                            t.stride()))
    return tuple(key)


class CompiledStage:
    """All device tiles of one stage as a single callable."""

    def __init__(self, model, nodes, plans: Sequence[TilePlan],
                 needs: Sequence[tuple[str, str | None]],
                 sinks: Sequence[str], *, backend: str | None = None,
                 relu: bool = True, fuse: bool = True):
        self.model = model
        self.nodes = frozenset(nodes)
        self.plans = list(plans)
        self.needs = list(needs)
        self.sinks = list(sinks)
        self.backend = backend
        self.relu = relu
        # conv->pool chains lowered as one fused kernel call; only for
        # backends with a fused lowering (torch keeps the composed-op
        # sequence)
        self.fuse = bool(fuse)
        name = backend or getattr(model, "backend", None) or DEFAULT_BACKEND
        self.fusion = fusable_chains(model.graph, self.nodes) \
            if self.fuse and has_fused(name) else {}
        self._graphs: OrderedDict[tuple, cuda_graph.Graph] = OrderedDict()
        # the tuned plans the graphs were captured under
        self._tuning = autotune.generation()

    # bodies --------------------------------------------------------------

    def _run(self, params, boundary: Mapping) -> dict[str, torch.Tensor]:
        tiles_in = split_inputs(self.plans, self.needs, boundary)
        tiles_out = []
        for tp, tin in zip(self.plans, tiles_in):
            if tp.empty:
                tiles_out.append({})
                continue
            tiles_out.append(self.model.run_segment(
                params, self.nodes, tin,
                ranges=(tp.out_ranges, tp.in_ranges),
                relu=self.relu, backend=self.backend,
                fusion=self.fusion))
        return stitch_outputs(self.plans, self.sinks, tiles_out)

    def _run_frames(self, params, boundary: Mapping
                    ) -> dict[str, torch.Tensor]:
        f, n = boundary[self.needs[0]].shape[:2]
        folded = {k: boundary[k].reshape(f * n, *boundary[k].shape[2:])
                  for k in self.needs}
        outs = self._run(params, folded)
        return {s: y.reshape(f, n, *y.shape[1:]) for s, y in outs.items()}

    # public --------------------------------------------------------------

    def __call__(self, params, boundary: Mapping, *, copy_out: bool = True
                 ) -> dict[str, torch.Tensor]:
        """One frame.  ``copy_out=False`` hands out a replay's own output
        tensors, which the stage's next replay overwrites: for a caller
        that is done with them by then (the pipeline runner, whose later
        stages read them within the same call)."""
        return self._execute(self._run, params, boundary, copy_out)

    def run_frames(self, params, boundary: Mapping, *, copy_out: bool = True
                   ) -> dict[str, torch.Tensor]:
        """``boundary`` tensors carry a leading frame axis (F, N, H, W, C);
        returns sink tensors stacked the same way."""
        return self._execute(self._run_frames, params, boundary, copy_out)

    def _execute(self, body, params, boundary: Mapping, copy_out: bool
                 ) -> dict[str, torch.Tensor]:
        """``body`` eagerly, or replayed from its graph for these
        boundary shapes and weights (captured at the first call)."""
        bufs = [boundary[k] for k in self.needs]
        if not cuda_graph.enabled(bufs[0].device):
            return body(params, boundary)
        if self._tuning != autotune.generation():
            self._graphs.clear()
            self._tuning = autotune.generation()
        key = (body.__name__,
               tuple((tuple(b.shape), b.dtype) for b in bufs),
               params_key(params, self.nodes))
        g = self._graphs.get(key)
        if g is None:
            needs = self.needs
            g = self._graphs[key] = cuda_graph.Graph(
                lambda *xs: body(params, dict(zip(needs, xs))), bufs,
                name=f"{body.__name__} of a {len(self.nodes)}-node stage")
            while len(self._graphs) > GRAPHS_PER_STAGE:
                self._graphs.popitem(last=False)
            return g.take_warm()
        self._graphs.move_to_end(key)
        outs = g(*bufs)
        return {s: y.clone() if copy_out else y for s, y in outs.items()}

