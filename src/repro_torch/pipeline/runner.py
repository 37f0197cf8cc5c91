"""Pipeline runner: execute a full PICO plan over frames.

Two execution modes:

* :class:`PipelineRunner` runs the stages in plan order for each frame
  on one device (functional mode, the form used to run and validate
  plans);
* :func:`microbatch_pipeline` runs a GPipe schedule over one axis of a
  ``torch.distributed`` device mesh (``launch/mesh.py``): each rank
  holds one stage, microbatches stream through, and a stage's output is
  the only traffic between ranks, one hand-off a tick.  Every rank of
  the mesh calls it, as every shard runs the reference's ``shard_map``
  body.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from ..core.pipeline_dp import PipelinePlan
# HAND_OFFS is read here by the pipeline's callers: the counter of
# launch/mesh.py's ring_shift, the one hand-off of the port
from ..launch.mesh import HAND_OFFS, ring_shift, stages_on_host  # noqa: F401
from ..training import tree
from .stage import executors_from_plan


@dataclass
class PipelineRunner:
    model: "CNNDef"                  # noqa: F821 (models.cnn.builder)
    plan: PipelinePlan
    backend: str | None = None       # conv lowering; None -> model default
    mode: str = "compiled"           # "compiled" | "eager" stage execution
    exec_spec: object = None         # ExecSpec; supersedes backend/mode

    def __post_init__(self):
        self.stages = executors_from_plan(self.model, self.plan.stages,
                                          backend=self.backend,
                                          mode=self.mode,
                                          spec=self.exec_spec)
        # a stage whose outputs leave the call hands out copies; the
        # others may hand out their CUDA graph's own outputs, which the
        # later stages of the same call read before any replay of theirs
        sinks = set(self.model.graph.sinks())
        self._copy_out = [bool(sinks & set(ex.sinks)) for ex in self.stages]

    def __call__(self, params, image: torch.Tensor
                 ) -> dict[str, torch.Tensor]:
        produced: dict[str, torch.Tensor] = {}
        for ex, copy_out in zip(self.stages, self._copy_out):
            produced.update(ex(params, produced, image, copy_out=copy_out))
        return {s: produced[s] for s in self.model.graph.sinks()}

    def run_frames(self, params, frames: torch.Tensor
                   ) -> dict[str, torch.Tensor]:
        """Batch-folded stream: ``frames`` is an (F, N, H, W, C) stack;
        each stage runs the whole stack in one pass (one kernel launch
        per conv and tile).  Returns sinks stacked along F."""
        produced: dict[str, torch.Tensor] = {}
        for ex, copy_out in zip(self.stages, self._copy_out):
            produced.update(ex.run_frames(params, produced, frames,
                                          copy_out=copy_out))
        return {s: produced[s] for s in self.model.graph.sinks()}


# ---------------------------------------------------------------------------
# GPipe-style microbatch pipeline over a mesh axis
# ---------------------------------------------------------------------------

def microbatch_pipeline(
    stage_fn: Callable[[int, object, torch.Tensor], torch.Tensor],
    stage_params,
    x_microbatches: torch.Tensor,
    mesh,
    axis: str = "stage",
) -> torch.Tensor:
    """Run ``n_stages`` chained functions as a pipeline over ``mesh``'s
    ``axis`` (a ``torch.distributed`` ``DeviceMesh``; every rank calls
    this with the same arguments).

    ``stage_fn(stage_id, params_slice, x)`` applies one stage to one
    microbatch and returns a tensor of ``x``'s shape and dtype.
    ``stage_params`` is a tree (dicts, NamedTuples; ``training/tree.py``)
    whose leaves are stacked along axis 0, one entry per stage: the rank
    at coordinate ``sid`` of ``axis`` runs entry ``sid``.
    ``x_microbatches`` has shape (n_micro, ...); compute runs on its
    device.

    The reference's GPipe schedule, tick for tick: n_stages + n_micro - 1
    ticks; each tick stage 0 takes microbatch min(t, n_micro - 1), the
    other stages the tensor handed to them, every stage computes (bubble
    ticks included), and one hand-off on the axis's sub-group
    (``launch/mesh.py``'s :func:`ring_shift`) sends each stage's output
    to the next stage around the ring; the last stage's output at tick t is microbatch
    t - n_stages + 1's result.  A masked ``all_reduce`` (sum) over the
    sub-group then gives every rank of it the last stage's results, of
    ``x_microbatches``' shape.  One stage sends nothing.  On an N-D mesh
    each ring along ``axis`` runs on its own.

    Transport, chosen by the backend (:func:`stages_on_host`): under
    NCCL the tensors move as they are; under gloo a CUDA tensor is copied
    to the host for each hand-off and for the final ``all_reduce``, and
    the received tensor back to the device.  :data:`HAND_OFFS` counts
    the hand-offs of each kind.  Forward only: nothing here is
    differentiated.

    Raises ``ValueError`` when a leaf's leading dimension is not the
    axis's size, or when ``stage_fn`` returns another shape or dtype
    than it was given (on the rank where it does).
    """
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    sid = mesh.get_local_rank(axis)
    for path, leaf in tree.named_leaves(stage_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(f"stage_params leaf {path or '<root>'} has "
                             f"leading dimension {leaf.shape[0]}; the "
                             f"{axis!r} axis has {n_stages} stages")
    p = tree.map_(lambda a: a[sid], stage_params)
    xs = x_microbatches
    n_micro = xs.shape[0]
    buf = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(n_stages + n_micro - 1):
        cur = xs[min(t, n_micro - 1)] if sid == 0 else buf
        y = stage_fn(sid, p, cur)
        if y.shape != cur.shape or y.dtype != cur.dtype:
            raise ValueError(f"stage_fn of stage {sid} returned "
                             f"{tuple(y.shape)} {y.dtype} for an input of "
                             f"{tuple(cur.shape)} {cur.dtype}; every stage "
                             "keeps its input's shape and dtype")
        buf = ring_shift([y], group, sid, n_stages)[0] \
            if n_stages > 1 else y
        out_idx = t - (n_stages - 1)
        if 0 <= out_idx < n_micro:
            outs[out_idx] = y
    if sid != n_stages - 1:
        outs.zero_()
    if stages_on_host(group, outs):
        host = outs.cpu()
        dist.all_reduce(host, group=group)
        return host.to(outs.device)
    dist.all_reduce(outs, group=group)
    return outs
