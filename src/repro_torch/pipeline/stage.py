"""Stage executor: run one pipeline stage's fused segment on device tiles.

The default mode runs the stage as one :class:`CompiledStage` fetched
from the stage cache (identical stages across re-plans share one), with
conv->pool chains fused into one kernel call, replayed from a CUDA graph
on a CUDA device.  ``mode="eager"`` keeps the plain per-tile loop with
no fusion as the oracle, never graphed.  ``run_frames``
takes a stack of frames: compiled mode folds it into the batch axis,
eager mode loops over it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

from ..core.pipeline_dp import StagePlan
from .halo import TilePlan, plan_tiles, split_inputs, stitch_outputs


@dataclass
class StageExecutor:
    """Executable form of one StagePlan for a CNNDef."""

    model: "CNNDef"                  # noqa: F821 (models.cnn.builder)
    nodes: frozenset[str]
    fractions: list[float]
    name: str = "stage"
    backend: str | None = None       # None -> model.backend -> registry default
    mode: str = "compiled"           # "compiled" | "eager"
    fuse: bool = True                # lower conv->pool chains as one fused
    #                                  kernel call (compiled mode, backends
    #                                  with a fused lowering only)

    def __post_init__(self):
        g = self.model.graph
        self.nodes = frozenset(self.nodes)
        self.sinks = g.sinks(self.nodes)
        self.plans: list[TilePlan] = plan_tiles(
            g, self.nodes, self.model.full_sizes, self.model.input_size,
            self.fractions)
        # (node, outside_pred) pairs fed across the stage boundary
        self.needs = self.model.boundary_needs(self.nodes)
        if self.backend is None:
            # imported here: repro_torch.exec imports this package
            from ..exec import backends as _backends
            self.backend = self.model.backend or _backends.DEFAULT_BACKEND
        if self.mode not in ("compiled", "eager"):
            raise ValueError(f"unknown mode {self.mode!r}")
        # per-call-invariant part of the cache key, computed once so the
        # per-frame lookup only hashes boundary shapes
        from ..exec.cache import static_stage_key
        self._static_key = static_stage_key(self.model, self.nodes,
                                            self.plans, self.needs)

    def boundary_inputs(self, produced: Mapping[str, torch.Tensor],
                        image: torch.Tensor | None
                        ) -> dict[tuple[str, str | None], torch.Tensor]:
        """Full-width boundary tensors for every (node, pred) need."""
        return {(n, p): (image if p is None else produced[p])
                for (n, p) in self.needs}

    def __call__(self, params, produced: Mapping[str, torch.Tensor],
                 image: torch.Tensor | None = None, *, copy_out: bool = True
                 ) -> dict[str, torch.Tensor]:
        """The stage's sinks for one frame.  ``copy_out`` as in
        :meth:`CompiledStage.__call__` (compiled mode on CUDA only)."""
        boundary = self.boundary_inputs(produced, image)
        if self.mode == "eager":
            return self._run_eager(params, boundary)
        return self._executable(boundary)(params, boundary,
                                          copy_out=copy_out)

    def run_frames(self, params, produced: Mapping[str, torch.Tensor],
                   images: torch.Tensor | None = None, *,
                   copy_out: bool = True) -> dict[str, torch.Tensor]:
        """Frame-stack form of ``__call__``: every boundary tensor (and
        ``images``) carries a leading frame axis; sinks come back stacked
        the same way.  Compiled mode folds the stack into the batch axis
        in one pass; eager mode loops frames through the oracle path."""
        boundary = self.boundary_inputs(produced, images)
        if self.mode == "eager":
            n = next(iter(boundary.values())).shape[0]
            per = [self._run_eager(params, {k: v[f] for k, v in
                                            boundary.items()})
                   for f in range(n)]
            return {s: torch.stack([o[s] for o in per]) for s in self.sinks}
        return self._executable(boundary).run_frames(params, boundary,
                                                     copy_out=copy_out)

    # ------------------------------------------------------------------

    def _executable(self, boundary):
        from ..exec.cache import compiled_stage
        return compiled_stage(self.model, self.nodes, self.plans,
                              self.needs, self.sinks, backend=self.backend,
                              relu=True, boundary=boundary,
                              static_key=self._static_key, fuse=self.fuse)

    def _run_eager(self, params, boundary) -> dict[str, torch.Tensor]:
        """The plain path: eager loop over device tiles, no fusion."""
        tiles_in = split_inputs(self.plans, self.needs, boundary)
        tiles_out = []
        for tp, tin in zip(self.plans, tiles_in):
            if tp.empty:
                tiles_out.append({})
                continue
            res = self.model.run_segment(params, self.nodes, tin,
                                         ranges=(tp.out_ranges, tp.in_ranges),
                                         backend=self.backend)
            tiles_out.append(res)
        return stitch_outputs(self.plans, self.sinks, tiles_out)


def executors_from_plan(model: "CNNDef", stages: Sequence[StagePlan],  # noqa: F821
                        backend: str | None = None, mode: str = "compiled",
                        spec=None) -> list[StageExecutor]:
    """Build one executor per stage.  ``spec``
    (:class:`~repro_torch.api.specs.ExecSpec`) supersedes the individual
    ``backend``/``mode`` knobs when given."""
    fuse = True
    if spec is not None:
        backend, mode, fuse = spec.backend, spec.mode, spec.fuse
    return [StageExecutor(model, st.nodes, list(st.fractions),
                          name=f"stage{si}", backend=backend, mode=mode,
                          fuse=fuse)
            for si, st in enumerate(stages)]
