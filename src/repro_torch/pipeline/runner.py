"""Pipeline runner: execute a full PICO plan over frames.

:class:`PipelineRunner` runs the stages in plan order for each frame on
one device (functional mode, the form used to run and validate plans).
The JAX package's ``microbatch_pipeline`` (stages spread over a device
mesh) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.pipeline_dp import PipelinePlan
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

    def __call__(self, params, image: torch.Tensor
                 ) -> dict[str, torch.Tensor]:
        produced: dict[str, torch.Tensor] = {}
        for ex in self.stages:
            produced.update(ex(params, produced, image))
        return {s: produced[s] for s in self.model.graph.sinks()}

    def run_frames(self, params, frames: torch.Tensor
                   ) -> dict[str, torch.Tensor]:
        """Batch-folded stream: ``frames`` is an (F, N, H, W, C) stack;
        each stage runs the whole stack in one pass (one kernel launch
        per conv and tile).  Returns sinks stacked along F."""
        produced: dict[str, torch.Tensor] = {}
        for ex in self.stages:
            produced.update(ex.run_frames(params, produced, frames))
        return {s: produced[s] for s in self.model.graph.sinks()}
