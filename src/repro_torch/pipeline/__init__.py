"""Executable pipeline: halo split/stitch, stage executor, runner."""

from .halo import (TilePlan, plan_tiles, split_inputs, stitch_outputs,
                   tile_signature)
from .stage import StageExecutor, executors_from_plan
from .runner import PipelineRunner

__all__ = ["TilePlan", "plan_tiles", "split_inputs", "stitch_outputs",
           "tile_signature", "StageExecutor", "executors_from_plan",
           "PipelineRunner"]
