"""PICO core: graph IR, cost model, and the paper's three algorithms.

Framework-free copies of the JAX package's ``repro.core`` modules that
the planning half of the main path needs (graph, cost, partition,
pipeline DP, heterogeneous adjustment, planner facade, simulator), the
Pareto front over plans and the baseline planners.
"""

from .graph import Graph, LayerSpec, tile_widths, proportional_widths
from .cost import (Device, Cluster, CostTable, SegmentCost, StageCost,
                   segment_cost, stage_cost, make_pi_cluster,
                   BYTES_PER_ELEM)
from .partition import (Piece, PartitionResult, partition_graph,
                        partition_graph_dnc, piece_redundancy, chain_pieces,
                        block_pieces)
from .pipeline_dp import PipelineDP, PipelinePlan, StagePlan, plan_pipeline
from .hetero import adjust_stages
from .planner import (PicoPlan, plan, plan_with_spec, replan, recost,
                      partition_cluster, split_devices, ClusterPartition,
                      TenantShare)
from .simulate import (simulate, SimReport, DeviceReport, PlanMetrics,
                       plan_metrics)
from .pareto import FrontPoint, ParetoFront, dominates, plan_front
from . import baselines

__all__ = [
    "Graph", "LayerSpec", "tile_widths", "proportional_widths",
    "Device", "Cluster", "CostTable", "SegmentCost", "StageCost",
    "segment_cost", "stage_cost", "make_pi_cluster", "BYTES_PER_ELEM",
    "Piece", "PartitionResult", "partition_graph", "partition_graph_dnc",
    "piece_redundancy", "chain_pieces", "block_pieces",
    "PipelineDP", "PipelinePlan", "StagePlan", "plan_pipeline",
    "adjust_stages", "PicoPlan", "plan", "plan_with_spec", "replan",
    "recost", "partition_cluster", "split_devices", "ClusterPartition",
    "TenantShare", "simulate", "SimReport", "DeviceReport", "PlanMetrics",
    "plan_metrics", "FrontPoint", "ParetoFront", "dominates", "plan_front",
    "baselines",
]
