"""Cost calibration: time compiled stages, emit a CostTable.

The counterpart of the JAX package's ``exec/calibrate.py``, with its
semantics and names.  The planner's analytic model prices a segment as
FLOPs/capacity times a per-device regression coefficient alpha (Eq. 7).
This module runs each stage of a plan through its compiled stage
(:mod:`repro_torch.exec.compiler`; on a GPU the stage's CUDA graph,
captured by the warm-up call and replayed by the timed ones), measures
wall time, and expresses the result as a per-segment ratio

    ratio(seg) = measured_seconds / (executed_FLOPs / host_FLOPs)

i.e. how much slower (or faster, via fusion) the segment runs than the
roofline estimate at ``host_flops``, the fp32 matmul rate measured on
the deployment's device (:func:`measure_host_flops`).  The resulting
:class:`~repro_torch.core.cost.CostTable` plugs into
``core.cost.stage_cost`` and the planner's ``plan``/``replan``/
``recost``, replacing the purely analytic alpha with measured numbers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

import torch

from ..core.cost import CostTable
from ..obs import trace as obs_trace
from ..obs.metrics import default_registry


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_host_flops(n: int = 512, iters: int = 5,
                       device: str | torch.device = "cuda") -> float:
    """The achievable fp32 matmul FLOP/s of ``device``: the best of
    ``iters`` timed n x n ``torch.matmul`` calls after a warm-up, each
    synchronised on a GPU, with TF32 off for the call (IEEE fp32, the
    precision the stages run in)."""
    device = torch.device(device)
    a = torch.ones((n, n), dtype=torch.float32, device=device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        torch.matmul(a, a)
        _sync(device)
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            torch.matmul(a, a)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return 2.0 * n ** 3 / best


@dataclass
class StageCalibration:
    index: int
    nodes: frozenset[str]
    flops: float
    measured_s: float
    analytic_s: float

    @property
    def ratio(self) -> float:
        return self.measured_s / self.analytic_s if self.analytic_s > 0 else 1.0


@dataclass
class CalibrationReport:
    host_flops: float
    stages: list[StageCalibration] = field(default_factory=list)

    def table(self) -> CostTable:
        ratios = {s.nodes: s.ratio for s in self.stages if s.analytic_s > 0}
        mean = (sum(ratios.values()) / len(ratios)) if ratios else 1.0
        return CostTable(ratios, default=mean)


def calibrate_plan(model, params, stages: Sequence, *,
                   backend: str | None = None, iters: int = 3,
                   host_flops: float | None = None,
                   device: str | torch.device = "cuda"
                   ) -> CalibrationReport:
    """Time every stage of a plan through its compiled stage on
    ``device`` (where ``params`` live).

    ``stages`` is the ``PicoPlan.pipeline.stages`` list (each entry
    carries nodes, fractions and the analytic SegmentCost).  Boundary
    tensors are produced by actually running the pipeline in plan order
    on a standard normal frame (seed 0), so each stage is timed on its
    real input shapes: a warm-up call (on a GPU it captures the stage's
    graph), then the best of ``iters`` calls, each synchronised.
    Returns a report whose :meth:`~CalibrationReport.table` feeds the
    planner.
    """
    from ..pipeline.stage import StageExecutor     # lazy: avoid cycle
    device = torch.device(device)
    host_flops = host_flops or measure_host_flops(device=device)
    w, h = model.input_size
    image = torch.randn((1, h, w, model.in_channels),
                        generator=torch.Generator().manual_seed(0)).to(device)
    report = CalibrationReport(host_flops)
    produced: dict = {}
    for si, st in enumerate(stages):
        with obs_trace.current().wall_span("calibrate", stage=si,
                                           n_nodes=len(st.nodes)):
            ex = StageExecutor(model, st.nodes, list(st.fractions),
                               name=f"calib{si}", backend=backend)
            outs = ex(params, produced, image)          # build + warm
            _sync(device)
            best = float("inf")
            for _ in range(max(1, iters)):
                t0 = time.perf_counter()
                ex(params, produced, image)
                _sync(device)
                best = min(best, time.perf_counter() - t0)
        flops = float(sum(st.cost.seg.per_device_flops))
        default_registry().histogram("exec.calibrate.stage_s").observe(best)
        report.stages.append(StageCalibration(
            si, frozenset(st.nodes), flops, best, flops / host_flops))
        produced.update(outs)
    return report


def calibrated_plan(g, cluster, input_size, model, params, *,
                    iters: int = 3, plan_spec=None,
                    device: str | torch.device = "cuda"):
    """Plan -> calibrate -> re-plan on measured costs (one closed loop).

    Returns ``(pico, report)`` where ``pico`` was re-planned with the
    measured :class:`CostTable` and ``report`` holds the raw timings.
    ``plan_spec`` (:class:`~repro_torch.api.specs.PlanSpec`) defaults to
    ``PlanSpec()``.
    """
    from ..api.specs import PlanSpec
    from ..core.planner import plan_with_spec
    spec = plan_spec or PlanSpec()
    first = plan_with_spec(g, cluster, input_size, spec)
    report = calibrate_plan(model, params, first.pipeline.stages,
                            iters=iters, device=device)
    table = report.table()
    return plan_with_spec(g, cluster, input_size, spec,
                          partition=first.partition,
                          cost_table=table), report
