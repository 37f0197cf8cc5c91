"""Cross-check the event runtime against the closed-form simulator.

Runs the same PicoPlan through ``core.simulate`` (the paper's analytic
Figs. 13-16 quantities) and through :class:`PipelineRuntime` under the
ideal config, and reports relative errors on period, latency and
per-device utilization.  Agreement certifies that the executor's event
machinery implements the pipeline recurrence of Eq. 12; divergence
under non-ideal configs *measures* what the analytic model hides.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.cost import Cluster
from ..core.graph import Graph
from ..core.planner import PicoPlan, plan as plan_full
from ..core.simulate import SimReport, simulate
from .executor import PipelineRuntime, RuntimeConfig, RuntimeReport


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a)


@dataclass
class ValidationReport:
    sim: SimReport
    run: RuntimeReport
    period_rel_err: float
    latency_rel_err: float
    utilization_abs_err: float
    tol: float

    @property
    def ok(self) -> bool:
        return (self.period_rel_err <= self.tol
                and self.latency_rel_err <= self.tol
                and self.utilization_abs_err <= self.tol)

    def __str__(self) -> str:
        return (f"period {self.run.period:.4f}s vs {self.sim.period:.4f}s "
                f"({self.period_rel_err:.2%}); "
                f"latency {self.run.latency_first:.4f}s vs "
                f"{self.sim.latency:.4f}s ({self.latency_rel_err:.2%}); "
                f"max util err {self.utilization_abs_err:.2%}; "
                f"{'OK' if self.ok else 'MISMATCH'} (tol {self.tol:.0%})")


def validate(
    g: Graph | None = None,
    cluster: Cluster | None = None,
    input_size: tuple[int, int] | None = None,
    model=None,
    pico: PicoPlan | None = None,
    frames: int = 64,
    tol: float = 0.10,
    config: RuntimeConfig | None = None,
) -> ValidationReport:
    """Measured (runtime) vs predicted (simulator) pipeline metrics."""
    if model is not None:
        g, input_size = model.graph, model.input_size
    if pico is None:
        pico = plan_full(g, cluster, input_size)
    sim = simulate(pico.pipeline, frames=frames, cluster=cluster)
    rt = PipelineRuntime(g, cluster, input_size, pico=pico,
                         config=config or RuntimeConfig.ideal())
    run = rt.run(frames)
    sim_util = {(d.device, d.stage): d.utilization for d in sim.devices}
    util_err = 0.0
    for dr in run.devices:
        match = [u for (name, _), u in sim_util.items() if name == dr.device]
        if match:
            util_err = max(util_err, abs(dr.utilization - max(match)))
    return ValidationReport(
        sim, run,
        period_rel_err=_rel(run.period, sim.period),
        latency_rel_err=_rel(run.latency_first, sim.latency),
        utilization_abs_err=util_err,
        tol=tol,
    )
