"""Event-driven heterogeneous-cluster runtime with dynamic re-planning.

The executable counterpart of ``core.simulate``: device actors with
virtual clocks, queues, memory budgets and DVFS; timed stage-to-stage
links with latency/jitter/degradation; an EWMA monitor feeding measured
costs back into the planner; and churn-triggered re-planning that
migrates in-flight frames at stage boundaries.
"""

from .events import Event, EventKind, EventQueue
from .links import LinkMap, LinkModel
from .actors import ActorPool, DeviceActor
from .monitor import EWMA, Monitor
from .churn import (ChurnEvent, DeviceJoin, DeviceLeave, FreqScale,
                    LinkDegrade)
from .executor import (Frame, PipelineRuntime, ReplanRecord, RuntimeConfig,
                       RuntimeDeviceReport, RuntimeReport)
from .validate import ValidationReport, validate

__all__ = [
    "Event", "EventKind", "EventQueue",
    "LinkMap", "LinkModel",
    "ActorPool", "DeviceActor",
    "EWMA", "Monitor",
    "ChurnEvent", "DeviceJoin", "DeviceLeave", "FreqScale", "LinkDegrade",
    "Frame", "PipelineRuntime", "ReplanRecord", "RuntimeConfig",
    "RuntimeDeviceReport", "RuntimeReport",
    "ValidationReport", "validate",
]
