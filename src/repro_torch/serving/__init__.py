"""Serving: pipelined CNN inference servers, the multi-tenant
asynchronous scheduler, and the LM decode loop."""

from .server import PipelineServer, ServeStats, StreamingPipelineServer
from .queueing import (OpenLoopGenerator, TenantQueue, WeightedArbiter,
                       coalesce)
from .scheduler import (RepartitionRecord, SchedulerConfig, ServeReport,
                        ServingScheduler, TenantConfig, TenantJoin,
                        TenantLeave, serve_time_sliced, tenant_seed)
from .lm import generate

__all__ = ["PipelineServer", "ServeStats", "StreamingPipelineServer",
           "OpenLoopGenerator", "TenantQueue", "WeightedArbiter", "coalesce",
           "RepartitionRecord", "SchedulerConfig", "ServeReport",
           "ServingScheduler", "TenantConfig", "TenantJoin", "TenantLeave",
           "serve_time_sliced", "tenant_seed",
           "generate"]
