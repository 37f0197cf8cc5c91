"""``repro_torch.dist`` — real multi-worker pipeline execution.

PICO's premise is an offline-plan / online-execute split; this package
is the online half made real.  A :class:`~repro_torch.dist.launcher.
DistLauncher` turns a shipped :class:`~repro_torch.api.deployment.Deployment`
artifact into a chain of persistent stage workers — threads locally,
real OS processes via the multiprocessing *spawn* context — moving
length-prefixed framed tensors over pluggable transports
(:mod:`~repro_torch.dist.transport`: in-memory queue pairs and TCP sockets,
one shared codec).  Workers receive only the versioned JSON artifact
(the round-trip is the hand-off; no pickled objects), rebuild
model/plan/params deterministically, and run ``recv -> compiled
StageExecutor -> send`` loops with heartbeats; dead peers surface as
:class:`~repro_torch.runtime.churn.DeviceLeave` churn events and every
submitted frame ends either completed or dropped-with-reason.

The simulator stays the oracle: :func:`~repro_torch.dist.validate.validate`
pins distributed outputs bit-identical to the single-process compiled
path and sanity-checks observed-vs-modeled per-stage cost ratios.

The port of the JAX package's ``repro.dist``: the wire codec is the
same byte for byte, and each worker runs its stage through the port's
compiled stage on the deployment's device (on a CUDA device, the
stage's CUDA graph and the hand-written conv kernel).

Entry points::

    launcher = dep.fleet(repro_torch.DistSpec())   # public entry point
    report = launcher.run(frames)
    from repro_torch.dist import validate
    assert validate(dep).ok
"""

from .launcher import DistLauncher, DistReport
from .transport import (Message, MemoryTransport, TCPListener, TCPTransport,
                        Transport, decode, encode, memory_pair)
from .validate import DistValidation, make_frames, validate
from .worker import StageWorker, worker_main

__all__ = [
    "DistLauncher", "DistReport", "DistValidation", "MemoryTransport",
    "Message", "StageWorker", "TCPListener", "TCPTransport", "Transport",
    "decode", "encode", "make_frames", "memory_pair", "validate",
    "worker_main",
]
