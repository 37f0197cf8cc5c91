"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package compiles a decode step and a stage's body with
``jax.jit`` and runs each as one executable.  PyTorch runs eagerly, and
a step of a thousand small kernels is then bound by the host's launches.
:class:`Graph` captures such a body once as a CUDA graph
(``torch.cuda.CUDAGraph``) and replays it: one host call launches every
kernel of the body.

A graph reads and writes fixed addresses: its static inputs (filled with
``copy_`` before each replay), whatever the body reads from outside
(weights, a cache written in place), and its outputs, which each replay
overwrites.  The launch counts of the kernels stay what the card ran:
what the capture added to them is taken back, and each replay credits it
(``kernels._build.credit``).

Graphs are for CUDA devices, chosen by the device's type
(:func:`enabled`); :func:`eager` runs the bodies eagerly on CUDA too,
to time the eager path beside the graphed one or to hold one against the
other, in the thread that enters it.  A capture that fails raises;
nothing falls back to eager.

Several threads may build and replay graphs at once (thread-mode
``repro_torch.dist`` workers).  A capture runs in CUDA's thread-local
capture mode, so another thread's allocations and synchronising copies
during it are legal, and captures take turns under the count lock
(``kernels._build.capture_counts``), which also keeps each capture's
launch accounting its own thread's.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Sequence

import torch

from ..kernels import _build


class _EagerDepth(threading.local):
    n = 0                    # nesting of eager() in this thread


_eager = _EagerDepth()
_captures = 0


def captures() -> int:
    """Graphs captured in this process so far."""
    return _captures


@contextlib.contextmanager
def eager():
    """Within the block, bodies that this thread runs run eagerly on CUDA
    devices too: no graph is captured or replayed.  Other threads keep
    their graphs."""
    _eager.n += 1
    try:
        yield
    finally:
        _eager.n -= 1


def enabled(device: torch.device) -> bool:
    """Whether a body on ``device`` runs as a CUDA graph: on a CUDA
    device, outside this thread's :func:`eager`."""
    return device.type == "cuda" and not _eager.n


def _tensors(tree):
    """The tensors of a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class Graph:
    """``fn(*inputs)`` captured once as a CUDA graph, and replayed.

    Construction clones ``inputs`` into the static inputs, runs ``fn`` on
    them once eagerly on a side stream (the warm-up PyTorch asks for;
    :meth:`take_warm` hands its result over), then captures ``fn`` on
    that stream into a graph with a memory pool of its own.  ``fn`` is
    not kept.

    Calling the graph with tensors of the static inputs' shapes and
    dtypes copies them in, replays the graph on the current stream and
    returns :attr:`outputs` (what ``fn`` returned in the capture): the
    graph's own tensors, which the next replay overwrites.

    Held with the graph, and freed with it: the static inputs, the
    outputs, the pool (``graph.pool()``), the kernels' scratch buffers
    made during the warm-up (:attr:`scratch`) and the launches one
    replay credits (:attr:`launches`).
    """

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 name: str = "graph"):
        device = inputs[0].device
        if device.type != "cuda":
            raise ValueError(f"{name}: a CUDA graph needs CUDA tensors, "
                             f"got {device}")
        self.name = name
        self.inputs = tuple(x.clone() for x in inputs)
        self.scratch: dict[str, torch.Tensor] = {}
        self.graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with _build.owned_scratch(self.scratch), torch.cuda.stream(side):
            self.warm = fn(*self.inputs)
            t0 = time.perf_counter()
            # capture_begin / capture_end, not ``torch.cuda.graph``: that
            # one also collects garbage and empties the allocator's cache
            # at each capture, which a capture per generate call would pay
            # for (and the next prefill again, in cudaMalloc)
            with _build.capture_counts() as self.launches:
                try:
                    self.graph.capture_begin(
                        capture_error_mode="thread_local")
                    try:
                        self.outputs = fn(*self.inputs)
                    finally:
                        self.graph.capture_end()
                except RuntimeError as err:
                    raise RuntimeError(f"{name}: CUDA graph capture or "
                                       f"instantiation failed: {err}"
                                       ) from err
                global _captures
                _captures += 1
        #: host seconds of the capture and the instantiation
        self.capture_s = time.perf_counter() - t0
        current.wait_stream(side)
        for t in _tensors(self.warm):    # made on the side stream
            t.record_stream(current)

    def take_warm(self):
        """The warm-up's result (eager, not the graph's), handed over:
        the graph lets go of it."""
        warm, self.warm = self.warm, None
        return warm

    def __call__(self, *inputs: torch.Tensor):
        if len(inputs) != len(self.inputs):
            raise ValueError(f"{self.name}: {len(inputs)} inputs, the "
                             f"graph takes {len(self.inputs)}")
        for buf, x in zip(self.inputs, inputs):
            if x.shape != buf.shape or x.dtype != buf.dtype:
                raise ValueError(
                    f"{self.name}: input {tuple(x.shape)} {x.dtype}, the "
                    f"graph was captured for {tuple(buf.shape)} "
                    f"{buf.dtype}")
            if x.data_ptr() != buf.data_ptr():
                buf.copy_(x)
        self.graph.replay()
        _build.credit(self.launches)
        return self.outputs
