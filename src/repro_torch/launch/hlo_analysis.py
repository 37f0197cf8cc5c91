"""Per-device census of one call of the port: the counterpart of the JAX
package's ``launch/hlo_analysis.py``.

The reference parses the compiled, post-SPMD HLO of a step.  The port
has no compiled module to read: it censuses the ops that one call
*dispatches* on this rank, not HLO.  :class:`Census` is a
``TorchDispatchMode`` entered around the call, and its record is the
reference's :class:`HloCensus` (the same fields), so the dry run, the
profile and the report read one schema.

* **Per device.**  An op on DTensor arguments is deferred (the mode
  returns ``NotImplemented``), so DTensor runs it as ops on this rank's
  local shards, and those are what the census sees and counts.  The
  global-shape "shadow" ops that DTensor's sharding propagator runs on
  fake tensors to derive an output's metadata (on a cold cache only)
  are not counted: the census marks the propagator's calls while it is
  active and skips every op inside them.
* **FLOPs** of a plain op come from ``torch.utils.flop_counter``'s
  registry (matmuls, convolutions, attention), as the reference counts
  ``dot`` and ``convolution``; a hand-written kernel's come from its
  wrapper's ``work(...)`` (``kernels/_build.record_work``), under the
  kernel's name, whether it launched on the card or answered on fake
  tensors; the torch ops inside a wrapper are covered by that work and
  not counted again (``_build.quiet``).
* **Bytes** (``hbm_bytes``): an op's tensor inputs plus its outputs, an
  output that is one of its inputs (an in-place op) counted once; an
  in-place indexed write (``index_copy_``, ``index_put_``) its index and
  values read and the values' bytes written, not the whole tensor.
  Views, allocations (``empty``, ``empty_strided``, ...) and the wait of
  a functional collective move nothing and count 0.
* **Collectives**: the functional ones that DTensor's redistributions
  issue (``_c10d_functional``) and the c10d ones of ``ring_shift``,
  ``gather_axis`` and ``sharded.combine``, each as its result's bytes
  under the reference's five kinds (a send and its receive are one
  ``collective-permute``, counted at the receive), added to
  ``hbm_bytes`` too, as the reference adds them.  DTensor's
  Shard-to-Shard redistribution (``shard_dim_alltoall``) counts as one
  ``all-to-all`` of its result's bytes, the ops inside it not at all: on
  a CUDA mesh it is one ``_dtensor.shard_dim_alltoall`` op, on a CPU
  mesh DTensor falls back to an all-gather and a chunk (gloo has no
  all-to-all), which would otherwise count as a gather of the whole.

``by_computation`` holds one entry per op or kernel name: its calls
(``mult``), FLOPs and collective bytes.  Eager execution has no loop
structure to recover: every layer's ops are dispatched, and counted, as
they run, so the reference's loop-trip propagation has no counterpart.
``coll_ops`` keeps each collective (bytes, kind, op) for the profile's
largest ones.
"""

from __future__ import annotations

import threading
from dataclasses import asdict, dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import _build

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
#: c10d ops: kind, and whether the result is the op's first argument
#: (the buffers it writes); a send moves what its receive counts
_C10D = {
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}
_C10D_SILENT = {"send", "barrier", "monitored_barrier_"}
#: ops that move no bytes: allocations, and the waits of functional
#: collectives (the result is the collective's own buffer)
_NO_BYTES = {
    "aten.empty.memory_format", "aten.empty_strided.default",
    "aten.empty_like.default", "aten.new_empty.default",
    "aten.new_empty_strided.default", "aten.lift_fresh.default",
    "aten.detach.default", "aten.alias.default",
    "_c10d_functional.wait_tensor.default",
}
#: in-place indexed writes: they read their index and values and write
#: the values' bytes into ``self``, whose other entries stay untouched
_WRITES_INTO = {
    "aten.index_copy_.default", "aten.index_put_.default",
    "aten._index_put_impl_.default", "aten.scatter_.src",
}


@dataclass
class HloCensus:
    """The reference's census record: per-device FLOPs, bytes moved and
    collective bytes and counts by kind; ``by_computation`` per op or
    kernel name {mult, flops, coll_bytes, hbm_bytes}; ``coll_ops`` each collective
    as (bytes, kind, op name)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: dict[str, float] = field(default_factory=dict)
    coll_counts: dict[str, float] = field(default_factory=dict)
    by_computation: dict[str, dict] = field(default_factory=dict)
    coll_ops: list = field(default_factory=list)

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "HloCensus":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _moves_nothing(func) -> bool:
    return func.is_view or str(func) in _NO_BYTES


#: this thread's depth inside DTensor's sharding propagation (its ops
#: there are metadata shadows, not this rank's work)
_PROPAGATING = threading.local()
_PROP_METHODS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
_MARKED: list = []


def _mark_propagation() -> None:
    """Wrap DTensor's sharding propagator's metadata pass so that each
    call counts this thread's depth inside it while it runs (once a
    process: the wrapper only adds to a thread-local counter)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    if _MARKED:
        return
    for name in _PROP_METHODS:
        fn = ShardingPropagator.__dict__.get(name)
        if fn is None:
            continue

        def marked(*a, __fn=fn, **kw):
            _PROPAGATING.depth = getattr(_PROPAGATING, "depth", 0) + 1
            try:
                return __fn(*a, **kw)
            finally:
                _PROPAGATING.depth -= 1
        setattr(ShardingPropagator, name, marked)
        _MARKED.append(name)
    if not _MARKED:
        raise RuntimeError("Census: DTensor's sharding propagator has none "
                           f"of {_PROP_METHODS}; its shadow ops would be "
                           "counted")


#: the name an all-to-all redistribution counts under, on either mesh
ALLTOALL_OP = "_dtensor.shard_dim_alltoall.default"
_ALLTOALL: list = []


def _mark_alltoall() -> None:
    """Wrap DTensor's ``shard_dim_alltoall`` (where its module and
    ``placement_types``, which imports it by name, hold it; once a
    process) so that under a census the call counts as one all-to-all of
    its result's bytes and the ops inside it are quiet; outside a census
    it only calls through."""
    from torch.distributed.tensor import _collective_utils, placement_types
    if _ALLTOALL:
        return
    fn = getattr(_collective_utils, "shard_dim_alltoall", None)
    if fn is None:
        raise RuntimeError("Census: DTensor has no shard_dim_alltoall; its "
                           "all-to-alls would be counted as other ops")

    def counted(*a, **kw):
        census = _build.CENSUS[-1] if _build.CENSUS else None
        if census is None or in_propagation():
            return fn(*a, **kw)
        census.quiet += 1
        try:
            out = fn(*a, **kw)
        finally:
            census.quiet -= 1
        if not census.quiet:
            census._collective(ALLTOALL_OP, "all-to-all", _nbytes(out))
        return out
    for mod in (_collective_utils, placement_types):
        if getattr(mod, "shard_dim_alltoall", None) is fn:
            mod.shard_dim_alltoall = counted
    _ALLTOALL.append(counted)


def in_propagation() -> bool:
    """Whether this thread is inside DTensor's sharding propagation (once
    a census has marked it: :func:`_mark_propagation`)."""
    return getattr(_PROPAGATING, "depth", 0) > 0


class Census(TorchDispatchMode):
    """Counts what a call dispatches on this rank (see the module
    docstring); ``with Census() as c: fn(...)``, then ``c.census`` is the
    :class:`HloCensus`.  Enter it inside any ``FakeTensorMode`` of the
    call's tensors.  One census a process at a time: a backward that
    autograd runs on a device thread of its own counts in it too (the
    dispatch mode follows the backward there, and so must the kernels'
    work, ``_build.record_work``)."""

    def __init__(self):
        super().__init__()
        self.census = HloCensus()
        self.quiet = 0

    def __enter__(self):
        _mark_propagation()
        _mark_alltoall()
        with _build.COUNT_LOCK:
            if _build.CENSUS:
                raise RuntimeError("Census: another census is active in "
                                   "this process")
            _build.CENSUS.append(self)
        try:
            return super().__enter__()
        except BaseException:
            _build.CENSUS.pop()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _build.CENSUS.remove(self)

    def _entry(self, name: str) -> dict:
        return self.census.by_computation.setdefault(
            name, {"mult": 0, "flops": 0.0, "coll_bytes": 0.0,
                   "hbm_bytes": 0.0})

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One call of a hand-written kernel (``_build.record_work``)."""
        if in_propagation():
            return
        e = self._entry(name)
        e["mult"] += 1
        e["flops"] += float(flops)
        e["hbm_bytes"] += float(nbytes)
        self.census.flops += float(flops)
        self.census.hbm_bytes += float(nbytes)

    def _collective(self, name: str, kind: str, nbytes: int) -> None:
        c = self.census
        c.coll_bytes[kind] = c.coll_bytes.get(kind, 0.0) + nbytes
        c.coll_counts[kind] = c.coll_counts.get(kind, 0.0) + 1
        c.coll_ops.append((nbytes, kind, name))
        c.hbm_bytes += nbytes
        e = self._entry(name)
        e["mult"] += 1
        e["coll_bytes"] += nbytes
        e["hbm_bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.quiet or in_propagation():
            return out
        name = str(func)
        ns, op = func.namespace, func._schema.name.split("::")[-1]
        if ns == "prim":                # metadata queries (prim.device)
            return out
        if ns == "_c10d_functional" and op in _FUNCTIONAL:
            self._collective(name, _FUNCTIONAL[op],
                             sum(map(_nbytes, _tensors(out))))
            return out
        if ns == "c10d":
            if op in _C10D:
                self._collective(name, _C10D[op],
                                 sum(map(_nbytes, _tensors(args[0]))))
            elif op not in _C10D_SILENT:
                raise NotImplementedError(f"Census: no collective kind for "
                                          f"{name}")
            return out
        e = self._entry(name)
        e["mult"] += 1
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            flops = float(count(*args, **kwargs, out_val=out))
            e["flops"] += flops
            self.census.flops += flops
        if name in _WRITES_INTO:
            ins = _tensors((args[1:], kwargs))
            nbytes = sum(map(_nbytes, ins)) + _nbytes(ins[-1])
            e["hbm_bytes"] += nbytes
            self.census.hbm_bytes += nbytes
        elif not _moves_nothing(func):
            ins = _tensors((args, kwargs))
            seen = {id(t) for t in ins}
            nbytes = sum(map(_nbytes, ins)) + sum(
                _nbytes(t) for t in _tensors(out) if id(t) not in seen)
            e["hbm_bytes"] += nbytes
            self.census.hbm_bytes += nbytes
        return out


class Largest(TorchDispatchMode):
    """Watches the sizes of what a call dispatches on this rank: ``most``,
    the most elements of any op's output, and ``vocab_rows``, each output
    (op, shape) that holds whole rows of a vocab of ``vocab`` entries (a
    dim of that size and more than ``vocab`` elements; the one (V,) mask
    of padded slots, which every rank computes alike, is not such a row).
    Enter it inside a :class:`Census`, which marks DTensor's sharding
    propagation: its global-shape metadata ops are no rank's work."""

    def __init__(self, vocab: int | None = None):
        super().__init__()
        self.most = 0
        self.vocab = vocab
        self.vocab_rows: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if in_propagation():
            return out
        for t in _tensors(out):
            self.most = max(self.most, t.numel())
            if self.vocab and self.vocab in t.shape \
                    and t.numel() > self.vocab:
                self.vocab_rows.append((str(func), tuple(t.shape)))
        return out


def mem_tracker():
    """A ``torch.distributed._tools.mem_tracker.MemTracker`` (live bytes
    by device, and their peak) that, like the census, leaves out the
    outputs of DTensor's sharding propagation: global-shape fake
    tensors of metadata, which no rank holds."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if in_propagation():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)
    return Tracker()

