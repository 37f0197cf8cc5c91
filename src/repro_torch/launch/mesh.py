"""Device meshes over ``torch.distributed`` (functions only: importing this
module touches no device and no process group).

The counterpart of the JAX package's ``launch/mesh.py``.  A JAX mesh
spans the devices of one process; here a mesh spans the ranks of the
default process group, one coordinate a rank, built with
``torch.distributed.device_mesh.init_device_mesh``.  The caller starts
the group first (``init_process_group`` with its backend, address, world
size and rank); the mesh's sub-group along an axis is
``mesh.get_group(axis)`` and a rank's coordinate on it
``mesh.get_local_rank(axis)``.

The ring hand-off of the whole port is here: :func:`ring_shift` moves
tensors one step round an axis's sub-group (the pipeline's stage
outputs, ring attention's k/v blocks and their gradients), and
:func:`gather_axis` concatenates each rank's piece along the axis.
Under gloo a CUDA tensor goes through the host (:func:`stages_on_host`).

So do the collectives DTensor issues on a mesh's sub-groups (its
redistributions: all-gather, reduce-scatter, all-reduce, all-to-all):
gloo's coalesced all-gather, which DTensor calls, reads a CUDA tensor's
memory from the host and kills the rank (``tools/gloo_cuda_check.py``).
A CUDA mesh over a gloo process group therefore builds its sub-groups
with :data:`HOST_GLOO`, a backend the port registers: gloo, with every
CUDA tensor copied to the host before the collective and the results
copied back (:class:`HostGloo`).  Chosen by the backend's name, never by
a failed attempt.
"""

from __future__ import annotations

import math
from collections import Counter

import torch
import torch.distributed as dist
from torch._C._distributed_c10d import _create_work_from_future
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: the port's backend of gloo sub-groups that stage CUDA tensors through
#: the host (:class:`HostGloo`)
HOST_GLOO = "gloo_host"


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over every rank of the default
    process group, on ``device_type`` ("cuda", the default, or "cpu").

    Raises ``RuntimeError`` for "cuda" without a CUDA device (never a
    mesh on the CPU instead) and when no process group is started, and
    ``ValueError`` when the world size is not ``prod(shape)``."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass "
                           "device_type='cpu' for a mesh on the CPU")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks; the world size is {world}")
    host = device_type == "cuda" and dist.get_backend() == "gloo"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes,
                            backend_override=host_staged(axes) if host
                            else None)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks ("data", "model"); multi_pod adds a leading
    pod=2 axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_test_mesh(n_devices: int | None = None, axes=("data", "model"),
                   device_type: str = "cuda") -> DeviceMesh:
    """A small 2-D mesh over ``n_devices`` ranks (default: the world
    size), shaped by the reference's rule: 1 -> (1, 1), 2 -> (2, 1),
    4 -> (2, 2)."""
    n = n_devices or dist.get_world_size()
    a = 1
    while n % 2 == 0 and a * 2 <= n ** 0.5 + 1:
        a *= 2
        n //= 2
    shape = (a, (n_devices or dist.get_world_size()) // a)
    return make_mesh(shape, axes, device_type)


def batch_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Axes used for data parallelism on this mesh."""
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)


# ---------------------------------------------------------------------------
# the ring hand-off and the axis gather
# ---------------------------------------------------------------------------

#: ring hand-offs (:func:`ring_shift` calls) in this process since it
#: started, by transport: ``"direct"`` moved the tensors where they lie
#: (NCCL on the card, gloo on the CPU), ``"host"`` copied CUDA tensors to
#: the host for gloo and the received ones back
HAND_OFFS = {"direct": 0, "host": 0}


def stages_on_host(group, x: torch.Tensor) -> bool:
    """Whether the collectives of ``group`` copy ``x`` to the host: a
    CUDA tensor under the gloo backend (or :data:`HOST_GLOO`), whose send
    and recv read and write the tensor's memory from the host (a CUDA
    tensor's send aborts the rank: ``tools/gloo_cuda_check.py``).  Decided
    by the backend's name, never by a failed attempt."""
    return x.is_cuda and dist.get_backend(group) in ("gloo", HOST_GLOO)


# ---------------------------------------------------------------------------
# gloo with CUDA tensors staged through the host
# ---------------------------------------------------------------------------

#: the collectives :class:`HostGloo` groups carried in this process since it
#: started, by (kind, path): ``"host"`` copied CUDA tensors to the host and
#: back, ``"direct"`` handed host tensors to gloo as they were
COLLECTIVES: Counter = Counter()
#: the bytes of those collectives' outputs, by kind
COLLECTIVE_BYTES: Counter = Counter()


def _done(result):
    """A finished ``Work`` whose future holds ``result``."""
    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


class HostGloo(dist.ProcessGroup):
    """A gloo group that takes CUDA tensors: each collective copies them
    to the host, runs gloo on the copies, waits, and copies the outputs
    back into the caller's tensors; host tensors go to gloo as they are.
    It carries what DTensor's redistributions and the port's hand-offs
    issue: all-reduce, all-gather (list and into one tensor),
    reduce-scatter into one tensor, all-to-all of one tensor, broadcast,
    barrier, send and recv.  Each call finishes before it returns."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)

    def getBackendName(self) -> str:
        return HOST_GLOO

    # the group's name, which c10d sets after building it (a group from
    # Python has no C++ backend to hold it)
    def setGroupName(self, name: str) -> None:
        self._name = name

    def getGroupName(self) -> str:
        return self._name

    @property
    def group_name(self) -> str:
        return self._name

    def _staged(self, kind: str, ins: list, outs: list, run):
        """``run(host ins, host outs)`` (gloo's work, waited on), with the
        outputs copied back; returns a finished work of ``outs``."""
        host = any(t.is_cuda for t in ins + outs)
        copies = {id(t): t.cpu() for t in ins + outs if t.is_cuda}
        run([copies.get(id(t), t) for t in ins],
            [copies.get(id(t), t) for t in outs]).wait()
        for t in outs:
            if t.is_cuda:
                t.copy_(copies[id(t)])
        COLLECTIVES[(kind, "host" if host else "direct")] += 1
        COLLECTIVE_BYTES[kind] += sum(t.numel() * t.element_size()
                                      for t in outs)
        return _done(outs)

    def allreduce(self, tensors, opts=None):
        opts = opts or dist.AllreduceOptions()
        return self._staged("all_reduce", [], list(tensors),
                            lambda i, o: self._gloo.allreduce(o, opts))

    def allgather(self, output_lists, input_tensors, opts=None):
        opts = opts or dist.AllgatherOptions()
        outs = [t for ts in output_lists for t in ts]

        def run(i, o):
            it = iter(o)
            return self._gloo.allgather([[next(it) for _ in ts]
                                         for ts in output_lists], i, opts)
        return self._staged("all_gather", list(input_tensors), outs, run)

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        opts = opts or dist.AllgatherOptions()
        for out, x in zip(outputs, inputs):
            self._staged("all_gather_into_tensor", [x], [out],
                         lambda i, o: self._gloo._allgather_base(o[0], i[0],
                                                                 opts))
        return _done(list(outputs))

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        opts = opts or dist.ReduceScatterOptions()
        for out, x in zip(outputs, inputs):
            self._staged("reduce_scatter_tensor", [x], [out],
                         lambda i, o: self._gloo._reduce_scatter_base(
                             o[0], i[0], opts))
        return _done(list(outputs))

    def alltoall_base(self, output, input, output_splits, input_splits,
                      opts=None):
        opts = opts or dist.AllToAllOptions()
        return self._staged("all_to_all_single", [input], [output],
                            lambda i, o: self._gloo.alltoall_base(
                                o[0], i[0], output_splits, input_splits,
                                opts))

    def broadcast(self, tensors, opts=None):
        opts = opts or dist.BroadcastOptions()
        return self._staged("broadcast", [], list(tensors),
                            lambda i, o: self._gloo.broadcast(o, opts))

    def barrier(self, opts=None):
        return self._gloo.barrier(opts or dist.BarrierOptions())

    def send(self, tensors, dst: int, tag: int = 0):
        return self._gloo.send(tensors, dst, tag)

    def recv(self, tensors, src: int, tag: int = 0):
        return self._gloo.recv(tensors, src, tag)

    # the names newer torch releases look up first
    all_gather_single_coalesced = allgather_into_tensor_coalesced
    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    def all_to_all_single(self, output, input, output_splits, input_splits,
                          opts=None):
        return self.alltoall_base(output, input, output_splits, input_splits,
                                  opts)


def host_staged(axes) -> dict:
    """``init_device_mesh``'s ``backend_override`` that builds every axis's
    sub-group with :data:`HOST_GLOO` (registered at the first call)."""
    if not hasattr(dist.Backend, HOST_GLOO.upper()):
        dist.Backend.register_backend(HOST_GLOO, HostGloo,
                                      devices=["cpu", "cuda"])
    return {a: HOST_GLOO for a in axes}


def ring_shift(tensors: list[torch.Tensor], group, idx: int, n: int
               ) -> list[torch.Tensor]:
    """One ring hand-off on ``group`` (``n`` ranks; this rank at ``idx``):
    ``tensors`` go to coordinate ``idx + 1`` and what coordinate
    ``idx - 1`` sent comes back, tensors of the same shapes and dtypes in
    the same order.  The tensors travel as one byte buffer in one
    ``batch_isend_irecv`` (peers named by their global ranks); every rank
    of the group calls this with tensors of the same shapes and dtypes.
    Counts one hand-off in :data:`HAND_OFFS`."""
    ranks = dist.get_process_group_ranks(group)
    ts = [t.contiguous() for t in tensors]
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in ts])
    host = stages_on_host(group, flat)
    send = flat.cpu() if host else flat
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, ranks[(idx + 1) % n], group),
        dist.P2POp(dist.irecv, recv, ranks[(idx - 1) % n], group)])
    for req in reqs:
        req.wait()
    HAND_OFFS["host" if host else "direct"] += 1
    if host:
        recv = recv.to(flat.device)
    out, at = [], 0
    for t in ts:
        nbytes = t.numel() * t.element_size()
        out.append(recv[at:at + nbytes].view(t.dtype).view(t.shape))
        at += nbytes
    return out


def gather_axis(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in the
    order of the ranks' coordinates (one ``all_gather``; under gloo a CUDA
    tensor through the host).  A group of one returns ``x``."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    host = stages_on_host(group, x)
    src = x.cpu() if host else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if host else out
