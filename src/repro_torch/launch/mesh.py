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
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


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
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


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
    CUDA tensor under the gloo backend, whose send and recv read and write
    the tensor's memory from the host (a CUDA tensor's send aborts the
    rank: ``tools/gloo_cuda_check.py``).  Decided by the backend's name,
    never by a failed attempt."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


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
