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
