"""Launchers of the port: LM serving (``launch/serve.py``) on one device,
training (``launch/train.py``) on one device or sharded over
``torchrun``'s ranks, and the device meshes over ``torch.distributed``
(``launch/mesh.py``) that a multi-rank run builds on."""

from .mesh import batch_axes, make_mesh, make_production_mesh, make_test_mesh

__all__ = ["batch_axes", "make_mesh", "make_production_mesh",
           "make_test_mesh"]
