"""Launchers of the port: LM serving (``launch/serve.py``) on one device,
training (``launch/train.py``) on one device or sharded over
``torchrun``'s ranks, the device meshes over ``torch.distributed``
(``launch/mesh.py``) that a multi-rank run builds on and the sharding
rules (``launch/sharding.py``); and the launch tooling: the dry run of
every (arch x shape x mesh) step on fake tensors over a fake process
group (``launch/dryrun.py``), the per-device census of what a call
dispatches (``launch/hlo_analysis.py``), its roofline terms at the
H100's peaks (``launch/roofline.py``), and the listings and tables over
saved censuses and records (``launch/profile.py``,
``launch/report.py``)."""

from .mesh import batch_axes, make_mesh, make_production_mesh, make_test_mesh

__all__ = ["batch_axes", "make_mesh", "make_production_mesh",
           "make_test_mesh"]
