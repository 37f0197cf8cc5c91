"""PICO on PyTorch and CUDA — the port of the JAX package ``repro``.

The same "plan offline, execute online" split, with every stage
executed on one NVIDIA GPU (Hopper) through a hand-written CUDA conv
kernel:

    import repro_torch
    from repro_torch.core import make_pi_cluster
    from repro_torch.models.cnn import zoo
    dep = repro_torch.compile(zoo.vgg16(), make_pi_cluster([1.5, 1.2]))
    dep.run(frame)              # one (N, H, W, C) frame
    dep.run(frames)             # a list of frames, one batch-folded pass

Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.  The package imports neither ``jax`` nor ``repro``.
"""

from .api._compat import lazy_exports

_LAZY = {
    "compile": ("repro_torch.api.deployment", "compile"),
    "Deployment": ("repro_torch.api.deployment", "Deployment"),
    "PlanSpec": ("repro_torch.api.specs", "PlanSpec"),
    "ExecSpec": ("repro_torch.api.specs", "ExecSpec"),
    "DeploySpec": ("repro_torch.api.specs", "DeploySpec"),
    "ObjectiveSpec": ("repro_torch.api.specs", "ObjectiveSpec"),
    "OBJECTIVE_PRESETS": ("repro_torch.api.specs", "OBJECTIVE_PRESETS"),
    "api": ("repro_torch.api", None),
    "obs": ("repro_torch.obs", None),
}

__all__ = ["compile", "Deployment", "PlanSpec", "ExecSpec", "DeploySpec",
           "ObjectiveSpec", "OBJECTIVE_PRESETS", "api", "obs"]

__getattr__, __dir__ = lazy_exports(__name__, globals(), _LAZY)
