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
    dep.save("plan.json")       # the JAX package's artifact format
    dep.runtime(DeploySpec(), churn=[...]).run(inputs=frames)  # event-driven
    dep.server(streaming=True).load().serve(requests)  # serving front-end
    dep.scheduler(tenants).serve(workload)     # multi-tenant co-hosting
    dep.fleet(DistSpec()).run(frames)          # one worker per stage

``ExecSpec(calibrate=True, autotune=True)`` tunes the conv kernel's
launch plans and times every stage on the device before the final plan.
Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version.  The package imports neither ``jax`` nor ``repro``.
"""

from .api._compat import lazy_exports

_LAZY = {
    "compile": ("repro_torch.api.deployment", "compile"),
    "Deployment": ("repro_torch.api.deployment", "Deployment"),
    "require_device": ("repro_torch.api.deployment", "require_device"),
    "PlanSpec": ("repro_torch.api.specs", "PlanSpec"),
    "ExecSpec": ("repro_torch.api.specs", "ExecSpec"),
    "DeploySpec": ("repro_torch.api.specs", "DeploySpec"),
    "FleetSpec": ("repro_torch.api.specs", "FleetSpec"),
    "DistSpec": ("repro_torch.api.specs", "DistSpec"),
    "DistLauncher": ("repro_torch.dist.launcher", "DistLauncher"),
    "ObjectiveSpec": ("repro_torch.api.specs", "ObjectiveSpec"),
    "OBJECTIVE_PRESETS": ("repro_torch.api.specs", "OBJECTIVE_PRESETS"),
    "plan_front": ("repro_torch.core.pareto", "plan_front"),
    "ParetoFront": ("repro_torch.core.pareto", "ParetoFront"),
    "PlanRegistry": ("repro_torch.fleet.registry", "PlanRegistry"),
    "FleetRouter": ("repro_torch.fleet.router", "FleetRouter"),
    "api": ("repro_torch.api", None),
    "obs": ("repro_torch.obs", None),
    "fleet": ("repro_torch.fleet", None),
    "dist": ("repro_torch.dist", None),
}

__all__ = ["compile", "Deployment", "require_device", "PlanSpec",
           "ExecSpec", "DeploySpec", "FleetSpec", "DistSpec", "DistLauncher",
           "ObjectiveSpec", "OBJECTIVE_PRESETS", "plan_front", "ParetoFront",
           "PlanRegistry", "FleetRouter", "api", "obs", "fleet", "dist"]

__getattr__, __dir__ = lazy_exports(__name__, globals(), _LAZY)
