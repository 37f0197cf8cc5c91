"""Public deployment facade: ``compile() -> Deployment`` plus the spec
and artifact layers.  Re-exported at top level as ``repro_torch.compile``
/ ``repro_torch.Deployment`` / ``repro_torch.PlanSpec`` / ...

Only the lightweight pieces (specs, deprecation plumbing) import
eagerly; :func:`compile`/:class:`Deployment` and the artifact codecs
load on first touch, so ``repro_torch.core`` stays importable without
torch.
"""

from ._compat import lazy_exports, reset_legacy_warnings
from .specs import (OBJECTIVE_PRESETS, SPEC_VERSION, DeploySpec, ExecSpec,
                    FleetSpec, ObjectiveSpec, PlanSpec, spec_from_dict)

_LAZY = {
    "compile": ("repro_torch.api.deployment", "compile"),
    "Deployment": ("repro_torch.api.deployment", "Deployment"),
    "artifacts": ("repro_torch.api.artifacts", None),
    "SCHEMA_VERSION": ("repro_torch.api.artifacts", "SCHEMA_VERSION"),
}

__all__ = ["PlanSpec", "ExecSpec", "DeploySpec", "FleetSpec",
           "ObjectiveSpec", "OBJECTIVE_PRESETS", "spec_from_dict",
           "SPEC_VERSION", "SCHEMA_VERSION", "compile", "Deployment",
           "artifacts", "reset_legacy_warnings"]

__getattr__, __dir__ = lazy_exports(__name__, globals(), _LAZY)
