"""Compiled per-stage execution over torch tensors.

* :mod:`~repro_torch.exec.backends` — conv backends (``torch``,
  ``cuda``) selected per model/executor; ``cuda`` registers a *fused*
  conv-epilogue lowering onto the Hopper kernel;
* :mod:`~repro_torch.exec.compiler` — one stage's fused segment (all
  device tiles) as one callable, with conv->pool chains fused and
  batch-folded multi-frame runs;
* :mod:`~repro_torch.exec.cache` — cache of compiled stages keyed on
  (segment signature, tile shapes, dtype, backend, fuse).
"""

from .backends import (DEFAULT_BACKEND, JAX_BACKEND_NAMES, apply_conv,
                       apply_layer, available_backends, get_backend,
                       has_fused, register_backend)
from .compiler import CompiledStage, fusable_chains, segment_signature
from .cache import (CacheStats, cache_stats, clear_cache, compiled_stage,
                    set_cache_size, stage_cache_key, static_stage_key)

__all__ = [
    "DEFAULT_BACKEND", "JAX_BACKEND_NAMES", "apply_conv", "apply_layer",
    "available_backends", "get_backend", "has_fused", "register_backend",
    "CompiledStage", "fusable_chains", "segment_signature", "CacheStats",
    "cache_stats", "clear_cache", "compiled_stage", "set_cache_size",
    "stage_cache_key", "static_stage_key",
]
