"""Pluggable per-layer execution backends over torch tensors (NHWC).

A backend is how a *conv* vertex is lowered — everything else (pool,
fc, connectors) is backend-independent PyTorch.  Backends are registered
in a process-wide table but *selected* explicitly: :class:`CNNDef`
carries a ``backend`` field and the stage executors thread it through.

Registered backends, and the JAX package's names they stand for:

``torch`` (``"xla"`` in the JAX package)
    ``F.conv2d`` — the port's reference path on every device.
``cuda`` (``"pallas"`` in the JAX package; the default)
    The hand-written Hopper kernel (``kernels.conv2d``), which carries
    the conv epilogue — bias, relu, optional non-overlapping max-pool —
    inside the kernel, launched (as a fused chain) with the plan that
    ``exec.autotune`` installed for the conv's key, if any.  On CPU tensors its wrapper
    runs the kernel's plain PyTorch version.

A backend may additionally register a *fused* lowering: the signature
covers the whole conv epilogue (conv + bias + relu + optional pool) in
one call, and ``exec.compiler.fusable_chains`` only rewrites segments
for backends that have one — backends without it (torch) keep the
exact composed-op sequence.

Layout traps carried over from the JAX package: a pool pads with
``-inf`` and then takes a VALID window (``F.max_pool2d(padding=)`` would
not reproduce it); ``fc`` flattens in NHWC order; a conv tile gets its
own (possibly asymmetric) ``pad_w`` on W and the full ``ph`` on H.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..core.graph import LayerSpec
from ..kernels.conv2d import ops as conv_ops
from .autotune import tuned_plan

# conv backend signature: (spec, params, x, pad_w) -> y  (NHWC, VALID +
# explicit pad_w/ph padding, no bias, no activation)
ConvFn = Callable[[LayerSpec, dict, torch.Tensor, tuple[int, int]],
                  torch.Tensor]

# fused lowering: (conv_spec, pool_spec | None, params, x, pad_w, relu)
# -> y, with bias + relu (+ pool) applied — one kernel call per chain
FusedConvFn = Callable[
    [LayerSpec, Optional[LayerSpec], dict, torch.Tensor, tuple[int, int],
     bool], torch.Tensor]

_REGISTRY: dict[str, ConvFn] = {}
_FUSED: dict[str, FusedConvFn] = {}
DEFAULT_BACKEND = "cuda"
#: the JAX package's backend names -> the port's
JAX_BACKEND_NAMES = {"xla": "torch", "pallas": "cuda"}


def register_backend(name: str, fn: ConvFn,
                     fused: FusedConvFn | None = None) -> None:
    _REGISTRY[name] = fn
    if fused is not None:
        _FUSED[name] = fused
    else:
        _FUSED.pop(name, None)


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def get_backend(name: str | None) -> ConvFn:
    name = name or DEFAULT_BACKEND
    try:
        return _REGISTRY[name]
    except KeyError:
        hint = (f" (the JAX package's {name!r} is {JAX_BACKEND_NAMES[name]!r}"
                " here)" if name in JAX_BACKEND_NAMES else "")
        raise ValueError(f"unknown exec backend {name!r}{hint}; "
                         f"registered: {available_backends()}") from None


def has_fused(name: str | None) -> bool:
    """Does ``name`` register a fused conv-epilogue lowering?"""
    return (name or DEFAULT_BACKEND) in _FUSED


# ---------------------------------------------------------------------------
# NHWC helpers
# ---------------------------------------------------------------------------

def pad_hw(x: torch.Tensor, ph: int, pad_w: tuple[int, int],
           value: float = 0.0) -> torch.Tensor:
    """Pad an NHWC tensor by (ph, ph) on H and ``pad_w`` on W."""
    if ph == 0 and pad_w == (0, 0):
        return x
    return F.pad(x, (0, 0, pad_w[0], pad_w[1], ph, ph), value=value)


def max_pool_valid(x: torch.Tensor, window: tuple[int, int],
                   stride: tuple[int, int]) -> torch.Tensor:
    """VALID max-pool of an NHWC tensor; ``window``/``stride`` are (H, W)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=window,
                     stride=stride)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------

def _conv_torch(spec: LayerSpec, p: dict, x: torch.Tensor,
                pad_w: tuple[int, int]) -> torch.Tensor:
    xp = pad_hw(x, spec.padding[1], pad_w)
    y = F.conv2d(xp.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
                 stride=(spec.stride[1], spec.stride[0]))
    return y.permute(0, 2, 3, 1)


def _conv_cuda(spec: LayerSpec, p: dict, x: torch.Tensor,
               pad_w: tuple[int, int]) -> torch.Tensor:
    xp = pad_hw(x, spec.padding[1], pad_w).contiguous()
    return conv_ops.conv2d(xp, p["w"], stride=(spec.stride[1],
                                               spec.stride[0]))


def _conv_cuda_fused(spec: LayerSpec, pool_spec: LayerSpec | None, p: dict,
                     x: torch.Tensor, pad_w: tuple[int, int],
                     relu: bool) -> torch.Tensor:
    xp = pad_hw(x, spec.padding[1], pad_w).contiguous()
    pool = None if pool_spec is None \
        else (pool_spec.kernel[1], pool_spec.kernel[0])
    stride = (spec.stride[1], spec.stride[0])
    # the plan exec.autotune installed for this conv key, if any
    tile, split = tuned_plan(xp.shape, p["w"].shape, stride, relu, pool) \
        or (None, None)
    return conv_ops.conv2d_fused(xp, p["w"], p["b"], stride=stride,
                                 relu=relu, pool=pool, tile=tile,
                                 split=split)


register_backend("torch", _conv_torch)
register_backend("cuda", _conv_cuda, fused=_conv_cuda_fused)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def apply_conv(spec: LayerSpec, p, x: torch.Tensor, relu: bool,
               pad_w: tuple[int, int] = (0, 0),
               backend: str | None = None,
               pool_spec: LayerSpec | None = None) -> torch.Tensor:
    """Apply one conv epilogue chain (conv + bias + relu + optional
    non-overlapping max-pool) to an NHWC tile.

    Backends with a fused lowering execute the whole chain as one
    kernel call; others compose the eager sequence.  ``pool_spec`` must
    describe a VALID kernel==stride pool (the only shape
    ``fusable_chains`` emits).
    """
    name = backend or DEFAULT_BACKEND
    fused = _FUSED.get(name)
    if fused is not None:
        return fused(spec, pool_spec, p, x, pad_w, relu)
    y = get_backend(name)(spec, p, x, pad_w) + p["b"]
    if relu:
        y = torch.relu(y)
    if pool_spec is not None:
        y = max_pool_valid(y, (pool_spec.kernel[1], pool_spec.kernel[0]),
                           (pool_spec.stride[1], pool_spec.stride[0]))
    return y


def apply_layer(spec: LayerSpec, p, x: torch.Tensor, relu: bool,
                pad_w: tuple[int, int] = (0, 0),
                backend: str | None = None) -> torch.Tensor:
    """Apply one layer to an NHWC tile.

    ``pad_w`` is the tile's share of the layer's zero padding along W
    (only boundary tiles get any); H is never tiled, so the full
    (p_h, p_h) padding always applies.  ``backend`` selects the conv
    lowering; every other kind is plain PyTorch.
    """
    ph = spec.padding[1]
    if spec.kind == "conv":
        return apply_conv(spec, p, x, relu, pad_w, backend)
    if spec.kind == "pool":
        return max_pool_valid(pad_hw(x, ph, pad_w, float("-inf")),
                              (spec.kernel[1], spec.kernel[0]),
                              (spec.stride[1], spec.stride[0]))
    if spec.kind == "gpool":
        return x.mean(dim=(1, 2), keepdim=True)
    if spec.kind == "fc":
        flat = x.reshape(x.shape[0], -1)
        y = flat @ p["w"] + p["b"]
        return y.reshape(x.shape[0], 1, 1, -1)  # stay NHWC for uniformity
    if spec.kind in ("identity", "input", "output"):
        return x
    raise NotImplementedError(spec.kind)
