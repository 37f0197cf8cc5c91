"""The four assigned input shapes and fake-tensor input builders: the
counterpart of the JAX package's ``configs/shapes.py``.

Decode shapes run ``decode_step`` (ONE new token against a seq_len KV
cache), not a train step.  ``long_500k`` requires sub-quadratic decode:
SSM/hybrid run natively, Mixtral uses its native sliding window, and
pure full-attention archs run an explicit sliding-window variant
(``ArchConfig.with_sliding_window``).

:func:`input_specs` is the counterpart of the reference's
``ShapeDtypeStruct`` stand-ins: fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``), which carry shape,
dtype and device and allocate nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..models.transformer.config import ArchConfig
from ..models.transformer.model import init_cache

LONG_CONTEXT_WINDOW = 8192   # SWA window used by dense archs on long_500k


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def arch_for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """Swap in the sliding-window variant for quadratic archs on 500k."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return cfg.with_sliding_window(LONG_CONTEXT_WINDOW)
    return cfg


def input_specs(cfg: ArchConfig, shape: InputShape,
                dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cuda",
                fake_mode: FakeTensorMode | None = None) -> dict:
    """Fake-tensor stand-ins for every model input (no allocation), made
    in ``fake_mode`` (a new ``FakeTensorMode`` by default) on ``device``.

    train   -> {'tokens'|'embeds', 'labels'}
    prefill -> {'tokens'|'embeds'}
    decode  -> {'inputs': {'token'|'embed'}, 'cache': init_cache(...)}
    """
    cfg = arch_for_shape(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    with fake_mode or FakeTensorMode():
        def token_batch(with_labels: bool):
            if cfg.input_mode == "tokens":
                b = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                           device=device)}
            else:
                b = {"embeds": torch.empty((B, S, cfg.d_model), dtype=dtype,
                                           device=device)}
            if with_labels:
                b["labels"] = torch.empty((B, S), dtype=torch.int32,
                                          device=device)
            return b

        if shape.kind == "train":
            return token_batch(True)
        if shape.kind == "prefill":
            return token_batch(False)
        if cfg.input_mode == "tokens":
            inputs = {"token": torch.empty((B,), dtype=torch.int32,
                                           device=device)}
        else:
            inputs = {"embed": torch.empty((B, cfg.d_model), dtype=dtype,
                                           device=device)}
        return {"inputs": inputs,
                "cache": init_cache(cfg, B, S, dtype=dtype, device=device)}
