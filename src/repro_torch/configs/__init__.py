"""Config registry of the port: the ten architectures of the JAX
package's ``configs/`` (copies of its data files), and the dry run's
four input shapes (``shapes.py``: ``SHAPES``, ``InputShape``,
``LONG_CONTEXT_WINDOW``, ``arch_for_shape``, and ``input_specs``, whose
stand-ins are fake tensors where the reference's are
``ShapeDtypeStruct`` ones).
"""

from __future__ import annotations

import importlib

from ..models.transformer.config import ArchConfig
from .shapes import (LONG_CONTEXT_WINDOW, SHAPES, InputShape, arch_for_shape,
                     input_specs)

_MODULES = {
    "qwen1.5-4b": "qwen1_5_4b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-2.7b": "zamba2_2_7b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "command-r-35b": "command_r_35b",
    "llama3.2-1b": "llama3_2_1b",
    "llava-next-34b": "llava_next_34b",
    "musicgen-medium": "musicgen_medium",
    "mixtral-8x7b": "mixtral_8x7b",
}

ARCH_NAMES = list(_MODULES)


def get(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def all_archs() -> dict[str, ArchConfig]:
    return {n: get(n) for n in ARCH_NAMES}


__all__ = ["ArchConfig", "ARCH_NAMES", "get", "all_archs", "InputShape",
           "SHAPES", "LONG_CONTEXT_WINDOW", "arch_for_shape", "input_specs"]
