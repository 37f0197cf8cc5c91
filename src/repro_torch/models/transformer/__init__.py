"""Decoder LM substrate of the port (dense attention family)."""

from .config import ArchConfig
from . import layers, model

__all__ = ["ArchConfig", "layers", "model"]
