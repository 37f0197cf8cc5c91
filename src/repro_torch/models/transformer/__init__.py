"""Decoder LM substrate of the port: the dense attention, MoE and Mamba2
families."""

from .config import ArchConfig
from . import layers, model

__all__ = ["ArchConfig", "layers", "model"]
