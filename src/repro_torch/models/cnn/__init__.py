"""Graph-defined executable CNNs used in the paper's evaluation."""

from .builder import CNNDef, GB, params_from_numpy
from . import zoo

__all__ = ["CNNDef", "GB", "params_from_numpy", "zoo"]
