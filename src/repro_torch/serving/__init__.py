"""Serving of the port: the LM decode loop.  The CNN servers and the
multi-tenant scheduler of the JAX package are not ported yet (ROADMAP
Queue 1, item 8)."""

from .lm import generate

__all__ = ["generate"]
