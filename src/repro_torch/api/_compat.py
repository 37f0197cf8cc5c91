"""Deprecation machinery for the legacy kwarg surface.

Every pre-``repro.api`` entry point (``core.plan``, ``PipelineRuntime``,
the servers, ...) keeps accepting its historical keyword arguments, but
each such call site funnels through :func:`warn_legacy` so users see a
single :class:`DeprecationWarning` per entry point per process — loud
enough to notice, quiet enough not to drown a serving loop.
"""

from __future__ import annotations

import warnings

_WARNED: set[str] = set()


def warn_legacy(key: str, replacement: str, *, stacklevel: int = 3) -> None:
    """Warn (once per ``key``) that a legacy kwarg surface was used."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(
        f"{key} with loose keyword arguments is deprecated; "
        f"use {replacement} instead",
        DeprecationWarning, stacklevel=stacklevel)


def reset_legacy_warnings() -> None:
    """Forget which entry points already warned (test isolation hook)."""
    _WARNED.clear()


# sentinel distinguishing "caller passed nothing" from an explicit value
_UNSET = object()


def unset(*values) -> bool:
    """True iff every value is the _UNSET sentinel."""
    return all(v is _UNSET for v in values)


def pick(value, default):
    """Resolve a sentinel-defaulted kwarg."""
    return default if value is _UNSET else value


def lazy_exports(module_name: str, module_globals: dict, table: dict):
    """PEP 562 module ``__getattr__``/``__dir__`` pair over a
    ``{name: (module, attr_or_None)}`` table — shared by the package
    ``__init__`` files so heavyweight subsystems import on first touch."""

    def __getattr__(name):
        try:
            module, attr = table[name]
        except KeyError:
            raise AttributeError(
                f"module {module_name!r} has no attribute {name!r}")
        import importlib
        mod = importlib.import_module(module)
        value = mod if attr is None else getattr(mod, attr)
        module_globals[name] = value
        return value

    def __dir__():
        return sorted(set(module_globals) | set(table))

    return __getattr__, __dir__
