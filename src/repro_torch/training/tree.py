"""The parameter trees of the LM (dicts, NamedTuples of tensors, ``None``
for a missing bias) walked as ``jax.tree`` walks the reference's: dict
keys sorted, tuple fields in order, ``None`` an empty subtree.  That
order is the one both packages' checkpoints number their leaves in."""

from __future__ import annotations

from typing import Any, Callable


def named_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree.leaves``' order; a path joins
    dict keys and NamedTuple fields (or tuple indices) with ``.``, e.g.
    ``layers.attn.wq``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = list(zip(getattr(tree, "_fields", None)
                         or map(str, range(len(tree))), tree))
    else:
        return [(prefix, tree)]
    return [pair for k, t in items
            for pair in named_leaves(t, f"{prefix}.{k}" if prefix else k)]


def leaves(tree) -> list:
    """The tree's leaves, in ``jax.tree.leaves``' order."""
    return [x for _, x in named_leaves(tree)]


def unflatten(like, values) -> Any:
    """``like``'s structure with its leaves replaced, in order, by
    ``values``."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}          # keep like's key order
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def map_(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and trees of its
    structure (``jax.tree.map``)."""
    cols = [leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structures")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def describe(tree) -> str:
    """The structure with ``*`` for each leaf, e.g. ``{'head': *,
    'layers': {'attn': AttnParams(wq=*, ..., bq=None)}}``: what a
    checkpoint's ``.tree`` file holds."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={describe(x)}" for f, x in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(describe(x) for x in tree) + ")"
    return "*"
