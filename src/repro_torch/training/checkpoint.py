"""Parameter-tree checkpoints in the reference's files: ``<path>.npz``
with one array a leaf (``leaf_0``, ``leaf_1``, ... in ``jax.tree``'s
order of the same tree: :mod:`.tree`) and ``<path>.tree``, a text
description of the structure.  Either package loads the other's: each
reads only the ``.npz`` and takes the structure from the tree it is
given."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from . import tree as T


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:          # numpy has no bf16 of its own
        t = t.float()
    return t.numpy()


def save(path: str | Path, tree) -> None:
    """Write ``tree``'s leaves to ``<path>.npz`` and its structure to
    ``<path>.tree`` (bf16 leaves stored as fp32)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path.with_suffix(".npz"),
             **{f"leaf_{i}": _array(l) for i, l in enumerate(T.leaves(tree))})
    path.with_suffix(".tree").write_text(T.describe(tree))


def load(path: str | Path, like) -> object:
    """Restore into the structure of ``like``: each leaf in the dtype and
    on the device of ``like``'s leaf at its place; a shape that differs
    raises."""
    path = Path(path)
    with np.load(path.with_suffix(".npz")) as data:
        out = []
        for i, ref in enumerate(T.leaves(like)):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{path}: leaf {i} has shape {arr.shape}, "
                                 f"the tree wants {tuple(ref.shape)}")
            out.append(torch.from_numpy(arr).to(device=ref.device,
                                                dtype=ref.dtype))
    return T.unflatten(like, out)
