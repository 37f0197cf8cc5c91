"""PartitionSpec assignment for the decoder substrate on a device mesh, and
the specs as DTensor placements: the port of the JAX package's
``launch/sharding.py`` (baseline tensor-parallel + data-parallel layout).

Rules (model axis = 'model', batch over ('pod','data') where divisible):
  * embedding/head: padded-vocab dim over 'model'
  * attention projections: flattened head*dim output over 'model'
  * FFN/expert hidden dim over 'model'
  * mamba inner projections: d_inner-derived dims over 'model' where
    divisible, else replicated
  * caches/activations: batch over data axes; head_dim or kv-heads over
    'model' where divisible
Dims that do not divide the axis size are replicated (a helper checks).

A spec is a :class:`P`, one entry per tensor dim: ``None``, an axis name,
or a tuple of axis names (``jax.sharding.PartitionSpec``).  The rules
read only each axis's size, so ``mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` or a mapping of axis name
to size.  Leaf paths are ``training/tree.py``'s, matched on the same
names as the reference's ``/``-joined paths (``shared.attn.wq`` as
``shared/attn/wq``).  :func:`placements` turns a spec into DTensor
placements on a mesh and :func:`distribute` places a tree's leaves by
their specs; the model's entry points then run on the placed params
(``models/transformer/sharded.py``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Shard

from ..models.transformer.sharded import _axes, from_local, placements
from ..training import tree

__all__ = ["P", "param_pspecs", "batch_pspecs", "cache_pspecs",
           "placements", "local_shard", "distribute", "like_placements",
           "full"]


class P:
    """A partition spec: one entry per tensor dim, ``None`` (replicated),
    an axis name, or a tuple of axis names (the dim split over them, the
    first the outermost).  Equal to a tuple of the same entries, as
    ``jax.sharding.PartitionSpec`` is; a leaf of ``training.tree``'s
    walks, where a tuple would be a node.  A one-axis tuple is kept as
    the axis name, as ``PartitionSpec`` keeps it."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(
            (p[0] if len(p) == 1 else tuple(p))
            if isinstance(p, (tuple, list)) else p for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        if isinstance(other, P):
            other = other.parts
        return isinstance(other, tuple) and self.parts == other

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self.parts)) + ")"


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {str(k): int(v) for k, v in dict(mesh).items()}


def _div(n: int, sizes: dict, axis: str) -> bool:
    return axis in sizes and n % sizes[axis] == 0


def _spec(shape, sizes: dict, dim_axis: dict[int, str]) -> P:
    """P with axis per dim if divisible, else None."""
    parts = [None] * len(shape)
    for d, ax in dim_axis.items():
        if _div(shape[d], sizes, ax):
            parts[d] = ax
    return P(*parts)


def _specs_of(tree_, leaf_spec) -> Any:
    """``tree_``'s structure with ``leaf_spec(path, leaf)`` at each leaf
    (``None`` stays ``None``)."""
    return tree.unflatten(tree_, [leaf_spec(path, leaf) for path, leaf
                                  in tree.named_leaves(tree_)])


def param_pspecs(cfg, params_shape: Any, mesh) -> Any:
    """PartitionSpec tree matching a params tree (of tensors, or of
    anything with a ``shape``)."""
    sizes = axis_sizes(mesh)

    def leaf_spec(path: str, leaf) -> P:
        sh = tuple(leaf.shape)
        key = path.replace(".", "/")
        nd = len(sh)
        if "embed" in key:
            return _spec(sh, sizes, {0: "model"})
        if "head" in key:
            return _spec(sh, sizes, {1: "model"})
        if "moe" in key:
            if key.endswith("router"):
                return P(*([None] * nd))
            if key.endswith("w2"):
                return _spec(sh, sizes, {nd - 2: "model"})
            return _spec(sh, sizes, {nd - 1: "model"})
        if "attn" in key:
            if key.endswith("wo"):
                return _spec(sh, sizes, {nd - 2: "model"})
            if any(key.endswith(s) for s in ("wq", "wk", "wv", "bq", "bk",
                                             "bv")):
                return _spec(sh, sizes, {nd - 1: "model"})
        if "mlp" in key:
            if key.endswith("w2"):
                return _spec(sh, sizes, {nd - 2: "model"})
            return _spec(sh, sizes, {nd - 1: "model"})
        if "mamba" in key:
            if key.endswith("w_in"):
                return _spec(sh, sizes, {nd - 1: "model"})
            if key.endswith("w_out"):
                return _spec(sh, sizes, {nd - 2: "model"})
            if key.endswith(("conv_w", "conv_b", "norm_w")):
                return _spec(sh, sizes, {nd - 1: "model"})
        return P(*([None] * nd))

    return _specs_of(params_shape, leaf_spec)


def batch_pspecs(cfg, batch_shape: Any, mesh,
                 data_axes: tuple[str, ...]) -> Any:
    """Specs for a train/prefill batch dict."""
    sizes = axis_sizes(mesh)
    total = math.prod(sizes[a] for a in data_axes)

    def leaf_spec(path, leaf):
        sh = tuple(leaf.shape)
        if sh and sh[0] % total == 0:
            return P(tuple(data_axes), *([None] * (len(sh) - 1)))
        return P(*([None] * len(sh)))

    return _specs_of(batch_shape, leaf_spec)


def cache_pspecs(cfg, cache_shape: Any, mesh, data_axes: tuple[str, ...],
                 mode: str = "feature") -> Any:
    """Specs for a decode cache: batch on dim 1 (dim 0 is layers), plus

    mode='feature'  — shard the last (head_dim-ish) dim over 'model'
                      (baseline layout), or
    mode='sequence' — shard the KV cache's sequence dim (dim 2) over
                      'model' (flash-decoding-style partitioning:
                      attention contracts locally over the sequence shard
                      and all-reduces only the small softmax stats/output
                      instead of all-gathering the cache every layer).
    """
    sizes = axis_sizes(mesh)
    total = math.prod(sizes[a] for a in data_axes)

    def leaf_spec(path, leaf):
        sh = tuple(leaf.shape)
        names = path.replace(".", "/")
        nd = len(sh)
        if nd == 0:
            return P()
        parts = [None] * nd
        if nd >= 2 and sh[1] % total == 0 and sh[1] >= total:
            parts[1] = tuple(data_axes)
        is_kv = names in ("k", "v") or names.endswith(("/k", "/v")) \
            or "shared_k" in names or "shared_v" in names
        if mode == "sequence" and is_kv and nd >= 3 \
                and _div(sh[2], sizes, "model"):
            parts[2] = "model"
            return P(*parts)
        if "k" in names or "v" in names or "ssm" in names \
                or "conv" in names:
            # shard the last (feature) dims over 'model' where divisible
            for d in range(nd - 1, 1, -1):
                if _div(sh[d], sizes, "model"):
                    parts[d] = "model"
                    break
        return P(*parts)

    return _specs_of(cache_shape, leaf_spec)


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------

def check_divides(shape, spec, mesh) -> None:
    """``ValueError`` unless every dim that ``spec`` shards is a multiple
    of the product of its axes' sizes (DTensor would take uneven shards;
    the rules replicate such a dim instead)."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec!r} has {len(spec)} entries for a "
                         f"tensor of shape {tuple(shape)}")
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _axes(entry))
        if shape[d] % n:
            raise ValueError(f"spec {spec!r}: dim {d} of shape "
                             f"{tuple(shape)} does not divide over "
                             f"{_axes(entry)} ({n})")


def local_shard(t: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's shard of ``t`` (the whole tensor, on any device) under
    ``places`` on ``mesh``: a view, narrowed on each dim that a mesh dim
    shards (several mesh dims on one dim: the first outermost, as DTensor
    splits it).  The shards must be even (:func:`check_divides`)."""
    coord = mesh.get_coordinate()
    for d in range(t.dim()):
        dims = [i for i, p in enumerate(places) if p == Shard(d)]
        n, idx = 1, 0
        for i in dims:
            n *= mesh.shape[i]
            idx = idx * mesh.shape[i] + coord[i]
        step = t.shape[d] // n
        t = t.narrow(d, idx * step, step)
    return t


def distribute(tree_, specs, mesh) -> Any:
    """DTensors of ``tree_``'s leaves on ``mesh``, each placed by its spec
    in ``specs`` (a tree of ``tree_``'s structure, as the rules above
    return).  Every rank passes the same values, on any device (host
    tensors shared by the ranks, say): each copies only its own shards to
    the mesh's device, and nothing is sent."""
    def place(t, spec):
        check_divides(t.shape, spec, mesh)
        places = placements(spec, mesh)
        local = local_shard(t, mesh, places).to(mesh.device_type, copy=True)
        return from_local(local.contiguous(), mesh, places, t.shape)
    return tree.map_(place, tree_, specs)


def like_placements(tree_, like) -> Any:
    """``tree_``'s DTensor leaves redistributed to the placements of the
    leaves of ``like`` (a tree of its structure); plain leaves as they
    are."""
    def match(t, ref):
        if isinstance(t, DTensor) and tuple(t.placements) != \
                tuple(ref.placements):
            return t.redistribute(ref.device_mesh, ref.placements)
        return t
    return tree.map_(match, tree_, like)


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole value of ``t``: a DTensor gathered on every rank (a
    collective: every rank calls it), a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t
