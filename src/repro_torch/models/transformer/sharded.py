"""The decoder substrate on DTensor params: the port's counterpart of GSPMD.

Params placed by ``launch.sharding.distribute`` carry their placements,
as the reference's arrays carry a ``NamedSharding``, so ``forward``,
``loss_fn`` and ``prefill`` run the same code with or without them:
DTensor propagates placements through the plain torch ops (the
embedding, ``rms_norm``, the projections, the residual adds, remat's
checkpoint and the backward) and places the collectives.  Where an op
has no sharding rule, or a hand-written kernel needs plain tensors, the
layer goes through a *local-shard boundary* here: its inputs are
redistributed to fixed placements, the body runs on each rank's local
shards (the kernel wrappers on the card, their plain versions on the
CPU, the same code for ``backend="cuda"`` and ``"torch"``), and the
outputs become DTensors again.  Each boundary states its inputs'
gradient placements too: a local gradient that is only this rank's share
of the whole is ``Partial``, so the backward sums it.  With plain
tensors every function here calls its body directly.

The boundaries, and the mesh axes they use (the data axes, ``pod`` and
``data``, over the batch; ``model`` over heads or hidden units; a dim
that does not divide its axes is replicated, as the rules replicate it):

* :func:`embed`: the token embedding, each rank looking up its batch
  rows in its slice of the vocab (a token outside it gives zeros), the
  output ``Partial`` over ``model``;
* :func:`attention`: the causal attention core (``FlashPrefill`` and its
  backward kernel on the card), q/k/v/out batch over the data axes and
  kv heads over ``model``;
* :func:`moe`: the whole MoE layer (routing, per-sample dispatch, the
  three ``moe_gemm`` products, the combine) on this rank's batch rows and
  slice of ``d_ff``; the output is ``Partial`` over ``model``.  The
  dispatch stays per sample, as the reference's, so the buffer is
  batch-sharded whether ``moe_pspec`` is given or not;
* :func:`mamba2`: the Mamba2 layer on this rank's batch rows with its
  params gathered over ``model`` (the rules shard ``w_in`` over the
  concatenation of z, x, B, C and dt, which no local split follows; GSPMD
  gathers there as well).

:func:`like` gives a plain tensor that every rank computes alike (the
rope tables, the padded-vocab mask) the placement of the DTensor it
meets; :func:`constrain` is ``with_sharding_constraint``.  ``act_pspec``
is where the activations live between layers (what remat keeps); each
layer takes its input to whole rows first (:func:`rows`: batch over the
data axes, sequence and features gathered), so no op inside a layer
meets a sequence-sharded tensor.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ...launch.mesh import batch_axes

MODEL_AXIS = "model"


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(spec, mesh) -> tuple:
    """The DTensor placements of a partition spec on ``mesh``: ``Shard(d)``
    on each mesh dim that the spec names for tensor dim ``d``,
    ``Replicate()`` on the others.  A tuple of axes shards its dim over
    each of them and must list them in the mesh's order (DTensor splits
    a dim over mesh dims in that order).  ``ValueError`` for an axis the
    mesh lacks or one named twice."""
    names = tuple(mesh.mesh_dim_names or ())
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)!r} names axis {a!r}; "
                                 f"the mesh has {names}")
            if isinstance(out[names.index(a)], Shard):
                raise ValueError(f"spec {tuple(spec)!r} names axis {a!r} "
                                 "twice")
            out[names.index(a)] = Shard(d)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {tuple(spec)!r}: the axes of dim {d} "
                             f"must be in the mesh's order {names}")
    return tuple(out)


def check_specs(params_leaf, act_pspec, moe_pspec) -> None:
    """``ValueError`` when a pspec is given with plain-tensor params: a
    spec constrains DTensors, as ``with_sharding_constraint`` needs a
    mesh."""
    if (act_pspec is not None or moe_pspec is not None) \
            and not isinstance(params_leaf, DTensor):
        raise ValueError("act_pspec / moe_pspec need params placed by "
                         "launch.sharding.distribute (DTensors); these "
                         "params are plain tensors")


def constrain(x: torch.Tensor, spec) -> torch.Tensor:
    """``x`` (a DTensor where ``spec`` is given: :func:`check_specs`)
    redistributed to ``spec``'s placements (``None``: ``x``)."""
    if spec is None:
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t``, a plain tensor every rank computes alike, as a replicated
    DTensor on ``x``'s mesh when ``x`` is a DTensor (DTensor ops take no
    plain operand but a scalar); else ``t``."""
    if not isinstance(x, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def replicate_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` whole on every rank (a DTensor's shards of it
    gathered; the other placements kept)."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    places = [Replicate() if p == Shard(dim) or isinstance(p, Partial)
              else p for p in x.placements]
    return x.redistribute(x.device_mesh, places)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on every rank (a DTensor redistributed to
    ``Replicate`` on every mesh dim; a plain tensor as it is)."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def rows(x: torch.Tensor) -> torch.Tensor:
    """A layer's input (B, S, d): batch over the data axes where B
    divides them, whole elsewhere (partial sums added, sequence and
    features gathered); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, _places(mesh, _batch(mesh, x.shape[0]),
                                        Replicate()))


# ---------------------------------------------------------------------------
# the boundaries
# ---------------------------------------------------------------------------

def _split(n: int, mesh, axes) -> bool:
    """Whether a dim of ``n`` divides over all of ``axes`` (present)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    axes = [a for a in axes if a in sizes]
    return bool(axes) and n % math.prod(sizes[a] for a in axes) == 0


def _places(mesh, dims: dict, other) -> tuple:
    """A placement for each mesh dim: ``dims[axis]`` where the axis is a
    key, else ``other``."""
    return tuple(dims.get(a, other) for a in mesh.mesh_dim_names)


def _local(fn: Callable, mesh, args: list, out_places):
    """``fn`` on local shards: each of ``args`` is (tensor, placements,
    gradient placements) or a plain value passed as it is; a tensor is
    redistributed to its placements and taken to its local shard, whose
    gradient has the gradient placements.  ``fn``'s outputs (a tensor, or
    a tuple / dict of them, matching ``out_places``) become DTensors of
    those placements."""
    local = []
    for a in args:
        if isinstance(a, tuple) and len(a) == 3 \
                and isinstance(a[0], DTensor):
            t, places, grads = a
            # a tensor already in place is taken as it is: a redistribution
            # to the same placements would still, in its backward, sum a
            # Partial gradient on every use (a param's over the data axes,
            # which the step sums once)
            if tuple(t.placements) != tuple(places):
                t = t.redistribute(mesh, places)
            local.append(t.to_local(grad_placements=grads))
        else:
            local.append(a)
    out = fn(*local)

    def wrap(o, places):
        if isinstance(o, dict):
            return {k: wrap(o[k], places[k]) for k in o}
        if isinstance(o, tuple):
            return tuple(wrap(x, p) for x, p in zip(o, places))
        return DTensor.from_local(o, mesh, places, run_check=False)
    return wrap(out, out_places)


def _batch(mesh, rows: int) -> dict:
    """The data axes' placement of a tensor of ``rows`` rows on dim 0:
    ``Shard(0)`` on each where the rows divide over all of them."""
    axes = batch_axes(mesh)
    place = Shard(0) if _split(rows, mesh, axes) else Replicate()
    return {a: place for a in axes}


def _partial_rows(rows: dict) -> dict:
    """The data axes' placement of a gradient summed over batch rows:
    ``Partial`` where the rows are split, ``Replicate`` where whole."""
    return {a: Partial() if pl == Shard(0) else Replicate()
            for a, pl in rows.items()}


def embed(table, ids):
    """``table[ids]`` (the token embedding, table (V, d), ids (B, S)) on
    each rank's batch rows and vocab slice: the table split over
    ``model`` on V where it divides, each rank looking up the tokens in
    its slice and giving zeros for the others, so the output (batch over
    the data axes) is ``Partial`` over ``model``; the table's gradient is
    ``Partial`` over the data axes.  Plain ids (every rank's the same)
    are taken as replicated."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    ids = like(ids, table) if not isinstance(ids, DTensor) else ids
    rows_ = _batch(mesh, ids.shape[0])
    split = MODEL_AXIS in mesh.mesh_dim_names \
        and _split(table.shape[0], mesh, [MODEL_AXIS])
    rep = Replicate()
    vocab = {MODEL_AXIS: Shard(0) if split else rep}

    def lookup(t, i):
        if not split:
            return t[i]
        i = i - mesh.get_local_rank(MODEL_AXIS) * t.shape[0]
        keep = (i >= 0) & (i < t.shape[0])
        return t[i.clamp(0, t.shape[0] - 1)] * keep[..., None].to(t.dtype)
    ids_places = _places(mesh, rows_, rep)
    return _local(
        lookup, mesh,
        [(table, _places(mesh, vocab, rep),
          _places(mesh, {**_partial_rows(rows_), **vocab}, rep)),
         (ids, ids_places, ids_places)],
        _places(mesh, {**rows_, MODEL_AXIS: Partial() if split else rep},
                rep))


def attention(core: Callable, q, k, v, sliding_window: int, backend: str):
    """``core(q, k, v, sliding_window, backend)`` (the causal attention,
    q (B, S, K, G, D), k/v (B, S, K, D)) on each rank's batch rows and kv
    heads: batch over the data axes and K over ``model`` where they
    divide, else replicated there; the output and the gradients of q, k
    and v in the same placements (each rank's are its own shard's)."""
    if not isinstance(q, DTensor):
        return core(q, k, v, sliding_window, backend)
    mesh = q.device_mesh
    dims = _batch(mesh, q.shape[0])
    if MODEL_AXIS in mesh.mesh_dim_names:
        dims[MODEL_AXIS] = Shard(2) if _split(q.shape[2], mesh,
                                              [MODEL_AXIS]) else Replicate()
    places = _places(mesh, dims, Replicate())
    return _local(lambda q, k, v: core(q, k, v, sliding_window, backend),
                  mesh, [(t, places, places) for t in (q, k, v)], places)


def check_moe_pspec(moe_pspec, mesh) -> None:
    """``ValueError`` unless ``moe_pspec`` (the (B, E, C, d) dispatch
    buffer's spec) is ``None`` or names the mesh's data axes on dim 0 and
    nothing else: the port's dispatch is per sample on each rank's batch
    rows, so the buffer is batch-sharded, and only so."""
    if moe_pspec is None:
        return
    want = (batch_axes(mesh), None, None, None)
    got = tuple(moe_pspec)
    if len(got) != 4 or _axes(got[0]) != want[0] or any(got[1:]):
        raise ValueError(f"moe_pspec {got!r}: the (B, E, C, d) buffer is "
                         f"split over the batch only; give "
                         f"P({want[0]!r}, None, None, None) or None")


def moe(layer: Callable, p, x, top_k: int, capacity_factor: float,
        backend: str, moe_pspec=None):
    """``layer(p, x, top_k, capacity_factor, backend=backend)[0]`` (the
    MoE layer's output; its aux loss is dropped, as in ``forward``) on each
    rank's batch rows and slice of ``d_ff``: x batch over the data axes
    and whole over ``model``, the router replicated, w1/w3 over ``model``
    on ``d_ff`` (their last dim) and w2 on its ``d_ff`` dim (replicated
    where ``d_ff`` does not divide).  Each rank's output sums only its
    ``d_ff`` slice: ``Partial`` over ``model``.  Gradients: x's and the
    router's are ``Partial`` over ``model`` (each slice's share), the
    router's and the experts' ``Partial`` over the data axes (each rank's
    rows' share).  ``moe_pspec`` is checked (:func:`check_moe_pspec`;
    with plain tensors, :func:`check_specs` refused it)."""
    if not isinstance(x, DTensor):
        return layer(p, x, top_k, capacity_factor, backend=backend)[0]
    mesh = x.device_mesh
    check_moe_pspec(moe_pspec, mesh)
    rows = _batch(mesh, x.shape[0])
    split = MODEL_AXIS in mesh.mesh_dim_names \
        and _split(p.w1.shape[-1], mesh, [MODEL_AXIS])
    rep = Replicate()
    partial_rows = _partial_rows(rows)
    part = Partial() if split else rep

    def w_places(dim):
        return _places(mesh, {MODEL_AXIS: Shard(dim) if split else rep}, rep)

    def w_grads(dim):
        return _places(mesh, {**partial_rows,
                              MODEL_AXIS: Shard(dim) if split else rep}, rep)

    x_in = _places(mesh, rows, rep)
    x_grad = _places(mesh, {**rows, MODEL_AXIS: part}, rep)
    router_grad = _places(mesh, {**partial_rows, MODEL_AXIS: part}, rep)
    out = _places(mesh, {**rows, MODEL_AXIS: part}, rep)
    nd = p.w1.dim()
    return _local(
        lambda r, w1, w3, w2, xl: layer(
            type(p)(router=r, w1=w1, w3=w3, w2=w2), xl, top_k,
            capacity_factor, backend=backend)[0],
        mesh,
        [(p.router, _places(mesh, {}, rep), router_grad),
         (p.w1, w_places(nd - 1), w_grads(nd - 1)),
         (p.w3, w_places(nd - 1), w_grads(nd - 1)),
         (p.w2, w_places(nd - 2), w_grads(nd - 2)),
         (x, x_in, x_grad)],
        out)


def mamba2(layer: Callable, p, x, **kw):
    """``layer(p, x, **kw)`` (``mamba2_prefill``: (out, {"conv", "ssm"}))
    on each rank's batch rows, x and the params whole over ``model`` (the
    params gathered there); the output and both states batch over the
    data axes.  Every ``model`` rank computes its rows' whole layer, so
    the params' gradients are ``Partial`` over the data axes only."""
    if not isinstance(x, DTensor):
        return layer(p, x, **kw)
    mesh = x.device_mesh
    rows = _batch(mesh, x.shape[0])
    rep = Replicate()
    x_places = _places(mesh, rows, rep)
    p_grads = _places(mesh, _partial_rows(rows), rep)
    rep_all = _places(mesh, {}, rep)
    n = len(p)
    return _local(
        lambda *a: layer(type(p)(*a[:n]), a[n], **kw), mesh,
        [(t, rep_all, p_grads) for t in p] + [(x, x_places, x_places)],
        (x_places, {"conv": x_places, "ssm": x_places}))
