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
* :func:`ring_attention`: the ring (``ring=(mesh, axis)``) on each
  rank's rows, q/k/v sequence over ``axis`` and batch over the data
  axes, the ring's hand-offs on the axis's sub-group, the output handed
  on in the attention core's placements;
* :func:`moe`: the whole MoE layer (routing, per-sample dispatch, the
  three ``moe_gemm`` products, the combine) on this rank's batch rows and
  slice of ``d_ff``; the output is ``Partial`` over ``model``.  The
  dispatch stays per sample, as the reference's, so the buffer is
  batch-sharded whether ``moe_pspec`` is given or not;
* :func:`mlp`: the dense SwiGLU MLP (the layers' and the hybrid's
  shared block's) as :func:`moe` places its experts: batch rows and a
  slice of ``d_ff``, the output and x's gradient ``Partial`` over
  ``model``;
* :func:`mamba2`: the Mamba2 layer on this rank's batch rows with its
  params gathered over ``model`` (the rules shard ``w_in`` over the
  concatenation of z, x, B, C and dt, which no local split follows; GSPMD
  gathers there as well);
* :func:`token_nll`: the loss's per-token cross entropy on the logits'
  vocab slices over ``model`` (each slice's log-sum-exp gathered, B S m
  values, and combined; the label's logit picked where it lies), so no
  rank holds a tensor with the whole vocab as a dim.

``decode_step`` on a cache placed by ``cache_pspecs`` (either mode) has
two more, each taking a layer's slice of the cache (:func:`layer`, a
DTensor over the stored local shards) and writing it in place:

* :func:`decode_attention`: the new token's k/v written into the local
  shards first (on the ranks that hold its slot), then the
  ``decode_attention`` kernel on local shards.  Where W is whole (the
  ``"feature"`` layout, or the prefill's), the layer's cache is
  redistributed to the core's placements (batch over the data axes, K
  over ``model``: with feature mode's head-dim shards an all-to-all of
  the layer's cache at each step).  Where W is split over ``model``
  (``"sequence"``), each rank attends over its own W/m entries, with its
  local valid length, and the ranks' partial outputs combine by their
  log-sum-exps (:func:`combine`), gathered over the ``model`` sub-group;
* :func:`mamba2_decode`: the Mamba2 step on this rank's batch rows, the
  params and the layer's conv/ssm states gathered to whole rows; each
  rank writes its own shard of the new states back, with no collective.

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
from . import ring_attention as _ring

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


def check_cache(params_leaf, cache: dict) -> None:
    """``ValueError`` when params and cache are not both placed: placed
    params (DTensors) need a cache of DTensors (``len`` may be either), a
    placed cache needs placed params."""
    want = placed(params_leaf)
    for key, t in cache.items():
        if placed(t) != want and not (want and key == "len"):
            raise ValueError(
                f"decode_step: cache[{key!r}] is "
                f"{'a plain tensor' if want else 'a DTensor'} and the "
                f"params are {'placed' if want else 'plain tensors'}: "
                "place both by launch.sharding.distribute, or neither")


def placed(t) -> bool:
    """Whether ``t`` is a DTensor."""
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def from_local(loc: torch.Tensor, mesh, places, shape) -> torch.Tensor:
    """A DTensor of global ``shape`` (contiguous strides) over this rank's
    shard ``loc`` (used as it is: no copy, no check)."""
    return DTensor.from_local(loc, mesh, places, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


def layer(t: torch.Tensor, i: int) -> torch.Tensor:
    """``t[i]``: layer ``i``'s slice of a stacked cache leaf (L, ...).  Of
    a DTensor, a DTensor over the view ``t.to_local()[i]`` (L is never
    split), so writes into its local shard write the cache."""
    if not isinstance(t, DTensor):
        return t[i]
    if any(p == Shard(0) for p in t.placements):
        raise ValueError("a cache's leading (layer) dim is never split")
    return from_local(t.to_local()[i], t.device_mesh,
                      [Shard(p.dim - 1) if isinstance(p, Shard) else p
                       for p in t.placements], t.shape[1:])


def grow(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` with ``n`` zero entries appended along ``dim``; a DTensor
    (``dim`` whole on every rank) grown on its local shard, in its own
    placements."""
    def grown(x):
        room = x.new_zeros((*x.shape[:dim], n, *x.shape[dim + 1:]))
        return torch.cat([x, room], dim=dim)
    if not isinstance(t, DTensor):
        return grown(t)
    if Shard(dim) in t.placements:
        raise ValueError(f"grow: dim {dim} is split over the mesh")
    return from_local(grown(t.to_local()), t.device_mesh, t.placements,
                      (*t.shape[:dim], t.shape[dim] + n, *t.shape[dim + 1:]))


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


def heads(t: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """``t`` ready to have its ``dim`` viewed as (n, ...) heads: a DTensor
    whose ``dim`` is split over mesh dims whose sizes' product does not
    divide ``n`` gathered on those mesh dims first (DTensor views no
    shard that cuts a head in two, such as 8 kv heads over a ``model``
    axis of 16; GSPMD reshards there too); else ``t``."""
    if not isinstance(t, DTensor):
        return t
    cut = Shard(dim % t.dim())
    split = [i for i, p in enumerate(t.placements) if p == cut]
    if n % math.prod(t.device_mesh.shape[i] for i in split) == 0:
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p == cut else p
                                          for p in t.placements])


def split_grad(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``t``, a merge of heads into ``dim`` (its backward views the
    gradient's ``dim`` as (n, ...) again), with a gradient hook that takes
    the gradient through :func:`heads` first: a DTensor's gradient may
    arrive split where ``n`` does not divide, which DTensor's view refuses
    (torch 2.11) rather than redistribute.  A plain tensor, or one that
    needs no gradient, as it is."""
    if isinstance(t, DTensor) and t.requires_grad:
        t.register_hook(lambda g: heads(g, n, dim))
    return t


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


def _model_split(mesh, n: int) -> bool:
    """Whether a dim of ``n`` splits over the mesh's ``model`` axis."""
    return MODEL_AXIS in mesh.mesh_dim_names and _split(n, mesh, [MODEL_AXIS])


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
    split = _model_split(mesh, table.shape[0])
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


def _core_places(mesh, q) -> tuple:
    """The attention core's placements of q (B, S, K, G, D) and its
    output (k/v alike): batch over the data axes and K over ``model``
    where they divide, else replicated there."""
    dims = _batch(mesh, q.shape[0])
    if MODEL_AXIS in mesh.mesh_dim_names:
        dims[MODEL_AXIS] = Shard(2) if _split(q.shape[2], mesh,
                                              [MODEL_AXIS]) else Replicate()
    return _places(mesh, dims, Replicate())


def attention(core: Callable, q, k, v, sliding_window: int, backend: str):
    """``core(q, k, v, sliding_window, backend)`` (the causal attention,
    q (B, S, K, G, D), k/v (B, S, K, D)) on each rank's batch rows and kv
    heads: batch over the data axes and K over ``model`` where they
    divide, else replicated there; the output and the gradients of q, k
    and v in the same placements (each rank's are its own shard's)."""
    if not isinstance(q, DTensor):
        return core(q, k, v, sliding_window, backend)
    mesh = q.device_mesh
    places = _core_places(mesh, q)
    return _local(lambda q, k, v: core(q, k, v, sliding_window, backend),
                  mesh, [(t, places, places) for t in (q, k, v)], places)


def check_ring(ring, x) -> None:
    """``ValueError`` when ``x`` is a DTensor on another mesh than the
    ring's, ``ring=(mesh, axis)``: the ring's sub-group must be one of the
    mesh that places the params."""
    if isinstance(x, DTensor) and x.device_mesh != ring[0]:
        raise ValueError(f"ring: the ring's mesh {ring[0]} is not the "
                         f"params' mesh {x.device_mesh}; ring over an axis "
                         "of the mesh the params are placed on")


def ring_attention(q, k, v, mesh, axis: str, sliding_window: int = 0):
    """Ring attention over ``axis`` of ``mesh`` (q (B, S, K, G, D), k/v
    (B, S, K, D), S a multiple of the axis's size) on each rank's rows:
    the sequence split over ``axis``, the batch over the data axes where
    it divides, every other mesh dim whole; ``RingRows`` on the local
    rows over the axis's sub-group, at this rank's coordinate there, each
    data row running a ring of its own.  The gradients of q, k and v come
    back in those placements (each rank's rows are its own: the dk/dv
    accumulators come home, so nothing is ``Partial``); the output is
    redistributed to the attention core's placements (batch over the data
    axes, K over ``model`` where they divide), as :func:`attention`
    returns it.  Plain tensors go to ``ring_attention.ring_attention``
    (global inputs, the output gathered)."""
    if not isinstance(q, DTensor):
        return _ring.ring_attention(q, k, v, mesh, axis,
                                    sliding_window=sliding_window)
    check_ring((mesh, axis), q)
    n = _ring.ring_size(mesh, axis)
    if q.shape[1] % n:
        raise ValueError(f"ring_attention: sequence length {q.shape[1]} "
                         f"is no multiple of the {axis!r} axis's {n} ranks")
    places = _places(mesh, {**_batch(mesh, q.shape[0]), axis: Shard(1)},
                     Replicate())
    group, idx = mesh.get_group(axis), mesh.get_local_rank(axis)
    o = _local(lambda q, k, v: _ring.RingRows.apply(
        q, k, v, group, idx, n, int(sliding_window)),
        mesh, [(t, places, places) for t in (q, k, v)], places)
    # the rest of the layer meets the output as the attention core gives
    # it: on a sequence split, DTensor's propagation refuses the output
    # projection (the (B, S) rows merged into a strided shard)
    return o.redistribute(mesh, _core_places(mesh, q))


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
    split = _model_split(mesh, p.w1.shape[-1])
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


def mlp(layer: Callable, p, x):
    """``layer(p, x)`` (the SwiGLU MLP, w1/w3 (d, ff), w2 (ff, d)) on each
    rank's batch rows and slice of ``d_ff``, as :func:`moe` places its
    experts: x batch over the data axes and whole over ``model``, w1/w3
    over ``model`` on ``d_ff`` (their last dim) and w2 on its first
    (replicated where ``d_ff`` does not divide).  Each rank's output sums
    only its ``d_ff`` slice: ``Partial`` over ``model``.  Gradients: x's
    ``Partial`` over ``model`` (each slice's share), the weights'
    ``Partial`` over the data axes (each rank's rows' share).  Both
    backward products (``dh = dy w2ᵀ``, ``dw2 = hᵀ dy``) run on the
    rank's own slice, so w2 is never gathered (DTensor's propagation
    gathers it there, to meet a gradient that arrives ``Partial``)."""
    if not isinstance(x, DTensor):
        return layer(p, x)
    mesh = x.device_mesh
    rows = _batch(mesh, x.shape[0])
    split = _model_split(mesh, p.w1.shape[-1])
    rep = Replicate()
    part = Partial() if split else rep

    def w(dim, grads):
        return _places(mesh, {**(_partial_rows(rows) if grads else {}),
                              MODEL_AXIS: Shard(dim) if split else rep}, rep)
    return _local(
        lambda w1, w3, w2, xl: layer(type(p)(w1=w1, w3=w3, w2=w2), xl), mesh,
        [(p.w1, w(1, False), w(1, True)), (p.w3, w(1, False), w(1, True)),
         (p.w2, w(0, False), w(0, True)),
         (x, _places(mesh, rows, rep),
          _places(mesh, {**rows, MODEL_AXIS: part}, rep))],
        _places(mesh, {**rows, MODEL_AXIS: part}, rep))


def token_nll(logits, labels):
    """The per-token cross entropy ``logsumexp(logits) - logits[label]``
    (logits (B, S, V) in fp32, labels (B, S)): ``loss_fn``'s terms before
    the mean.  Plain tensors: exactly that expression.

    On a DTensor the vocab stays split over ``model`` (where V divides),
    so no tensor on any rank has the whole V as a dim: each rank takes
    ``logsumexp`` over its own vocab slice, the (B, S) slice results are
    gathered over ``model`` (B S m values, not B S V) and combined by one
    more ``logsumexp``; the label's logit is picked on the rank whose
    slice holds it (zeros elsewhere, ``Partial`` over ``model``, summed).
    The backward forms each rank's slice of softmax minus one-hot only.
    A slice that is all padding (``_mask_padded_vocab``'s -1e30) has lse
    about -1e30 and weighs 0, as in :func:`combine`.  The result is batch
    over the data axes and whole over ``model``."""
    if not isinstance(logits, DTensor):
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, labels[..., None])[..., 0]
        return lse - picked
    mesh = logits.device_mesh
    split = _model_split(mesh, logits.shape[-1])
    rep = Replicate()
    batch = _batch(mesh, logits.shape[0])
    places = _places(mesh, {**batch, MODEL_AXIS: Shard(2) if split else rep},
                     rep)
    rows = _places(mesh, batch, rep)
    labels = like(labels, logits) if not isinstance(labels, DTensor) \
        else labels

    def body(lg, lb):
        v = lg.shape[-1]
        at = lb - mesh.get_local_rank(MODEL_AXIS) * v if split else lb
        own = (at >= 0) & (at < v)
        picked = lg.gather(-1, at.clamp(0, v - 1)[..., None])[..., 0]
        return (torch.logsumexp(lg, dim=-1)[..., None],
                picked * own.to(lg.dtype))
    slices, picked = _local(
        body, mesh, [(logits, places, places), (labels, rows, rows)],
        (places, _places(mesh, {**batch, MODEL_AXIS: Partial() if split
                                else rep}, rep)))
    lse = torch.logsumexp(slices.redistribute(mesh, rows), dim=-1)
    return lse - picked.redistribute(mesh, rows)


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


# ---------------------------------------------------------------------------
# decode on a placed cache
# ---------------------------------------------------------------------------

def _shard_start(mesh, places, dim: int, size: int) -> int:
    """The first index of this rank's shard of a dim that ``places``
    splits into local pieces of ``size`` (several mesh dims on it: the
    first outermost, as DTensor splits it)."""
    coord, idx = mesh.get_coordinate(), 0
    for i, p in enumerate(places):
        if p == Shard(dim):
            idx = idx * mesh.shape[i] + coord[i]
    return idx * size


def _write_slot(cache, new, slot: torch.Tensor) -> None:
    """``cache[:, slot] = new`` on this rank's shards: cache (B, W, K, D),
    a DTensor over the stored shards, new (B, 1, K, D) a DTensor too.
    ``new`` is taken to the cache's placements (W whole); where W is
    split, the slot is written by the rank that holds it, chosen on the
    device: every rank writes its local slot's own value back but that
    one (no host read of ``slot``)."""
    mesh, places = cache.device_mesh, tuple(cache.placements)
    loc = cache.to_local()
    row = new.redistribute(mesh, [Replicate() if p == Shard(1) else p
                                  for p in places]).to_local().to(loc.dtype)
    if Shard(1) not in places:
        loc.index_copy_(1, slot, row)
        return
    w = loc.shape[1]
    at = slot - _shard_start(mesh, places, 1, w)
    own = (at >= 0) & (at < w)
    at = at.clamp(0, w - 1)
    loc.index_copy_(1, at, torch.where(own, row, loc.index_select(1, at)))


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` stacked on a new dim 0, in the
    order of the ranks' coordinates: one ``all_gather`` (a host-staged
    gloo group copies CUDA tensors through the host itself; plain gloo
    gets host copies here)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n == 1:
        return x[None]
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    src = x.cpu() if host else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(x.device)


def combine(os: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The attention over the union of disjoint sets of cache entries from
    each set's output and log-sum-exp, stacked on dim 0: os (n, ..., D),
    lses (n, ...).  In fp32, in the sets' order: M = max lse,
    o = sum e^(lse - M) o / sum e^(lse - M).  A set with no valid entry
    has lse about -1e30 and weighs 0."""
    lse = lses.float()
    w = torch.exp(lse - lse.amax(dim=0))
    return (w[..., None] * os.float()).sum(0) / w.sum(0)[..., None]


def decode_attention(core: Callable, q, k, v, cache_k, cache_v, cache_len,
                     sliding_window: int):
    """One decode step's attention: the new token's k/v (B, 1, K, D)
    written at its slot of ``cache_k``/``cache_v`` (B, W, K, D; the slot
    ``len`` or, for a sliding window, ``len % W``), then
    ``core(q, k, v, valid_len, with_lse=...)`` (the ``decode_attention``
    kernel or its plain version) for q (B, K, G, D) over the first
    ``min(len, W - 1) + 1`` entries.  Returns (B, K, G, D).

    Plain tensors: written in place, then the core on the whole cache.
    A placed cache (DTensors, written in place on its local shards):

    * W whole (feature mode, or the prefill's layout): the layer's cache
      redistributed to the core's placements, batch over the data axes
      and K over ``model`` where they divide (from feature mode's head-dim
      shards an all-to-all), q likewise, the core on the local shards;
    * W split over ``model`` (sequence mode): each rank's core over its
      W/m entries with the local valid length ``clamp(valid - r W/m, 0,
      W/m)`` and their lse; the (o, lse) of the ``model`` ranks gathered
      and combined (:func:`combine`), the same bits on each.

    Nothing reads ``len`` on the host."""
    W = cache_k.shape[1]
    n = local(cache_len)
    last = torch.clamp(n, max=W - 1)
    slot = ((n % W) if sliding_window else last).long().reshape(1)
    valid = (last + 1).to(torch.int32)
    if not isinstance(cache_k, DTensor):
        cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
        cache_v.index_copy_(1, slot, v.to(cache_v.dtype))
        return core(q, cache_k, cache_v, valid)
    _write_slot(cache_k, k, slot)
    _write_slot(cache_v, v, slot)
    mesh = cache_k.device_mesh
    names = mesh.mesh_dim_names
    split = [names[i] for i, p in enumerate(cache_k.placements)
             if p == Shard(1)]
    rows_ = _batch(mesh, q.shape[0])
    rep = Replicate()
    if not split:
        heads = (Shard(1) if MODEL_AXIS in names
                 and _split(q.shape[1], mesh, [MODEL_AXIS]) else rep)
        q_places = _places(mesh, {**rows_, MODEL_AXIS: heads}, rep)
        kv = _places(mesh, {**rows_, MODEL_AXIS: Shard(2) if heads != rep
                            else rep}, rep)
        return _local(lambda q, k, v: core(q, k, v, valid), mesh,
                      [(q, q_places, q_places), (cache_k, kv, kv),
                       (cache_v, kv, kv)], q_places)
    if split != [MODEL_AXIS]:
        raise ValueError(f"decode_attention: the cache's W is split over "
                         f"{split}; only {MODEL_AXIS!r} combines")
    group = mesh.get_group(MODEL_AXIS)
    w = W // mesh.size(names.index(MODEL_AXIS))
    mine = (valid - mesh.get_local_rank(MODEL_AXIS) * w).clamp(0, w) \
        .to(torch.int32)
    q_places = _places(mesh, rows_, rep)
    kv = _places(mesh, {**rows_, MODEL_AXIS: Shard(1)}, rep)

    def body(q, k, v):
        o, lse = core(q, k, v, mine, with_lse=True)
        parts = _gather(torch.cat([o.float().reshape(-1), lse.reshape(-1)]),
                        group)
        os = parts[:, :o.numel()].reshape(-1, *o.shape)
        return combine(os, parts[:, o.numel():].reshape(-1, *lse.shape)) \
            .to(o.dtype)
    return _local(body, mesh, [(q, q_places, q_places), (cache_k, kv, kv),
                               (cache_v, kv, kv)], q_places)


def mamba2_decode(step: Callable, p, x, conv, ssm, **kw):
    """``step(p, x, {"conv": conv, "ssm": ssm}, **kw)`` (``mamba2_decode``:
    (out, new states)), its new states written into ``conv``/``ssm`` (a
    layer's slices of the cache) in place; returns out.  On DTensors: x
    and both states batch over the data axes and whole over ``model`` (the
    states' feature shards gathered), the params gathered over ``model``,
    the step on this rank's rows; each rank then writes its own shards of
    the new states (taking a shard of a whole row moves nothing)."""
    if not isinstance(x, DTensor):
        out, new = step(p, x, {"conv": conv, "ssm": ssm}, **kw)
        conv.copy_(new["conv"])
        ssm.copy_(new["ssm"])
        return out
    mesh = x.device_mesh
    rep = Replicate()
    x_places = _places(mesh, _batch(mesh, x.shape[0]), rep)
    rep_all = _places(mesh, {}, rep)
    n = len(p)

    def body(*a):
        out, new = step(type(p)(*a[:n]), a[n],
                        {"conv": a[n + 1], "ssm": a[n + 2]}, **kw)
        return out, new["conv"], new["ssm"]
    out, new_conv, new_ssm = _local(
        body, mesh, [(t, rep_all, rep_all) for t in p]
        + [(t, x_places, x_places) for t in (x, conv, ssm)],
        (x_places, x_places, x_places))
    for c, t in ((conv, new_conv), (ssm, new_ssm)):
        c.to_local().copy_(t.redistribute(mesh, c.placements).to_local())
    return out
