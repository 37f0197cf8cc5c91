"""Ring attention: causal GQA attention with the sequence split over one
axis of a ``torch.distributed`` device mesh; the port of the JAX
package's ``models/transformer/ring_attention.py``.

The reference is a ``shard_map``: each device keeps its S/m query rows
and passes its k/v block round the axis with ``lax.ppermute``, m steps,
each an online-softmax update (:func:`_block_update`) masked by global
positions.  Here every rank of the axis's sub-group calls
:func:`ring_attention` with the global q, k, v (equal on every rank,
as the reference's replicated batch), takes its rows and its block, runs
the same steps with :func:`..launch.mesh.ring_shift` as the hand-off,
and gathers the output rows: every rank returns the global output, as
the ``shard_map`` looks from outside.  Axes of the mesh beyond ``axis``
run a ring each.

Step r of rank i meets k/v block src = (i - r) mod m; the diagonal block
(r = 0) comes first, so every row's running max is a real score before a
block masks the row out entirely (a wholly masked first block would
weigh each masked entry exp(0) = 1).  A block that masks every row
(wholly in the future, or wholly outside the window) changes no
statistic, so its products are skipped; its k/v still go round.  The
reference's last rotation only brings the blocks home: the forward
skips it (m - 1 hand-offs).

:class:`RingRows` is the ring on this rank's rows, and is
differentiable: its backward recomputes each block's probabilities from
the saved row log-sum-exps and runs a second ring in which the dk/dv
accumulators travel with their k/v block and come home (m hand-offs),
so each rank ends with its own rows' dq, dk and dv.
:class:`RingAttention` slices the global inputs' rows, runs
:class:`RingRows` and gathers the output, and in its backward dq, dk
and dv, so every rank holds the gradient of the global inputs that the
one-process path gives.  On DTensor inputs (params placed by
``launch.sharding.distribute``) ``sharded.ring_attention`` runs
:class:`RingRows` on each rank's local rows instead, with no gather.
The block update is plain torch: the reference's is a pair of XLA
einsums, not a Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from ...launch.mesh import gather_axis, ring_shift

NEG = -1e30   # the reference's mask value (not -inf)


def ring_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` of ``mesh``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _live(i: int, src: int, rows: int, sliding_window: int) -> bool:
    """Whether query block ``i`` sees any key of block ``src`` (blocks of
    ``rows`` positions)."""
    if src > i:
        return False
    return not sliding_window \
        or i * rows - ((src + 1) * rows - 1) < sliding_window


def _scores(q_blk, k_blk, q_pos, k_pos, sliding_window: int):
    """fp32 scores (B, K, G, Sq, Sk) of q (B, Sq, K, G, D) against k
    (B, Sk, K, D), masked to -1e30 by global positions."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q_blk.float(), k_blk.float()) \
        / math.sqrt(q_blk.shape[-1])
    mask = q_pos[:, None] >= k_pos[None, :]
    if sliding_window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < sliding_window
    return s.masked_fill(~mask, NEG)


def _block_update(carry, q_blk, k_blk, v_blk, q_pos, k_pos,
                  sliding_window: int):
    """Online-softmax update of (m, l, acc) with one kv block: the
    reference's ``_block_update``.  q_blk (B, Sq, K, G, D), k_blk/v_blk
    (B, Sk, K, D), q_pos (Sq,) and k_pos (Sk,) global positions; m, l
    (B, K, G, Sq) and acc (B, K, G, Sq, D) in fp32.  The probabilities
    are cast to v's dtype before the PV product, as the reference's."""
    m_, l_, acc = carry
    s = _scores(q_blk, k_blk, q_pos, k_pos, sliding_window)
    m_new = torch.maximum(m_, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_ - m_new)
    l_new = l_ * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bkgqs,bskd->bkgqd", p.to(v_blk.dtype).float(), v_blk.float())
    return m_new, l_new, acc_new


class RingRows(torch.autograd.Function):
    """``RingRows.apply(q_l, k_l, v_l, group, idx, n, sliding_window)``:
    this rank's rows of causal attention, q_l (B, S/n, K, G, D) and
    k_l/v_l (B, S/n, K, D) the rows of coordinate ``idx`` of ``group``
    (``n`` ranks), which hold the sequence's blocks in coordinate order.
    Returns this rank's output rows in q's dtype; the backward returns
    this rank's dq_l, dk_l and dv_l, with no gather.  Saves the rank's
    rows and block, its output rows (fp32) and their log-sum-exps."""

    @staticmethod
    def forward(ctx, q_l, k_l, v_l, group, idx, n, sliding_window):
        B, rows, K, G, D = q_l.shape
        pos = torch.arange(rows, device=q_l.device)
        m_ = torch.full((B, K, G, rows), -math.inf, device=q_l.device)
        l_ = torch.zeros((B, K, G, rows), device=q_l.device)
        acc = torch.zeros((B, K, G, rows, D), device=q_l.device)
        k_cur, v_cur = k_l, v_l
        for r in range(n):
            src = (idx - r) % n
            if _live(idx, src, rows, sliding_window):
                m_, l_, acc = _block_update(
                    (m_, l_, acc), q_l, k_cur, v_cur, idx * rows + pos,
                    src * rows + pos, sliding_window)
            if r < n - 1:
                k_cur, v_cur = ring_shift([k_cur, v_cur], group, idx, n)
        o_l = (acc / l_.clamp_min(1e-30)[..., None]).permute(0, 3, 1, 2, 4)
        ctx.save_for_backward(q_l, k_l, v_l, o_l, m_ + torch.log(l_))
        ctx.ring = (group, idx, n, sliding_window)
        return o_l.to(q_l.dtype)

    @staticmethod
    def backward(ctx, do_l):
        q_l, k_l, v_l, o_l, lse = ctx.saved_tensors
        group, idx, n, sliding_window = ctx.ring
        rows, D = q_l.shape[1], q_l.shape[-1]
        scale = 1.0 / math.sqrt(D)
        pos = torch.arange(rows, device=q_l.device)
        do_l = do_l.float()
        qf = q_l.float()
        delta = (do_l * o_l).sum(dim=-1).permute(0, 2, 3, 1)  # (B,K,G,Sq)
        dq = torch.zeros_like(qf)
        dk = torch.zeros(k_l.shape, device=k_l.device)
        dv = torch.zeros(v_l.shape, device=v_l.device)
        k_cur, v_cur = k_l, v_l
        for r in range(n):
            src = (idx - r) % n
            if _live(idx, src, rows, sliding_window):
                p = torch.exp(_scores(q_l, k_cur, idx * rows + pos,
                                      src * rows + pos, sliding_window)
                              - lse[..., None])
                dp = torch.einsum("bqkgd,bskd->bkgqs", do_l, v_cur.float())
                ds = p * (dp - delta[..., None])
                dq += torch.einsum("bkgqs,bskd->bqkgd", ds,
                                   k_cur.float()) * scale
                dk += torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
                dv += torch.einsum("bkgqs,bqkgd->bskd", p, do_l)
            # the accumulators travel with their block; the last step
            # sends only them, home
            if r < n - 1:
                k_cur, v_cur, dk, dv = ring_shift([k_cur, v_cur, dk, dv],
                                                  group, idx, n)
            elif n > 1:
                dk, dv = ring_shift([dk, dv], group, idx, n)
        return (dq.to(q_l.dtype), dk.to(k_l.dtype), dv.to(v_l.dtype),
                None, None, None, None)


class RingAttention(torch.autograd.Function):
    """``RingAttention.apply(q, k, v, group, idx, n, sliding_window)``:
    the global output of causal attention, q (B, S, K, G, D) and k/v
    (B, S, K, D) global and equal on every rank of ``group`` (``n``
    ranks, this one at coordinate ``idx``), S a multiple of ``n``: this
    rank's rows through :class:`RingRows`, the output rows gathered, and
    in the backward dq, dk and dv gathered, so every rank holds the
    gradient of the global inputs."""

    @staticmethod
    def forward(ctx, q, k, v, group, idx, n, sliding_window):
        rows = q.shape[1] // n
        mine = slice(idx * rows, (idx + 1) * rows)
        o_l = RingRows.forward(ctx, q[:, mine], k[:, mine], v[:, mine],
                               group, idx, n, sliding_window)
        return gather_axis(o_l, group, dim=1)

    @staticmethod
    def backward(ctx, do):
        group, idx, n, _ = ctx.ring
        rows = do.shape[1] // n
        grads = RingRows.backward(ctx, do[:, idx * rows:(idx + 1) * rows])
        return (*(gather_axis(g, group, dim=1) for g in grads[:3]),
                None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "model", sliding_window: int = 0,
                   axis_size: int | None = None) -> torch.Tensor:
    """Causal GQA attention with the sequence split over ``axis`` of
    ``mesh`` (a ``torch.distributed`` ``DeviceMesh``; every rank of the
    axis calls this with the same arguments).

    q: (B, S, K, G, D) with rope applied; k/v: (B, S, K, D); global, and
    equal on every rank.  S must be a multiple of the axis's size.
    Returns the global (B, S, K, G, D) in q's dtype on every rank, and
    differentiates to the global gradients (:class:`RingAttention`).
    ``axis_size`` is the reference's argument for a mesh it cannot see;
    here the mesh is given, and a size that differs from it raises
    ``ValueError``."""
    n = ring_size(mesh, axis)
    if axis_size is not None and axis_size != n:
        raise ValueError(f"ring_attention: axis_size {axis_size}, but the "
                         f"{axis!r} axis has {n} ranks")
    if q.dim() != 5 or k.dim() != 4 or k.shape != v.shape \
            or tuple(k.shape) != (*q.shape[:3], q.shape[4]):
        raise ValueError(f"ring_attention: want q (B,S,K,G,D), k/v "
                         f"(B,S,K,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[1] % n:
        raise ValueError(f"ring_attention: sequence length {q.shape[1]} "
                         f"is no multiple of the {axis!r} axis's {n} ranks")
    return RingAttention.apply(q, k, v, mesh.get_group(axis),
                               mesh.get_local_rank(axis), n,
                               int(sliding_window))
