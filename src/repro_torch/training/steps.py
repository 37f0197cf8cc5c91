"""Train and eval steps of the decoder substrate (the reference's
``jax.value_and_grad`` step, with ``torch.autograd``)."""

from __future__ import annotations

import torch

from ..launch import sharding
from ..models.transformer.config import ArchConfig
from ..models.transformer.model import loss_fn
from . import tree
from .optim import AdamW, AdamWState


def loss_and_grads(cfg: ArchConfig, params, batch, unroll: bool = False,
                   backend: str = "cuda", ring=None, act_pspec=None,
                   moe_pspec=None):
    """(loss, grads): ``loss_fn`` at ``params`` (remat on) and its
    gradient, a tree of ``params``' structure (the reference's
    ``jax.value_and_grad``).  Every leaf reaches the loss in every
    family; autograd raises if one does not.  The params passed in are
    not changed.  ``ring=(mesh, axis)`` goes to ``loss_fn``: every rank
    of the axis calls this with the same arguments and gets the whole
    gradient (on placed params, together with ``act_pspec`` and
    ``moe_pspec``, each gradient in its param's placements).

    On params placed by ``launch.sharding.distribute`` (``act_pspec`` and
    ``moe_pspec`` go to ``loss_fn``) every rank of the mesh calls this;
    each gradient is a DTensor in its param's placements (one that comes
    out ``Partial`` over the data axes, as a param replicated there does,
    is summed), and the loss a plain 0-d tensor, equal on every rank."""
    live = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
    loss = loss_fn(cfg, tree.unflatten(params, live), batch, unroll=unroll,
                   backend=backend, ring=ring, act_pspec=act_pspec,
                   moe_pspec=moe_pspec)
    grads = torch.autograd.grad(loss, live)
    return sharding.full(loss.detach()), sharding.like_placements(
        tree.unflatten(params, grads), params)


def make_train_step(cfg: ArchConfig, opt: AdamW, unroll: bool = False,
                    act_pspec=None, moe_pspec=None, backend: str = "cuda"):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    loss): :func:`loss_and_grads` (the loss a 0-d tensor, not read on
    the host), then ``opt.update``.  The params passed in are not
    changed.  ``act_pspec``/``moe_pspec`` go to ``loss_fn``; on placed
    params the new params, m and v are DTensors in the placements the
    params had."""

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = loss_and_grads(cfg, params, batch, unroll=unroll,
                                     backend=backend, act_pspec=act_pspec,
                                     moe_pspec=moe_pspec)
        new, opt_state = opt.update(grads, opt_state, params)
        opt_state = AdamWState(opt_state.step,
                               sharding.like_placements(opt_state.m, params),
                               sharding.like_placements(opt_state.v, params))
        return sharding.like_placements(new, params), opt_state, loss

    return train_step


def make_eval_step(cfg: ArchConfig, backend: str = "cuda"):
    """Returns eval_step(params, batch) -> the loss, without gradients."""
    def eval_step(params, batch):
        with torch.no_grad():
            return loss_fn(cfg, params, batch, backend=backend)
    return eval_step
