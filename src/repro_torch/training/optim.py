"""AdamW and a cosine schedule as functional updates of the parameter
tree, with the reference's arithmetic (``src/repro/training/optim.py``):
a global-norm clip in fp32, bias corrections in fp32, weight decay added
to the update of every leaf with two or more dimensions (so the stacked
norms, (L, d), are decayed, as there).  Nothing is read on the host: the
step, the norm and the learning rate stay tensors on the params'
device."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from . import tree


class AdamWState(NamedTuple):
    step: torch.Tensor     # 0-d int32
    m: Any
    v: Any


@dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        first = tree.leaves(params)[0]
        return AdamWState(
            torch.zeros((), dtype=torch.int32, device=first.device),
            tree.map_(torch.zeros_like, params),
            tree.map_(torch.zeros_like, params))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """(new params, new state): new tensors; nothing is updated in
        place."""
        step = state.step + 1
        if self.grad_clip:
            gnorm = torch.sqrt(sum(g.float().square().sum()
                                   for g in tree.leaves(grads)))
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
            grads = tree.map_(lambda g: g * scale.to(g.dtype), grads)
        b1, b2 = self.b1, self.b2
        m = tree.map_(lambda mm, g: b1 * mm + (1 - b1) * g, state.m, grads)
        v = tree.map_(lambda vv, g: b2 * vv + (1 - b2) * g.square(),
                      state.v, grads)
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()
        lr = self._lr(step)

        def upd(p, mm, vv):
            delta = (mm / c1) / (torch.sqrt(vv / c2) + self.eps)
            if self.weight_decay and p.dim() >= 2:   # decay matrices only
                delta = delta + self.weight_decay * p
            return (p - lr * delta).to(p.dtype)

        return tree.map_(upd, params, m, v), AdamWState(step, m, v)


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up over ``warmup`` steps, then a cosine to 0 at
    ``total``; takes the step as a tensor and returns an fp32 tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr
