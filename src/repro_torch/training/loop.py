"""The training loop: data -> train step -> metrics -> checkpoints."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

from ..data.pipeline import TokenStream
from ..models.transformer.config import ArchConfig
from ..models.transformer.model import init_params
from . import checkpoint
from .optim import AdamW, cosine_schedule
from .steps import make_train_step


@dataclass
class TrainReport:
    losses: list[float] = field(default_factory=list)
    steps: int = 0
    wall_s: float = 0.0
    tokens: int = 0
    #: each step's host-clock seconds, batch drawn to loss read (the read
    #: waits for the device)
    step_s: list[float] = field(default_factory=list)
    #: the params after the last step
    params: Any = None

    @property
    def final_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")


def train(cfg: ArchConfig, steps: int = 100, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, seed: int = 0, log_every: int = 10,
          ckpt_path: str | None = None, warmup: int = 20,
          device: str | torch.device = "cuda") -> TrainReport:
    """End-to-end training on the synthetic token stream, on ``device``
    (the kernels on the card, their plain versions on the CPU).  Weights
    are drawn on the CPU from ``seed`` (``init_params``), so both devices
    start from the same ones."""
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device=device)
    opt = AdamW(lr=cosine_schedule(lr, warmup, steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    stream = iter(TokenStream(cfg.vocab_size, batch, seq, seed=seed,
                              device=str(device)))

    rep = TrainReport()
    t0 = time.time()
    for i in range(steps):
        ts = time.perf_counter()
        batch_data = next(stream)
        params, opt_state, loss = step_fn(params, opt_state, batch_data)
        rep.losses.append(float(loss))
        rep.step_s.append(time.perf_counter() - ts)
        rep.tokens += batch * seq
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:4d}  loss {rep.losses[-1]:.4f}  "
                  f"({rep.tokens / max(time.time() - t0, 1e-9):.0f} tok/s)",
                  flush=True)
    rep.steps = steps
    rep.wall_s = time.time() - t0
    rep.params = params
    if ckpt_path:
        checkpoint.save(Path(ckpt_path), params)
    return rep
