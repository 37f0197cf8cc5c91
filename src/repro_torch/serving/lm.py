"""Autoregressive decode loop for the transformer substrate."""

from __future__ import annotations

import torch

from ..models.transformer import model as M
from ..models.transformer.config import ArchConfig


def prefill_prompt(cfg: ArchConfig, params, prompt: torch.Tensor,
                   n_new: int, backend: str = "cuda"
                   ) -> tuple[torch.Tensor, dict]:
    """Prefill all but the last prompt token, and give a k/v cache room
    for the ``n_new`` tokens to come (+1 for the fed-back last prompt
    token).  A sliding-window cache is a ring buffer and keeps its size,
    and a Mamba2 cache (conv and ssm states) has none to grow.
    Returns (the prefill's last logits, the cache).
    """
    logits, cache = M.prefill(cfg, params, {"tokens": prompt[:, :-1]},
                              backend=backend)
    if not cfg.sliding_window and "k" in cache:
        for key in ("k", "v"):
            c = cache[key]
            room = c.new_zeros((*c.shape[:2], n_new + 1, *c.shape[3:]))
            cache[key] = torch.cat([c, room], dim=2)
    return logits, cache


def generate(cfg: ArchConfig, params, prompt: torch.Tensor, n_new: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None,
             backend: str = "cuda") -> torch.Tensor:
    """Greedy (``temperature == 0``) or temperature decode.  prompt:
    (B, S) int, S >= 2.

    Returns (B, n_new) int32 generated tokens.  Prefill once, then one
    ``decode_step`` per token.  Sampling draws from ``generator``
    (default: a generator on the prompt's device seeded with 0).  The
    loop never reads a token on the host.
    """
    B, S = prompt.shape
    if S < 2:
        raise ValueError("prompt must have at least 2 tokens")
    _, cache = prefill_prompt(cfg, params, prompt, n_new, backend)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    tok = prompt[:, -1]
    toks = []
    for _ in range(n_new):
        logits, cache = M.decode_step(cfg, params, cache, {"token": tok},
                                      backend=backend)
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = logits.argmax(dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1).to(torch.int32)
