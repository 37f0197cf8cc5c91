"""Synthetic data pipeline.

Deterministic, seeded generators for: LM token batches (Zipf-ish
unigram + Markov bigram structure so loss can actually go down), image
frame streams for the CNN serving path, and a Poisson request stream
for the pipelined server.  Everything is drawn with host-side numpy,
with the JAX package's draws, and handed out as torch tensors on
``device`` (``"cuda"`` unless the caller passes ``"cpu"``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch


def synthetic_token_batch(rng: np.random.Generator, batch: int, seq: int,
                          vocab: int, n_patterns: int = 64,
                          device: str | torch.device = "cuda"):
    """Tokens with learnable bigram structure: each sampled pattern id
    deterministically maps token t -> (a*t + b) % vocab for a stretch."""
    toks = np.empty((batch, seq + 1), np.int32)
    for i in range(batch):
        pat = rng.integers(0, n_patterns)
        a = 3 + 2 * (pat % 13)
        b = 1 + (pat // 13)
        start = rng.integers(0, vocab)
        seqv = np.empty(seq + 1, np.int64)
        seqv[0] = start
        for t in range(1, seq + 1):
            seqv[t] = (a * seqv[t - 1] + b) % vocab
        toks[i] = seqv.astype(np.int32)
    return {"tokens": torch.as_tensor(toks[:, :-1], device=device),
            "labels": torch.as_tensor(toks[:, 1:], device=device)}


@dataclass
class TokenStream:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    device: str = "cuda"

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        while True:
            yield synthetic_token_batch(rng, self.batch, self.seq,
                                        self.vocab, device=self.device)

    def batches(self, n: int):
        it = iter(self)
        return [next(it) for _ in range(n)]


@dataclass
class ImageStream:
    """Frame source for CNN pipeline serving (the paper's camera)."""

    width: int
    height: int
    channels: int = 3
    seed: int = 0
    device: str = "cuda"

    def frames(self, n: int, batch: int = 1):
        rng = np.random.default_rng(self.seed)
        return [torch.as_tensor(rng.standard_normal(
            (batch, self.height, self.width, self.channels), np.float32),
            device=self.device)
            for _ in range(n)]


@dataclass
class Request:
    rid: int
    arrival: float
    payload: object


@dataclass
class RequestStream:
    """Poisson arrivals for the batched serving driver."""

    rate_per_s: float
    seed: int = 0

    def generate(self, n: int, make_payload) -> list[Request]:
        rng = np.random.default_rng(self.seed)
        t = 0.0
        out = []
        for i in range(n):
            t += rng.exponential(1.0 / self.rate_per_s)
            out.append(Request(i, t, make_payload(rng, i)))
        return out
