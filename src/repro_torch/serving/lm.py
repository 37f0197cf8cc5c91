"""Autoregressive decode loop for the transformer substrate.

The JAX package jits ``decode_step``; here :class:`Decoder` replays it
from a CUDA graph on a CUDA device (:mod:`repro_torch.exec.graph`), and
runs it eagerly on the CPU and on placed params.

Params placed by ``launch.sharding.distribute`` serve as they are, as
the reference's jitted ``generate`` takes sharded params through GSPMD:
every rank of the mesh calls :func:`generate` with the same prompt, the
cache keeps the placements ``prefill`` gives it, and the tokens come
back as a DTensor.
"""

from __future__ import annotations

import torch

from ..exec import graph as cuda_graph
from ..models.transformer import model as M
from ..models.transformer import sharded
from ..models.transformer.config import ArchConfig


def prefill_prompt(cfg: ArchConfig, params, prompt: torch.Tensor,
                   n_new: int, backend: str = "cuda"
                   ) -> tuple[torch.Tensor, dict]:
    """Prefill all but the last prompt entry, and give a k/v cache room
    for the ``n_new`` entries to come (+1 for the fed-back last prompt
    entry).  ``prompt`` is (B, S) token ids, or (B, S, d) embeddings for
    a config with ``input_mode == "embeds"``.  The k/v of attention
    layers and of a hybrid's shared-block sites grow; a sliding-window
    cache is a ring buffer and keeps its size, and a Mamba2 cache (conv
    and ssm states) has none to grow.
    On placed params the cache's tensors are DTensors, each grown on its
    local shards in its own placements (``sharded.grow``).
    Returns (the prefill's last logits, the cache).
    """
    key = "tokens" if cfg.input_mode == "tokens" else "embeds"
    logits, cache = M.prefill(cfg, params, {key: prompt[:, :-1]},
                              backend=backend)
    if not cfg.sliding_window:
        for key in ("k", "v", "shared_k", "shared_v"):
            if key in cache:
                cache[key] = sharded.grow(cache[key], 2, n_new + 1)
    return logits, cache


class Decoder:
    """Decode steps on one cache: ``decoder(x)`` runs one step for ``x``,
    (B,) token ids or, for a config with ``input_mode == "embeds"``,
    (B, d) embeddings, and returns its logits (B, vocab_padded).

    ``decode_step`` writes the cache's k/v (or conv and ssm states) in
    place; the decoder advances the cache's length in place too, in a
    ``len`` of its own, so every step reads and writes the same tensors.
    On a CUDA device (:func:`repro_torch.exec.graph.enabled`) and with
    ``capture``, the first call runs the step eagerly (the graph's
    warm-up) and captures it; every later call copies its input in and
    replays the graph.  The logits of a replay are the graph's own
    tensor, which the next call overwrites.  No step reads a device
    value on the host.

    On params placed by ``launch.sharding.distribute`` (DTensors: chosen
    by the params' type) every step runs eagerly: a sharded step's
    collectives may stage through the host (gloo), which a CUDA graph
    cannot capture, so none is tried.
    """

    def __init__(self, cfg: ArchConfig, params, cache: dict,
                 backend: str = "cuda", capture: bool = True):
        self.cfg, self.params, self.backend = cfg, params, backend
        self.cache = {**cache, "len": cache["len"].clone()}
        self.capture = capture and not sharded.placed(params["head"])
        self.graph: cuda_graph.Graph | None = None
        self.key = "token" if cfg.input_mode == "tokens" else "embed"

    def _step(self, x: torch.Tensor) -> torch.Tensor:
        logits, cache = M.decode_step(self.cfg, self.params, self.cache,
                                      {self.key: x}, backend=self.backend)
        self.cache["len"].copy_(cache["len"])
        return logits

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.graph is not None:
            return self.graph(x)
        if not (self.capture and cuda_graph.enabled(x.device)):
            return self._step(x)
        self.graph = cuda_graph.Graph(self._step, (x,),
                                      name=f"{self.cfg.name} decode step")
        return self.graph.take_warm()


def generate(cfg: ArchConfig, params, prompt: torch.Tensor, n_new: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None,
             backend: str = "cuda") -> torch.Tensor:
    """Greedy (``temperature == 0``) or temperature decode.  prompt:
    (B, S) int, S >= 2.

    Returns (B, n_new) int32 generated tokens.  Prefill once, then one
    decode step per token through a :class:`Decoder`: on a CUDA device
    the first step runs eagerly and the rest replay one CUDA graph,
    captured for this call (the next prefill makes new cache tensors).
    Sampling, outside the graph, draws from ``generator`` (default: a
    generator on the prompt's device seeded with 0).  The loop never
    reads a token on the host.

    On placed params (every rank of the mesh calls this with the same
    prompt) the decode steps run eagerly (:class:`Decoder`), the argmax
    and the sampling read each row's whole vocab (gathered over
    ``model``; a sampled draw over the whole batch on every rank, so the
    ranks draw alike and as one device would), and the tokens are a
    DTensor.

    A config with ``input_mode == "embeds"`` has no token loop (each
    step's input is an embedding from a frontend the repo stubs): it
    raises ``ValueError``; drive its ``prefill_prompt`` and
    :class:`Decoder` directly.
    """
    if cfg.input_mode != "tokens":
        raise ValueError(f"{cfg.name}: input_mode {cfg.input_mode!r} takes "
                         f"embeddings, and generate feeds tokens back")
    B, S = prompt.shape
    if S < 2:
        raise ValueError("prompt must have at least 2 tokens")
    _, cache = prefill_prompt(cfg, params, prompt, n_new, backend)
    if temperature > 0 and generator is None:
        generator = torch.Generator(
            device=sharded.local(prompt).device).manual_seed(0)
    decoder = Decoder(cfg, params, cache, backend, capture=n_new > 1)
    tok = prompt[:, -1].long()
    toks = []
    for _ in range(n_new):
        logits = decoder(tok)
        if temperature > 0:
            probs = torch.softmax(sharded.local(sharded.replicated(
                logits)).float() / temperature, dim=-1)
            tok = sharded.like(torch.multinomial(
                probs, 1, generator=generator)[:, 0], logits)
        else:
            tok = sharded.replicate_dim(logits, -1).argmax(dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1).to(torch.int32)
