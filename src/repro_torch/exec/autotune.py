"""Launch-plan autotuning for the Hopper conv kernel.

The counterpart of the JAX package's ``exec/autotune.py``, which
searches the Pallas kernel's channel blocks.  The Hopper kernel has no
channel blocks to tune: what a launch can vary is its plan
(``kernels.conv2d.ops.plan``), the output tile (BM, BN) and the split-K
factor S of its thread-block cluster.  The heuristic picks them from the
shape; this module times the candidate plans per conv shape, keeps the
heuristic plan unless another beats it by more than the timing's
spread, records each search as an ``autotune`` span and
``exec.autotune.*`` metrics, and keeps the winners in the
:class:`~repro_torch.core.cost.CostTable` artifact (its ``kernels``
field), beside the calibration ratios, so they survive
``Deployment.save()/load()``.

Keys (:func:`shape_key`) have the JAX package's spatial-size-free form
with the port's backend label, ``conv:cuda:c{ci}x{co}:k..:s..:r..:p..``,
because the pipeline runs the same conv on many tile widths.  An entry
``{"tile": [bm, bn], "split": s, "best_us", "backend": "cuda"}`` gives
every width of a layer the same plan: the tile holds where the variant
takes it and the split is clipped to what K allows, neither of which
depends on the spatial size (``ops.plan``).  Where the heuristic plan
won, the entry holds ``"tile": null, "split": null``: every width keeps
its own heuristic plan (the full width's plan is not the heuristic's at
the others), and the key still counts as tuned.

Winners are *installed* process-wide (:func:`install`); the ``cuda``
backend's conv consults :func:`tuned_plan` on every call and takes the
heuristic plan where no entry matches.  Entries under other keys (the
JAX package's ``conv:pallas:...`` block sizes, which an artifact of
that package carries) stay in the table and are saved again unchanged,
but are never installed.  Each change to the installed entries bumps
:func:`generation`, which drops the CUDA graphs that captured the old
plans (``exec.compiler.CompiledStage``).
"""

from __future__ import annotations

import statistics
import time as _time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

import torch

from ..core.cost import CostTable
from ..kernels.conv2d import ops as conv_ops
from ..obs import trace as obs_trace
from ..obs.metrics import default_registry

#: the backend label of the keys this package installs
BACKEND = "cuda"
#: (tile, split) candidates: every tile and split-K factor the kernel
#: takes.  A shape resolves each to the plan it allows (``ops.plan``);
#: equal plans are timed once, and the heuristic plan always
DEFAULT_CANDIDATES: tuple[tuple[tuple[int, int], int], ...] = tuple(
    (tile, split) for tile in conv_ops.TILES for split in conv_ops.SPLITS)


def shape_key(x_shape, w_shape, stride, relu=False, pool=None,
              backend: str = BACKEND) -> str:
    """Stable CostTable key for one conv-epilogue configuration.

    Spatial dims are excluded on purpose (see module docstring); the
    key captures channels, filter, stride, epilogue, and backend.
    """
    ci = x_shape[-1]
    kh, kw, _, co = w_shape
    sh, sw = stride
    p = "-" if pool is None else f"{pool[0]}x{pool[1]}"
    return (f"conv:{backend}:c{ci}x{co}:k{kh}x{kw}:s{sh}x{sw}"
            f":r{int(bool(relu))}:p{p}")


# ---------------------------------------------------------------------------
# installed winners (process-wide, consulted by exec.backends)
# ---------------------------------------------------------------------------

_TUNED: dict[str, dict] = {}
_GENERATION = 0
_PREFIX = f"conv:{BACKEND}:"


def _bump() -> None:
    global _GENERATION
    _GENERATION += 1


def install(kernels: Mapping[str, Mapping]) -> None:
    """Merge CostTable ``kernels`` entries under ``conv:cuda:`` keys into
    the process-wide tuned registry (last write wins per key); other
    keys are left out.  ``Deployment`` calls this on construction and
    load, so a saved artifact re-arms its tuned plans."""
    new = {k: dict(e) for k, e in kernels.items() if k.startswith(_PREFIX)}
    for e in new.values():
        if (e["tile"] is None) != (e["split"] is None):
            raise ValueError(f"conv2d: tile {e['tile']} and split "
                             f"{e['split']}: both or neither are null")
        if e["tile"] is not None:
            conv_ops.check_override(tuple(e["tile"]), int(e["split"]))
    if any(_TUNED.get(k) != e for k, e in new.items()):
        _TUNED.update(new)
        _bump()


def installed() -> dict[str, dict]:
    """Copy of the currently installed tuned entries."""
    return {k: dict(e) for k, e in _TUNED.items()}


def clear_installed() -> None:
    if _TUNED:
        _TUNED.clear()
        _bump()


def generation() -> int:
    """Bumped by each change to the installed entries: a plan captured
    under another generation may no longer be the one a call takes."""
    return _GENERATION


def tuned_plan(x_shape, w_shape, stride, relu=False, pool=None
               ) -> tuple[tuple[int, int], int] | None:
    """(tile, split) installed for this conv call, or None (the
    heuristic plan applies: no entry, or one the heuristic won)."""
    e = _TUNED.get(shape_key(x_shape, w_shape, stride, relu, pool))
    if e is None or e["tile"] is None:
        return None
    return tuple(e["tile"]), int(e["split"])


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

#: rounds of a search: each round times every plan once, in turn, so
#: that a drift of the card's clock or of its neighbours' load falls on
#: every plan alike and shows in each plan's spread
ROUNDS = 8


@dataclass
class TuneResult:
    key: str
    tile: tuple[int, int]
    split: int
    #: the chosen plan's median seconds per call, in microseconds
    best_us: float
    #: the plan the heuristic gives the tuned shape
    heuristic: conv_ops.Plan
    #: (plan, median seconds per call) of each distinct plan timed
    trials: list[tuple[conv_ops.Plan, float]] = field(default_factory=list)
    #: the spread (max - min of its rounds) that the fastest plan had to
    #: beat the heuristic's median by, in microseconds
    spread_us: float = 0.0

    @property
    def heuristic_us(self) -> float:
        return next(dt for p, dt in self.trials if p == self.heuristic) * 1e6

    def entry(self, backend: str = BACKEND) -> dict:
        """The CostTable ``kernels`` entry for this winner: tile and
        split null where the heuristic plan won."""
        won = (self.tile, self.split) == (self.heuristic.tile,
                                          self.heuristic.split)
        return {"tile": None if won else list(self.tile),
                "split": None if won else self.split,
                "best_us": self.best_us, "backend": backend}


def _time_rounds(fns, iters: int, device: torch.device
                 ) -> list[list[float]]:
    """Seconds per call of each of ``fns``, one sample a round: after a
    warm-up call of each, :data:`ROUNDS` rounds in which each fn in turn
    is timed over ``iters`` calls, between CUDA events on a GPU (the
    host clock on the CPU)."""
    for fn in fns:
        fn()
    cuda = device.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    samples: list[list[float]] = [[] for _ in fns]
    for _ in range(ROUNDS):
        for fn, out in zip(fns, samples):
            if cuda:
                torch.cuda.synchronize(device)
                start.record()
            else:
                t0 = _time.perf_counter()
            for _ in range(iters):
                fn()
            if cuda:
                end.record()
                torch.cuda.synchronize(device)
                out.append(start.elapsed_time(end) / 1e3 / iters)
            else:
                out.append((_time.perf_counter() - t0) / iters)
    return samples


def autotune_conv(x_shape: Sequence[int], w_shape: Sequence[int], *,
                  stride=(1, 1), relu: bool = False,
                  pool: tuple[int, int] | None = None,
                  backend: str = BACKEND,
                  candidates: Iterable[tuple[tuple[int, int], int]]
                  = DEFAULT_CANDIDATES,
                  iters: int = 3, device: str | torch.device = "cuda"
                  ) -> TuneResult:
    """Time ``candidates`` (tile, split) on one conv-epilogue shape (with
    a bias, inputs drawn from seed 0) and return the plan to install;
    emits an ``autotune`` span per shape and an ``exec.autotune.trial_s``
    histogram sample per plan timed.

    Each candidate is resolved to the plan the shape allows
    (``ops.plan``); equal plans are timed once, and the heuristic plan
    is always among them.  The plans are timed in :data:`ROUNDS` rounds
    of ``iters`` calls each, taken in turns (:func:`_time_rounds`); a
    plan's time is the median of its rounds and its spread their range.
    The fastest plan replaces the heuristic's only where it beats the
    heuristic's median by more than the larger of the two spreads: a
    difference within the noise keeps the heuristic plan.

    On a GPU each plan launches the kernel, timed between CUDA events.
    On the CPU, which a caller gets only by asking for ``device="cpu"``,
    the wrapper runs the plain version for every candidate: the search
    then exercises the plumbing, and its times say nothing of the kernel.
    """
    device = torch.device(device)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(tuple(x_shape), generator=g).to(device)
    w = (torch.randn(tuple(w_shape), generator=g) * 0.1).to(device)
    b = torch.randn((w_shape[-1],), generator=g).to(device)
    stride = conv_ops.normalize_stride(stride)
    pool = None if pool is None else tuple(pool)
    skey = shape_key(x_shape, w_shape, stride, relu, pool, backend)
    n, h, wd, ci = x_shape
    kh, kw, _, co = w_shape

    def plan_of(tile=None, split=None):
        return conv_ops.plan(n, h, wd, ci, kh, kw, co, stride, pool, True,
                             tile, split)

    heuristic = plan_of()
    plans = list(dict.fromkeys(
        [heuristic] + [plan_of(tuple(t), int(s)) for t, s in candidates]))
    reg = default_registry()
    tr = obs_trace.current()
    with tr.wall_span("autotune", key=skey) if tr else nullcontext():
        samples = _time_rounds(
            [lambda p=p: conv_ops.conv2d_fused(
                x, w, b, stride=stride, relu=relu, pool=pool, tile=p.tile,
                split=p.split) for p in plans], iters, device)
    trials = [(p, statistics.median(s)) for p, s in zip(plans, samples)]
    for _, dt in trials:
        reg.histogram("exec.autotune.trial_s").observe(dt)
    spread = {p: max(s) - min(s) for p, s in zip(plans, samples)}
    (best, dt), (_, dt_h) = min(trials, key=lambda t: t[1]), trials[0]
    margin = max(spread[best], spread[heuristic])
    if dt_h - dt <= margin:
        best, dt = heuristic, dt_h
    reg.counter("exec.autotune.tuned", backend=backend).inc()
    return TuneResult(skey, best.tile, best.split, dt * 1e6, heuristic,
                      trials, margin * 1e6)


def conv_shapes(model) -> list[dict]:
    """Distinct conv-epilogue invocation shapes of a model, fused the
    way the compiler will fuse them (conv->pool chains collapse into
    one shape with ``pool`` set).  Spatial dims come from the model's
    full (untiled) geometry — representative, and irrelevant to the
    spatial-size-agnostic key."""
    from .compiler import fusable_chains
    g = model.graph
    fusion = fusable_chains(g, frozenset(g.layers))
    shapes: dict[str, dict] = {}
    for n, spec in g.layers.items():
        if spec.kind != "conv":
            continue
        ps = g.preds[n]
        w_in, h_in = (model.full_sizes[ps[0]] if ps else model.input_size)
        pw, ph = spec.padding
        x_shape = (1, h_in + 2 * ph, w_in + 2 * pw, spec.in_channels)
        w_shape = (spec.kernel[1], spec.kernel[0], spec.in_channels,
                   spec.out_channels)
        stride = (spec.stride[1], spec.stride[0])
        pool = None
        if n in fusion:
            pspec = g.layers[fusion[n]]
            pool = (pspec.kernel[1], pspec.kernel[0])
        d = dict(x_shape=x_shape, w_shape=w_shape, stride=stride,
                 relu=True, pool=pool)
        shapes.setdefault(shape_key(x_shape, w_shape, stride, True, pool), d)
    return list(shapes.values())


def autotune_model(model, *, backend: str = BACKEND,
                   table: CostTable | None = None,
                   candidates: Iterable[tuple[tuple[int, int], int]]
                   = DEFAULT_CANDIDATES,
                   iters: int = 3, device: str | torch.device = "cuda"
                   ) -> tuple[CostTable, list[TuneResult]]:
    """Tune every distinct conv shape of ``model`` not already present
    in ``table.kernels`` (a loaded artifact re-tunes nothing), merge the
    winners into the table, and install them process-wide.

    Returns ``(table, results)`` where ``results`` holds only the
    shapes actually tuned this call."""
    table = table if table is not None else CostTable()
    results: list[TuneResult] = []
    for d in conv_shapes(model):
        skey = shape_key(d["x_shape"], d["w_shape"], d["stride"],
                         d["relu"], d["pool"], backend)
        if skey in table.kernels:
            continue
        res = autotune_conv(d["x_shape"], d["w_shape"], stride=d["stride"],
                            relu=d["relu"], pool=d["pool"], backend=backend,
                            candidates=candidates, iters=iters,
                            device=device)
        table.kernels[skey] = res.entry(backend)
        results.append(res)
    if table.kernels:
        install(table.kernels)
    return table, results
