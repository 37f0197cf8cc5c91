"""Validate real distributed execution against the simulator oracle.

The repo's discrete-event simulator / single-process compiled runner
stay the source of truth: :func:`validate` runs the *same* frames
through a :class:`~repro_torch.dist.launcher.DistLauncher` and through
the in-process compiled path (the port's ``PipelineRunner`` on the
deployment's device, on the same seeded weights as the workers, chunked
identically, so the batch-folded/single-frame split matches), then
asserts

* **bit-identical outputs** — every sink tensor of every frame is
  ``np.array_equal`` between the two paths (the hard gate);
* **zero dropped in-flight frames** across the clean shutdown;
* **observed-vs-modeled cost ratios** — each stage's measured compute
  wall per frame over the plan's modeled ``StageCost.t_comp``.  The
  model prices paper-testbed Raspberry-Pi capacities, not this host,
  so the gate is a sanity band (finite, positive, within
  ``ratio_band``) plus a bounded cross-stage spread, not equality.

Returns a :class:`DistValidation`; ``ok`` is the conjunction, and
``failures`` says what broke.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..api.specs import DistSpec


@dataclass
class DistValidation:
    """Outcome of one dist-vs-oracle comparison."""

    ok: bool
    bit_identical: bool
    max_abs_diff: float
    frames: int
    dropped: int
    ratios: dict[int, float]            # stage -> observed / modeled compute
    ratio_ok: bool
    sim_period: float                   # simulator steady-state period (s)
    report: object                      # the underlying DistReport
    failures: list[str] = field(default_factory=list)

    def describe(self) -> str:
        r = ", ".join(f"s{k}={v:.2g}" for k, v in sorted(self.ratios.items()))
        return (f"dist.validate: {'OK' if self.ok else 'FAIL'} — "
                f"{self.frames} frames, bit_identical={self.bit_identical} "
                f"(max|diff|={self.max_abs_diff:.3g}), "
                f"dropped={self.dropped}, ratios[{r}]"
                + (f"; failures: {self.failures}" if self.failures else ""))


def make_frames(model, n: int, seed: int = 0) -> list[np.ndarray]:
    """Deterministic pseudo-random input frames shaped like the model's
    graph input ``(1, H, W, C)``."""
    w, h = model.input_size
    ch = getattr(model, "in_channels", 3)
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, h, w, ch), dtype=np.float32)
            for _ in range(n)]


def reference_outputs(deployment, frames, micro_batch: int = 1,
                      seed: int = 0) -> list[dict[str, np.ndarray]]:
    """Single-process compiled-path outputs, chunked exactly like the
    launcher chunks (``micro_batch`` cohorts through ``run_frames``,
    singletons through ``__call__``) so the comparison is bit-for-bit
    meaningful.  The weights are the workers': ``model.init`` seeded
    with ``seed``, on the deployment's device."""
    device = getattr(deployment, "device", torch.device("cuda"))
    params = deployment.model.init(torch.Generator().manual_seed(seed),
                                   device=device)
    runner = deployment.runner
    outs: list[dict[str, np.ndarray]] = []
    i = 0
    while i < len(frames):
        chunk = [torch.as_tensor(f, device=device)
                 for f in frames[i:i + micro_batch]]
        if len(chunk) == 1:
            res = runner(params, chunk[0])
            outs.append({k: v.cpu().numpy() for k, v in res.items()})
        else:
            res = runner.run_frames(params, torch.stack(chunk))
            for k_i in range(len(chunk)):
                outs.append({k: v[k_i].cpu().numpy()
                             for k, v in res.items()})
        i += len(chunk)
    return outs


def validate(deployment, spec: DistSpec | None = None, *, frames: int = 6,
             seed: int = 0, ratio_band: tuple[float, float] = (1e-4, 1e4),
             max_spread: float = 1e4) -> DistValidation:
    """Run ``frames`` random frames through real distributed execution
    and through the in-process oracle; see the module docstring for
    what is asserted.  Raises nothing — inspect ``.ok``/``.failures``
    (tests typically ``assert v.ok, v.describe()``)."""
    spec = spec or DistSpec()
    xs = make_frames(deployment.model, frames, seed=seed)
    launcher = deployment.fleet(spec)
    rep = launcher.run(xs)
    ref = reference_outputs(deployment, xs, micro_batch=spec.micro_batch,
                            seed=spec.seed)
    failures: list[str] = []
    if rep.dropped:
        failures.append(f"{len(rep.dropped)} dropped frame(s): "
                        f"{rep.dropped[:3]}")
    max_diff = 0.0
    bit_identical = True
    for fid, want in enumerate(ref):
        got = rep.outputs.get(fid)
        if got is None:
            bit_identical = False
            failures.append(f"frame {fid} missing from dist outputs")
            continue
        for sink, arr in want.items():
            g = got.get(sink)
            if g is None or g.shape != arr.shape or not np.array_equal(g,
                                                                       arr):
                bit_identical = False
                d = (float(np.max(np.abs(np.asarray(g, np.float64)
                                         - np.asarray(arr, np.float64))))
                     if g is not None and g.shape == arr.shape
                     else float("inf"))
                max_diff = max(max_diff, d)
                failures.append(f"frame {fid} sink {sink!r} differs "
                                f"(max|diff|={d:.3g})")
    # observed-vs-modeled cost ratios (simulator as the cost oracle)
    observed = rep.stage_compute_s()
    stages = deployment.pico.pipeline.stages
    ratios: dict[int, float] = {}
    for i, st in enumerate(stages):
        obs = observed.get(i)
        modeled = st.cost.t_comp
        if obs is None:
            failures.append(f"stage {i}: no observed compute stats")
            continue
        if modeled <= 0:
            continue                    # nothing to compare against
        ratios[i] = obs / modeled
    ratio_ok = bool(ratios)
    lo, hi = ratio_band
    for i, r in ratios.items():
        if not (np.isfinite(r) and lo <= r <= hi):
            ratio_ok = False
            failures.append(f"stage {i}: observed/modeled ratio {r:.3g} "
                            f"outside [{lo:g}, {hi:g}]")
    if len(ratios) > 1:
        spread = max(ratios.values()) / min(ratios.values())
        if spread > max_spread:
            ratio_ok = False
            failures.append(f"cross-stage ratio spread {spread:.3g} > "
                            f"{max_spread:g}")
    sim = deployment.simulate(frames=max(frames, 2))
    ok = bit_identical and not rep.dropped and ratio_ok
    return DistValidation(
        ok=ok, bit_identical=bit_identical, max_abs_diff=max_diff,
        frames=frames, dropped=len(rep.dropped), ratios=ratios,
        ratio_ok=ratio_ok, sim_period=getattr(sim, "period", 0.0),
        report=rep, failures=failures)
