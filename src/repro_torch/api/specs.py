"""Frozen configuration specs for the ``repro.api`` facade.

One declarative config surface replacing the ``(t_lim, backend,
n_split, dnc_threshold, max_diameter, ...)`` kwarg sprawl that every
entry point used to re-thread:

* :class:`PlanSpec`   — the offline optimizer (Algorithms 1-3) knobs;
* :class:`ExecSpec`   — how plans lower to executables (backend,
  compile mode, donation, scan batching, cache limits, calibration);
* :class:`DeploySpec` — the online runtime/serving knobs (batching,
  link realism, churn/drift re-planning policy).

All three are frozen dataclasses with eager validation and an exact
JSON round-trip (``to_json``/``from_json``); non-finite floats are
encoded as the strings ``"Infinity"``/``"-Infinity"`` so the payloads
stay strict-JSON parseable.  The module deliberately imports nothing
heavyweight — specs are safe to build in a CLI before torch loads.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass

SPEC_VERSION = 1

_EXEC_MODES = ("compiled", "eager")


def encode_float(v):
    """JSON-safe float: non-finite values become their string spelling
    (``"Infinity"``/``"-Infinity"``/``"NaN"``) so documents stay
    strict-JSON parseable."""
    if isinstance(v, float) and not math.isfinite(v):
        if math.isnan(v):
            return "NaN"
        return "Infinity" if v > 0 else "-Infinity"
    return v


def decode_float(v):
    if v == "Infinity":
        return float("inf")
    if v == "-Infinity":
        return float("-inf")
    if v == "NaN":
        return float("nan")
    return v


def _encode_deep(v):
    """Recursive :func:`encode_float` (nested spec payloads carry their
    own non-finite floats, e.g. an ``ObjectiveSpec`` inside a
    ``PlanSpec``)."""
    if isinstance(v, dict):
        return {k: _encode_deep(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_encode_deep(x) for x in v]
    return encode_float(v)


class _SpecBase:
    """Shared (de)serialization for the frozen spec dataclasses."""

    #: fields omitted from payloads while None — additive evolution:
    #: documents written before the field existed stay byte-identical,
    #: and so do every registry/artifact key derived from them.
    _omit_if_none: tuple = ()

    def to_dict(self) -> dict:
        """Plain payload dict (raw float values — non-finite floats are
        spelled out only at JSON-encode time, by :meth:`to_json` or the
        enclosing artifact encoder).  Nested specs become nested payload
        dicts."""
        out = {"kind": type(self).__name__, "version": SPEC_VERSION}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None and f.name in self._omit_if_none:
                continue
            out[f.name] = v.to_dict() if isinstance(v, _SpecBase) else v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "_SpecBase":
        d = dict(d)
        kind = d.pop("kind", cls.__name__)
        if kind != cls.__name__:
            raise ValueError(f"expected a {cls.__name__} payload, got {kind!r}")
        version = d.pop("version", SPEC_VERSION)
        if not isinstance(version, int):
            raise ValueError(f"{cls.__name__} payload version must be an "
                             f"integer, got {version!r}")
        if version > SPEC_VERSION:
            raise ValueError(f"{cls.__name__} payload version {version} is "
                             f"newer than supported {SPEC_VERSION}")
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
        vals = {}
        for k, v in d.items():
            if isinstance(v, dict) and v.get("kind") in SPEC_KINDS:
                vals[k] = SPEC_KINDS[v["kind"]].from_dict(v)
            else:
                vals[k] = decode_float(v)
        return cls(**vals)

    def to_json(self, **dump_kw) -> str:
        dump_kw.setdefault("sort_keys", True)
        return json.dumps(_encode_deep(self.to_dict()), **dump_kw)

    @classmethod
    def from_json(cls, s: str) -> "_SpecBase":
        return cls.from_dict(json.loads(s))

    def replace(self, **changes) -> "_SpecBase":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ObjectiveSpec(_SpecBase):
    """Multi-objective planner scoring: weights + hard constraints over
    throughput (pipeline period), end-to-end latency, steady-state
    per-frame energy, and peak per-device memory.

    The default instance is *pure throughput* — it reproduces the
    single-objective planner bit-identically.  Weights are unit-free:
    :meth:`score` normalizes each metric by a reference point (the
    front's elementwise minimum in :meth:`~repro_torch.core.pareto.
    ParetoFront.select`) before weighting, so ``latency=1.0`` means
    "one unit of relative latency costs as much as one unit of relative
    period".  Constraints are absolute: seconds for ``max_latency_s``,
    Joules/frame for ``max_energy_j``, bytes for ``max_memory_bytes``
    (peak, per device).

    Inside Algorithm 2, ``max_latency_s`` tightens ``t_lim``,
    ``max_memory_bytes`` prunes stage candidates whose peak per-device
    footprint (params + live features) exceeds the budget, and a
    positive ``latency`` weight switches the DP comparison from
    lexicographic (period, latency) to the weighted scalarization —
    on both the scalar and the vectorized solver paths.  Energy is a
    whole-plan quantity (idle power depends on the final period), so
    its weight/constraint apply at plan scoring, not inside the DP.
    """

    throughput: float = 1.0
    latency: float = 0.0
    energy: float = 0.0
    memory: float = 0.0
    max_latency_s: float = float("inf")
    max_energy_j: float = float("inf")
    max_memory_bytes: float = float("inf")

    def __post_init__(self):
        weights = (self.throughput, self.latency, self.energy, self.memory)
        for name, w in zip(("throughput", "latency", "energy", "memory"),
                           weights):
            if not (w >= 0 and math.isfinite(w)):
                raise ValueError(f"{name} weight must be finite and >= 0, "
                                 f"got {w}")
        if not any(w > 0 for w in weights):
            raise ValueError("at least one objective weight must be > 0")
        for name in ("max_latency_s", "max_energy_j", "max_memory_bytes"):
            if not getattr(self, name) > 0:
                raise ValueError(f"{name} must be > 0, "
                                 f"got {getattr(self, name)}")

    # -- planner-facing views -------------------------------------------
    @property
    def is_throughput_only(self) -> bool:
        """True for the default single-objective planner behavior."""
        return (self.latency == 0 and self.energy == 0 and self.memory == 0
                and not math.isfinite(self.max_latency_s)
                and not math.isfinite(self.max_energy_j)
                and not math.isfinite(self.max_memory_bytes))

    @property
    def shapes_dp(self) -> bool:
        """Whether Algorithm 2's DP must deviate from the pure
        throughput solver (latency enters the comparison, or stage
        candidates are memory-pruned)."""
        return self.latency > 0 or math.isfinite(self.max_memory_bytes)

    def dp_signature(self) -> tuple:
        """The part of the objective a solved DP table depends on
        (``max_latency_s`` folds into ``t_lim`` upstream)."""
        return (self.throughput, self.latency, self.max_memory_bytes)

    def relaxed(self) -> "ObjectiveSpec":
        """Constraints dropped, weights kept — the best-effort fallback
        target when the constrained problem is infeasible."""
        return self.replace(max_latency_s=float("inf"),
                            max_energy_j=float("inf"),
                            max_memory_bytes=float("inf"))

    # -- plan scoring ---------------------------------------------------
    def feasible(self, metrics) -> bool:
        """Whether a plan's metrics satisfy every hard constraint."""
        return (metrics.latency <= self.max_latency_s
                and metrics.energy_j <= self.max_energy_j
                and metrics.memory_bytes <= self.max_memory_bytes)

    def score(self, metrics, ref=None) -> float:
        """Weighted scalarization of a plan's metrics (lower is better).

        ``metrics``/``ref`` carry ``period``/``latency``/``energy_j``/
        ``memory_bytes``; with ``ref`` each term is normalized by the
        reference value so the weights compare like-for-like.
        """
        def norm(v, r):
            return v / r if (r is not None and r > 0) else v
        r = ref
        return (self.throughput * norm(metrics.period,
                                       r.period if r else None)
                + self.latency * norm(metrics.latency,
                                      r.latency if r else None)
                + self.energy * norm(metrics.energy_j,
                                     r.energy_j if r else None)
                + self.memory * norm(metrics.memory_bytes,
                                     r.memory_bytes if r else None))

    def label(self) -> str:
        """Preset name when this spec equals one, else ``"custom"`` —
        the human-readable provenance carried on plans it selects."""
        for name, preset in OBJECTIVE_PRESETS.items():
            if preset == self:
                return name
        return "custom"

    @classmethod
    def named(cls, name: str) -> "ObjectiveSpec":
        """Look up a preset objective (``throughput`` / ``latency`` /
        ``battery`` / ``memory`` / ``balanced``)."""
        try:
            return OBJECTIVE_PRESETS[name]
        except KeyError:
            raise ValueError(f"unknown objective {name!r}; presets: "
                             f"{sorted(OBJECTIVE_PRESETS)}") from None


#: Named deployment profiles: ``throughput`` is the paper's planner;
#: ``latency`` favors short end-to-end frames (interactive SLOs);
#: ``battery`` favors low per-frame energy (edge fleets on battery);
#: ``memory`` favors small peak per-device footprints; ``balanced``
#: weighs all four equally.
OBJECTIVE_PRESETS = {
    "throughput": ObjectiveSpec(),
    "latency": ObjectiveSpec(throughput=0.1, latency=1.0),
    "battery": ObjectiveSpec(throughput=0.1, energy=1.0),
    "memory": ObjectiveSpec(throughput=0.1, memory=1.0),
    "balanced": ObjectiveSpec(throughput=1.0, latency=1.0, energy=1.0,
                              memory=1.0),
}


@dataclass(frozen=True)
class PlanSpec(_SpecBase):
    """Offline-planner configuration (Algorithm 1 + 2 + 3 knobs).

    ``n_split`` is the reference tiling for Algorithm 1's C(M); ``None``
    defers to ``max(2, len(cluster))`` at plan time.  Graphs with more
    than ``dnc_threshold`` vertices use the divide-and-conquer
    partitioner.  ``t_lim`` is the paper's soft latency budget.
    ``objective`` makes the planner multi-objective
    (:class:`ObjectiveSpec`); ``None`` is the legacy pure-throughput
    planner, and is omitted from payloads so pre-objective documents —
    and every registry key derived from them — stay byte-identical.
    """

    t_lim: float = float("inf")
    max_diameter: int = 5
    n_split: int | None = None
    dnc_threshold: int = 120
    objective: ObjectiveSpec | None = None

    _omit_if_none = ("objective",)

    def __post_init__(self):
        if not self.t_lim > 0:
            raise ValueError(f"t_lim must be > 0, got {self.t_lim}")
        if self.max_diameter < 1:
            raise ValueError(f"max_diameter must be >= 1, "
                             f"got {self.max_diameter}")
        if self.n_split is not None and self.n_split < 2:
            raise ValueError(f"n_split must be None or >= 2, "
                             f"got {self.n_split}")
        if self.dnc_threshold < 1:
            raise ValueError(f"dnc_threshold must be >= 1, "
                             f"got {self.dnc_threshold}")
        if self.objective is not None and \
                not isinstance(self.objective, ObjectiveSpec):
            raise ValueError(f"objective must be None or an ObjectiveSpec, "
                             f"got {type(self.objective).__name__}")

    def resolve_n_split(self, n_devices: int) -> int:
        return self.n_split or max(2, n_devices)


@dataclass(frozen=True)
class ExecSpec(_SpecBase):
    """Execution-backend configuration for compiled plans.

    ``backend`` picks the conv lowering (``exec.backends`` registry;
    ``None`` = model default, ``"cuda"``).  The JAX package's names map
    as ``"xla"`` -> ``"torch"`` and ``"pallas"`` -> ``"cuda"``.
    ``mode`` selects the compiled whole-stage executable or the eager
    per-tile oracle.  ``scan_batch`` routes multi-frame cohorts through
    the batch-folded ``run_frames`` path.  ``cache_size`` bounds the
    *process-wide* executable cache (applied whenever a Deployment
    carrying the spec is built or loaded).  ``calibrate`` makes
    :func:`repro_torch.api.compile` time each stage on the deployment's
    device (best of ``calibrate_iters``) and re-plan on the measured
    :class:`~repro_torch.core.cost.CostTable`.  ``fuse`` lowers
    conv->pool chains as one fused kernel call on backends with a fused
    lowering (numerics-neutral on the others).  ``autotune`` makes
    :func:`repro_torch.api.compile` time the conv kernel's launch plans
    (tile and split-K) per conv shape before calibration
    (``autotune_iters`` calls each) and keep the winners in the
    deployment's CostTable artifact.

    The fields are those of the JAX package's ``ExecSpec``, so that one
    payload reads in both packages; ``donate`` and ``profile`` are
    carried but not acted on here.
    """

    backend: str | None = None
    mode: str = "compiled"
    donate: bool = False
    scan_batch: bool = True
    cache_size: int | None = None
    calibrate: bool = False
    calibrate_iters: int = 3
    profile: bool = False       # profiler bracket around each stage call
    fuse: bool = True           # fuse conv->pool chains into one kernel call
    autotune: bool = False      # tune kernel launch plans at compile time
    autotune_iters: int = 3

    def __post_init__(self):
        if self.mode not in _EXEC_MODES:
            raise ValueError(f"mode must be one of {_EXEC_MODES}, "
                             f"got {self.mode!r}")
        if self.cache_size is not None and self.cache_size < 1:
            raise ValueError(f"cache_size must be None or >= 1, "
                             f"got {self.cache_size}")
        if self.calibrate_iters < 1:
            raise ValueError(f"calibrate_iters must be >= 1, "
                             f"got {self.calibrate_iters}")
        if self.autotune_iters < 1:
            raise ValueError(f"autotune_iters must be >= 1, "
                             f"got {self.autotune_iters}")

    def apply_cache_limit(self) -> int | None:
        """Apply ``cache_size`` to the process-global executable cache
        (no-op when unset).  Last-write-wins across deployments — the
        cache is shared process state, not per-deployment.  Returns the
        previous bound (or None if nothing was applied) so a scoped
        caller can restore it."""
        if self.cache_size is None:
            return None
        from ..exec.cache import set_cache_size
        return set_cache_size(self.cache_size)


@dataclass(frozen=True)
class DeploySpec(_SpecBase):
    """Online runtime/serving configuration (maps onto
    :class:`~repro_torch.runtime.executor.RuntimeConfig`).

    The default is *ideal* — no jitter, no noise, free inter-stage
    hand-off — which reproduces ``core.simulate`` exactly.

    ``objective`` names the :data:`OBJECTIVE_PRESETS` profile this
    deployment optimizes for; :meth:`~repro_torch.core.pareto.ParetoFront.
    deployment` uses it to pick the Pareto-front point to ship, and the
    chosen plan carries the name as provenance
    (``PicoPlan.objective``).  ``None`` means unspecified (throughput).
    """

    seed: int = 0
    max_batch: int = 1
    compute_noise: float = 0.0
    inter_stage_bandwidth: float | None = None
    link_latency_s: float = 0.0
    link_jitter_s: float = 0.0
    mem_budget_bytes: float = float("inf")
    replan_on_churn: bool = True
    replan_on_drift: bool = True
    drift_threshold: float = 0.25
    drift_cooldown: int = 24
    ewma_beta: float = 0.3
    migration_bandwidth: float | None = None
    trace: bool = False         # record repro_torch.obs spans during runs
    metrics: bool = True        # publish runtime metrics (repro_torch.obs)
    objective: str | None = None  # OBJECTIVE_PRESETS profile to deploy

    _omit_if_none = ("objective",)

    def __post_init__(self):
        if self.objective is not None and \
                self.objective not in OBJECTIVE_PRESETS:
            raise ValueError(f"objective must be None or one of "
                             f"{sorted(OBJECTIVE_PRESETS)}, "
                             f"got {self.objective!r}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        for name in ("compute_noise", "link_latency_s", "link_jitter_s",
                     "drift_threshold", "drift_cooldown"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, "
                                 f"got {getattr(self, name)}")
        if not 0 < self.ewma_beta <= 1:
            raise ValueError(f"ewma_beta must be in (0, 1], "
                             f"got {self.ewma_beta}")
        if self.mem_budget_bytes <= 0:
            raise ValueError(f"mem_budget_bytes must be > 0, "
                             f"got {self.mem_budget_bytes}")
        for name in ("inter_stage_bandwidth", "migration_bandwidth"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be None or > 0, got {v}")

    def to_runtime_config(self):
        from ..runtime.executor import RuntimeConfig
        return RuntimeConfig(
            seed=self.seed,
            compute_noise=self.compute_noise,
            inter_stage_bandwidth=self.inter_stage_bandwidth,
            link_latency_s=self.link_latency_s,
            link_jitter_s=self.link_jitter_s,
            mem_budget_bytes=self.mem_budget_bytes,
            replan_on_churn=self.replan_on_churn,
            replan_on_drift=self.replan_on_drift,
            drift_threshold=self.drift_threshold,
            drift_cooldown=self.drift_cooldown,
            ewma_beta=self.ewma_beta,
            migration_bandwidth=self.migration_bandwidth,
            max_batch=self.max_batch,
            trace=self.trace,
            metrics=self.metrics)


_ROUTE_POLICIES = ("least_loaded", "round_robin")


@dataclass(frozen=True)
class FleetSpec(_SpecBase):
    """Fleet-tier configuration (:mod:`repro_torch.fleet`).

    ``registry_capacity`` bounds the LRU plan registry (entries =
    distinct (model, cluster signature, PlanSpec, CostTable) keys).
    ``routing`` picks the admission policy: ``least_loaded`` sends a new
    tenant to the cell with the lowest load-EWMA per unit capacity;
    ``round_robin`` ignores load.  ``ewma_beta`` is the cell-load
    smoothing factor (same convention as
    :attr:`DeploySpec.ewma_beta`).  ``scale_up_load`` /
    ``scale_down_load`` are the autoscaler watermarks on smoothed cell
    load, and ``min_clusters`` / ``max_clusters`` bound how far the
    hooks may grow or shrink the fleet.
    """

    registry_capacity: int = 256
    routing: str = "least_loaded"
    ewma_beta: float = 0.3
    scale_up_load: float = 0.8
    scale_down_load: float = 0.25
    min_clusters: int = 1
    max_clusters: int | None = None

    def __post_init__(self):
        if self.registry_capacity < 1:
            raise ValueError(f"registry_capacity must be >= 1, "
                             f"got {self.registry_capacity}")
        if self.routing not in _ROUTE_POLICIES:
            raise ValueError(f"routing must be one of {_ROUTE_POLICIES}, "
                             f"got {self.routing!r}")
        if not 0 < self.ewma_beta <= 1:
            raise ValueError(f"ewma_beta must be in (0, 1], "
                             f"got {self.ewma_beta}")
        if not 0 <= self.scale_down_load < self.scale_up_load:
            raise ValueError(
                f"need 0 <= scale_down_load < scale_up_load, got "
                f"{self.scale_down_load} / {self.scale_up_load}")
        if self.min_clusters < 1:
            raise ValueError(f"min_clusters must be >= 1, "
                             f"got {self.min_clusters}")
        if (self.max_clusters is not None
                and self.max_clusters < self.min_clusters):
            raise ValueError(f"max_clusters must be None or >= min_clusters, "
                             f"got {self.max_clusters}")


_DIST_TRANSPORTS = ("memory", "tcp")
_DIST_WORKERS = ("thread", "process")


@dataclass(frozen=True)
class DistSpec(_SpecBase):
    """Real distributed execution configuration (:mod:`repro.dist`).

    ``transport`` picks how stage tensors move between workers:
    ``memory`` (queue pair carrying the encoded wire bytes — same codec
    as TCP) or ``tcp`` (length-prefixed framed tensors over loopback/
    LAN sockets, chunked sends).  ``workers`` picks the worker
    substrate: ``thread`` (persistent threads in this process — the CI
    mode) or ``process`` (one real OS process per pipeline stage via
    the multiprocessing *spawn* context; requires ``transport="tcp"``
    since spawned workers share no memory).  Either way each worker
    receives its slice of the versioned Deployment JSON artifact — the
    artifact round-trip is the hand-off; no pickled Python objects
    cross the boundary.

    ``heartbeat_s`` is the worker liveness beacon period; a worker
    silent for ``peer_timeout_s`` is declared dead and surfaced as a
    :class:`~repro.runtime.churn.DeviceLeave` churn event.
    ``start_timeout_s`` bounds worker spawn + handshake + executable
    warmup; ``recv_timeout_s`` bounds any single blocking receive
    (drain progress) and ``shutdown_timeout_s`` the final drain before
    in-flight frames are reported dropped.  ``micro_batch`` groups
    frames per wire message through the ``lax.scan`` path;
    ``max_inflight`` caps frames in the pipe (back-pressure);
    ``chunk_bytes`` sizes transport send chunks (per-chunk byte/latency
    accounting feeds ``repro.obs``).  ``seed`` seeds the deterministic
    per-worker weight rebuild (workers re-init from the shipped graph,
    bit-identical to the launcher's params).
    """

    transport: str = "memory"
    workers: str = "thread"
    heartbeat_s: float = 0.2
    peer_timeout_s: float = 10.0
    start_timeout_s: float = 120.0
    recv_timeout_s: float = 30.0
    shutdown_timeout_s: float = 30.0
    micro_batch: int = 1
    max_inflight: int = 8
    chunk_bytes: int = 1 << 20
    seed: int = 0
    trace: bool = True          # merge worker spans into one Perfetto trace

    def __post_init__(self):
        if self.transport not in _DIST_TRANSPORTS:
            raise ValueError(f"transport must be one of {_DIST_TRANSPORTS}, "
                             f"got {self.transport!r}")
        if self.workers not in _DIST_WORKERS:
            raise ValueError(f"workers must be one of {_DIST_WORKERS}, "
                             f"got {self.workers!r}")
        if self.workers == "process" and self.transport != "tcp":
            raise ValueError("workers='process' requires transport='tcp' "
                             "(spawned workers share no memory)")
        for name in ("heartbeat_s", "peer_timeout_s", "start_timeout_s",
                     "recv_timeout_s", "shutdown_timeout_s"):
            v = getattr(self, name)
            if not (isinstance(v, (int, float)) and v > 0
                    and math.isfinite(v)):
                raise ValueError(f"{name} must be finite and > 0, got {v}")
        if self.peer_timeout_s <= self.heartbeat_s:
            raise ValueError(f"peer_timeout_s ({self.peer_timeout_s}) must "
                             f"exceed heartbeat_s ({self.heartbeat_s})")
        if self.micro_batch < 1:
            raise ValueError(f"micro_batch must be >= 1, "
                             f"got {self.micro_batch}")
        if self.max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, "
                             f"got {self.max_inflight}")
        if self.chunk_bytes < 1024:
            raise ValueError(f"chunk_bytes must be >= 1024, "
                             f"got {self.chunk_bytes}")


SPEC_KINDS = {cls.__name__: cls
              for cls in (ObjectiveSpec, PlanSpec, ExecSpec, DeploySpec,
                          FleetSpec, DistSpec)}


def spec_from_dict(d: dict):
    """Dispatch a spec payload to its dataclass by the ``kind`` field."""
    kind = d.get("kind")
    if kind not in SPEC_KINDS:
        raise ValueError(f"unknown spec kind {kind!r}")
    return SPEC_KINDS[kind].from_dict(d)
