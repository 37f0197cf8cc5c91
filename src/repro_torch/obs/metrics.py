"""Metrics registry: counters, gauges, windowed histograms, snapshots.

One substrate for every number the system used to keep in private
ad-hoc dicts — ``runtime.Monitor`` EWMAs, ``ServeStats`` latency lists,
``exec.cache`` counters, conv-backend fallback tallies.  Instruments
are cheap mutable cells keyed by ``(name, labels)``;
:meth:`MetricsRegistry.snapshot` freezes everything into a versioned
strict-JSON document (same envelope discipline as
:mod:`repro.api.artifacts`), and :func:`flatten` turns a snapshot into
the flat ``name -> value`` map the bench-regression gate consumes — so
bench figures, serving reports and the CI gate share one schema.

Quantiles use the nearest-rank method (:func:`quantile`), shared by
:class:`Histogram` and ``serving.ServeStats`` so every surface reports
identical percentiles, including on tiny windows (n < 3) where linear
interpolation degenerates.
"""

from __future__ import annotations

import json
import math
from collections import deque
from typing import Callable, Iterable, Mapping, Sequence

#: Version of the metrics-snapshot payload schema.  Same policy as
#: ``api.artifacts.SCHEMA_VERSION``: loaders reject *newer* payloads;
#: additive evolution (new optional fields) does not bump it.
METRICS_SCHEMA_VERSION = 1

#: Artifact kind in the snapshot envelope.
ARTIFACT_KIND = "metrics"

#: Default bound on histogram windows — enough for smoke-bench streams
#: while keeping long-running serves O(1) in memory.
DEFAULT_WINDOW = 4096

#: The percentiles every histogram snapshot reports.
SNAPSHOT_QUANTILES = (50.0, 95.0, 99.0)


def quantile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of ``values`` (``q`` in [0, 100]).

    The nearest-rank method returns an actual observed sample (rank
    ``ceil(q/100 * n)``), so it is well-defined for any ``n >= 1`` —
    unlike linear interpolation, which degenerates on tiny windows
    (n < 3 collapses p50/p95/p99 toward the midpoint).  Monotone in
    ``q``, exact on the empirical distribution.
    """
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100], got {q}")
    n = len(values)
    if n == 0:
        return 0.0
    s = sorted(values)
    if q == 0.0:
        return float(s[0])
    rank = math.ceil(q / 100.0 * n)          # 1-based
    return float(s[min(n, max(1, rank)) - 1])


def _label_key(labels: Mapping[str, object]) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count (events, bytes, fallbacks)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (must be >= 0) to the count."""
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (ratios, occupancy, config)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Windowed distribution with nearest-rank percentiles.

    Keeps the last ``window`` observations for quantiles plus lifetime
    ``count``/``sum``/``min``/``max``; the snapshot reports p50/p95/p99
    over the window via :func:`quantile`, so histogram percentiles and
    ``ServeStats`` percentiles agree sample-for-sample.
    """

    __slots__ = ("name", "labels", "window", "count", "sum", "min", "max")

    def __init__(self, name: str, labels: tuple = (),
                 window: int = DEFAULT_WINDOW):
        self.name = name
        self.labels = labels
        self.window: deque = deque(maxlen=max(1, int(window)))
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        """Record one sample."""
        v = float(v)
        self.window.append(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the current window."""
        return quantile(list(self.window), q)


class _NullInstrument:
    """Shared no-op counter/gauge/histogram for a disabled registry."""

    __slots__ = ()
    name = "null"
    labels = ()
    value = 0.0
    count = 0
    sum = 0.0
    mean = 0.0

    def inc(self, n: float = 1.0) -> None:
        """Record nothing."""

    def set(self, v: float) -> None:
        """Record nothing."""

    def observe(self, v: float) -> None:
        """Record nothing."""

    def percentile(self, q: float) -> float:
        return 0.0


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """Disabled registry: every instrument is the shared no-op cell.
    ``bool(NULL_REGISTRY)`` is False so callers can skip optional
    bookkeeping entirely."""

    __slots__ = ()
    enabled = False

    def __bool__(self) -> bool:
        return False

    def counter(self, name: str, **labels) -> _NullInstrument:
        """Return the shared no-op instrument."""
        return _NULL_INSTRUMENT

    def gauge(self, name: str, **labels) -> _NullInstrument:
        """Return the shared no-op instrument."""
        return _NULL_INSTRUMENT

    def histogram(self, name: str, window: int = DEFAULT_WINDOW,
                  **labels) -> _NullInstrument:
        """Return the shared no-op instrument."""
        return _NULL_INSTRUMENT

    def register_collector(self, fn) -> None:
        """Ignore the collector."""


NULL_REGISTRY = NullRegistry()


class MetricsRegistry:
    """Instrument store keyed by ``(kind, name, sorted labels)``.

    ``counter``/``gauge``/``histogram`` are get-or-create (the same
    call site always returns the same cell).  Subsystems that keep
    their own cheap hot-path state (the executable cache, a serve's
    stats) publish through *collectors*: callables invoked at snapshot
    time to set gauges/counters from that state, so hot paths pay
    nothing extra between snapshots.
    """

    enabled = True

    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._collectors: list[Callable[["MetricsRegistry"], None]] = []

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self._metrics)

    # -------------------------------------------------------------- get

    def counter(self, name: str, **labels) -> Counter:
        """Get-or-create the counter ``name`` with ``labels``."""
        key = ("c", name, _label_key(labels))
        c = self._metrics.get(key)
        if c is None:
            c = self._metrics[key] = Counter(name, key[2])
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        """Get-or-create the gauge ``name`` with ``labels``."""
        key = ("g", name, _label_key(labels))
        g = self._metrics.get(key)
        if g is None:
            g = self._metrics[key] = Gauge(name, key[2])
        return g

    def histogram(self, name: str, window: int = DEFAULT_WINDOW,
                  **labels) -> Histogram:
        """Get-or-create the histogram ``name`` with ``labels``."""
        key = ("h", name, _label_key(labels))
        h = self._metrics.get(key)
        if h is None:
            h = self._metrics[key] = Histogram(name, key[2], window=window)
        return h

    def register_collector(self,
                           fn: Callable[["MetricsRegistry"], None]) -> None:
        """Add a snapshot-time publisher (idempotent per function)."""
        if fn not in self._collectors:
            self._collectors.append(fn)

    def clear(self) -> None:
        """Drop every instrument and collector (tests, fresh runs)."""
        self._metrics.clear()
        self._collectors.clear()

    def drop(self, name: str, kind: str | None = None) -> int:
        """Remove every instrument named ``name`` (all label sets;
        optionally restricted to one kind: "c"/"g"/"h").  Returns the
        number of cells removed.  Lets a subsystem scope its accounting
        per run — e.g. ``kernels.conv2d.ops.reset_fallbacks`` — without
        clearing unrelated instruments."""
        keys = [k for k in self._metrics
                if k[1] == name and (kind is None or k[0] == kind)]
        for k in keys:
            del self._metrics[k]
        return len(keys)

    # ------------------------------------------------------------ views

    def counters(self) -> list[Counter]:
        return [m for (k, _, _), m in sorted(self._metrics.items(),
                                             key=lambda kv: kv[0])
                if k == "c"]

    def value(self, name: str, **labels) -> float:
        """Current value of a counter/gauge (0.0 when absent)."""
        for kind in ("c", "g"):
            m = self._metrics.get((kind, name, _label_key(labels)))
            if m is not None:
                return m.value
        return 0.0

    def total(self, name: str) -> float:
        """Sum of a counter's value across all label sets."""
        return sum(m.value for (k, n, _), m in self._metrics.items()
                   if k == "c" and n == name)

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other``'s instruments into this registry (counters
        add, gauges last-write-win, histogram samples append)."""
        for (kind, name, labels), m in other._metrics.items():
            lbl = dict(labels)
            if kind == "c":
                self.counter(name, **lbl).inc(m.value)
            elif kind == "g":
                self.gauge(name, **lbl).set(m.value)
            else:
                mine = self.histogram(name, window=m.window.maxlen, **lbl)
                for v in m.window:
                    mine.observe(v)
                # lifetime stats beyond the window survive the merge
                extra = m.count - len(m.window)
                if extra > 0:
                    mine.count += extra
                    mine.sum += m.sum - sum(m.window)
                mine.min = min(mine.min, m.min)
                mine.max = max(mine.max, m.max)
        for fn in other._collectors:
            self.register_collector(fn)
        return self

    # --------------------------------------------------------- snapshot

    def snapshot(self, meta: Mapping | None = None) -> dict:
        """Freeze every instrument into a versioned strict-JSON doc.

        Runs registered collectors first, then emits::

            {"artifact": "metrics", "version": 1, "payload": {
              "counters":   [{"name", "labels", "value"}, ...],
              "gauges":     [{"name", "labels", "value"}, ...],
              "histograms": [{"name", "labels", "count", "sum", "mean",
                              "min", "max", "p50", "p95", "p99"}, ...],
              "meta": {...}}}

        Non-finite floats are encoded as ``"Infinity"``-style strings
        (the :mod:`repro.api.specs` float codec) so the document stays
        strict-JSON parseable.
        """
        from ..api.specs import encode_float
        for fn in list(self._collectors):
            fn(self)
        counters, gauges, histograms = [], [], []
        for (kind, name, labels), m in sorted(self._metrics.items(),
                                              key=lambda kv: kv[0]):
            row = {"name": name, "labels": dict(labels)}
            if kind in ("c", "g"):
                row["value"] = encode_float(float(m.value))
                (counters if kind == "c" else gauges).append(row)
            else:
                row.update(count=m.count,
                           sum=encode_float(m.sum),
                           mean=encode_float(m.mean),
                           min=encode_float(m.min if m.count else 0.0),
                           max=encode_float(m.max if m.count else 0.0))
                for q in SNAPSHOT_QUANTILES:
                    row[f"p{q:g}"] = encode_float(m.percentile(q))
                histograms.append(row)
        payload = {"counters": counters, "gauges": gauges,
                   "histograms": histograms, "meta": dict(meta or {})}
        return {"artifact": ARTIFACT_KIND,
                "version": METRICS_SCHEMA_VERSION, "payload": payload}

    def snapshot_json(self, meta: Mapping | None = None, **dump_kw) -> str:
        dump_kw.setdefault("sort_keys", True)
        return json.dumps(self.snapshot(meta), **dump_kw)


def open_snapshot(doc: Mapping) -> dict:
    """Validate a snapshot envelope and return its payload.

    Same version policy as artifact codecs: payloads *newer* than
    :data:`METRICS_SCHEMA_VERSION` are rejected with a clear error;
    older/current versions decode with the current reader.
    """
    if doc.get("artifact") != ARTIFACT_KIND:
        raise ValueError(f"expected a {ARTIFACT_KIND!r} artifact, got "
                         f"{doc.get('artifact')!r}")
    version = doc.get("version")
    if not isinstance(version, int):
        raise ValueError("metrics snapshot has no integer version field")
    if version > METRICS_SCHEMA_VERSION:
        raise ValueError(f"metrics snapshot version {version} is newer "
                         f"than supported {METRICS_SCHEMA_VERSION}")
    try:
        payload = doc["payload"]
    except KeyError:
        raise ValueError("metrics snapshot envelope has no payload field")
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(payload.get(section), list):
            raise ValueError(f"metrics snapshot payload has no {section} "
                             f"list")
    return payload


def _flat_name(row: Mapping) -> str:
    labels = row.get("labels") or {}
    if not labels:
        return row["name"]
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{row['name']}{{{inner}}}"


def flatten(doc: Mapping) -> dict[str, float]:
    """Snapshot -> flat ``name -> value`` map (the bench-gate view).

    Counters and gauges map to their value under ``name`` (labelled
    series under ``name{k=v,...}``); histograms expand to
    ``name.count/.mean/.p50/.p95/.p99/...``.  Non-finite string-encoded
    floats decode back to floats.
    """
    from ..api.specs import decode_float
    payload = open_snapshot(doc)
    flat: dict[str, float] = {}
    for row in payload["counters"] + payload["gauges"]:
        flat[_flat_name(row)] = float(decode_float(row["value"]))
    for row in payload["histograms"]:
        base = _flat_name(row)
        for k in ("count", "sum", "mean", "min", "max",
                  *(f"p{q:g}" for q in SNAPSHOT_QUANTILES)):
            if k in row:
                flat[f"{base}.{k}"] = float(decode_float(row[k]))
    return flat


def registry_from_values(values: Mapping[str, float]) -> MetricsRegistry:
    """Build a registry of gauges from a flat name -> value map (how
    ``benchmarks.run`` lifts its derived figures into snapshot form)."""
    reg = MetricsRegistry()
    for name, v in values.items():
        reg.gauge(name).set(float(v))
    return reg


# ---------------------------------------------------------------------------
# process-global default registry
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry for process-global signals: executable
    cache hits/misses, conv-backend fallbacks, compile wall-times.
    Deployment-scoped registries merge it into their snapshots."""
    return _DEFAULT


def percentiles(values: Iterable[float],
                qs: Sequence[float] = SNAPSHOT_QUANTILES) -> dict[str, float]:
    """Convenience: nearest-rank percentiles of ``values`` as a dict."""
    vals = list(values)
    return {f"p{q:g}": quantile(vals, q) for q in qs}
