"""Structured tracing core: explicit spans on one shared timeline.

Every layer of the system — planner, runtime, exec, serving — emits the
*same* span vocabulary (:data:`SPAN_NAMES`), so a simulated run and a
real run produce traces that can be diffed span-for-span.  A span
carries a name (what happened), a track (which actor row it renders
on — one process-row per device actor in Perfetto), a timestamp and
duration in seconds (virtual time for runtime spans, wall time for
host-side spans), and an attribute dict (frame id, stage index, tenant,
modeled-vs-observed seconds, ...).

Two tracer implementations share one interface:

* :class:`Tracer` — records spans into a list and exports
  Chrome-trace / Perfetto JSON (:meth:`Tracer.to_chrome_trace`);
* :class:`NullTracer` — the zero-allocation default: every method is a
  no-op returning cached singletons, so instrumented hot paths cost a
  single attribute lookup and call when tracing is off.

Instrumented library code reaches the active tracer through
:func:`current`; an owner (a :class:`~repro.api.deployment.Deployment`,
the runtime, a test) activates its tracer with :func:`scoped` around
the work it wants captured.
"""

from __future__ import annotations

import json
import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping

#: The shared span vocabulary.  Emitters are not restricted to it, but
#: every subsystem's instrumentation sticks to these names so traces
#: from different execution forms (closed-form replay, event-driven
#: runtime, multi-tenant serving) line up.
SPAN_NAMES = (
    "frame",            # one request end-to-end (arrival -> completion)
    "stage.compute",    # one device's compute phase of one stage batch
    "stage.comm",       # inter-stage hand-off transfer
    "halo.exchange",    # intra-stage scatter/gather (tile boundaries)
    "stage.refill",     # runtime: a resumed frame's missing boundary nodes
                        # computed (real compute only; no virtual time)
    "plan",             # a full PICO optimization pass
    "replan",           # runtime churn/drift re-plan (incl. migration)
    "calibrate",        # one stage timed through its compiled executable
    "compile",          # executable-cache miss: stage lowered + jitted
    "cache.lookup",     # executable-cache probe (hit or miss)
    "conv.fallback",    # Pallas conv fell back to the XLA reference
    "sched.admit",      # scheduler admission decision
    "sched.coalesce",   # stage-0 batch formation
    "sched.drain",      # drain window before a re-plan / re-partition
    "sched.repartition",  # cross-tenant device re-split + migration
    "registry.lookup",  # fleet plan-registry probe (hit or miss)
    "fleet.route",      # tenant admission / routing decision
    "fleet.autoscale",  # autoscaler watermark evaluation
    "dist.launch",      # dist worker spawn + handshake + warmup probe
    "dist.churn",       # dist worker declared dead (heartbeat/link/error)
)

#: Default track for host-side (wall-clock) spans.
HOST_TRACK = "host"


@dataclass(frozen=True)
class Span:
    """One traced interval (or instant, when ``dur == 0``).

    ``ts``/``dur`` are seconds on the emitting timeline — virtual
    seconds for runtime spans, wall seconds for host-side spans; the
    Chrome-trace exporter converts to microseconds for display but
    preserves the exact values for round-trips.
    """

    name: str
    ts: float
    dur: float = 0.0
    track: str = HOST_TRACK
    attrs: tuple[tuple[str, Any], ...] = ()

    @property
    def end(self) -> float:
        return self.ts + self.dur

    def attr(self, key: str, default=None):
        """Look up one attribute by name."""
        for k, v in self.attrs:
            if k == key:
                return v
        return default

    @staticmethod
    def freeze_attrs(attrs: Mapping[str, Any]) -> tuple:
        """Attrs as a canonical (sorted, hashable) tuple of pairs."""
        return tuple(sorted(attrs.items()))


class _NullSpanCtx:
    """Reusable no-op context manager returned by NullTracer.wall_span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullSpanCtx()


class NullTracer:
    """The disabled tracer: every emit is a no-op, nothing allocates.

    A single module-level instance (:data:`NULL_TRACER`) is shared by
    every un-traced code path; ``bool(NULL_TRACER)`` is False so hot
    paths can guard optional work (batch fid lists, attr dicts) with
    ``if tracer:``.
    """

    __slots__ = ()
    enabled = False
    spans: tuple = ()

    def __bool__(self) -> bool:
        return False

    def emit(self, name, ts, dur=0.0, track=HOST_TRACK, **attrs) -> None:
        """Record nothing."""

    def instant(self, name, ts, track=HOST_TRACK, **attrs) -> None:
        """Record nothing."""

    def wall_span(self, name, track=HOST_TRACK, **attrs):
        """Return a cached no-op context manager."""
        return _NULL_CTX


NULL_TRACER = NullTracer()


class _WallSpanCtx:
    """Context manager measuring a wall-clock span for a live Tracer."""

    __slots__ = ("_tracer", "_name", "_track", "_attrs", "_t0")

    def __init__(self, tracer, name, track, attrs):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._attrs = attrs

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        self._tracer.emit(self._name, t0 - self._tracer.epoch,
                          time.perf_counter() - t0, track=self._track,
                          **self._attrs)
        return False


class Tracer:
    """Span recorder with Chrome-trace / Perfetto JSON export.

    Spans are appended in emission order; tracks (Perfetto process
    rows) are created on first use in a stable order.  ``epoch`` anchors
    wall-clock spans (:meth:`wall_span`) so their timestamps start near
    zero like virtual-time spans do.
    """

    enabled = True

    def __init__(self):
        self.spans: list[Span] = []
        self.epoch = time.perf_counter()

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self.spans)

    def emit(self, name: str, ts: float, dur: float = 0.0,
             track: str = HOST_TRACK, **attrs) -> None:
        """Record one span at ``ts`` lasting ``dur`` seconds on ``track``."""
        self.spans.append(Span(name, float(ts), float(dur), track,
                               Span.freeze_attrs(attrs)))

    def instant(self, name: str, ts: float, track: str = HOST_TRACK,
                **attrs) -> None:
        """Record a zero-duration marker."""
        self.emit(name, ts, 0.0, track=track, **attrs)

    def wall_span(self, name: str, track: str = HOST_TRACK, **attrs):
        """Context manager timing a host-side block with perf_counter."""
        return _WallSpanCtx(self, name, track, attrs)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def tracks(self) -> list[str]:
        """Track names in order of first appearance."""
        seen: dict[str, None] = {}
        for s in self.spans:
            seen.setdefault(s.track, None)
        return list(seen)

    def by_name(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    # ------------------------------------------------------------------
    # Chrome trace / Perfetto export
    # ------------------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """Export as Chrome-trace JSON (the format Perfetto opens).

        One *process row* per track: each track gets its own ``pid``
        with a ``process_name`` metadata event, so devices render as
        separate rows in the Perfetto UI.  Intervals are complete
        (``ph: "X"``) events; instants are ``ph: "i"``.  The exact
        float seconds are carried in ``args`` (``ts_s``/``dur_s``) so
        :func:`from_chrome_trace` reloads are bit-identical despite the
        microsecond display unit.
        """
        events: list[dict] = []
        pids: dict[str, int] = {}
        for track in self.tracks():
            pid = pids[track] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": track}})
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": 0, "args": {"name": track}})
        for s in self.spans:
            args = {k: _jsonable(v) for k, v in s.attrs}
            args["ts_s"] = s.ts
            args["dur_s"] = s.dur
            ev = {"name": s.name, "cat": s.name, "pid": pids[s.track],
                  "tid": 0, "ts": s.ts * 1e6, "args": args}
            if s.dur > 0.0:
                ev["ph"] = "X"
                ev["dur"] = s.dur * 1e6
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def to_json(self, **dump_kw) -> str:
        dump_kw.setdefault("sort_keys", True)
        return json.dumps(self.to_chrome_trace(), **dump_kw)

    def save(self, path) -> str:
        """Write the Perfetto JSON trace to ``path``; returns the path."""
        import os
        with open(path, "w") as f:
            f.write(self.to_json(indent=1))
            f.write("\n")
        return os.fspath(path)


def _jsonable(v):
    """Attr values as strict-JSON scalars (containers via repr)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        if isinstance(v, float) and not math.isfinite(v):
            return repr(v)
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    return repr(v)


def from_chrome_trace(doc: Mapping) -> list[Span]:
    """Rebuild the span list from :meth:`Tracer.to_chrome_trace` output.

    Uses the exact ``ts_s``/``dur_s`` values stashed in ``args`` (the
    microsecond fields are display-only), so an emit → export → reload
    cycle reproduces the original span tree bit-identically.
    """
    errors = validate_chrome_trace(doc)
    if errors:
        raise ValueError(f"invalid chrome trace: {errors[0]} "
                         f"(+{len(errors) - 1} more)" if len(errors) > 1
                         else f"invalid chrome trace: {errors[0]}")
    track_of: dict[int, str] = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            track_of[ev["pid"]] = ev["args"]["name"]
    spans: list[Span] = []
    for ev in doc["traceEvents"]:
        if ev.get("ph") not in ("X", "i", "I"):
            continue
        args = dict(ev.get("args", {}))
        ts = args.pop("ts_s", ev["ts"] / 1e6)
        dur = args.pop("dur_s", ev.get("dur", 0.0) / 1e6)
        spans.append(Span(ev["name"], float(ts), float(dur),
                          track_of.get(ev["pid"], HOST_TRACK),
                          Span.freeze_attrs(args)))
    return spans


def validate_chrome_trace(doc: Mapping) -> list[str]:
    """Structural validation of a Chrome-trace document.

    Returns a list of human-readable problems (empty = valid):
    ``traceEvents`` must be a list; every event needs a ``ph``; every
    span/instant needs a numeric ``ts`` and a ``pid`` with a
    ``process_name`` metadata row; ``X`` events need a non-negative
    ``dur``.  Used by ``python -m repro_torch.tools.trace --validate``.
    """
    errors: list[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    named_pids: set[int] = set()
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            if not isinstance(ev.get("args", {}).get("name"), str):
                errors.append(f"process_name metadata without a string "
                              f"name: {ev}")
            named_pids.add(ev.get("pid"))
    n_spans = 0
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph is None:
            errors.append(f"event {i} has no ph field")
            continue
        if ph == "M":
            continue
        if ph not in ("X", "i", "I"):
            errors.append(f"event {i} has unsupported ph {ph!r}")
            continue
        n_spans += 1
        if not isinstance(ev.get("ts"), (int, float)):
            errors.append(f"event {i} ({ev.get('name')!r}) has no "
                          f"numeric ts")
        if not isinstance(ev.get("name"), str):
            errors.append(f"event {i} has no name")
        if ev.get("pid") not in named_pids:
            errors.append(f"event {i} ({ev.get('name')!r}) pid "
                          f"{ev.get('pid')!r} has no process_name row")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i} ({ev.get('name')!r}) X-event "
                              f"without non-negative dur")
    if n_spans == 0:
        errors.append("trace contains no span or instant events")
    return errors


def span_tree(spans: Iterable[Span]) -> dict[str, list[Span]]:
    """Spans grouped by track, each list sorted by (ts, name) — the
    canonical comparison form for round-trip tests and sim-vs-real
    diffs."""
    tree: dict[str, list[Span]] = {}
    for s in spans:
        tree.setdefault(s.track, []).append(s)
    for track in tree:
        tree[track].sort(key=lambda s: (s.ts, s.name, s.dur))
    return tree


# ---------------------------------------------------------------------------
# active-tracer plumbing
# ---------------------------------------------------------------------------

_ACTIVE: Tracer | NullTracer = NULL_TRACER


def current() -> "Tracer | NullTracer":
    """The tracer instrumented library code should emit into.

    Defaults to :data:`NULL_TRACER`; an owner activates its tracer with
    :func:`scoped` (or :func:`activate`) around the work it captures.
    """
    return _ACTIVE


def activate(tracer: "Tracer | NullTracer | None") -> "Tracer | NullTracer":
    """Install ``tracer`` as the process-wide active tracer; returns the
    previous one so callers can restore it (prefer :func:`scoped`).
    ``None`` installs :data:`NULL_TRACER` — :func:`current` never hands
    instrumented code a non-tracer."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer if tracer is not None else NULL_TRACER
    return prev


@contextmanager
def scoped(tracer: "Tracer | NullTracer"):
    """Activate ``tracer`` for the dynamic extent of a with-block."""
    prev = activate(tracer)
    try:
        yield tracer
    finally:
        activate(prev)
