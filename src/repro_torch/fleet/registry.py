"""Fleet plan registry: identical clusters never re-plan.

The registry caches finished :class:`~repro_torch.core.planner.PicoPlan`
artifacts (the same versioned payloads ``repro_torch.api`` ships to disk)
under a content key::

    (model fingerprint, cluster signature, PlanSpec, CostTable)

* **model fingerprint** — sha256 over the serialized layer graph +
  input size, so two tenants loading "vgg16" from different processes
  collide onto one entry;
* **cluster signature** — when the link is flat (no per-pair bandwidth
  overrides) the signature is *name-insensitive*: the sorted multiset
  of device parameters + bandwidth.  Identical hardware with different
  device names is the same planning problem, and on a hit the cached
  plan's devices are rebound positionally onto the requesting
  cluster's.  With pair overrides, names are load-bearing and the
  signature is exact;
* **spec / cost table** — the planner knobs and measured calibration
  ratios that shaped the plan.

Misses plan through :func:`~repro_torch.core.planner.plan_with_spec` with a
per-model :class:`~repro_torch.core.pipeline_dp.PlannerCache`, so even a miss
is incremental when the same model was planned before on a different
cluster.  Hits and misses are counted locally and published to
``repro_torch.obs`` (``fleet.registry.hit`` / ``fleet.registry.miss``).
"""

from __future__ import annotations

import hashlib
import json
from collections import OrderedDict

from ..api import artifacts
from ..api.specs import PlanSpec
from ..core.cost import Cluster, CostTable
from ..core.pipeline_dp import PlannerCache
from ..core.planner import PicoPlan, plan_with_spec
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace


def _sha(payload) -> str:
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def fingerprint_model(model) -> str:
    """Content hash of a graph carrier (``.graph`` + ``.input_size``)."""
    return _sha({"graph": artifacts.graph_to_dict(model.graph),
                 "input_size": list(model.input_size)})


def _device_key(d) -> list:
    return [d.capacity, d.alpha, d.active_power, d.idle_power]


def cluster_signature(cluster: Cluster) -> str:
    """Content hash of the planning-relevant cluster state.

    Name-insensitive (sorted device-parameter multiset) when the link
    is flat; exact (ordered, named) when per-pair bandwidth overrides
    make names load-bearing.
    """
    if cluster.pair_bandwidth:
        return _sha({"exact": artifacts.cluster_to_dict(cluster)})
    return _sha({"devices": sorted(_device_key(d) for d in cluster.devices),
                 "bandwidth": cluster.bandwidth})


def _spec_key(spec: PlanSpec) -> str:
    return spec.to_json()


def _cost_table_key(ct: CostTable | None) -> str:
    if ct is None:
        return ""
    return _sha(json.loads(artifacts.dumps_payload(
        "cost_table", artifacts.cost_table_to_dict(ct))))


def _rebind(plan: PicoPlan, cluster: Cluster) -> PicoPlan:
    """Re-point a cached plan's stage devices at ``cluster``'s devices.

    Valid only under a name-insensitive signature match: both sides
    hold the same multiset of device parameters, so sorting each by
    (capacity desc, params, name) pairs equivalent devices.
    """
    old = sorted({d.name: d for st in plan.pipeline.stages
                  for d in st.devices}.values(),
                 key=lambda d: (-d.capacity, d.alpha, d.name))
    new = sorted(cluster.devices, key=lambda d: (-d.capacity, d.alpha, d.name))
    mapping = {o.name: n for o, n in zip(old, new)}
    for st in plan.pipeline.stages:
        st.devices = [mapping[d.name] for d in st.devices]
    return plan


class PlanRegistry:
    """LRU cache of finished plans, shared fleet-wide.

    Entries store the *serialized* plan payload (exactly what
    ``repro_torch.api`` writes to disk), so a hit decodes a fresh, isolated
    :class:`PicoPlan` — mutating a served plan never corrupts the
    registry — and :meth:`to_payload`/:meth:`from_payload` round-trip
    the whole registry as one versioned artifact
    (``artifacts.to_json("plan_registry", reg)``).
    """

    def __init__(self, capacity: int = 256, metrics=None, store=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: OrderedDict[tuple, dict] = OrderedDict()
        self._caches: dict[str, PlannerCache] = {}
        self.hits = 0
        self.misses = 0
        self._metrics = (metrics if metrics is not None
                         else obs_metrics.default_registry())
        if store is not None and not hasattr(store, "get"):
            from .store import PlanStore      # path-like -> file-backed
            store = PlanStore(store)
        self.store = store

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def key(self, model, cluster: Cluster, spec: PlanSpec,
            cost_table: CostTable | None = None) -> tuple:
        return (fingerprint_model(model), cluster_signature(cluster),
                _spec_key(spec), _cost_table_key(cost_table))

    def planner_cache_for(self, model) -> PlannerCache:
        """The per-model incremental-planner state (misses plan through
        this, so repeat models stay on the hot path even when the
        cluster signature is new)."""
        return self._caches.setdefault(fingerprint_model(model),
                                       PlannerCache())

    # -- lookup / insert ------------------------------------------------
    def get(self, model, cluster: Cluster, spec: PlanSpec | None = None,
            cost_table: CostTable | None = None) -> PicoPlan | None:
        spec = spec or PlanSpec()
        key = self.key(model, cluster, spec, cost_table)
        with obs_trace.current().wall_span(
                "registry.lookup", model=key[0], cluster=key[1],
                hit=key in self._entries):
            entry = self._entries.get(key)
            if entry is None and self.store is not None:
                entry = self.store.get(key)     # shared-store fallback
                if entry is not None:
                    self._entries[key] = entry
                    while len(self._entries) > self.capacity:
                        self._entries.popitem(last=False)
                    self._metrics.counter("fleet.registry.store_hit").inc()
            if entry is None:
                self.misses += 1
                self._metrics.counter("fleet.registry.miss").inc()
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            self._metrics.counter("fleet.registry.hit").inc()
            plan = artifacts.plan_from_dict(entry["plan"])
            plan.source = "registry"
            cached_names = entry["device_names"]
            if cached_names != [d.name for d in cluster.devices]:
                _rebind(plan, cluster)
            return plan

    def put(self, model, cluster: Cluster, spec: PlanSpec | None,
            plan: PicoPlan, cost_table: CostTable | None = None) -> None:
        spec = spec or PlanSpec()
        key = self.key(model, cluster, spec, cost_table)
        entry = {
            "model": key[0], "cluster_sig": key[1], "spec": spec.to_dict(),
            "cost_table_key": key[3],
            "device_names": [d.name for d in cluster.devices],
            "cluster": artifacts.cluster_to_dict(cluster),
            "plan": artifacts.plan_to_dict(plan),
        }
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
        if self.store is not None:
            # persist beyond the LRU horizon and this process's lifetime
            self.store.put(key, entry)
        self._metrics.gauge("fleet.registry.size").set(len(self._entries))

    def get_or_plan(self, model, cluster: Cluster,
                    spec: PlanSpec | None = None,
                    cost_table: CostTable | None = None) -> PicoPlan:
        """Serve from the registry, or plan (incrementally when the
        model is known) and insert.  ``plan.source`` says which."""
        spec = spec or PlanSpec()
        hit = self.get(model, cluster, spec, cost_table)
        if hit is not None:
            return hit
        pico = plan_with_spec(model.graph, cluster, model.input_size, spec,
                              cost_table=cost_table,
                              planner_cache=self.planner_cache_for(model))
        self.put(model, cluster, spec, pico, cost_table)
        return pico

    # -- artifact round-trip --------------------------------------------
    def to_payload(self) -> dict:
        return {"capacity": self.capacity,
                "entries": list(self._entries.values())}

    @classmethod
    def from_payload(cls, d) -> "PlanRegistry":
        reg = cls(capacity=d["capacity"])
        for e in d["entries"]:
            spec = PlanSpec.from_dict(e["spec"])
            key = (e["model"], e["cluster_sig"], _spec_key(spec),
                   e.get("cost_table_key", ""))
            reg._entries[key] = dict(e)
        return reg

    def to_json(self, **kw) -> str:
        return artifacts.to_json("plan_registry", self, **kw)

    @classmethod
    def from_json(cls, s: str) -> "PlanRegistry":
        return artifacts.from_json("plan_registry", s)
