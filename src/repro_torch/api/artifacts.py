"""Versioned JSON serialization for planner artifacts.

The counterpart of the JAX package's ``api/artifacts.py``, writing the
same documents: an artifact of either package loads in the other.  The
optimizer's output is shipped to a device fleet and executed there, so
every artifact on that boundary is durable —
:class:`~repro_torch.core.planner.PicoPlan` (piece chain + stage/device
mapping + priced costs),
:class:`~repro_torch.core.partition.PartitionResult`,
:class:`~repro_torch.core.cost.CostTable` (measured calibration ratios
and tuned kernel plans), :class:`~repro_torch.core.cost.Cluster`, the
model definition itself (graph of
:class:`~repro_torch.core.graph.LayerSpec`) and the exec spec — as
strict JSON with a schema version field.

Backend names are written in the JAX package's words (``"xla"``,
``"pallas"``) and read in either package's (``"torch"``, ``"cuda"``
too), so a document of this package runs in the JAX package; ``null``
stays ``null``, each package's default.

Round-trips are exact: floats serialize via ``repr`` (shortest
round-trip form, bit-identical on load), node sets as sorted lists,
non-finite floats as ``"Infinity"`` strings.  A loaded plan re-prices,
simulates and executes identically to the original with zero
re-planning or re-calibration.

Version policy: loaders reject payloads *newer* than their own
``SCHEMA_VERSION`` with a clear error, so new-format artifacts fail
fast on old code.  Additive evolution (new optional fields) does not
bump the version — decoders default missing fields (``dict.get``).  A
*breaking* payload-shape change must bump ``SCHEMA_VERSION`` and ship
a version-dispatched migration in this module alongside it; until one
exists, every version ``<=`` current decodes with the current codecs.
"""

from __future__ import annotations

import json
from typing import Mapping

from ..core.cost import (Cluster, CostTable, Device, SegmentCost, StageCost)
from ..core.graph import Graph, LayerSpec
from ..core.partition import PartitionResult, Piece
from ..core.pipeline_dp import PipelinePlan, StagePlan
from ..core.planner import PicoPlan
from .specs import ExecSpec, decode_float, encode_float

SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# envelope
# ---------------------------------------------------------------------------

def envelope(kind: str, payload: dict) -> dict:
    return {"artifact": kind, "version": SCHEMA_VERSION, "payload": payload}


def open_envelope(d: Mapping, kind: str) -> dict:
    got = d.get("artifact")
    if got != kind:
        raise ValueError(f"expected a {kind!r} artifact, got {got!r}")
    version = d.get("version")
    if not isinstance(version, int):
        raise ValueError(f"{kind} artifact has no integer version field")
    if version > SCHEMA_VERSION:
        raise ValueError(f"{kind} artifact version {version} is newer than "
                         f"supported {SCHEMA_VERSION}")
    try:
        return d["payload"]
    except KeyError:
        raise ValueError(f"{kind} artifact envelope has no payload field")


def _nodes_out(nodes) -> list[str]:
    return sorted(nodes)


def _nodes_in(names) -> frozenset[str]:
    return frozenset(names)


# ---------------------------------------------------------------------------
# devices / clusters
# ---------------------------------------------------------------------------

def device_to_dict(d: Device) -> dict:
    return {"name": d.name, "capacity": d.capacity, "alpha": d.alpha,
            "active_power": d.active_power, "idle_power": d.idle_power}


def device_from_dict(d: Mapping) -> Device:
    return Device(d["name"], d["capacity"], d.get("alpha", 1.0),
                  d.get("active_power", 4.0), d.get("idle_power", 1.6))


def cluster_to_dict(c: Cluster) -> dict:
    return {"devices": [device_to_dict(d) for d in c.devices],
            "bandwidth": c.bandwidth,
            "pair_bandwidth": [[a, b, bw] for (a, b), bw
                               in sorted(c.pair_bandwidth.items())]}


def cluster_from_dict(d: Mapping) -> Cluster:
    return Cluster([device_from_dict(x) for x in d["devices"]],
                   bandwidth=d["bandwidth"],
                   pair_bandwidth={(a, b): bw for a, b, bw
                                   in d.get("pair_bandwidth", ())})


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------

def piece_to_dict(p: Piece) -> dict:
    return {"nodes": _nodes_out(p.nodes), "redundancy": p.redundancy,
            "index": p.index}


def piece_from_dict(d: Mapping) -> Piece:
    return Piece(_nodes_in(d["nodes"]), d["redundancy"], d["index"])


def partition_to_dict(pr: PartitionResult) -> dict:
    return {"pieces": [piece_to_dict(p) for p in pr.pieces],
            "objective": pr.objective,
            "states_explored": pr.states_explored,
            "wall_time_s": pr.wall_time_s}


def partition_from_dict(d: Mapping) -> PartitionResult:
    return PartitionResult([piece_from_dict(p) for p in d["pieces"]],
                           d["objective"], d["states_explored"],
                           d["wall_time_s"])


# ---------------------------------------------------------------------------
# pipeline plan (priced stages)
# ---------------------------------------------------------------------------

def _segment_cost_to_dict(s: SegmentCost) -> dict:
    return {"nodes": _nodes_out(s.nodes),
            "per_device_flops": list(s.per_device_flops),
            "exact_flops": s.exact_flops,
            "in_bytes": list(s.in_bytes), "out_bytes": list(s.out_bytes),
            "param_bytes": s.param_bytes,
            "feature_bytes": list(s.feature_bytes)}


def _segment_cost_from_dict(d: Mapping) -> SegmentCost:
    return SegmentCost(_nodes_in(d["nodes"]), list(d["per_device_flops"]),
                       d["exact_flops"], list(d["in_bytes"]),
                       list(d["out_bytes"]), d["param_bytes"],
                       list(d["feature_bytes"]))


def _stage_cost_to_dict(c: StageCost) -> dict:
    return {"t_comp": c.t_comp, "t_comm": c.t_comm,
            "per_device_comp": list(c.per_device_comp),
            "seg": _segment_cost_to_dict(c.seg)}


def _stage_cost_from_dict(d: Mapping) -> StageCost:
    return StageCost(d["t_comp"], d["t_comm"], list(d["per_device_comp"]),
                     _segment_cost_from_dict(d["seg"]))


def _stage_plan_to_dict(st: StagePlan) -> dict:
    return {"first_piece": st.first_piece, "last_piece": st.last_piece,
            "devices": [device_to_dict(d) for d in st.devices],
            "nodes": _nodes_out(st.nodes),
            "cost": _stage_cost_to_dict(st.cost),
            "fractions": list(st.fractions)}


def _stage_plan_from_dict(d: Mapping) -> StagePlan:
    return StagePlan(d["first_piece"], d["last_piece"],
                     [device_from_dict(x) for x in d["devices"]],
                     _nodes_in(d["nodes"]), _stage_cost_from_dict(d["cost"]),
                     list(d["fractions"]))


def pipeline_to_dict(p: PipelinePlan) -> dict:
    return {"stages": [_stage_plan_to_dict(s) for s in p.stages],
            "period": p.period, "latency": p.latency,
            "wall_time_s": p.wall_time_s, "feasible": p.feasible}


def pipeline_from_dict(d: Mapping) -> PipelinePlan:
    return PipelinePlan([_stage_plan_from_dict(s) for s in d["stages"]],
                        d["period"], d["latency"], d["wall_time_s"],
                        d.get("feasible", True))


def plan_to_dict(pico: PicoPlan) -> dict:
    # "source" (scratch | incremental | registry) is an additive field:
    # pre-provenance artifacts load as "scratch", old loaders ignore it
    d = {"partition": partition_to_dict(pico.partition),
         "pipeline": pipeline_to_dict(pico.pipeline),
         "source": pico.source}
    # objective label (additive, omitted while None so pre-objective
    # plan documents stay byte-identical)
    if pico.objective is not None:
        d["objective"] = pico.objective
    return d


def plan_from_dict(d: Mapping) -> PicoPlan:
    return PicoPlan(partition_from_dict(d["partition"]),
                    pipeline_from_dict(d["pipeline"]),
                    source=d.get("source", "scratch"),
                    objective=d.get("objective"))


# ---------------------------------------------------------------------------
# cost table
# ---------------------------------------------------------------------------

def cost_table_to_dict(t: CostTable) -> dict:
    d = {"ratios": [{"nodes": _nodes_out(k), "ratio": v}
                    for k, v in sorted(t.ratios.items(),
                                       key=lambda kv: sorted(kv[0]))],
         "default": t.default}
    # autotuned kernel winners: additive field (absent pre-autotune
    # artifacts load fine; older loaders ignore it), so no schema bump
    if getattr(t, "kernels", None):
        d["kernels"] = [{"key": k, **t.kernels[k]}
                        for k in sorted(t.kernels)]
    return d


def cost_table_from_dict(d: Mapping) -> CostTable:
    kernels = {e["key"]: {k: v for k, v in e.items() if k != "key"}
               for e in d.get("kernels", ())}
    return CostTable({_nodes_in(e["nodes"]): e["ratio"]
                      for e in d["ratios"]}, default=d.get("default"),
                     kernels=kernels)


# ---------------------------------------------------------------------------
# graph of LayerSpecs
# ---------------------------------------------------------------------------

def layer_spec_to_dict(s: LayerSpec) -> dict:
    return {"name": s.name, "kind": s.kind, "kernel": list(s.kernel),
            "stride": list(s.stride), "padding": list(s.padding),
            "in_channels": s.in_channels, "out_channels": s.out_channels,
            "flops_coeff": s.flops_coeff, "param_bytes": s.param_bytes,
            "global_rf": s.global_rf,
            "tile_independent_flops": s.tile_independent_flops}


def layer_spec_from_dict(d: Mapping) -> LayerSpec:
    return LayerSpec(d["name"], d["kind"], tuple(d["kernel"]),
                     tuple(d["stride"]), tuple(d["padding"]),
                     d["in_channels"], d["out_channels"], d["flops_coeff"],
                     d["param_bytes"], d["global_rf"],
                     d["tile_independent_flops"])


def graph_to_dict(g: Graph) -> dict:
    # layer order is semantic (stable Kahn topo ties break on insertion
    # order), so serialize layers as an ordered list, not a mapping
    return {"layers": [layer_spec_to_dict(g.layers[n]) for n in g.layers],
            "edges": [list(e) for e in g.edges]}


def graph_from_dict(d: Mapping) -> Graph:
    g = Graph()
    for ls in d["layers"]:
        g.layers[ls["name"]] = layer_spec_from_dict(ls)
    g.edges = [(u, v) for u, v in d["edges"]]
    g._invalidate()
    return g


# ---------------------------------------------------------------------------
# backend names (the JAX package's words on the wire)
# ---------------------------------------------------------------------------

def backend_to_wire(name: str | None) -> str | None:
    """The port's backend name in the JAX package's words."""
    from ..exec.backends import JAX_BACKEND_NAMES     # lazy: pulls in torch
    return {v: k for k, v in JAX_BACKEND_NAMES.items()}.get(name, name)


def backend_from_wire(name: str | None) -> str | None:
    """Either package's backend name as the port's."""
    from ..exec.backends import JAX_BACKEND_NAMES
    return JAX_BACKEND_NAMES.get(name, name)


def exec_spec_to_dict(spec: ExecSpec) -> dict:
    d = spec.to_dict()
    d["backend"] = backend_to_wire(d["backend"])
    return d


def exec_spec_from_dict(d: Mapping) -> ExecSpec:
    return ExecSpec.from_dict(
        {**d, "backend": backend_from_wire(d.get("backend"))})


# ---------------------------------------------------------------------------
# model definition (graph of LayerSpecs)
# ---------------------------------------------------------------------------

def model_to_dict(model) -> dict:
    """Serialize a :class:`~repro_torch.models.cnn.builder.CNNDef`."""
    return {"name": model.name, "graph": graph_to_dict(model.graph),
            "input_size": list(model.input_size),
            "in_channels": model.in_channels,
            "blocks": [list(b) for b in model.blocks],
            "backend": backend_to_wire(model.backend)}


def model_from_dict(d: Mapping):
    from ..models.cnn.builder import CNNDef     # lazy: pulls in torch
    return CNNDef(d["name"], graph_from_dict(d["graph"]),
                  tuple(d["input_size"]), d["in_channels"],
                  [list(b) for b in d.get("blocks", ())],
                  backend_from_wire(d.get("backend")))


# ---------------------------------------------------------------------------
# pareto front (multi-objective planner output)
# ---------------------------------------------------------------------------

def _plan_metrics_to_dict(m) -> dict:
    return {"period": m.period, "latency": m.latency,
            "energy_j": m.energy_j, "memory_bytes": m.memory_bytes}


def _plan_metrics_from_dict(d: Mapping):
    from ..core.simulate import PlanMetrics
    return PlanMetrics(d["period"], d["latency"], d["energy_j"],
                       d["memory_bytes"])


def _front_point_to_dict(p) -> dict:
    return {"plan": plan_to_dict(p.plan),
            "metrics": _plan_metrics_to_dict(p.metrics),
            "n_devices": p.n_devices, "t_lim": p.t_lim}


def _front_point_from_dict(d: Mapping):
    from ..core.pareto import FrontPoint
    return FrontPoint(plan_from_dict(d["plan"]),
                      _plan_metrics_from_dict(d["metrics"]),
                      d["n_devices"], d.get("t_lim", float("inf")))


def pareto_front_to_dict(front) -> dict:
    """Serialize a :class:`~repro_torch.core.pareto.ParetoFront`: the
    sweep's :class:`~repro_torch.api.specs.PlanSpec` plus every
    non-dominated point (full plan + priced metrics + sweep
    coordinates)."""
    return {"spec": front.spec.to_dict(),
            "points": [_front_point_to_dict(p) for p in front.points]}


def pareto_front_from_dict(d: Mapping):
    from ..core.pareto import ParetoFront   # lazy: avoid import cycle
    from .specs import PlanSpec
    return ParetoFront([_front_point_from_dict(p) for p in d["points"]],
                       PlanSpec.from_dict(d["spec"]))


# ---------------------------------------------------------------------------
# fleet plan registry
# ---------------------------------------------------------------------------

def plan_registry_to_dict(reg) -> dict:
    """Serialize a :class:`~repro_torch.fleet.registry.PlanRegistry`
    (entries in LRU order, oldest first; the payload shape is owned by
    the registry so its key scheme and this codec evolve together)."""
    return reg.to_payload()


def plan_registry_from_dict(d: Mapping):
    from ..fleet.registry import PlanRegistry   # lazy: avoid import cycle
    return PlanRegistry.from_payload(d)


# ---------------------------------------------------------------------------
# public JSON entry points
# ---------------------------------------------------------------------------

_CODECS = {
    "plan": (plan_to_dict, plan_from_dict),
    "partition": (partition_to_dict, partition_from_dict),
    "cost_table": (cost_table_to_dict, cost_table_from_dict),
    "cluster": (cluster_to_dict, cluster_from_dict),
    "model": (model_to_dict, model_from_dict),
    "plan_registry": (plan_registry_to_dict, plan_registry_from_dict),
    "pareto_front": (pareto_front_to_dict, pareto_front_from_dict),
}


def dumps_payload(kind: str, payload: dict, **dump_kw) -> str:
    """Envelope + strict-JSON encode a raw payload dict — the one spot
    where the document format (version field, float spelling, key
    order) is decided, shared by every artifact including the
    deployment bundle."""
    dump_kw.setdefault("sort_keys", True)
    return json.dumps(_finite(envelope(kind, payload)), **dump_kw)


def loads_payload(kind: str, s: str) -> dict:
    return open_envelope(_definite(json.loads(s)), kind)


def to_json(kind: str, obj, **dump_kw) -> str:
    """Serialize ``obj`` (one of ``plan``/``partition``/``cost_table``/
    ``cluster``/``model``) into its versioned JSON envelope."""
    enc, _ = _CODECS[kind]
    return dumps_payload(kind, enc(obj), **dump_kw)


def from_json(kind: str, s: str):
    _, dec = _CODECS[kind]
    return dec(loads_payload(kind, s))


def plan_to_json(pico: PicoPlan, **kw) -> str:
    return to_json("plan", pico, **kw)


def plan_from_json(s: str) -> PicoPlan:
    return from_json("plan", s)


def partition_to_json(pr: PartitionResult, **kw) -> str:
    return to_json("partition", pr, **kw)


def partition_from_json(s: str) -> PartitionResult:
    return from_json("partition", s)


def cost_table_to_json(t: CostTable, **kw) -> str:
    return to_json("cost_table", t, **kw)


def cost_table_from_json(s: str) -> CostTable:
    return from_json("cost_table", s)


_RESERVED_SPELLINGS = ("Infinity", "-Infinity", "NaN")


def _finite(x):
    """Recursively replace non-finite floats with their string spelling
    so the emitted document is strict JSON.  A *string* field that
    happens to equal one of the reserved spellings would be mangled
    into a float on load, so refuse it loudly instead of corrupting
    the artifact silently."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, str) and x in _RESERVED_SPELLINGS:
        raise ValueError(
            f"cannot serialize the string {x!r}: it collides with the "
            f"non-finite float spelling (rename the layer/device)")
    return encode_float(x)


def _definite(x):
    if isinstance(x, dict):
        return {k: _definite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_definite(v) for v in x]
    return decode_float(x)
