"""The port's decoder graph export (``models/graph_export.py``) against
the JAX package's.

The module is a framework-free copy, so the exported graphs must be
*equal*, vertex for vertex (every ``LayerSpec`` field) and edge for
edge, and the planner's copy must cut the same pieces and build the same
stages on them.  The port has no TPU cluster constants: its
``Cluster`` is built from the fields of the reference's
``make_tpu_cluster(4)``.  Then the port's versions of
``tests/test_graph_export.py``'s three checks.
"""

import dataclasses

import pytest

from repro import configs as ref_configs
from repro.api.specs import PlanSpec as RefPlanSpec
from repro.core import make_tpu_cluster as ref_tpu_cluster
from repro.core import partition_graph as ref_partition_graph
from repro.core import plan as ref_plan
from repro.models.graph_export import export_graph as ref_export_graph
from repro_torch import configs
from repro_torch.api.specs import PlanSpec
from repro_torch.core import Cluster, Device, partition_graph, plan
from repro_torch.models.graph_export import export_graph

SEQS = (1024, 8192)
# planned end to end here; mamba2 and zamba2 cut in depth (194 and 236
# vertices at full depth take 50-100 s to plan in each package), widths
# as published
PLANNED = {"llama3.2-1b": None, "mixtral-8x7b": None,
           "qwen1.5-0.5b": None, "mamba2-370m": 8, "zamba2-2.7b": 12}


def _cluster(n=4) -> Cluster:
    """The port's Cluster with the reference's ``make_tpu_cluster(n)``
    fields."""
    rc = ref_tpu_cluster(n)
    return Cluster([Device(d.name, d.capacity, d.alpha, d.active_power,
                           d.idle_power) for d in rc.devices],
                   bandwidth=rc.bandwidth,
                   pair_bandwidth=dict(rc.pair_bandwidth))


def _cfgs(name):
    depth = PLANNED.get(name)
    ref_cfg, cfg = ref_configs.get(name), configs.get(name)
    if depth is not None:
        ref_cfg = dataclasses.replace(ref_cfg, n_layers=depth)
        cfg = dataclasses.replace(cfg, n_layers=depth)
    return ref_cfg, cfg


def _layers(g) -> dict:
    return {n: dataclasses.asdict(s) for n, s in g.layers.items()}


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("name", ref_configs.ARCH_NAMES)
def test_export_graph_is_the_references(name, seq):
    """Every vertex with every field, in insertion order, and every
    edge."""
    want = ref_export_graph(ref_configs.get(name), seq_len=seq)
    got = export_graph(configs.get(name), seq_len=seq)
    assert list(got.layers) == list(want.layers)
    assert _layers(got) == _layers(want)
    assert [tuple(e) for e in got.edges] == [tuple(e) for e in want.edges]
    assert got.width() == want.width() == 1
    assert got.sources() == want.sources() and got.sinks() == want.sinks()


@pytest.mark.parametrize("name", ref_configs.ARCH_NAMES)
def test_partition_of_the_export_is_the_references(name):
    """Algorithm 1 on the exported graph: the same pieces and objective
    (zamba2's sync-point partition, n_split 4, diameter 5)."""
    seq = 2048
    want = ref_partition_graph(
        ref_export_graph(ref_configs.get(name), seq_len=seq), (seq, 1),
        n_split=4, max_diameter=5)
    got = partition_graph(export_graph(configs.get(name), seq_len=seq),
                          (seq, 1), n_split=4, max_diameter=5)
    assert got.objective == want.objective
    assert [p.nodes for p in got.pieces] == [p.nodes for p in want.pieces]


@pytest.mark.parametrize("name", sorted(PLANNED))
def test_plan_of_the_export_is_the_references(name):
    """Algorithms 1-3 on the export over the four-device cluster: the
    same pieces, stages (nodes, devices, width fractions, stage times),
    period and latency."""
    seq = 1024
    ref_cfg, cfg = _cfgs(name)
    want = ref_plan(ref_export_graph(ref_cfg, seq_len=seq),
                    ref_tpu_cluster(4), (seq, 1),
                    spec=RefPlanSpec(max_diameter=2))
    got = plan(export_graph(cfg, seq_len=seq), _cluster(4), (seq, 1),
               spec=PlanSpec(max_diameter=2))
    assert [p.nodes for p in got.partition.pieces] \
        == [p.nodes for p in want.partition.pieces]
    a, b = want.pipeline.stages, got.pipeline.stages
    assert [s.nodes for s in b] == [s.nodes for s in a]
    assert [[d.name for d in s.devices] for s in b] \
        == [[d.name for d in s.devices] for s in a]
    assert [list(s.fractions) for s in b] == [list(s.fractions) for s in a]
    assert [s.cost.total for s in b] == [s.cost.total for s in a]
    assert (got.period, got.latency) == (want.period, want.latency)


# -- the reference's checks (tests/test_graph_export.py), on the port ------

def test_zamba2_attention_is_a_sync_point():
    cfg = configs.get("zamba2-2.7b")
    g = export_graph(cfg, seq_len=2048)
    assert g.width() == 1  # decoder chain
    res = partition_graph(g, (2048, 1), n_split=4, max_diameter=5)
    assert res.objective == 0
    for p in res.pieces:
        kinds = {g.layers[n].kind for n in p.nodes}
        # a global-RF attention never fuses below a finite-halo mixer
        if "attn" in kinds:
            assert not kinds & {"conv1d", "ssd"}, kinds


@pytest.mark.parametrize("name", ["llama3.2-1b", "mixtral-8x7b",
                                  "mamba2-370m"])
def test_planner_balances_decoder_pipeline(name):
    _, cfg = _cfgs(name)
    g = export_graph(cfg, seq_len=1024)
    p = plan(g, _cluster(4), (1024, 1), spec=PlanSpec(max_diameter=2))
    assert len(p.pipeline.stages) >= 2
    times = [st.cost.total for st in p.pipeline.stages]
    assert max(times) <= 2.5 * (sum(times) / len(times))  # balanced
    # all vertices covered exactly once
    seen = set()
    for st in p.pipeline.stages:
        assert not (seen & st.nodes)
        seen |= st.nodes
    assert seen == set(g.layers)


def test_swa_has_finite_halo():
    cfg = configs.get("mixtral-8x7b")
    g = export_graph(cfg, seq_len=8192)
    attn = g.layers["l0.attn"]
    assert attn.kind == "swa" and not attn.global_rf
    assert attn.kernel[0] == cfg.sliding_window
