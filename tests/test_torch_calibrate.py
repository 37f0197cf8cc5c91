"""Calibration and autotune of the port (``repro_torch.exec.calibrate``,
``repro_torch.exec.autotune``) against the JAX package's contract:
per-stage ratios on the reference's node sets, the spatial-size-free
shape keys, launch-plan overrides the C side takes, the CostTable
artifact round trip, and the compile/load symmetry (a loaded artifact
re-tunes nothing).

On the CPU the conv wrapper runs the plain version, so these searches
test the plumbing (winner selection, keys, artifact, install), not the
kernel's times.  The kernel under each candidate plan is held to the
plain version on the card, in ``tests/test_torch_cuda.py``.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

import repro
import repro.exec.autotune as ref_autotune_mod
import repro_torch
import repro_torch.api.deployment as deployment_mod
import repro_torch.exec.autotune as at
from repro.api import ExecSpec as RefExecSpec
from repro.core import make_pi_cluster as ref_pi_cluster
from repro.core import plan_with_spec as ref_plan_with_spec
from repro.exec.autotune import clear_installed as ref_clear_installed
from repro.exec.autotune import shape_key as ref_shape_key
from repro.exec.calibrate import calibrate_plan as ref_calibrate_plan
from repro.models.cnn import zoo as ref_zoo
from repro_torch.api import artifacts
from repro_torch.api.specs import ExecSpec
from repro_torch.core import CostTable, make_pi_cluster, plan_with_spec
from repro_torch.exec.autotune import (DEFAULT_CANDIDATES, autotune_conv,
                                       autotune_model, clear_installed,
                                       conv_shapes, generation, install,
                                       installed, shape_key, tuned_plan)
from repro_torch.exec.calibrate import (calibrate_plan, calibrated_plan,
                                        measure_host_flops)
from repro_torch.kernels.conv2d import ops
from repro_torch.models.cnn import params_from_numpy, zoo
from repro_torch.pipeline import StageExecutor

from _torch_cases import ZOO_TINY, image, np_params

FREQS = [1.5, 1.2, 1.0, 0.8]
FRACS = [0.4, 0.35, 0.25]
WITHIN = dict(rtol=1e-6, atol=1e-6)
# a short candidate list: two tiles, no split and the deepest
TINY = (((128, 64), 1), ((64, 64), 8))
CUDA_ENTRY = {"tile": [64, 64], "split": 2, "best_us": 3.5,
              "backend": "cuda"}
PALLAS_ENTRY = {"block_ci": 8, "block_co": 16, "best_us": 12.5,
                "backend": "pallas"}


@pytest.fixture(autouse=True)
def _isolate_installed():
    """Each test starts and ends with an empty tuned registry, in both
    packages."""
    clear_installed()
    ref_clear_installed()
    yield
    clear_installed()
    ref_clear_installed()


def _tiny_vgg(head=True):
    return zoo.vgg16(input_size=(40, 40), scale=0.1, head=head)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["vgg16", "resnet34"])
def test_calibrate_plan_gives_one_entry_per_reference_stage(name):
    """One entry per stage, on the reference's node sets and FLOPs, with
    positive times and ratios; the table's default is their mean."""
    ref_m = ref_zoo.build(name, **ZOO_TINY[name])
    m = zoo.build(name, **ZOO_TINY[name])
    p_np = np_params(m)
    ref_plan = ref_plan_with_spec(ref_m.graph, ref_pi_cluster(FREQS),
                                  ref_m.input_size)
    pico = plan_with_spec(m.graph, make_pi_cluster(FREQS), m.input_size)
    want = ref_calibrate_plan(ref_m, p_np, ref_plan.pipeline.stages,
                              backend="xla", iters=1)
    got = calibrate_plan(m, params_from_numpy(p_np, "cpu"),
                         pico.pipeline.stages, iters=1, device="cpu")
    assert [(s.index, s.nodes, s.flops) for s in got.stages] \
        == [(s.index, s.nodes, s.flops) for s in want.stages]
    assert got.host_flops > 0
    for s in got.stages:
        assert s.measured_s > 0 and s.ratio > 0
        assert s.ratio == s.measured_s / (s.flops / got.host_flops)
    table = got.table()
    assert set(table.ratios) == {s.nodes for s in got.stages}
    assert table.default == pytest.approx(
        sum(s.ratio for s in got.stages) / len(got.stages))


def test_calibrate_plan_spans_and_histogram():
    """A ``calibrate`` wall span per stage in the active tracer and one
    ``exec.calibrate.stage_s`` sample per stage."""
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.metrics import default_registry
    m = _tiny_vgg()
    pico = plan_with_spec(m.graph, make_pi_cluster(FREQS), m.input_size)
    hist = default_registry().histogram("exec.calibrate.stage_s")
    before = hist.count
    tracer = obs_trace.Tracer()
    with obs_trace.scoped(tracer):
        calibrate_plan(m, m.init(device="cpu"), pico.pipeline.stages,
                       iters=1, host_flops=1e9, device="cpu")
    spans = tracer.by_name("calibrate")
    assert [s.attr("stage") for s in spans] \
        == list(range(len(pico.pipeline.stages)))
    assert hist.count - before == len(pico.pipeline.stages)


def test_calibrated_plan_keeps_the_partition():
    m = _tiny_vgg()
    cluster = make_pi_cluster(FREQS)
    first = plan_with_spec(m.graph, cluster, m.input_size)
    pico, report = calibrated_plan(m.graph, cluster, m.input_size, m,
                                   m.init(device="cpu"), iters=1,
                                   device="cpu")
    assert [p.nodes for p in pico.partition.pieces] \
        == [p.nodes for p in first.partition.pieces]
    assert len(report.stages) == len(first.pipeline.stages)
    assert pico.pipeline.stages        # re-planned on the measured table


def test_measure_host_flops_keeps_tf32_as_it_was():
    before = torch.backends.cuda.matmul.allow_tf32
    assert measure_host_flops(n=64, iters=2, device="cpu") > 0
    assert torch.backends.cuda.matmul.allow_tf32 == before


# ---------------------------------------------------------------------------
# keys and the installed registry
# ---------------------------------------------------------------------------

def test_shape_key_is_spatial_size_agnostic():
    a = shape_key((1, 32, 32, 8), (3, 3, 8, 16), (1, 1))
    assert a == "conv:cuda:c8x16:k3x3:s1x1:r0:p-"
    assert a == ref_shape_key((1, 32, 32, 8), (3, 3, 8, 16), (1, 1),
                              backend="cuda")
    assert a == shape_key((1, 7, 9, 8), (3, 3, 8, 16), (1, 1))
    assert a == shape_key((8, 226, 5, 8), (3, 3, 8, 16), (1, 1))
    # but channels, stride, epilogue and backend all distinguish
    assert a != shape_key((1, 32, 32, 9), (3, 3, 9, 16), (1, 1))
    assert a != shape_key((1, 32, 32, 8), (3, 3, 8, 16), (2, 2))
    assert a != shape_key((1, 32, 32, 8), (3, 3, 8, 16), (1, 1), relu=True)
    assert a != shape_key((1, 32, 32, 8), (3, 3, 8, 16), (1, 1),
                          pool=(2, 2))
    assert a != shape_key((1, 32, 32, 8), (3, 3, 8, 16), (1, 1),
                          backend="torch")


def test_tuned_plan_consults_the_installed_registry():
    k = shape_key((1, 10, 10, 8), (3, 3, 8, 16), (1, 1), True, (2, 2))
    assert tuned_plan((1, 10, 10, 8), (3, 3, 8, 16), (1, 1), True,
                      (2, 2)) is None
    install({k: CUDA_ENTRY})
    # any spatial size hits the same entry
    assert tuned_plan((1, 99, 3, 8), (3, 3, 8, 16), (1, 1), True,
                      (2, 2)) == ((64, 64), 2)
    assert tuned_plan((1, 99, 3, 8), (3, 3, 8, 16), (1, 1)) is None
    assert installed() == {k: CUDA_ENTRY}
    # an entry the heuristic won: installed, and each width keeps its own
    # heuristic plan
    won = {**CUDA_ENTRY, "tile": None, "split": None}
    install({k: won})
    assert installed() == {k: won}
    assert tuned_plan((1, 99, 3, 8), (3, 3, 8, 16), (1, 1), True,
                      (2, 2)) is None


def test_install_bumps_the_generation_only_on_a_change():
    k = "conv:cuda:c8x16:k3x3:s1x1:r1:p-"
    g0 = generation()
    install({k: CUDA_ENTRY})
    g1 = generation()
    assert g1 > g0
    install({k: dict(CUDA_ENTRY)})              # the same entry again
    assert generation() == g1
    install({k: {**CUDA_ENTRY, "split": 4}})
    assert generation() > g1
    g2 = generation()
    clear_installed()
    assert generation() > g2 and installed() == {}
    g3 = generation()
    clear_installed()                           # nothing to clear
    assert generation() == g3


def test_install_refuses_a_plan_the_kernel_does_not_take():
    k = "conv:cuda:c8x16:k3x3:s1x1:r1:p-"
    for bad in ({**CUDA_ENTRY, "tile": [32, 32]},
                {**CUDA_ENTRY, "split": 3}, {**CUDA_ENTRY, "split": 16},
                {**CUDA_ENTRY, "tile": None}, {**CUDA_ENTRY, "split": None}):
        with pytest.raises(ValueError):
            install({k: bad})
    assert installed() == {}


def test_pallas_entries_are_kept_and_never_installed(tmp_path):
    """A table carrying the JAX package's block sizes and a port plan:
    the deployment installs the port's entry alone, and saves and loads
    both unchanged."""
    m = _tiny_vgg()
    dep = repro_torch.compile(m, make_pi_cluster(FREQS), device="cpu")
    table = CostTable(kernels={"conv:pallas:c3x6:k3x3:s1x1:r1:p-":
                               dict(PALLAS_ENTRY),
                               "conv:cuda:c3x6:k3x3:s1x1:r1:p-":
                               dict(CUDA_ENTRY)})
    dep = repro_torch.Deployment(m, dep.cluster, dep.plan_spec,
                                 dep.exec_spec, dep.pico, cost_table=table,
                                 device=torch.device("cpu"))
    assert installed() == {"conv:cuda:c3x6:k3x3:s1x1:r1:p-": CUDA_ENTRY}
    path = dep.save(tmp_path / "d.json")
    saved = json.loads(open(path).read())["payload"]["cost_table"]
    assert {"key": "conv:pallas:c3x6:k3x3:s1x1:r1:p-", **PALLAS_ENTRY} \
        in saved["kernels"]
    clear_installed()
    dep2 = repro_torch.Deployment.load(path, device="cpu")
    assert dep2.cost_table.kernels == table.kernels
    assert installed() == {"conv:cuda:c3x6:k3x3:s1x1:r1:p-": CUDA_ENTRY}


def test_a_reference_tuned_artifact_loads_and_is_saved_again(tmp_path,
                                                              monkeypatch):
    """The JAX package's compile(autotune=True) saves its block sizes
    (its search stubbed to one winner a shape: interpret mode is slow);
    the port loads the artifact, installs none of them, saves them again
    unchanged, and a port compile on that table tunes its own keys beside
    them."""
    def one_winner(x_shape, w_shape, *, stride, relu, pool, backend, **kw):
        return ref_autotune_mod.TuneResult(
            ref_shape_key(x_shape, w_shape, stride, relu, pool, backend),
            8, 16, 12.5)

    monkeypatch.setattr(ref_autotune_mod, "autotune_conv", one_winner)
    ref_m = ref_zoo.vgg16(input_size=(40, 40), scale=0.1, head=False)
    ref_dep = repro.compile(ref_m, ref_pi_cluster([1.5, 1.0]),
                            exec_spec=RefExecSpec(backend="pallas",
                                                  autotune=True,
                                                  autotune_iters=1),
                            key=jax.random.PRNGKey(0))
    ref_kernels = ref_dep.cost_table.kernels
    assert ref_kernels and all(k.startswith("conv:pallas:")
                               for k in ref_kernels)
    path = ref_dep.save(tmp_path / "ref.json")
    dep = repro_torch.Deployment.load(path, device="cpu")
    assert dep.cost_table.kernels == ref_kernels
    assert installed() == {}
    again = json.loads(open(dep.save(tmp_path / "port.json")).read())
    want = json.loads(open(path).read())
    assert again["payload"]["cost_table"] == want["payload"]["cost_table"]

    m = zoo.vgg16(input_size=(40, 40), scale=0.1, head=False)
    dep2 = repro_torch.compile(
        m, make_pi_cluster([1.5, 1.0]),
        exec_spec=ExecSpec(autotune=True, autotune_iters=1),
        cost_table=dep.cost_table, device="cpu")
    ours = {k for k in dep2.cost_table.kernels if k.startswith("conv:cuda:")}
    assert len(ours) == len(ref_kernels)
    assert set(installed()) == ours
    assert {k: e for k, e in dep2.cost_table.kernels.items()
            if k not in ours} == ref_kernels


# ---------------------------------------------------------------------------
# overrides of the launch plan
# ---------------------------------------------------------------------------

def _c_side_takes(p, x_shape, w_shape, pool) -> bool:
    """What ``conv2d_fused_launch`` accepts (csrc/conv2d_fused.cu), and
    the plan's own rules: ``general`` takes 64 x 64 only, and a split
    keeps MIN_SPLIT_SLICES slices of K a block."""
    _, _, _, ci = x_shape
    kh, kw, _, co = w_shape
    ph, pw = pool or (1, 1)
    slices = math.ceil(kh * kw * ci / ops.BK)
    return (p.tile in ((128, 64), (64, 64)) and 1 <= p.split <= 8
            and p.split <= slices and ph * pw <= p.tile[0]
            and (p.variant == "general" or (ci % 4 == 0 and co % 4 == 0))
            and (p.variant == "ring" or p.tile == (64, 64))
            and (p.split == 1 or slices >= p.split * ops.MIN_SPLIT_SLICES))


def _launched_shapes(name, monkeypatch):
    """(x shape, w shape, stride, pool) of every conv launch of the
    tiny-zoo ``name`` as one stage split three ways, on the ``cuda``
    backend (the plain version on the CPU)."""
    m = zoo.build(name, **ZOO_TINY[name])
    seen = []
    real = ops.conv2d_fused

    def recording(x, w, b=None, *, stride=(1, 1), relu=False, pool=None,
                  **kw):
        seen.append((tuple(x.shape), tuple(w.shape),
                     ops.normalize_stride(stride),
                     None if pool is None else tuple(pool), relu))
        return real(x, w, b, stride=stride, relu=relu, pool=pool, **kw)

    monkeypatch.setattr(ops, "conv2d_fused", recording)
    StageExecutor(m, frozenset(m.graph.layers), FRACS, backend="cuda")(
        m.init(device="cpu"), {}, torch.tensor(image(m)))
    return seen


@pytest.mark.parametrize("name", sorted(ZOO_TINY))
def test_every_override_is_a_plan_the_kernel_takes(name, monkeypatch):
    """At every tile width the tiny zoo launches, each candidate resolves
    to a plan the C side takes, no deeper than asked, the same for every
    width of one key; the heuristic is one of the candidates' plans."""
    by_key: dict = {}
    for xs, ws, st, pool, relu in _launched_shapes(name, monkeypatch):
        key = shape_key(xs, ws, st, relu, pool)
        args = (*xs, ws[0], ws[1], ws[3], st, pool)
        resolved = []
        for tile, split in DEFAULT_CANDIDATES:
            p = ops.plan(*args, True, tile, split)
            assert _c_side_takes(p, xs, ws, pool), (xs, ws, p)
            assert p.split <= split
            assert p.tile == tile or p.variant == "general"
            resolved.append(p)
        assert ops.plan(*args) in resolved
        assert by_key.setdefault(key, resolved) == resolved, key


def test_plan_cache_keys_on_the_override():
    args = (1, 16, 16, 512, 3, 3, 512, (1, 1), (2, 2))
    assert ops.plan(*args) == ("ring", (64, 64), 8)
    assert ops.plan(*args, True, (128, 64), 1) == ("ring", (128, 64), 1)
    assert ops.plan(*args, True, (64, 64), 2) == ("ring", (64, 64), 2)
    assert ops.plan(*args, True, None, 4) == ("ring", (64, 64), 4)
    assert ops.plan(*args) == ("ring", (64, 64), 8)
    # general takes 64 x 64 whatever the tile; K of 3 x 3 x 3 = 2 slices
    assert ops.plan(1, 60, 60, 3, 3, 3, 64, (1, 1), None, True, (128, 64),
                    8) == ("general", (64, 64), 1)


@pytest.mark.parametrize("tile,split", [((32, 32), None), ((128, 128), 1),
                                        (None, 3), (None, 16), (None, 0)])
def test_an_override_no_plan_takes_raises(tile, split):
    with pytest.raises(ValueError):
        ops.plan(1, 16, 16, 64, 3, 3, 64, (1, 1), None, True, tile, split)
    x, w = torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 8)
    with pytest.raises(ValueError):
        ops.conv2d_fused(x, w, tile=tile, split=split)


def test_the_cuda_backend_passes_the_installed_plan(monkeypatch):
    """The ``cuda`` backend's fused conv chain asks the registry on every
    call and passes what it finds to the wrapper; nothing where nothing
    is installed.  The conv without epilogue (no key autotune makes)
    takes the heuristic plan."""
    from repro_torch.exec import backends
    m = _tiny_vgg(head=False)
    seen = []
    real = ops.conv2d_fused

    def recording(x, w, b=None, **kw):
        seen.append((kw.get("tile"), kw.get("split")))
        return real(x, w, b, **kw)

    monkeypatch.setattr(ops, "conv2d_fused", recording)
    params = m.init(device="cpu")
    x = torch.tensor(image(m))
    ex = StageExecutor(m, frozenset(m.graph.layers), FRACS)
    ex(params, {}, x)
    assert seen and set(seen) == {(None, None)}
    keys = [shape_key(d["x_shape"], d["w_shape"], d["stride"], d["relu"],
                      d["pool"]) for d in conv_shapes(m)]
    install({k: {**CUDA_ENTRY, "tile": [128, 64], "split": 4} for k in keys})
    seen.clear()
    ex(params, {}, x)
    assert seen and set(seen) == {((128, 64), 4)}
    spec = next(s for s in m.graph.layers.values() if s.kind == "conv")
    seen.clear()
    backends.get_backend("cuda")(spec, params[spec.name], x, (1, 1))
    assert seen == [(None, None)]


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def test_autotune_conv_times_each_distinct_plan_once():
    res = autotune_conv((1, 20, 20, 8), (3, 3, 8, 16), stride=(1, 1),
                        relu=True, pool=(2, 2), iters=1, device="cpu")
    plans = [p for p, _ in res.trials]
    assert len(plans) == len(set(plans))
    assert res.heuristic in plans
    # K = 72: 5 slices, so every split resolves to 1: two tiles
    assert sorted(p.tile for p in plans) == [(64, 64), (128, 64)]
    assert (res.tile, res.split) in {(p.tile, p.split) for p in plans}
    chosen = next(t for p, t in res.trials
                  if (p.tile, p.split) == (res.tile, res.split))
    assert res.best_us == pytest.approx(chosen * 1e6)
    assert res.heuristic_us > 0 and res.spread_us >= 0
    # another plan replaces the heuristic's only by more than the spread
    if (res.tile, res.split) != (res.heuristic.tile, res.heuristic.split):
        assert res.heuristic_us - res.best_us > res.spread_us
    assert set(res.entry()) == {"tile", "split", "best_us", "backend"}
    assert res.key == shape_key((1, 20, 20, 8), (3, 3, 8, 16), (1, 1),
                                True, (2, 2))


@pytest.mark.parametrize("faster_by, wins", [(0.5, False), (3.0, True)])
def test_autotune_conv_keeps_the_heuristic_within_the_spread(
        monkeypatch, faster_by, wins):
    """The fastest plan by median replaces the heuristic's only where it
    is faster by more than the larger of the two plans' spreads (the
    range of their rounds): here 2 us, the heuristic's."""
    def rounds(fns, iters, device):
        assert len(fns) == 2
        base = [10e-6, 11e-6, 12e-6, 11e-6]        # median 11 us, range 2
        return [base, [(11.0 - faster_by) * 1e-6] * 4]    # range 0

    monkeypatch.setattr(at, "_time_rounds", rounds)
    res = autotune_conv((1, 20, 20, 8), (3, 3, 8, 16), relu=True,
                        pool=(2, 2), candidates=TINY, iters=1, device="cpu")
    assert res.heuristic_us == pytest.approx(11.0)
    assert res.spread_us == pytest.approx(2.0)
    other = next(p for p, _ in res.trials if p != res.heuristic)
    got = (res.tile, res.split)
    assert got == ((other.tile, other.split) if wins
                   else (res.heuristic.tile, res.heuristic.split))
    assert res.best_us == pytest.approx(11.0 - faster_by if wins else 11.0)
    # the heuristic's win forces no plan on the layer's other widths
    entry = res.entry()
    assert (entry["tile"], entry["split"]) == (
        (list(other.tile), other.split) if wins else (None, None))


def test_default_candidates_cover_every_tile_and_split():
    assert set(DEFAULT_CANDIDATES) == {(t, s) for t in ops.TILES
                                       for s in ops.SPLITS}


def test_conv_shapes_fuses_like_the_compiler():
    m = zoo.build("vgg16", **ZOO_TINY["vgg16"])
    shapes = conv_shapes(m)
    assert shapes
    assert len(shapes) <= sum(
        1 for s in m.graph.layers.values() if s.kind == "conv")
    assert any(d["pool"] for d in shapes) and all(d["relu"] for d in shapes)
    ref_m = ref_zoo.build("vgg16", **ZOO_TINY["vgg16"])
    assert shapes == ref_autotune_mod.conv_shapes(ref_m)


def test_autotune_model_skips_warm_table_entries():
    m = zoo.build("squeezenet", **ZOO_TINY["squeezenet"])
    table, results = autotune_model(m, candidates=TINY, iters=1,
                                    device="cpu")
    assert results and len(table.kernels) == len(results)
    assert installed() == table.kernels
    table2, results2 = autotune_model(m, table=table, candidates=TINY,
                                      iters=1, device="cpu")
    assert results2 == [] and table2.kernels == table.kernels


# ---------------------------------------------------------------------------
# compile / save / load
# ---------------------------------------------------------------------------

def test_calibrate_and_autotune_run_on_the_cpu():
    """``compile(ExecSpec(calibrate=True, autotune=True))`` on the CPU:
    a ratio per stage of the initial plan, a tuned plan per conv shape,
    the re-plan on the same pieces, and outputs equal to the monolithic
    forward's within ULPs."""
    m = _tiny_vgg()
    params = params_from_numpy(np_params(m), "cpu")
    cluster = make_pi_cluster(FREQS)
    first = repro_torch.compile(m, cluster, device="cpu")
    dep = repro_torch.compile(
        m, cluster, exec_spec=ExecSpec(calibrate=True, calibrate_iters=1,
                                       autotune=True, autotune_iters=1),
        params=params, device="cpu")
    assert set(dep.cost_table.ratios) == {s.nodes for s in
                                          first.pipeline.stages}
    assert set(dep.cost_table.kernels) == {
        shape_key(d["x_shape"], d["w_shape"], d["stride"], d["relu"],
                  d["pool"]) for d in conv_shapes(m)}
    assert installed() == dep.cost_table.kernels
    assert [p.nodes for p in dep.partition.pieces] \
        == [p.nodes for p in first.partition.pieces]
    assert "autotuned" in dep.describe() and "calibrated" in dep.describe()
    x = torch.tensor(image(m))
    got, want = dep.run(x), m.forward(params, x)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **WITHIN)


def test_compile_autotunes_and_save_load_retunes_nothing(tmp_path,
                                                         monkeypatch):
    m = zoo.build("squeezenet", **ZOO_TINY["squeezenet"])
    cluster = make_pi_cluster([1.0, 0.8])
    es = ExecSpec(autotune=True, autotune_iters=1)
    orig = at.autotune_conv
    calls = []

    def counting(*a, **kw):
        calls.append(a)
        kw["candidates"] = TINY
        return orig(*a, **kw)

    monkeypatch.setattr(at, "autotune_conv", counting)
    dep = repro_torch.compile(m, cluster, exec_spec=es, device="cpu")
    assert calls, "compile(autotune=True) must run the tuner"
    n_tuned = len(dep.cost_table.kernels)
    assert n_tuned == len(calls)
    path = dep.save(tmp_path / "dep.json")

    calls.clear()
    clear_installed()
    monkeypatch.setattr(deployment_mod, "plan_with_spec", None)
    dep2 = repro_torch.Deployment.load(path, model=m, device="cpu")
    assert dep2.cost_table.kernels == dep.cost_table.kernels
    assert installed() == dep2.cost_table.kernels
    assert calls == []
    monkeypatch.undo()
    monkeypatch.setattr(at, "autotune_conv", counting)
    # a re-compile against the loaded table is also a no-op search
    repro_torch.compile(m, cluster, exec_spec=es,
                        cost_table=dep2.cost_table, device="cpu")
    assert calls == [], "warm CostTable must re-tune nothing"
    assert len(dep2.cost_table.kernels) == n_tuned


def test_cost_table_artifact_round_trips_port_kernels():
    t = CostTable(kernels={"conv:cuda:c3x8:k3x3:s1x1:r1:p2x2":
                           dict(CUDA_ENTRY)})
    t2 = artifacts.cost_table_from_json(artifacts.cost_table_to_json(t))
    assert t2.kernels == t.kernels
    assert "kernels" not in json.loads(
        artifacts.cost_table_to_json(CostTable()))["payload"]
