"""The port's planning and execution half against the JAX package's:
planner, halo tiles, stage executor, runner and ``compile(...).run``.

The planner is a framework-free copy, so its plans must be *identical*.
Execution compares tensors: within the port to 1e-6 (the same fp32
operations, regrouped by tiling, fusion or batch folding, which can only
move ULPs), and across packages with the model tests' rtol 1e-4 /
atol 1e-5 (XLA and PyTorch sum in different orders).
"""

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import make_pi_cluster as ref_pi_cluster
from repro.core import plan_with_spec as ref_plan_with_spec
from repro.models.cnn import zoo as ref_zoo
from repro.pipeline.halo import plan_tiles as ref_plan_tiles
from repro_torch.api.specs import ExecSpec
from repro_torch.core import make_pi_cluster, plan_with_spec
from repro_torch.exec.cache import cache_stats, clear_cache
from repro_torch.models.cnn import params_from_numpy, zoo
from repro_torch.pipeline import PipelineRunner, StageExecutor, plan_tiles

from _torch_cases import ZOO_TINY, image, np_params

CROSS = dict(rtol=1e-4, atol=1e-5)
WITHIN = dict(rtol=1e-6, atol=1e-6)
FREQS = [1.5, 1.2, 1.0, 0.8]
FRACS = [0.4, 0.35, 0.25]


def _close(a, b, tol):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), **tol)


def _np(d):
    return {k: v.numpy() for k, v in d.items()}


@pytest.mark.parametrize("name", ["vgg16", "resnet34"])
def test_planner_gives_the_reference_plan(name):
    ref = ref_zoo.build(name, **ZOO_TINY[name])
    port = zoo.build(name, **ZOO_TINY[name])
    a = ref_plan_with_spec(ref.graph, ref_pi_cluster(FREQS), ref.input_size)
    b = plan_with_spec(port.graph, make_pi_cluster(FREQS), port.input_size)
    assert [p.nodes for p in b.partition.pieces] \
        == [p.nodes for p in a.partition.pieces]
    assert len(b.pipeline.stages) == len(a.pipeline.stages)
    for sa, sb in zip(a.pipeline.stages, b.pipeline.stages):
        assert sb.nodes == sa.nodes
        assert [d.name for d in sb.devices] == [d.name for d in sa.devices]
        assert list(sb.fractions) == list(sa.fractions)
    assert b.period == a.period and b.latency == a.latency

    # and the halo tiles of every stage
    for sa, sb in zip(a.pipeline.stages, b.pipeline.stages):
        ta = ref_plan_tiles(ref.graph, sa.nodes, ref.full_sizes,
                            ref.input_size, list(sa.fractions))
        tb = plan_tiles(port.graph, sb.nodes, port.full_sizes,
                        port.input_size, list(sb.fractions))
        assert [t.signature() for t in tb] == [t.signature() for t in ta]


@pytest.mark.parametrize("name", sorted(ZOO_TINY))
def test_plan_tiles_gives_the_reference_ranges(name):
    ref = ref_zoo.build(name, **ZOO_TINY[name])
    port = zoo.build(name, **ZOO_TINY[name])
    nodes = frozenset(ref.graph.layers)
    ta = ref_plan_tiles(ref.graph, nodes, ref.full_sizes, ref.input_size,
                        FRACS)
    tb = plan_tiles(port.graph, nodes, port.full_sizes, port.input_size,
                    FRACS)
    assert [t.signature() for t in tb] == [t.signature() for t in ta]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", sorted(ZOO_TINY))
def test_tiled_stage_matches_monolithic_and_eager(name, backend):
    """Whole model as one stage split [0.4, 0.35, 0.25]: compiled (fused
    conv->pool on ``cuda``) == eager (unfused) == monolithic forward."""
    m = zoo.build(name, **ZOO_TINY[name])
    params = params_from_numpy(np_params(m), device="cpu")
    x = torch.tensor(image(m))
    nodes = frozenset(m.graph.layers)
    compiled = StageExecutor(m, nodes, FRACS, backend=backend)(params, {}, x)
    eager = StageExecutor(m, nodes, FRACS, backend=backend,
                          mode="eager")(params, {}, x)
    mono = m.forward(params, x, backend=backend)
    _close(_np(compiled), _np(eager), WITHIN)
    _close(_np(compiled), _np(mono), WITHIN)


def test_compiled_stage_fuses_conv_pool_chains():
    m = zoo.build("vgg16", **ZOO_TINY["vgg16"])
    ex = StageExecutor(m, frozenset(m.graph.layers), FRACS)
    x = torch.zeros(1, 40, 40, 3)
    cs = ex._executable(ex.boundary_inputs({}, x))
    assert len(cs.fusion) == 5                     # every conv -> pool
    torch_ex = StageExecutor(m, frozenset(m.graph.layers), FRACS,
                             backend="torch")
    assert torch_ex._executable(torch_ex.boundary_inputs({}, x)).fusion == {}


@pytest.mark.parametrize("mode", ["compiled", "eager"])
def test_batch_folded_run_frames_matches_per_frame_loop(mode):
    m = zoo.vgg16(input_size=(40, 40), scale=0.1, head=True)
    params = params_from_numpy(np_params(m), device="cpu")
    dep = repro_torch.compile(m, make_pi_cluster(FREQS),
                              exec_spec=ExecSpec(mode=mode), params=params,
                              device="cpu")
    frames = torch.tensor(image(m, n=3)).unsqueeze(1)    # (F, 1, H, W, C)
    stacked = dep.runner.run_frames(params, frames)
    for f in range(frames.shape[0]):
        one = dep.runner(params, frames[f])
        _close(_np({k: v[f] for k, v in stacked.items()}), _np(one), WITHIN)


def test_compile_run_matches_reference_deployment():
    """``repro_torch.compile(...).run`` vs ``repro.compile(...).run`` on
    tiny VGG16 with its head, 4-Pi cluster, the same params and frames."""
    ref_m = ref_zoo.vgg16(input_size=(40, 40), scale=0.1, head=True)
    m = zoo.vgg16(input_size=(40, 40), scale=0.1, head=True)
    p_np = np_params(ref_m)
    ref_dep = repro.compile(ref_m, ref_pi_cluster(FREQS))
    dep = repro_torch.compile(m, make_pi_cluster(FREQS),
                              params=params_from_numpy(p_np, "cpu"),
                              device="cpu")
    assert dep.exec_spec.backend is None          # resolves to "cuda"
    assert [s.nodes for s in dep.pipeline.stages] \
        == [s.nodes for s in ref_dep.pipeline.stages]
    assert dep.period == ref_dep.period
    x = image(m, n=1)
    _close(_np(dep.run(x)), ref_dep.run(x, params=p_np), CROSS)
    frames = [image(m, seed=s) for s in (2, 3, 4)]
    for got, want in zip(dep.run(frames), ref_dep.run(frames, params=p_np)):
        _close(_np(got), want, CROSS)
    assert "runs on cpu" in dep.describe()


def test_runner_on_the_torch_backend_matches_reference_runner():
    from repro.pipeline import PipelineRunner as RefRunner
    ref_m = ref_zoo.resnet34(**ZOO_TINY["resnet34"])
    m = zoo.resnet34(**ZOO_TINY["resnet34"])
    p_np = np_params(ref_m)
    pa = ref_plan_with_spec(ref_m.graph, ref_pi_cluster(FREQS),
                            ref_m.input_size)
    pb = plan_with_spec(m.graph, make_pi_cluster(FREQS), m.input_size)
    x = image(m)
    want = RefRunner(ref_m, pa.pipeline, backend="xla")(p_np, x)
    got = PipelineRunner(m, pb.pipeline, backend="torch")(
        params_from_numpy(p_np, "cpu"), torch.tensor(x))
    _close(_np(got), want, CROSS)


def test_stage_cache_hits_and_metrics():
    clear_cache()
    m = zoo.vgg16(input_size=(40, 40), scale=0.1, head=False)
    params = params_from_numpy(np_params(m), device="cpu")
    dep = repro_torch.compile(m, make_pi_cluster(FREQS), params=params,
                              device="cpu")
    x = torch.tensor(image(m))
    dep.run(x)
    first = cache_stats().snapshot()
    assert first.misses == len(dep.pipeline.stages) and first.hits == 0
    dep.run(x)
    assert cache_stats().since(first).hits == len(dep.pipeline.stages)
    snap = dep.metrics_snapshot()
    names = {k.split("{")[0] for k in repro_torch.obs.flatten(snap)}
    assert {"exec.cache.hits", "exec.cache.misses",
            "exec.cache.evictions", "exec.cache.entries"} <= names
