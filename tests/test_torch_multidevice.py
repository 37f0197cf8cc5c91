"""The port's device meshes and GPipe pipeline (``repro_torch.launch.mesh``,
``repro_torch.pipeline.microbatch_pipeline``) on ``torch.distributed``
gloo ranks on the CPU, against the JAX package's ``launch/mesh.py`` and
``microbatch_pipeline``: the counterpart of ``tests/test_multidevice.py``.

The reference runs in one JAX subprocess on four host devices
(``--xla_force_host_platform_device_count``, as in
``tests/test_multidevice.py``); the port in spawned ranks
(``_torch_mesh_ranks.run_ranks``: one process group a run on a free
port, each run under its own time limit, every rank killed past it).
Inputs come from a numpy seed and go to both packages; the reduced
Llama's weights are the reference's, through numpy.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod

from _torch_mesh_ranks import (body_four, body_small, run_ranks,
                               sequential)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6       # test_microbatch_pipeline_exact's tolerance
# the reduced Llama split: both packages' attention and matmuls sum in
# other orders, through 8 layers (measured worst: about 1e-6 x max|ref|)
LLAMA_TOL = 1e-4              # x max|ref|
LLAMA = dict(n_layers=8, d_model=128)   # examples/pico_pod_pipeline.py's

REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.launch.mesh import batch_axes, make_mesh, make_test_mesh
from repro.models.transformer import model as M
from repro.models.transformer.layers import attention_prefill, mlp, rms_norm
from repro.pipeline.runner import microbatch_pipeline

inp = dict(np.load(sys.argv[1]))
ws, xs = jnp.asarray(inp["ws"]), jnp.asarray(inp["xs"])
fn = lambda sid, w, x: jnp.tanh(x @ w)
line = make_mesh((4,), ("stage",))
out = {"exact": microbatch_pipeline(fn, ws, xs, line),
       "micro2": microbatch_pipeline(fn, ws, jnp.asarray(inp["xs2"]), line),
       "micro1": microbatch_pipeline(fn, ws, jnp.asarray(inp["xs1"]), line),
       "ws1": microbatch_pipeline(fn, ws[:1], xs, make_mesh((1,), ("stage",))),
       "ws2": microbatch_pipeline(fn, ws[:2], xs, make_mesh((2,), ("stage",))),
       "mesh22": microbatch_pipeline(fn, ws[:2], xs,
                                     make_mesh((2, 2), ("data", "stage")))}

cfg = configs.get("llama3.2-1b").reduced(**json.loads(sys.argv[3]))
params = M.init_params(cfg, jax.random.PRNGKey(0))
stages = jax.tree.map(lambda a: a.reshape(4, -1, *a.shape[1:]),
                      params["layers"])

def stage_fn(sid, lp, x):
    def body(x, one):
        h, _ = attention_prefill(
            one["attn"], rms_norm(x, one["ln1"], cfg.norm_eps),
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
            rope_theta=cfg.rope_theta, sliding_window=cfg.sliding_window)
        x = x + h
        x = x + mlp(one["mlp"], rms_norm(x, one["ln2"], cfg.norm_eps))
        return x, None
    return jax.lax.scan(body, x, lp)[0]

xs_l = params["embed"][jnp.asarray(inp["toks"])]
out["llama"] = microbatch_pipeline(stage_fn, stages, xs_l, line)
for i, leaf in enumerate(jax.tree.leaves(params)):
    out[f"leaf{i:03d}"] = leaf
meshes = {"test_mesh": {n: [list(make_test_mesh(n).devices.shape),
                            list(make_test_mesh(n).axis_names)]
                        for n in (1, 2, 4)},
          "batch_axes": [list(batch_axes(m)) for m in (
              make_test_mesh(4), make_mesh((1, 2, 2), ("pod", "data", "model")),
              line)]}
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print(json.dumps(meshes))
"""


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    cfg = configs.get("llama3.2-1b").reduced(**LLAMA)
    return {"ws": (rng.standard_normal((4, 16, 16)) * 0.1).astype(f32),
            "xs": rng.standard_normal((6, 2, 16)).astype(f32),
            "xs2": rng.standard_normal((2, 2, 16)).astype(f32),
            "xs1": rng.standard_normal((1, 2, 16)).astype(f32),
            "toks": rng.integers(0, cfg.vocab_size, (6, 2, 64))}


@pytest.fixture(scope="module")
def ref(inputs, tmp_path_factory):
    """The reference's results on four host devices (one subprocess)."""
    d = tmp_path_factory.mktemp("ref")
    np.savez(d / "in.npz", **inputs)
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(d)}
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                          str(d / "in.npz"), str(d / "out.npz"),
                          json.dumps(LLAMA)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    out = dict(np.load(d / "out.npz"))
    out.update(json.loads(res.stdout.splitlines()[-1]))
    return out


@pytest.fixture(scope="module")
def four(inputs, ref):
    """The port on four gloo ranks: every rank's results."""
    cfg = configs.get("llama3.2-1b").reduced(**LLAMA)
    leaves = [ref[k] for k in sorted(ref) if k.startswith("leaf")]
    return run_ranks(body_four, 4, inputs, (cfg, leaves, inputs["toks"]))


@pytest.fixture(scope="module")
def small(inputs):
    """The port on one and on two gloo ranks."""
    return {n: run_ranks(body_small, n, inputs) for n in (1, 2)}


def _ranks_equal(outs):
    for r, o in enumerate(outs[1:], 1):
        assert np.array_equal(o, outs[0]), f"rank {r} differs from rank 0"


def test_microbatch_pipeline_exact(four, ref, inputs):
    """4 stages, 6 microbatches of tanh(x @ w): every rank returns the
    same bits, the reference's result and the sequential composition."""
    outs = [r["exact"] for r in four]
    _ranks_equal(outs)
    np.testing.assert_allclose(outs[0], ref["exact"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[0], sequential(inputs["ws"],
                                                   inputs["xs"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["micro2", "micro1", "ws1", "ws2",
                                  "mesh22"])
def test_pipeline_edges_match_the_reference(case, four, small, ref, inputs):
    """Fewer microbatches than stages (2 of 4), one microbatch, one stage
    (world size 1: no P2P), two stages, and a (2, 2) ("data", "stage")
    mesh whose two data groups each run their own 2-stage ring on the
    same replicated inputs."""
    if case.startswith("ws"):
        outs = [r["pipe"] for r in small[int(case[2:])]]
    else:
        outs = [r[case] for r in four]
    _ranks_equal(outs)
    np.testing.assert_allclose(outs[0], ref[case], rtol=RTOL, atol=ATOL)
    n_stages = {"ws1": 1, "ws2": 2, "mesh22": 2}.get(case, 4)
    xs = inputs["xs" + {"micro2": "2", "micro1": "1"}.get(case, "")]
    np.testing.assert_allclose(outs[0],
                               sequential(inputs["ws"][:n_stages], xs),
                               rtol=RTOL, atol=ATOL)


def test_reduced_llama_split_matches_the_reference(four, ref):
    """The example's setting: Llama-3.2-1B reduced to 8 layers of d 128,
    4 stages of 2 layers, 6 microbatches of (2, 64) tokens, on the
    reference's weights; the port's attention through the kernel
    wrapper (its plain version on the CPU)."""
    outs = [r["llama"] for r in four]
    _ranks_equal(outs)
    want = ref["llama"]
    assert outs[0].shape == want.shape == (6, 2, 64, 128)
    err = np.abs(outs[0] - want).max()
    assert err <= LLAMA_TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("n", [1, 2, 4])
def test_make_test_mesh_shape_is_the_references(n, four, small, ref):
    got = (four[0] if n == 4 else small[n][0])["test_mesh"]
    assert [list(got[0]), list(got[1])] == ref["test_mesh"][str(n)]


def test_make_mesh_names_and_sizes(four):
    assert four[0]["make_mesh"] == [((4,), ("stage",)),
                                    ((2, 2), ("data", "stage"))]


@pytest.mark.parametrize("i,axes", list(enumerate(
    [("data", "model"), ("pod", "data", "model"), ("stage",)])))
def test_batch_axes_are_the_references(i, axes, four, ref):
    assert list(four[0]["batch_axes"][i]) == ref["batch_axes"][i]


@pytest.mark.parametrize("case,numbers", [
    ("production", ("256", "4")), ("production_multi_pod", ("512", "4")),
    ("world", ("2", "4"))])
def test_make_mesh_refuses_a_world_of_another_size(case, numbers, four):
    msg = four[0]["raises"][case]
    assert "world size" in msg
    for n in numbers:
        assert n in msg


@pytest.mark.parametrize("case,words", [
    ("leading_dim", ("leading dimension 3", "4 stages")),
    ("shape", ("(2, 8)", "(2, 16)")),
    ("dtype", ("torch.float64", "torch.float32"))])
def test_microbatch_pipeline_refusals(case, words, four):
    """A stacked leaf whose leading dimension is not the axis's size, and
    a stage_fn that changes its input's shape or dtype: ValueError."""
    for r in four:
        for w in words:
            assert w in r["raises"][case], r["raises"][case]


@pytest.mark.parametrize("make", [
    lambda: mesh_mod.make_mesh((1,), ("stage",)),
    lambda: mesh_mod.make_test_mesh(4),
    lambda: mesh_mod.make_production_mesh()],
    ids=["make_mesh", "make_test_mesh", "make_production_mesh"])
def test_a_cuda_mesh_needs_a_card(make, monkeypatch):
    """The default device type is "cuda"; without a CUDA device the mesh
    builders raise, and never build a CPU mesh instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
