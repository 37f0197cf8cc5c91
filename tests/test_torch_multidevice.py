"""The port's device meshes, GPipe pipeline and ring attention
(``repro_torch.launch.mesh``, ``repro_torch.pipeline.microbatch_pipeline``,
``repro_torch.models.transformer.ring_attention`` and the ``ring=``
argument of ``forward``, ``prefill`` and ``loss_fn``) on
``torch.distributed`` gloo ranks on the CPU, against the JAX package's
``launch/mesh.py``, ``microbatch_pipeline`` and ``ring_attention``: the
counterpart of ``tests/test_multidevice.py``.

The reference runs in one JAX subprocess on four host devices
(``--xla_force_host_platform_device_count``, as in
``tests/test_multidevice.py``), and its ring attention in another on
eight, a (2, 4) ("data", "model") mesh under ``jax.jit``; the port in
spawned ranks
(``_torch_mesh_ranks.run_ranks``: one process group a run on a free
port, each run under its own time limit, every rank killed past it).
Inputs come from a numpy seed and go to both packages; the reduced
Llama's weights are the reference's, through numpy.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.transformer import model as RM
from repro_torch import configs
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.transformer.layers import blockwise_causal_attention
from repro_torch.pipeline import runner

from _torch_mesh_ranks import (body_four, body_ring, body_small, run_ranks,
                               sequential)
from test_torch_attention import TOL as ATTN_TOL
from test_torch_training import GRAD_REL, LOSS_REL

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
def four(inputs, ref, ring_inputs, ring_ref):
    """The port on four gloo ranks: every rank's results."""
    cfg = configs.get("llama3.2-1b").reduced(**LLAMA)
    leaves = [ref[k] for k in sorted(ref) if k.startswith("leaf")]
    ring = ([ring_inputs[f"s64_{t}"] for t in "qkv"],
            (_ring_cfgs("llama")[1], _numpy_tree(ring_ref, "llama"),
             ring_inputs["llama_tokens"]))
    return run_ranks(body_four, 4, inputs, (cfg, leaves, inputs["toks"]),
                     ring)


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


# -- ring attention: the reference on a (2, 4) mesh of 8 host devices -------

#: test_ring_attention_exact's shapes, (B, S, K, G, D, window)
RING_ATTN = {"s64": (2, 64, 2, 2, 16, 0), "s128": (1, 128, 1, 4, 32, 0),
             "s64_w24": (2, 64, 2, 1, 16, 24)}
#: reduced models (2 layers, d 128) of the ring's forward, prefill and
#: gradient: (arch, sliding window); granite's MoE runs between rings
RING_MODELS = {"llama": ("llama3.2-1b", 0), "llama_w24": ("llama3.2-1b", 24),
               "granite": ("granite-moe-3b-a800m", 0)}
RING_TOKENS = (2, 64)
# the reference's test_ring_attention_exact tolerance, and the model
# outputs' (measured worst: about 1.3e-6 x max|ref|)
RING_TOL = dict(rtol=2e-4, atol=2e-4)
RING_MODEL_TOL = 1e-4        # x max|ref|

RING_REFERENCE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.compat import set_mesh
from repro.launch.mesh import make_mesh
from repro.models.transformer import model as M
from repro.models.transformer.ring_attention import ring_attention

inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
mesh = make_mesh((2, 4), ("data", "model"))
ring = ("model", 4)
out = {}
with mesh, set_mesh(mesh):
    for name, (*_, w) in spec["attn"].items():
        q, k, v, do = (jnp.asarray(inp[f"{name}_{t}"])
                       for t in ("q", "k", "v", "do"))
        fn = jax.jit(lambda q, k, v, w=w: ring_attention(
            q, k, v, mesh, axis="model", sliding_window=w))
        out[f"{name}_o"], vjp = jax.vjp(fn, q, k, v)
        for t, g in zip("qkv", vjp(do)):
            out[f"{name}_d{t}"] = g
    bf = [jnp.asarray(inp[f"s64_{t}"]).astype(jnp.bfloat16) for t in "qkv"]
    out["bf16"] = jax.jit(lambda q, k, v: ring_attention(
        q, k, v, mesh, axis="model"))(*bf).astype(jnp.float32)
    for name, (arch, window) in spec["models"].items():
        cfg = configs.get(arch).reduced(n_layers=2, d_model=128)
        cfg = dataclasses.replace(cfg, sliding_window=window)
        params = M.init_params(cfg, jax.random.PRNGKey(0))
        toks = jnp.asarray(inp[f"{name}_tokens"])
        batch = {"tokens": toks, "labels": jnp.asarray(inp[f"{name}_labels"])}
        out[f"{name}_logits"] = jax.jit(lambda p, t: M.forward(
            cfg, p, {"tokens": t}, ring=ring))(params, toks)
        last, cache = jax.jit(lambda p, t: M.prefill(
            cfg, p, {"tokens": t}, ring=ring))(params, toks)
        out[f"{name}_last"] = last
        out.update({f"{name}_cache_{k}": c for k, c in cache.items()})
        loss, grads = jax.jit(jax.value_and_grad(lambda p: M.loss_fn(
            cfg, p, batch, ring=ring)))(params)
        out[f"{name}_loss"] = loss
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[f"{name}_grad{i:03d}"] = g
        for i, leaf in enumerate(jax.tree.leaves(params)):
            out[f"{name}_leaf{i:03d}"] = leaf
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _ring_cfgs(name):
    """(reference cfg, port cfg) of a RING_MODELS entry."""
    arch, window = RING_MODELS[name]
    return tuple(dataclasses.replace(
        c.get(arch).reduced(n_layers=2, d_model=128), sliding_window=window)
        for c in (ref_configs, configs))


@pytest.fixture(scope="module")
def ring_inputs():
    rng = np.random.default_rng(1)
    f32 = np.float32
    out = {}
    for name, (b, s, k, g, d, _) in RING_ATTN.items():
        out.update({f"{name}_q": rng.standard_normal((b, s, k, g, d)),
                    f"{name}_k": rng.standard_normal((b, s, k, d)),
                    f"{name}_v": rng.standard_normal((b, s, k, d)),
                    f"{name}_do": rng.standard_normal((b, s, k, g, d))})
    out = {n: a.astype(f32) for n, a in out.items()}
    for name in RING_MODELS:
        vocab = _ring_cfgs(name)[1].vocab_size
        for t in ("tokens", "labels"):
            out[f"{name}_{t}"] = rng.integers(0, vocab, RING_TOKENS,
                                              dtype=np.int32)
    return out


@pytest.fixture(scope="module")
def ring_ref(ring_inputs, tmp_path_factory):
    """The reference's ring results on eight host devices (one
    subprocess)."""
    d = tmp_path_factory.mktemp("ring_ref")
    np.savez(d / "in.npz", **ring_inputs)
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(d)}
    spec = {"attn": RING_ATTN, "models": RING_MODELS}
    res = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(RING_REFERENCE), str(d / "in.npz"),
                          str(d / "out.npz"), json.dumps(spec)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def _numpy_tree(ref, name):
    """The reference's params of RING_MODELS[name] (its leaves from the
    subprocess) as a numpy tree for ``params_from_numpy``, each group a
    plain tuple (spawned ranks unpickle no reference type)."""
    rcfg = _ring_cfgs(name)[0]
    shape = jax.eval_shape(lambda: RM.init_params(rcfg,
                                                  jax.random.PRNGKey(0)))
    leaves = [ref[k] for k in sorted(ref) if k.startswith(f"{name}_leaf")]
    tree = jax.tree.unflatten(jax.tree.structure(shape), leaves)

    def plain(group):
        return {k: tuple(v) if hasattr(v, "_fields")
                else plain(v) if isinstance(v, dict) else v
                for k, v in group.items()}
    return plain(tree)


@pytest.fixture(scope="module")
def ring(ring_inputs, ring_ref):
    """The port on eight gloo ranks, a (2, 4) ("data", "model") mesh:
    every rank's results."""
    models = {n: (_ring_cfgs(n)[1], _numpy_tree(ring_ref, n))
              for n in RING_MODELS}
    return run_ranks(body_ring, 8, ring_inputs, RING_ATTN, models)


def _close_to_max(got, want, rel):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _all_ranks(ring, *path):
    """``path``'s value on every rank, after checking that every rank
    holds the same bits."""
    vals = []
    for r in ring:
        for p in path:
            r = r[p]
        vals.append(r)
    _ranks_equal(vals)
    return vals[0]


@pytest.mark.parametrize("case", sorted(RING_ATTN))
def test_ring_attention_exact(case, ring, ring_ref, ring_inputs):
    """``ring_attention`` on a (2, 4) mesh (each data row a ring of four):
    every rank returns the global output, the same bits on all eight,
    within the reference test's 2e-4 of the reference's ring and of the
    port's one-process attention; three hand-offs (m - 1: the last
    rotation, which only brings k/v home, is skipped)."""
    got = _all_ranks(ring, case, "o")
    np.testing.assert_allclose(got, ring_ref[f"{case}_o"], **RING_TOL)
    q, k, v = (torch.tensor(ring_inputs[f"{case}_{t}"]) for t in "qkv")
    one = blockwise_causal_attention(q, k, v, RING_ATTN[case][-1],
                                     backend="torch")
    np.testing.assert_allclose(got, one.numpy(), **RING_TOL)
    for r in ring:
        assert r[case]["hand_offs"] == {"direct": 3, "host": 0}


@pytest.mark.parametrize("case", sorted(RING_ATTN))
def test_ring_attention_backward_matches_jax_vjp(case, ring, ring_ref,
                                                 ring_inputs):
    """dq, dk, dv of ``RingAttention``'s backward (a second ring that
    carries the dk/dv accumulators home: four hand-offs), the same bits
    on every rank, within GRAD_REL x max|ref| of ``jax.vjp`` of the
    reference's ring and of the port's plain backward."""
    q, k, v, do = (torch.tensor(ring_inputs[f"{case}_{t}"])
                   for t in ("q", "k", "v", "do"))
    w = RING_ATTN[case][-1]
    plain = attn_ref.flash_prefill_bwd_ref(
        q, k, v, attn_ref.flash_prefill_ref(q, k, v, w), do, w)
    for t, one in zip("qkv", plain):
        got = _all_ranks(ring, case, f"d{t}")
        _close_to_max(got, ring_ref[f"{case}_d{t}"], GRAD_REL)
        _close_to_max(got, one.numpy(), GRAD_REL)
    for r in ring:
        assert r[case]["bwd_hand_offs"] == {"direct": 4, "host": 0}


def test_ring_attention_bf16(ring, ring_ref, ring_inputs):
    """bf16 inputs (scores, softmax and sums in fp32, p rounded to bf16
    before the PV product, as the reference's): within the port's bf16
    attention band of the reference's bf16 ring and of the port's
    one-process bf16 attention."""
    got = _all_ranks(ring, "bf16")
    np.testing.assert_allclose(got, ring_ref["bf16"], **ATTN_TOL["bfloat16"])
    q, k, v = (torch.tensor(ring_inputs[f"s64_{t}"]).bfloat16()
               for t in "qkv")
    one = blockwise_causal_attention(q, k, v, backend="torch").float()
    np.testing.assert_allclose(got, one.numpy(), **ATTN_TOL["bfloat16"])


@pytest.mark.parametrize("name", sorted(RING_MODELS))
def test_forward_with_ring_matches_the_reference(name, ring, ring_ref):
    """``forward(ring=(mesh, "model"))`` of a reduced model on the
    reference's weights: logits within 1e-4 x max|ref| of the reference's
    ``forward(ring=("model", 4))``, the same bits on every rank, and
    three hand-offs for each of the two attention layers."""
    got = _all_ranks(ring, name, "logits")
    assert got.shape == ring_ref[f"{name}_logits"].shape
    _close_to_max(got, ring_ref[f"{name}_logits"], RING_MODEL_TOL)
    for r in ring:
        assert r[name]["hand_offs"] == {"direct": 6, "host": 0}


@pytest.mark.parametrize("name", sorted(RING_MODELS))
def test_prefill_with_ring_matches_the_reference(name, ring, ring_ref):
    """``prefill(ring=...)``: the last position's logits and every cache
    leaf (each layer's k/v, window-trimmed where the window is set) within
    1e-4 x max|ref| of the reference's, the same bits on every rank."""
    _close_to_max(_all_ranks(ring, name, "last"), ring_ref[f"{name}_last"],
                  RING_MODEL_TOL)
    cache = ring[0][name]["cache"]
    assert sorted(cache) == sorted(k.removeprefix(f"{name}_cache_")
                                   for k in ring_ref
                                   if k.startswith(f"{name}_cache_"))
    for key in cache:
        got = _all_ranks(ring, name, "cache", key)
        want = ring_ref[f"{name}_cache_{key}"]
        if key == "len":
            assert got == want
        else:
            _close_to_max(got, want, RING_MODEL_TOL)


@pytest.mark.parametrize("name", sorted(RING_MODELS))
def test_loss_fn_gradient_with_ring_matches_jax_grad(name, ring, ring_ref):
    """``loss_and_grads(ring=...)`` (``loss_fn`` with remat on, so the
    backward's recompute runs each ring again): the loss within LOSS_REL
    and every gradient leaf, in ``jax.tree``'s order, within GRAD_REL x
    max|leaf| of ``jax.value_and_grad`` of the reference's
    ``loss_fn(ring=...)``; the same bits on every rank."""
    want_loss = float(ring_ref[f"{name}_loss"])
    for r in ring:
        assert abs(r[name]["loss"] - want_loss) <= LOSS_REL * abs(want_loss)
    want = [ring_ref[k] for k in sorted(ring_ref)
            if k.startswith(f"{name}_grad")]
    got = ring[0][name]["grads"]
    assert [g.shape for g in got] == [w.shape for w in want]
    for i, w in enumerate(want):
        _close_to_max(_all_ranks(ring, name, "grads", i), w, GRAD_REL)


@pytest.mark.parametrize("name", sorted(RING_MODELS))
def test_ring_takes_the_blockwise_path_off_the_axis_multiple(name, ring):
    """62 tokens on a ring of four (62 % 4 != 0): every layer runs the
    one-process attention, as the reference's rule says: no hand-off,
    and the logits equal ``forward`` without ``ring`` bit for bit."""
    for r in ring:
        assert r[name]["short_hand_offs"] == {"direct": 0, "host": 0}
        assert np.array_equal(r[name]["short"], r[name]["short_plain"])


@pytest.mark.parametrize("case,words", [
    ("axis_size", ("axis_size 2", "4 ranks")),
    ("seq", ("62", "4 ranks")),
    ("shape", ("(B,S,K,G,D)",))])
def test_ring_attention_refusals(case, words, ring):
    """An ``axis_size`` other than the axis's, a sequence no multiple of
    it, and k/v that do not fit q: ValueError on every rank."""
    for r in ring:
        for w in words:
            assert w in r["raises"][case], r["raises"][case]


def test_pipeline_hand_offs_are_ring_shifts(four):
    """The pipeline's hand-offs go through ``launch.mesh.ring_shift``, the
    port's one hand-off, and count in its counter: 4 + 6 - 1 = 9 a rank
    for the 4-stage, 6-microbatch call; ``pipeline.runner`` reads the
    same counter."""
    assert runner.HAND_OFFS is mesh_mod.HAND_OFFS
    assert runner.stages_on_host is mesh_mod.stages_on_host
    for r in four:
        assert r["exact_hand_offs"] == {"direct": 9, "host": 0}


def test_ring_on_four_ranks_matches_the_eight(four, ring):
    """The 4-rank run's line mesh as the ring (``ring=(line, "stage")``):
    ``ring_attention`` and the reduced Llama's ``forward`` give the same
    bits as each data row of the (2, 4) mesh."""
    for key in ("o", "logits"):
        got = _all_ranks(four, "ring", key)
        want = ring[0]["s64"]["o"] if key == "o" else ring[0]["llama"]["logits"]
        assert np.array_equal(got, want)
