"""Ring attention on placed params (``models/transformer/sharded.py``'s
``ring_attention`` boundary, reached from ``forward``, ``prefill``,
``loss_fn`` and ``loss_and_grads`` with ``ring=(mesh, "model")`` and
``act_pspec``) against the JAX package's same calls with
``ring=("model", 2)`` under its sharding rules.

Four spawned gloo ranks run the port on a (2, 2) ("data", "model") mesh
of host-staged gloo sub-groups (``launch.mesh.HostGloo``, what a CUDA
mesh over gloo gets) while one JAX subprocess on four host devices
(``--xla_force_host_platform_device_count``) runs the reference under
``jax.jit`` on params placed by its ``param_pspecs``.  The port runs on
the reference's weights (``params_from_numpy``), placed by the port's
``param_pspecs``, and the same numpy tokens (4, 32).  The models are
reduced (2 layers, d 128): Llama at vocab 1000 (padded to 1024, so the
vocab mask runs sharded), Llama with a window of 24, and granite with
``moe_pspec`` (the MoE runs between rings), each with ``act_pspec``
None and ``P(("data",), "model", None)``.  Tolerances are the ones these
tests use elsewhere: logits and cache leaves within PREFILL_TOL x
max|ref| (``tests/test_torch_sharding.py``'s, the ring's
``RING_MODEL_TOL`` in ``tests/test_torch_multidevice.py``), the loss
within LOSS_REL and each gradient leaf within GRAD_REL x max|leaf|
(``tests/test_torch_training.py``).
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

from repro import configs as ref_configs
from repro.models.transformer import model as RM
from repro_torch import configs

from _torch_mesh_ranks import body_ring_sharded, run_ranks
from test_torch_sharding import PREFILL_TOL
from test_torch_training import GRAD_REL, LOSS_REL, _leaf_close

ROOT = Path(__file__).resolve().parents[1]
#: the models: (arch, vocab or None, sliding window)
MODELS = {"llama_v1000": ("llama3.2-1b", 1000, 0),
          "llama_w24": ("llama3.2-1b", None, 24),
          "granite": ("granite-moe-3b-a800m", None, 0)}
#: act_pspec: None, and the sequence over ``model``
ACTS = {"act_none": None, "act_seq": (("data",), "model", None)}
MOE_PSPEC = (("data",), None, None, None)
TOKENS = (4, 32)
#: the model of the port-only checks (the fallback, decode, refusal)
EXTRA = "llama_v1000"
LAYERS, RING = 2, 2
CASES = [(m, a) for m in MODELS for a in ACTS]
IDS = [f"{m}-{a}" for m, a in CASES]

REFERENCE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.compat import set_mesh
from repro.launch.mesh import make_mesh
from repro.launch.sharding import param_pspecs
from repro.models.transformer import model as M

inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
mesh = make_mesh((2, 2), ("data", "model"))
ring = ("model", 2)
out = {}

def save(prefix, tree):
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        out[f"{prefix}{i:03d}"] = leaf

for name, (arch, vocab, window) in spec["models"].items():
    cfg = configs.get(arch).reduced(n_layers=2, d_model=128)
    cfg = dataclasses.replace(cfg, sliding_window=window,
                              **({"vocab_size": vocab} if vocab else {}))
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    save(f"{name}_leaf", params)
    toks = jnp.asarray(inp[f"{name}_tokens"])
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
    with mesh, set_mesh(mesh):
        p = jax.device_put(params, jax.tree.map(
            lambda s: NamedSharding(mesh, s),
            param_pspecs(cfg, params, mesh),
            is_leaf=lambda x: isinstance(x, P)))
        for key, act in spec["acts"].items():
            kw = dict(ring=ring, act_pspec=P(*act) if act else None,
                      moe_pspec=P(*spec["moe"]) if cfg.is_moe else None)
            tag = f"{name}_{key}"
            out[f"{tag}_logits"] = jax.jit(lambda p, t: M.forward(
                cfg, p, {"tokens": t}, **kw))(p, toks)
            last, cache = jax.jit(lambda p, t: M.prefill(
                cfg, p, {"tokens": t}, **kw))(p, toks)
            out[f"{tag}_last"] = last
            out.update({f"{tag}_cache_{k}": c for k, c in cache.items()})
            loss, grads = jax.jit(jax.value_and_grad(lambda p: M.loss_fn(
                cfg, p, batch, **kw)))(p)
            out[f"{tag}_loss"] = loss
            save(f"{tag}_grad", grads)
        if name == spec["extra"]:
            out[f"{name}_short"] = jax.jit(lambda p, t: M.forward(
                cfg, p, {"tokens": t}, ring=ring))(p, toks[:, :-1])
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _cfgs(name):
    """(reference cfg, port cfg) of a MODELS entry."""
    arch, vocab, window = MODELS[name]
    extra = {"vocab_size": vocab} if vocab else {}
    return tuple(dataclasses.replace(
        mod.get(arch).reduced(n_layers=LAYERS, d_model=128),
        sliding_window=window, **extra) for mod in (ref_configs, configs))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    return {f"{name}_tokens": rng.integers(0, _cfgs(name)[1].vocab_size,
                                           TOKENS, dtype=np.int32)
            for name in MODELS}


@pytest.fixture(scope="module")
def weights():
    """The reference's weights of each model (``init_params`` at
    ``PRNGKey(0)``) as numpy trees, each group a plain tuple (spawned
    ranks unpickle no reference type)."""
    def plain(group):
        return {k: tuple(v) if hasattr(v, "_fields")
                else plain(v) if isinstance(v, dict) else v
                for k, v in group.items()}
    return {name: plain(jax.tree.map(np.asarray, RM.init_params(
        _cfgs(name)[0], jax.random.PRNGKey(0)))) for name in MODELS}


@pytest.fixture(scope="module")
def ref_run(inputs, tmp_path_factory):
    """The reference on four host devices, started in one subprocess that
    runs while the port's ranks do: (process, its directory)."""
    d = tmp_path_factory.mktemp("ring_sharded_ref")
    np.savez(d / "in.npz", **inputs)
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": str(d)}
    spec = {"models": MODELS, "acts": ACTS, "moe": MOE_PSPEC,
            "extra": EXTRA}
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(d / "in.npz"),
         str(d / "out.npz"), json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(inputs, weights, ref_run):
    """The port on four gloo ranks, a (2, 2) mesh: every rank's results."""
    models = {n: (_cfgs(n)[1], weights[n]) for n in MODELS}
    toks = {n: inputs[f"{n}_tokens"] for n in MODELS}
    return run_ranks(body_ring_sharded, 4, models, toks, ACTS, MOE_PSPEC,
                     EXTRA)


@pytest.fixture(scope="module")
def ref(ref_run):
    """The reference's results (waits for its subprocess)."""
    proc, d = ref_run
    try:
        _, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(d / "out.npz"))


def _keys(ref, prefix):
    return [ref[k] for k in sorted(ref) if k.startswith(prefix)]


@pytest.mark.parametrize("name,act", CASES, ids=IDS)
def test_forward_matches_the_reference(ranks, ref, name, act):
    """``forward(ring=(mesh, "model"), act_pspec=...)`` on placed params:
    the logits (gathered) within PREFILL_TOL x max|ref| of the
    reference's ``forward(ring=("model", 2), act_pspec=...)``."""
    got = ranks[0][name, act]["logits"]
    want = ref[f"{name}_{act}_logits"]
    assert got.shape == want.shape
    _leaf_close(got, want, PREFILL_TOL)


@pytest.mark.parametrize("name,act", CASES, ids=IDS)
def test_prefill_matches_the_reference(ranks, ref, name, act):
    """``prefill`` with the ring on placed params: the last logits and
    every cache leaf (gathered; the window's ring-aligned last 24) within
    PREFILL_TOL x max|ref| of the reference's, ``len`` equal."""
    got = ranks[0][name, act]
    tag = f"{name}_{act}"
    _leaf_close(got["last"], ref[f"{tag}_last"], PREFILL_TOL)
    assert sorted(got["cache"]) == sorted(
        k.removeprefix(f"{tag}_cache_") for k in ref
        if k.startswith(f"{tag}_cache_"))
    for key, t in got["cache"].items():
        want = ref[f"{tag}_cache_{key}"]
        assert t.shape == want.shape, key
        if key == "len":
            assert t == want
        else:
            _leaf_close(t, want, PREFILL_TOL)


@pytest.mark.parametrize("name,act", CASES, ids=IDS)
def test_loss_matches_the_reference(ranks, ref, name, act):
    """``loss_and_grads(ring=..., act_pspec=...)``'s loss on every rank
    within LOSS_REL of the reference's ``loss_fn`` with the same
    arguments under ``jax.value_and_grad``."""
    want = float(ref[f"{name}_{act}_loss"])
    for r in ranks:
        assert abs(r[name, act]["loss"] - want) <= LOSS_REL * abs(want)


@pytest.mark.parametrize("name,act", CASES, ids=IDS)
def test_gradients_match_jax_grad(ranks, ref, name, act):
    """Every gradient leaf (gathered) within GRAD_REL x max|leaf| of
    ``jax.value_and_grad`` of the reference's ``loss_fn`` with the ring,
    finite, and in its param's placements on every rank: under remat the
    recompute runs each ring again, and the ring's backward sends the
    dk/dv accumulators home."""
    got = ranks[0][name, act]["grads"]
    want = _keys(ref, f"{name}_{act}_grad")
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        _leaf_close(g, w, GRAD_REL)
    assert all(r[name, act]["placed"] for r in ranks)


@pytest.mark.parametrize("name,act", CASES, ids=IDS)
def test_every_rank_holds_the_same_bits(ranks, name, act):
    """The gathered logits, cache, loss and gradients of every rank equal
    rank 0's bit for bit."""
    r0 = ranks[0][name, act]
    for r in ranks[1:]:
        got = r[name, act]
        assert np.array_equal(got["logits"], r0["logits"])
        assert np.array_equal(got["last"], r0["last"])
        assert all(np.array_equal(got["cache"][k], r0["cache"][k])
                   for k in r0["cache"])
        assert got["loss"] == r0["loss"]
        assert all(np.array_equal(a, b)
                   for a, b in zip(got["grads"], r0["grads"]))


@pytest.mark.parametrize("name,act", CASES, ids=IDS)
def test_the_ring_hands_off_once_a_layer(ranks, name, act):
    """On a ``model`` axis of 2 the forward makes one hand-off a layer
    (the last rotation is skipped); ``loss_and_grads`` four (the forward,
    remat's recompute, and the backward's two: the block with its dk/dv,
    then dk/dv home).  Host tensors on gloo: every one ``direct``."""
    for r in ranks:
        assert r[name, act]["hand_offs"] == {"direct": LAYERS * (RING - 1),
                                             "host": 0}
        assert r[name, act]["grad_hand_offs"] == {
            "direct": LAYERS * (2 * (RING - 1) + RING), "host": 0}


def test_a_sequence_off_the_axis_falls_back(ranks, ref):
    """31 tokens are no multiple of the axis's 2: ``forward(ring=...)``
    takes the blockwise path (no hand-off), as the reference's does, and
    its logits are within PREFILL_TOL x max|ref| of the reference's."""
    for r in ranks:
        assert r[EXTRA, "extra"]["short_hand_offs"] == {"direct": 0,
                                                        "host": 0}
    got = ranks[0][EXTRA, "extra"]["short"]
    want = ref[f"{EXTRA}_short"]
    assert got.shape == want.shape == (TOKENS[0], TOKENS[1] - 1,
                                       want.shape[-1])
    _leaf_close(got, want, PREFILL_TOL)


def test_decode_runs_on_a_ring_prefill_cache(ranks):
    """The ring prefill's cache has the non-ring prefill's placements
    (kv heads over ``model``), and one ``decode_step`` on it (grown by a
    slot) gives the step on the non-ring prefill's cache within
    PREFILL_TOL x max|ref|."""
    for r in ranks:
        e = r[EXTRA, "extra"]
        assert e["ring_places"] == e["plain_places"]
        assert e["ring_places"]["k"] == ["Shard(dim=1)", "Shard(dim=3)"]
        _leaf_close(e["ring_step"], e["plain_step"], PREFILL_TOL)


def test_a_ring_over_another_mesh_raises(ranks):
    """A ring whose mesh is not the params' (a line of the 4 ranks)
    raises ``ValueError`` on every rank."""
    for r in ranks:
        msg = r[EXTRA, "extra"]["other_mesh"]
        assert "not the params' mesh" in msg, msg


@pytest.mark.parametrize("name", sorted(MODELS))
def test_the_reference_runs_on_the_ranks_weights(name, weights, ref):
    """The reference subprocess's weights are the ones the ranks got, leaf
    for leaf."""
    got = _keys(ref, f"{name}_leaf")
    want = jax.tree.leaves(weights[name])
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
