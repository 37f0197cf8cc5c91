"""The port's sharding rules as DTensor placements
(``repro_torch.launch.sharding``, the local-shard boundaries of
``repro_torch.models.transformer.sharded`` and ``act_pspec``/``moe_pspec``
on ``forward``, ``loss_fn``, ``prefill`` and ``make_train_step``) against
the JAX package's ``launch/sharding.py`` and its sharded ``jax.jit`` runs.

The rules are compared on shapes alone: the reference's read only
``mesh.shape[axis]``, so a namespace whose ``shape`` is a mapping serves
it without devices.  The sharded runs use spawned gloo ranks on the CPU
(``_torch_mesh_ranks.run_ranks``) against one JAX subprocess on eight
host devices (``--xla_force_host_platform_device_count``): the
counterpart of ``tests/test_multidevice.py``'s ``test_sharded_train_step``
on a (2, 4) ("data", "model") mesh, and gradients with
``act_pspec=P(("data",), "model", None)`` on a (2, 2) mesh.  The port
runs on the reference's weights (``params_from_numpy``) and the same
numpy tokens.  Tolerances are ``tests/test_torch_training.py``'s: the
loss within LOSS_REL, each gradient leaf within GRAD_REL x max|leaf|, and
the new params after one AdamW step (lr 1e-3, eps 1e-6) within 1e-5.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP
from torch.distributed.tensor import Replicate, Shard

from repro import configs as ref_configs
from repro.launch import sharding as ref_sharding
from repro.models.transformer import model as RM
from repro_torch import configs
from repro_torch.launch import sharding
from repro_torch.launch.sharding import P
from repro_torch.models.transformer import model as M
from repro_torch.training import (AdamW, loss_and_grads, make_train_step,
                                  tree)

from _torch_mesh_ranks import body_shard_grads, body_shard_step, run_ranks
from test_torch_training import GRAD_REL, LOSS_REL, _leaf_close

ROOT = Path(__file__).resolve().parents[1]

# -- the rules ---------------------------------------------------------------

#: reduced configs of the rules: dense, QKV bias, MoE, Mamba2, hybrid
RULE_ARCHS = ["llama3.2-1b", "qwen1.5-0.5b", "granite-moe-3b-a800m",
              "mamba2-370m", "zamba2-2.7b"]
#: meshes by axis sizes: dividing, non-dividing (3), and with a pod axis
RULE_MESHES = {"data2_model4": {"data": 2, "model": 4},
               "data2_model3": {"data": 2, "model": 3},
               "pod2_data2_model2": {"pod": 2, "data": 2, "model": 2}}
RULE_KINDS = ["params", "batch", "cache_feature", "cache_sequence"]
RULE_BATCH, RULE_SEQ = 4, 32


def _rule_specs(arch, sizes, kind):
    """(reference's specs, port's specs) of ``kind`` for the reduced
    ``arch`` on a mesh of ``sizes``, each as a list of tuples in
    ``jax.tree.leaves``' order."""
    rcfg = ref_configs.get(arch).reduced(n_layers=2, d_model=128)
    cfg = configs.get(arch).reduced(n_layers=2, d_model=128)
    mesh = types.SimpleNamespace(shape=dict(sizes))
    daxes = tuple(a for a in ("pod", "data") if a in sizes)
    shape = (RULE_BATCH, RULE_SEQ)
    if kind == "params":
        ref = ref_sharding.param_pspecs(rcfg, jax.eval_shape(
            lambda: RM.init_params(rcfg, jax.random.PRNGKey(0))), mesh)
        port = sharding.param_pspecs(cfg, M.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"), sizes)
    elif kind == "batch":
        ref = ref_sharding.batch_pspecs(
            rcfg, {k: jax.ShapeDtypeStruct(shape, np.int32)
                   for k in ("tokens", "labels")}, mesh, daxes)
        port = sharding.batch_pspecs(
            cfg, {k: torch.zeros(shape, dtype=torch.int32)
                  for k in ("tokens", "labels")}, sizes, daxes)
    else:
        mode = kind.removeprefix("cache_")
        ref = ref_sharding.cache_pspecs(rcfg, jax.eval_shape(
            lambda: RM.init_cache(rcfg, *shape)), mesh, daxes, mode=mode)
        port = sharding.cache_pspecs(cfg, M.init_cache(cfg, *shape,
                                                       device="cpu"),
                                     sizes, daxes, mode=mode)
    ref = [tuple(s) for s in jax.tree.leaves(
        ref, is_leaf=lambda x: isinstance(x, RefP))]
    return ref, [tuple(s) for s in tree.leaves(port)]


@pytest.mark.parametrize("kind", RULE_KINDS)
@pytest.mark.parametrize("mesh", sorted(RULE_MESHES))
@pytest.mark.parametrize("arch", RULE_ARCHS)
def test_rules_match_the_reference(arch, mesh, kind):
    """``param_pspecs``, ``batch_pspecs`` and ``cache_pspecs`` (both
    modes) give the reference's spec leaf for leaf, on the same shapes:
    a dividing mesh, one whose model axis (3) divides nothing and one
    with a pod axis."""
    ref, port = _rule_specs(arch, RULE_MESHES[mesh], kind)
    assert len(port) == len(ref)
    assert port == ref


FAKE_MESH = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                  shape=(2, 2, 2))


@pytest.mark.parametrize("spec,want", [
    (P(("pod", "data"), None, "model"), (Shard(0), Shard(0), Shard(2))),
    (P(None, "data"), (Replicate(), Shard(1), Replicate())),
    (P(), (Replicate(), Replicate(), Replicate())),
    (P("stage", None), "names axis 'stage'"),
    (P("model", "model"), "names axis 'model' twice"),
    (P(("data", "pod"), None), "in the mesh's order")],
    ids=["pod_data_model", "data", "empty", "missing_axis", "twice",
         "order"])
def test_placements_of_specs(spec, want):
    """A spec's placements: ``Shard(d)`` on each axis it names for dim d,
    ``Replicate()`` elsewhere, a tuple of axes in the mesh's order;
    ``ValueError`` for an axis the mesh lacks, one named twice, or a
    tuple out of the mesh's order."""
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            sharding.placements(spec, FAKE_MESH)
    else:
        assert sharding.placements(spec, FAKE_MESH) == want


def test_uneven_shards_are_refused():
    """The rules replicate a dim that does not divide its axes; a spec
    that shards one anyway is refused, never split unevenly."""
    sizes = {"data": 2, "model": 3}
    sharding.check_divides((4, 6), P("data", "model"), sizes)
    with pytest.raises(ValueError, match="does not divide"):
        sharding.check_divides((4, 128), P("data", "model"), sizes)
    with pytest.raises(ValueError, match="entries"):
        sharding.check_divides((4, 6), P("data"), sizes)


def _plain_setup():
    cfg = configs.get("llama3.2-1b").reduced(n_layers=2, d_model=64)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.zeros((2, 16), dtype=torch.long)
    return cfg, params, {"tokens": toks, "labels": toks}


@pytest.mark.parametrize("entry", ["forward", "loss_fn", "prefill",
                                   "train_step"])
@pytest.mark.parametrize("kw", ["act_pspec", "moe_pspec"])
def test_a_pspec_with_plain_params_raises(entry, kw):
    """A pspec constrains DTensors: with plain-tensor params every entry
    point raises ``ValueError`` (the counterpart of
    ``with_sharding_constraint`` outside a mesh), never ignores it."""
    cfg, params, batch = _plain_setup()
    spec = {"act_pspec": P(("data",), None, None),
            "moe_pspec": P(("data",), None, None, None)}[kw]
    fns = {"forward": lambda: M.forward(cfg, params, batch, **{kw: spec}),
           "loss_fn": lambda: M.loss_fn(cfg, params, batch, **{kw: spec}),
           "prefill": lambda: M.prefill(cfg, params, batch, **{kw: spec}),
           "train_step": lambda: make_train_step(cfg, AdamW(), **{kw: spec})(
               params, AdamW().init(params), batch)}
    with pytest.raises(ValueError, match="launch.sharding.distribute"):
        fns[entry]()


# -- the sharded runs: the reference on eight host devices -------------------

#: the train step's config (test_sharded_train_step's), tokens and AdamW
STEP_TOKENS, STEP_LR, STEP_EPS, STEP_ATOL = (4, 32), 1e-3, 1e-6, 1e-5
#: the gradient cases on a (2, 2) mesh: (arch, vocab or None).  Llama's
#: vocab 1000 pads to 1024, so the padded-vocab mask runs sharded
GRAD_MODELS = {"llama_v1000": ("llama3.2-1b", 1000),
               "granite": ("granite-moe-3b-a800m", None),
               "mamba2": ("mamba2-370m", None),
               "zamba2": ("zamba2-2.7b", None)}
#: the reference's gradient is NaN through the reduced SSD step (ROADMAP
#: Queue 3): these are held to the port's one-device gradients only
NAN_MODELS = ("mamba2", "zamba2")
ACT_PSPEC = (("data",), "model", None)
MOE_PSPEC = (("data",), None, None, None)
PREFILL_TOL = 1e-4         # x max|ref|: tests/test_torch_multidevice.py's

REFERENCE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.compat import set_mesh
from repro.launch.mesh import make_mesh
from repro.launch.sharding import param_pspecs
from repro.models.transformer import model as M
from repro.training.optim import AdamW
from repro.training.steps import make_train_step

inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
out = {}

def placed(cfg, params, mesh):
    specs = param_pspecs(cfg, params, mesh)
    return jax.device_put(params, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P)))

def batch_of(name):
    toks = jnp.asarray(inp[name])
    return {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}

def save(prefix, tree):
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        out[f"{prefix}{i:03d}"] = leaf

# test_sharded_train_step's run: (2, 4), one jitted step
cfg = configs.get("llama3.2-1b").reduced(n_layers=2, d_model=128)
mesh = make_mesh((2, 4), ("data", "model"))
params = M.init_params(cfg, jax.random.PRNGKey(0))
opt = AdamW(lr=spec["lr"], eps=spec["eps"])
with mesh, set_mesh(mesh):
    new, _, loss = jax.jit(make_train_step(cfg, opt))(
        placed(cfg, params, mesh), opt.init(params), batch_of("step_tokens"))
out["step_loss"] = loss
save("step_leaf", params)
save("step_new", new)

# gradients with act_pspec (and moe_pspec) on a (2, 2) mesh
sub = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
act, moe = P(*spec["act"]), P(*spec["moe"])
for name, (arch, vocab) in spec["grads"].items():
    cfg = configs.get(arch).reduced(n_layers=2, d_model=128)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    batch = batch_of(f"{name}_tokens")
    kw = dict(act_pspec=act, moe_pspec=moe if cfg.is_moe else None)
    with sub, set_mesh(sub):
        p = placed(cfg, params, sub)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: M.loss_fn(cfg, p, batch, **kw)))(p)
        if name == spec["prefill"]:
            last, cache = jax.jit(lambda p: M.prefill(
                cfg, p, {"tokens": batch["tokens"]}, act_pspec=act))(p)
            out[f"{name}_last"] = last
            out.update({f"{name}_cache_{k}": c for k, c in cache.items()})
    out[f"{name}_loss"] = loss
    save(f"{name}_leaf", params)
    save(f"{name}_grad", grads)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _cfgs(name):
    """(reference cfg, port cfg) of a GRAD_MODELS entry (or "step")."""
    arch, vocab = GRAD_MODELS.get(name, ("llama3.2-1b", None))
    return tuple(dataclasses.replace(c, vocab_size=vocab) if vocab else c
                 for c in (mod.get(arch).reduced(n_layers=2, d_model=128)
                           for mod in (ref_configs, configs)))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(2)
    out = {"step_tokens": rng.integers(0, _cfgs("step")[1].vocab_size,
                                       STEP_TOKENS, dtype=np.int32)}
    for name in GRAD_MODELS:
        out[f"{name}_tokens"] = rng.integers(0, _cfgs(name)[1].vocab_size,
                                             STEP_TOKENS, dtype=np.int32)
    return out


@pytest.fixture(scope="module")
def weights():
    """The reference's weights of each case (``init_params`` at
    ``PRNGKey(0)``, drawn in this process), as numpy trees for
    ``params_from_numpy``, each group a plain tuple (spawned ranks
    unpickle no reference type)."""
    def plain(group):
        return {k: tuple(v) if hasattr(v, "_fields")
                else plain(v) if isinstance(v, dict) else v
                for k, v in group.items()}
    return {name: plain(jax.tree.map(np.asarray, RM.init_params(
        _cfgs(name)[0], jax.random.PRNGKey(0))))
        for name in ["step", *GRAD_MODELS]}


@pytest.fixture(scope="module")
def ref_run(inputs, tmp_path_factory):
    """The reference on eight host devices, started in one subprocess
    that runs while the port's ranks do: (process, its directory)."""
    d = tmp_path_factory.mktemp("shard_ref")
    np.savez(d / "in.npz", **inputs)
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(d)}
    spec = {"lr": STEP_LR, "eps": STEP_EPS, "act": ACT_PSPEC,
            "moe": MOE_PSPEC, "grads": GRAD_MODELS, "prefill": "llama_v1000"}
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(d / "in.npz"),
         str(d / "out.npz"), json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_run):
    """The reference's sharded results (waits for its subprocess)."""
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


def _one_device(name, weights, tokens):
    """(cfg, params, batch): the port on one device with the reference's
    weights and ``tokens``, labels rolled as in the ranks."""
    cfg = _cfgs(name)[1]
    params = M.params_from_numpy(cfg, weights[name], device="cpu")
    toks = torch.as_tensor(tokens)
    return cfg, params, {"tokens": toks, "labels": torch.roll(toks, -1, 1)}


@pytest.fixture(scope="module")
def step(inputs, weights, ref_run):
    """The port's sharded train step on eight gloo ranks, a (2, 4) mesh:
    every rank's results."""
    return run_ranks(body_shard_step, 8, _cfgs("step")[1], weights["step"],
                     inputs["step_tokens"], STEP_LR, STEP_EPS)


@pytest.fixture(scope="module")
def step_one(inputs, weights):
    """The port's one-device step from the same weights: (loss, new
    params as numpy)."""
    cfg, params, batch = _one_device("step", weights, inputs["step_tokens"])
    opt = AdamW(lr=STEP_LR, eps=STEP_EPS)
    new, _, loss = make_train_step(cfg, opt)(params, opt.init(params), batch)
    return float(loss), [t.numpy() for t in tree.leaves(new)]


def test_sharded_train_step_loss_matches(step, step_one, ref):
    """``tests/test_multidevice.py::test_sharded_train_step``'s case on 8
    gloo ranks: reduced Llama (2 layers, d 128) placed by
    ``param_pspecs`` on a (2, 4) mesh, tokens (4, 32), one
    ``make_train_step`` step: every rank's loss within LOSS_REL of the
    port's one-device step and of the reference's sharded step."""
    for want in (step_one[0], float(ref["step_loss"])):
        for r in step:
            assert abs(r["loss"] - want) <= LOSS_REL * abs(want), \
                (r["loss"], want)


def test_sharded_train_step_params_match(step, step_one, ref):
    """The new params (gathered) within 1e-5 of the one-device step's and
    of the reference's sharded step's (AdamW lr 1e-3, eps 1e-6), the same
    bits on every rank."""
    got = step[0]["params"]
    for r in step[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(r["params"], got))
    for want in (step_one[1], _keys(ref, "step_new")):
        assert [a.shape for a in got] == [w.shape for w in want]
        for a, w in zip(got, want):
            np.testing.assert_allclose(a, w, rtol=0, atol=STEP_ATOL)


def test_sharded_train_step_keeps_placements(step):
    """The new params, m and v come back as DTensors in the placements of
    their params' specs, on every rank."""
    for r in step:
        assert r["placed"] == [True, True, True]


@pytest.fixture(scope="module")
def grads(inputs, weights, ref_run):
    """The port's sharded gradients on four gloo ranks, a (2, 2) mesh:
    every rank's results."""
    models = {n: (_cfgs(n)[1], weights[n]) for n in GRAD_MODELS}
    toks = {n: inputs[f"{n}_tokens"] for n in GRAD_MODELS}
    return run_ranks(body_shard_grads, 4, models, toks, ACT_PSPEC, MOE_PSPEC)


@pytest.fixture(scope="module")
def grads_one(inputs, weights):
    """The port's one-device ``loss_and_grads`` of each GRAD_MODELS case
    on the reference's weights: {name: (params, loss, grad leaves)}."""
    out = {}
    for name in GRAD_MODELS:
        cfg, params, batch = _one_device(name, weights,
                                         inputs[f"{name}_tokens"])
        loss, g = loss_and_grads(cfg, params, batch)
        out[name] = (params, float(loss), [t.numpy() for t in tree.leaves(g)])
    return out


@pytest.mark.parametrize("name", sorted(GRAD_MODELS))
def test_sharded_gradients_match_one_device(name, grads, grads_one):
    """``loss_and_grads`` with ``act_pspec=P(("data",), "model", None)``
    (and ``moe_pspec`` for granite) on params placed by ``param_pspecs``:
    the loss within LOSS_REL and every gradient leaf (gathered) within
    GRAD_REL x max|leaf| of the port's one-device gradients, each in its
    param's placements, the same bits on every rank.  Every family's
    local-shard boundaries run: attention, MoE (output Partial over
    ``model``, its gradients Partial), Mamba2, the hybrid's shared block;
    Llama's vocab 1000 pads to 1024, so the mask runs sharded."""
    _, want_loss, want = grads_one[name]
    r0 = grads[0][name]
    for r in grads:
        assert abs(r[name]["loss"] - want_loss) <= LOSS_REL * abs(want_loss)
        assert r[name]["placed"]
        assert all(np.array_equal(a, b)
                   for a, b in zip(r[name]["grads"], r0["grads"]))
    assert [g.shape for g in r0["grads"]] == [w.shape for w in want]
    for g, w in zip(r0["grads"], want):
        assert np.isfinite(g).all()
        _leaf_close(g, w, GRAD_REL)


@pytest.mark.parametrize("name", sorted(GRAD_MODELS))
def test_sharded_loss_matches_the_reference(name, grads, ref):
    """The sharded loss within LOSS_REL of the reference's
    ``loss_fn(act_pspec=...)`` under ``jax.jit`` on its (2, 2) mesh."""
    want = float(ref[f"{name}_loss"])
    assert abs(grads[0][name]["loss"] - want) <= LOSS_REL * abs(want)


@pytest.mark.parametrize("name", sorted(set(GRAD_MODELS) - set(NAN_MODELS)))
def test_sharded_gradients_match_jax_grad(name, grads, ref):
    """Llama (padded vocab) and granite (``moe_pspec``): every gradient
    leaf within GRAD_REL x max|leaf| of ``jax.value_and_grad`` of the
    reference's sharded ``loss_fn``."""
    want = _keys(ref, f"{name}_grad")
    got = grads[0][name]["grads"]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _leaf_close(g, w, GRAD_REL)


@pytest.mark.parametrize("name", NAN_MODELS)
def test_sharded_ssm_gradients_are_finite(name, grads):
    """Mamba2 and the hybrid: the reference's gradients have non-finite
    leaves through the reduced SSD step (ROADMAP Queue 3), the port's
    sharded ones are all finite."""
    assert all(np.isfinite(g).all() for g in grads[0][name]["grads"])


def test_prefill_with_act_pspec_matches_the_reference(grads, ref):
    """``prefill(act_pspec=...)`` of the padded-vocab Llama on placed
    params: the last logits and every cache leaf (gathered) within 1e-4 x
    max|ref| of the reference's ``prefill(act_pspec=...)``."""
    got = grads[0]["llama_v1000"]
    want = ref["llama_v1000_last"]
    assert got["last"].shape == want.shape
    _leaf_close(got["last"], want, PREFILL_TOL)
    assert sorted(got["cache"]) == sorted(
        k.removeprefix("llama_v1000_cache_") for k in ref
        if k.startswith("llama_v1000_cache_"))
    for key, t in got["cache"].items():
        want = ref[f"llama_v1000_cache_{key}"]
        if key == "len":
            assert t == want
        else:
            _leaf_close(t, want, PREFILL_TOL)


def test_clipped_update_of_sharded_gradients(grads, grads_one):
    """``AdamW.update`` on DTensor gradients of several placements, with
    a clip that engages (global norm 1e-3) and eps 1 (the step then
    scales with the clipped gradient; lr 1e3 lifts it far above the
    params' rounding): each leaf's step within 1e-3 x its max of the
    update of the one-device gradients."""
    params, _, g = grads_one["llama_v1000"]
    opt = AdamW(lr=1e3, weight_decay=0.0, grad_clip=1e-3, eps=1.0)
    grads_t = tree.unflatten(params, [torch.as_tensor(x) for x in g])
    new, _ = opt.update(grads_t, opt.init(params), params)
    for got, want, p in zip(grads[0]["llama_v1000"]["clipped"],
                            tree.leaves(new), tree.leaves(params)):
        _leaf_close(got - p.numpy(), (want - p).numpy(), 1e-3)


def test_moe_pspec_off_the_data_axes_raises(grads):
    """The port's MoE dispatch is per sample on each rank's batch rows: a
    ``moe_pspec`` whose dim 0 is not the data axes raises ``ValueError``
    on every rank."""
    for r in grads:
        msg = r["granite"]["moe_pspec_raises"]
        assert "moe_pspec" in msg and "P(('data',), None, None, None)" in msg


@pytest.mark.parametrize("name", ["step", *GRAD_MODELS])
def test_the_reference_runs_on_the_ranks_weights(name, weights, ref):
    """The reference subprocess's weights are the ones the ranks got,
    leaf for leaf."""
    got = _keys(ref, f"{name}_leaf")
    want = jax.tree.leaves(weights[name])
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_host_staged_groups_carry_dtensor_collectives(grads):
    """The gradient ranks' mesh has the sub-groups a CUDA mesh over gloo
    gets (``launch.mesh.HostGloo``, backend ``gloo_host``): DTensor's
    all-gathers, reduce-scatters and all-reduces all went through them,
    on host tensors handed to gloo as they were (the card's copies are
    the only difference), the same count on every rank."""
    kinds = {"all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce"}
    for r in grads:
        assert r["backend"] == "gloo_host"
        assert r["collectives"] == grads[0]["collectives"]
        assert {k for k, _ in r["collectives"]} >= kinds
        assert {p for _, p in r["collectives"]} == {"direct"}
