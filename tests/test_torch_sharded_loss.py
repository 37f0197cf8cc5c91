"""The sharded train step's loss on vocab shards and its dense MLP on
``d_ff`` shards (``repro_torch.models.transformer.sharded``'s
``token_nll`` and ``mlp``) on four spawned gloo ranks, a (2, 2)
("data", "model") mesh of host-staged sub-groups, against the port's
one-process ``loss_and_grads`` and the JAX package's
``jax.value_and_grad`` of its ``loss_fn``, on the reference's weights
(``params_from_numpy``) and the same numpy tokens.

Two cases: reduced Llama at vocab 200, padded to 512, so the ``model``
axis's second vocab slice (256-511) is all padding; and reduced zamba2,
whose shared attention+MLP block runs its MLP through ``sharded.mlp``.
Tolerances are ``tests/test_torch_training.py``'s: the loss within
LOSS_REL, each gradient leaf within GRAD_REL x max|leaf|; the per-token
terms within LOSS_REL x max|term| of the plain expression on the same
logits.  The reference's gradient through zamba2's reduced SSD step is
NaN (ROADMAP Queue 3), so only its loss is held to the reference.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.transformer import model as RM
from repro_torch import configs
from repro_torch.models.transformer import model as M
from repro_torch.models.transformer.model import shared_apply_flags
from repro_torch.training import loss_and_grads, tree

from _torch_mesh_ranks import body_sharded_loss, run_ranks
from test_torch_training import GRAD_REL, LOSS_REL, _leaf_close

#: (arch, vocab or None) of each case, reduced to 2 layers of d 128
CASES = {"llama_v200": ("llama3.2-1b", 200), "zamba2": ("zamba2-2.7b", None)}
#: the reference's gradient is NaN through the reduced SSD step
NAN_CASES = ("zamba2",)
TOKENS = (4, 32)
MODEL_RANKS = 2


def _cfgs(name):
    arch, vocab = CASES[name]
    return tuple(dataclasses.replace(c, vocab_size=vocab) if vocab else c
                 for c in (mod.get(arch).reduced(n_layers=2, d_model=128)
                           for mod in (ref_configs, configs)))


@pytest.fixture(scope="module")
def setup():
    """{name: (ref cfg, port cfg, numpy weights, tokens)}: the reference's
    ``init_params`` at ``PRNGKey(0)`` as plain numpy tuples, tokens from
    numpy seed 3."""
    def plain(group):
        return {k: tuple(v) if hasattr(v, "_fields")
                else plain(v) if isinstance(v, dict) else v
                for k, v in group.items()}
    rng = np.random.default_rng(3)
    out = {}
    for name in CASES:
        rcfg, cfg = _cfgs(name)
        weights = plain(jax.tree.map(np.asarray, RM.init_params(
            rcfg, jax.random.PRNGKey(0))))
        out[name] = (rcfg, cfg, weights, rng.integers(
            0, cfg.vocab_size, TOKENS, dtype=np.int32))
    return out


def _one_process(cfg, weights, toks):
    """(loss, gradient leaves) of the port's one-process
    ``loss_and_grads``."""
    params = M.params_from_numpy(cfg, weights, device="cpu")
    t = torch.as_tensor(toks)
    loss, g = loss_and_grads(cfg, params, {"tokens": t,
                                           "labels": torch.roll(t, -1, 1)})
    return float(loss), [x.numpy() for x in tree.leaves(g)]


def _reference(rcfg, toks, grads: bool):
    """(loss, gradient leaves or None) of the reference's ``loss_fn``
    under ``jax.jit`` on one device."""
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    fn = lambda p: RM.loss_fn(rcfg, p, batch)         # noqa: E731
    if not grads:
        return float(jax.jit(fn)(params)), None
    loss, g = jax.jit(jax.value_and_grad(fn))(params)
    return float(loss), [np.asarray(x) for x in jax.tree.leaves(g)]


@pytest.fixture(scope="module")
def runs(setup):
    """{"ranks": each rank's results, "one": {name: one-process (loss,
    grads)}, "ref": {name: the reference's (loss, grads or None)}}: the
    ranks run in a thread while this process computes the others."""
    box: dict = {}

    def spawn():
        try:
            box["ranks"] = run_ranks(
                body_sharded_loss, 4,
                {n: (*CASES[n], s[2]) for n, s in setup.items()},
                {n: s[3] for n, s in setup.items()})
        except BaseException as e:          # re-raised below
            box["error"] = e
    th = threading.Thread(target=spawn)
    th.start()
    try:
        box["one"] = {n: _one_process(s[1], s[2], s[3])
                      for n, s in setup.items()}
        box["ref"] = {n: _reference(s[0], s[3], grads=n not in NAN_CASES)
                      for n, s in setup.items()}
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return box


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["ranks"]


@pytest.fixture(scope="module")
def one(runs):
    return runs["one"]


def test_one_vocab_slice_is_all_padding():
    """The padded case's premise: at vocab 200 (padded to 512) the
    ``model`` axis's second slice holds padded slots only."""
    cfg = _cfgs("llama_v200")[1]
    assert cfg.vocab_size <= cfg.vocab_padded // MODEL_RANKS
    assert cfg.vocab_padded % MODEL_RANKS == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_loss_matches_one_process_and_the_reference(name, runs):
    """Every rank's loss within LOSS_REL of the one-process loss and of
    the reference's ``loss_fn``."""
    ranks = runs["ranks"]
    wants = (runs["one"][name][0], runs["ref"][name][0])
    for r in ranks:
        for want in wants:
            assert abs(r[name]["loss"] - want) <= LOSS_REL * abs(want), \
                (r[name]["loss"], want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_gradients_match_one_process(name, ranks, one):
    """Every gradient leaf (gathered) within GRAD_REL x max|leaf| of the
    one-process gradients, finite, in its param's placements, the same
    bits on every rank."""
    want = one[name][1]
    r0 = ranks[0][name]
    assert [g.shape for g in r0["grads"]] == [w.shape for w in want]
    for r in ranks:
        assert r[name]["placed"]
        assert all(np.array_equal(a, b)
                   for a, b in zip(r[name]["grads"], r0["grads"]))
    for g, w in zip(r0["grads"], want):
        assert np.isfinite(g).all()
        _leaf_close(g, w, GRAD_REL)


def test_padded_case_gradients_match_jax_grad(runs):
    """The padded-vocab Llama: every gradient leaf within GRAD_REL x
    max|leaf| of ``jax.value_and_grad`` of the reference's ``loss_fn`` on
    one device (the head's padded columns included: both zero)."""
    want = runs["ref"]["llama_v200"][1]
    got = runs["ranks"][0]["llama_v200"]["grads"]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _leaf_close(g, w, GRAD_REL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_token_nll_keeps_the_vocab_split(name, ranks):
    """``sharded.token_nll`` of the placed logits (vocab ``Shard(2)`` over
    ``model``) comes back batch over ``data`` and whole over ``model``,
    each token's term within LOSS_REL x max|term| of the plain
    expression on the same logits gathered."""
    for r in ranks:
        got = r[name]
        assert got["places"] == {"logits": ["Shard(dim=0)", "Shard(dim=2)"],
                                 "nll": ["Shard(dim=0)", "Replicate()"]}
        assert np.isfinite(got["nll"]).all()
        err = np.abs(got["nll"] - got["plain"]).max()
        assert err <= LOSS_REL * np.abs(got["plain"]).max(), err


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_mlp_runs_on_d_ff_slices(name, ranks):
    """``sharded.mlp`` met placed inputs at every dense MLP: each layer's
    (Llama) or each shared-block site's (zamba2), twice (the forward and
    remat's recompute)."""
    cfg = _cfgs(name)[1]
    sites = cfg.n_layers if cfg.layer_pattern == "attn" \
        else sum(shared_apply_flags(cfg)[0])
    assert sites > 0
    assert all(r[name]["mlp_calls"] == 2 * sites for r in ranks)
