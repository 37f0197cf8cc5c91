"""The port's training substrate (``repro_torch.training``, the train
launcher, ``forward``'s remat) against the JAX package's on reduced
configs with the reference's parameters.

Tolerances, each from fp32 sums taken in another order:
- loss within 1e-6 relative, and each gradient leaf within 5e-5 x
  max|reference leaf| of ``jax.value_and_grad`` (worst seen 9.3e-6, a
  Mamba2 leaf);
- ``AdamW.update`` on identical gradients within 1e-6 absolute;
- three train steps at lr 1e-3: params within 1e-5 absolute.  Both
  optimizers take eps = 1e-6 there: at the default 1e-8 an element whose
  gradient is within fp32 noise of zero (|g| ~ 1e-9, sums of O(1e-2)
  terms) moves by up to lr x dg / eps ~ 1e-4, and the reference's own
  jitted and eager steps differ by that much.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import TokenStream as RefTokenStream
from repro.models.transformer import model as RM
from repro.training import checkpoint as ref_checkpoint
from repro.training.optim import AdamW as RefAdamW
from repro.training.optim import cosine_schedule as ref_cosine
from repro.training.steps import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.data.pipeline import TokenStream
from repro_torch.kernels.attention import ops
from repro_torch.launch import train as train_launcher
from repro_torch.models.transformer import model as M
from repro_torch.training import (AdamW, AdamWState, checkpoint,
                                  cosine_schedule, loss_and_grads,
                                  make_eval_step, make_train_step, tree)
from repro_torch.training.loop import train

from _torch_cases import LM_CASES
from test_torch_hybrid import _batch, _port_batch, _ref_batch
from test_torch_lm import _setup

LOSS_REL, GRAD_REL = 1e-6, 5e-5
#: the reference's gradient is NaN through two SSD chunks (see below)
NAN_CASE = "mamba2_q256"
GRAD_CASES = sorted(set(LM_CASES) - {NAN_CASE})
DENSE_CASES = ["llama", "qwen_bias", "llama_swa16"]


@functools.lru_cache(maxsize=None)
def _reference(case):
    """(setup, batch, reference loss, reference gradient leaves)."""
    rcfg, rparams, cfg, params = _setup(case)
    b = _batch(cfg, case)
    loss, grads = jax.value_and_grad(
        lambda p: RM.loss_fn(rcfg, p, _ref_batch(cfg, b)))(rparams)
    return ((rcfg, rparams, cfg, params), b, float(loss),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def _leaf_close(got, want, rel=GRAD_REL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_loss_and_grads_match_jax_value_and_grad(case, backend):
    """Every family (dense with and without bias and window, MoE, Mamba2,
    hybrid, embeds): the loss and every gradient leaf, in ``jax.tree``'s
    leaf order, against the reference's ``jax.value_and_grad(loss_fn)``.
    ``backend="cuda"`` on the CPU runs ``FlashPrefill``'s plain backward;
    no kernel launches."""
    (_, _, cfg, params), b, want_loss, want = _reference(case)
    ops.reset_launches()
    loss, grads = loss_and_grads(cfg, params, _port_batch(cfg, b),
                                 backend=backend)
    assert loss.dim() == 0 and not loss.requires_grad
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss)
    got = tree.leaves(grads)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _leaf_close(g.numpy(), w)
    assert ops.launch_count("flash_prefill_bwd") == 0


def test_reference_gradient_is_nan_through_two_ssd_chunks():
    """mamba2 at 512 tokens (two SSD chunks of 256): the reference's
    ``jax.grad`` is NaN (an overflowing decay masked after the exp), the
    port's is finite.  The port is held to the loss, to the leaves the
    reference gets finite (``final_norm``, ``head``), and along its own
    gradient to a central difference of the loss (step 0.005 on a unit
    direction, within 1e-3: the difference's own error is about 2e-5
    there, and falls as the step squared)."""
    (_, _, cfg, params), b, want_loss, want = _reference(NAN_CASE)
    assert not all(np.isfinite(w).all() for w in want)
    batch = _port_batch(cfg, b)
    loss, grads = loss_and_grads(cfg, params, batch)
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss)
    got = tree.leaves(grads)
    assert all(torch.isfinite(g).all() for g in got)
    for g, w in zip(got, want):
        if np.isfinite(w).all():
            _leaf_close(g.numpy(), w)
    norm = torch.sqrt(sum(g.square().sum() for g in got))
    h = 0.005

    def loss_at(sign):
        moved = [p + sign * h * g / norm
                 for p, g in zip(tree.leaves(params), got)]
        return float(M.loss_fn(cfg, tree.unflatten(params, moved), batch))

    slope = (loss_at(1) - loss_at(-1)) / (2 * h)
    assert abs(slope - float(norm)) <= 1e-3 * float(norm)


@pytest.mark.parametrize("case", ["llama", "granite_moe", "mamba2",
                                  "zamba2", "embeds"])
def test_remat_changes_nothing(case):
    """``forward(remat=True)`` (each layer and shared-block site under
    ``torch.utils.checkpoint``) gives the same logits and the same
    gradients, bit for bit on the CPU, as ``remat=False``."""
    _, _, cfg, params = _setup(case)
    b = _port_batch(cfg, _batch(cfg, case))
    out = {}
    for remat in (True, False):
        live = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
        logits = M.forward(cfg, tree.unflatten(params, live), b, remat=remat)
        grads = torch.autograd.grad(logits.float().logsumexp(-1).mean(), live)
        out[remat] = (logits.detach(), grads)
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(x, y) for x, y in zip(out[True][1],
                                                  out[False][1]))


def test_loss_fn_takes_unroll():
    _, _, cfg, params = _setup("llama")
    b = _port_batch(cfg, _batch(cfg, "llama"))
    assert torch.equal(M.loss_fn(cfg, params, b, unroll=True),
                       M.loss_fn(cfg, params, b))


def _np_tree(params, seed):
    """Standard-normal numpy leaves in ``params``' structure."""
    rng = np.random.default_rng(seed)
    return tree.map_(lambda t: rng.standard_normal(tuple(t.shape))
                     .astype(np.float32) * 0.01, params)


def _to_jax(np_tree, like):
    return jax.tree.unflatten(jax.tree.structure(like),
                              [jnp.asarray(a) for a in tree.leaves(np_tree)])


def test_adamw_updates_match_the_reference():
    """Three ``AdamW.update`` calls (cosine schedule, clip, weight decay,
    default eps) on the same gradients: params, m and v within 1e-6, the
    step equal.  The stacked norms (L, d) are decayed, 1-d leaves not."""
    _, rparams, _, params = _setup("qwen_bias")
    sched = dict(base_lr=1e-2, warmup=2, total=5)
    opt, ropt = (AdamW(lr=cosine_schedule(**sched)),
                 RefAdamW(lr=ref_cosine(**sched)))
    state, rstate = opt.init(params), ropt.init(rparams)
    p, rp = params, rparams
    for i in range(3):
        g = _np_tree(params, seed=i)
        p, state = opt.update(tree.map_(torch.tensor, g), state, p)
        rp, rstate = ropt.update(_to_jax(g, rparams), rstate, rp)
        for ours, theirs in ((p, rp), (state.m, rstate.m),
                             (state.v, rstate.v)):
            for a, w in zip(tree.leaves(ours), jax.tree.leaves(theirs)):
                np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                           rtol=0, atol=1e-6)
        assert int(state.step) == int(rstate.step) == i + 1
    zero = tree.map_(torch.zeros_like, params)
    decayed, _ = AdamW(lr=0.1).update(zero, AdamW().init(params), params)
    assert not torch.equal(decayed["layers"]["ln1"],
                           params["layers"]["ln1"])
    assert torch.equal(decayed["final_norm"], params["final_norm"])


@pytest.mark.parametrize("warmup,total", [(10, 20), (0, 7), (5, 5)])
def test_cosine_schedule_matches_the_reference(warmup, total):
    ours, theirs = (cosine_schedule(3e-3, warmup, total),
                    ref_cosine(3e-3, warmup, total))
    for step in [0, 1, 4, 5, 9, 10, 11, 15, 20, 25]:
        got = ours(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got),
                                   float(theirs(jnp.int32(step))),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("case", DENSE_CASES)
def test_three_dense_train_steps_match_the_reference(case):
    """Three ``make_train_step`` steps from the reference's params on the
    same ``TokenStream`` batches: losses within 1e-6 relative, params
    within 1e-5 (AdamW lr 1e-3, eps 1e-6: see the module's note)."""
    rcfg, rparams, cfg, params = _setup(case)
    opt, ropt = AdamW(lr=1e-3, eps=1e-6), RefAdamW(lr=1e-3, eps=1e-6)
    state, rstate = opt.init(params), ropt.init(rparams)
    step = make_train_step(cfg, opt)
    rstep = jax.jit(ref_make_train_step(rcfg, ropt))
    batches = TokenStream(cfg.vocab_size, 2, 24, seed=0,
                          device="cpu").batches(3)
    rbatches = RefTokenStream(rcfg.vocab_size, 2, 24, seed=0).batches(3)
    for b, rb in zip(batches, rbatches):
        assert np.array_equal(b["tokens"].numpy(), np.asarray(rb["tokens"]))
        params, state, loss = step(params, state, b)
        rparams, rstate, rloss = rstep(rparams, rstate, rb)
        assert abs(float(loss) - float(rloss)) <= LOSS_REL * float(rloss)
    for a, w in zip(tree.leaves(params), jax.tree.leaves(rparams)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_training_reduces_loss_and_checkpoints(tmp_path):
    """The reference's ``tests/test_system.py`` case, on the port, on the
    CPU."""
    cfg = configs.get("llama3.2-1b").reduced(n_layers=2, d_model=64)
    rep = train(cfg, steps=30, batch=4, seq=32, lr=3e-3, log_every=0,
                ckpt_path=str(tmp_path / "ck"), device="cpu")
    assert np.isfinite(rep.final_loss)
    assert np.mean(rep.losses[-5:]) < np.mean(rep.losses[:5])
    assert rep.steps == len(rep.step_s) == 30 and rep.tokens == 30 * 4 * 32
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    loaded = checkpoint.load(tmp_path / "ck", params)
    assert all(a.shape == b.shape for a, b in
               zip(tree.leaves(params), tree.leaves(loaded)))
    assert not torch.equal(loaded["head"], params["head"])   # trained


@pytest.mark.parametrize("case", ["qwen_bias", "granite_moe", "zamba2",
                                  "embeds"])
def test_checkpoints_load_across_the_packages(case, tmp_path):
    """A checkpoint the port writes loads into the reference's tree, and
    one the reference writes loads into the port's, leaf for leaf
    (``None`` biases, NamedTuple groups, stacked and shared leaves)."""
    _, rparams, cfg, params = _setup(case)
    other = tree.map_(torch.tensor, _np_tree(params, seed=7))
    checkpoint.save(tmp_path / "port", other)
    assert (tmp_path / "port.npz").exists()
    assert (tmp_path / "port.tree").read_text().startswith("{'")
    loaded = ref_checkpoint.load(tmp_path / "port", rparams)
    for a, w in zip(tree.leaves(other), jax.tree.leaves(loaded)):
        assert np.array_equal(a.numpy(), np.asarray(w))
    ref_checkpoint.save(tmp_path / "ref", rparams)
    back = checkpoint.load(tmp_path / "ref", other)
    for a, w in zip(tree.leaves(back), jax.tree.leaves(rparams)):
        assert a.dtype == torch.float32
        assert np.array_equal(a.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(tmp_path / "ref",
                        {**other, "head": other["head"][:, :1]})


@pytest.mark.parametrize("case", ["llama", "granite_moe", "zamba2"])
def test_tree_leaves_follow_jax_order(case):
    _, rparams, _, params = _setup(case)
    state = AdamW().init(params)
    rstate = RefAdamW().init(rparams)
    for ours, theirs in ((params, rparams), (state, rstate)):
        assert [tuple(t.shape) for t in tree.leaves(ours)] == \
            [tuple(a.shape) for a in jax.tree.leaves(theirs)]
    again = tree.unflatten(params, tree.leaves(params))
    assert list(again) == list(params)
    assert tree.describe(again) == tree.describe(params)
    assert all(a is b for a, b in zip(tree.leaves(again),
                                      tree.leaves(params)))


def test_train_steps_refuse_shardings_and_eval_step_is_the_loss():
    """A sharded step needs params placed by ``launch.sharding``: with
    plain-tensor params an ``act_pspec`` or ``moe_pspec`` raises
    ``ValueError`` (``tests/test_torch_sharding.py`` runs the sharded
    step); the eval step is the loss, without gradients."""
    cfg = configs.get("llama3.2-1b").reduced(n_layers=2, d_model=64)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    b = TokenStream(cfg.vocab_size, 2, 16, device="cpu").batches(1)[0]
    for kw in (dict(act_pspec=("data",)), dict(moe_pspec=("data",))):
        with pytest.raises(ValueError, match="launch.sharding.distribute"):
            make_train_step(cfg, AdamW(), **kw)(params, AdamW().init(params),
                                                 b)
    loss = make_eval_step(cfg)(params, b)
    assert not loss.requires_grad
    assert torch.equal(loss, M.loss_fn(cfg, params, b))


def test_train_launcher_runs_on_cpu(capsys):
    rep = train_launcher.main(["--reduced", "--device", "cpu", "--steps",
                               "3", "--batch", "2", "--seq", "16"])
    assert len(rep.losses) == 3 and all(np.isfinite(rep.losses))
    out = capsys.readouterr().out
    assert "llama3.2-1b-smoke" in out and "done:" in out and "tok/s" in out


@pytest.mark.parametrize("arch", ["llava-next-34b", "musicgen-medium"])
def test_train_launcher_refuses_archs_that_take_embeddings(arch):
    with pytest.raises(SystemExit, match="takes embeddings"):
        train_launcher.main(["--arch", arch, "--reduced", "--device",
                             "cpu"])


def test_train_launcher_stops_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_launcher.main(["--reduced", "--steps", "1"])


def test_adamw_state_is_a_named_tuple_of_the_reference_fields():
    assert AdamWState._fields == ("step", "m", "v")
    assert [f.name for f in dataclasses.fields(AdamW)] == \
        [f.name for f in dataclasses.fields(RefAdamW)]
    assert AdamW() == AdamW(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8,
                            weight_decay=0.1, grad_clip=1.0)
    ref = RefAdamW()
    assert (ref.lr, ref.b1, ref.b2, ref.eps, ref.weight_decay,
            ref.grad_clip) == (3e-4, 0.9, 0.95, 1e-8, 0.1, 1.0)
    assert ref_configs.get("llama3.2-1b").vocab_size == \
        configs.get("llama3.2-1b").vocab_size
