"""The port's full-sequence ``forward`` and ``loss_fn``, zamba2's shared
attention+MLP block and the ``embeds`` input mode, against the JAX
package on reduced configs with the reference's parameters.

``forward`` and ``loss_fn`` are held on every LM case of
``tests/_torch_cases.py`` (dense, MoE, Mamba2, hybrid, embeds);
prefill and teacher-forced decode of the hybrid and embeds cases are in
``tests/test_torch_lm.py``.  Tolerance rtol/atol 2e-4, as there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.transformer import model as RM
from repro_torch import configs
from repro_torch.kernels.attention import ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models.transformer import model as M
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.serving import lm

from _torch_cases import LM_CASES, LM_PROMPT, lm_config, lm_inputs, lm_tokens
from test_torch_lm import TOL, _prefill_len, _setup, _shapes, one, seq


def _batch(cfg, case, labels=True):
    """The same (inputs, labels) for both packages, as numpy."""
    n = _prefill_len(case)
    out = {"x": lm_inputs(cfg, n=n)}
    if labels:
        out["labels"] = lm_tokens(cfg, n=n, seed=5)
    return out


def _ref_batch(cfg, b):
    return {**seq(cfg, jnp.asarray(b["x"])),
            "labels": jnp.asarray(b["labels"])}


def _port_batch(cfg, b):
    return {**seq(cfg, torch.tensor(b["x"])),
            "labels": torch.tensor(b["labels"])}


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_forward_matches_the_reference(case):
    """Logits (B, S, vocab_padded) of every position, padded slots
    masked, within 2e-4 of the reference's ``forward``; on the CPU no
    kernel launches."""
    rcfg, rparams, cfg, params = _setup(case)
    b = _batch(cfg, case)
    want = RM.forward(rcfg, rparams, _ref_batch(cfg, b), remat=False)
    ops.reset_launches()
    ssd_ops.reset_launches()
    got = M.forward(cfg, params, _port_batch(cfg, b))
    assert tuple(got.shape) == (*b["x"].shape[:2], cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ops.launch_count("flash_prefill") == 0
    assert ssd_ops.launch_count("ssd_chunk") == 0


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_loss_fn_matches_the_reference(case):
    rcfg, rparams, cfg, params = _setup(case)
    b = _batch(cfg, case)
    want = float(RM.loss_fn(rcfg, rparams, _ref_batch(cfg, b)))
    got = M.loss_fn(cfg, params, _port_batch(cfg, b))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, **TOL)
    np.testing.assert_allclose(float(M.loss_fn(cfg, params,
                                               _port_batch(cfg, b),
                                               backend="torch")), want, **TOL)


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_forward_last_position_equals_prefill(case):
    _, _, cfg, params = _setup(case)
    b = _batch(cfg, case, labels=False)
    x = seq(cfg, torch.tensor(b["x"]))
    logits, cache = M.prefill(cfg, params, x)
    np.testing.assert_allclose(M.forward(cfg, params, x)[:, -1].numpy(),
                               logits.numpy(), **TOL)
    assert int(cache["len"]) == b["x"].shape[1]


@pytest.mark.parametrize("layers,every", [(4, 2), (5, 2), (54, 6), (7, 3),
                                          (3, 0)])
def test_shared_sites_match_the_reference(layers, every):
    """Which layers the shared block follows and its site there, as
    Python ints, equal to the reference's arrays (the site clamped to 0
    before the first application)."""
    fields = dict(name="h", n_layers=layers, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=500, ssm_state=16,
                  ssm_head_dim=16, layer_pattern="mamba",
                  shared_attn_every=every)
    cfg, rcfg = ArchConfig(**fields), ref_configs.ArchConfig(**fields)
    apply, app_idx = M.shared_apply_flags(cfg)
    rapply, rapp_idx = RM._shared_apply_flags(rcfg)
    assert apply == np.asarray(rapply).tolist()
    assert app_idx == np.asarray(rapp_idx).tolist()
    assert all(type(a) is bool for a in apply)
    assert all(type(a) is int for a in app_idx)
    assert M.n_shared_apps(cfg) == RM.n_shared_apps(rcfg) == sum(apply)


@pytest.mark.parametrize("case", ["zamba2", "hybrid", "embeds", "musicgen"])
def test_init_params_and_cache_match_the_reference(case):
    """The reference's tree (``shared`` unstacked; no ``embed`` in the
    embeds mode), its parameter count, scales and cache layout
    (``shared_k``/``shared_v`` of A sites)."""
    rcfg, cfg = lm_config(ref_configs, case), lm_config(configs, case)
    p = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    assert _shapes(p) == _shapes(rp)
    assert ("embed" in p) == (cfg.input_mode == "tokens")
    assert ("shared" in p) == bool(cfg.shared_attn_every)
    if "shared" in p:
        wq = p["shared"]["attn"].wq
        assert wq.shape == (cfg.d_model, cfg.n_heads * cfg.hd)
        assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1) < 0.15
    cache = M.init_cache(cfg, 3, 40, device="cpu")
    assert _shapes(cache) == _shapes(RM.init_cache(rcfg, 3, 40))
    if cfg.shared_attn_every:
        assert cache["shared_k"].shape[0] == M.n_shared_apps(cfg) == 2


def _tree(case):
    rcfg = lm_config(ref_configs, case)
    return jax.tree.map(np.asarray, RM.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))


def test_params_from_numpy_takes_shared_attn_as_a_plain_tuple():
    """``shared["attn"]`` as a plain tuple in ``AttnParams``' field order
    (the reference's model zips it with the fields) gives the same
    parameters as the NamedTuple."""
    cfg, tree = lm_config(configs, "zamba2"), _tree("zamba2")
    plain = {**tree, "shared": {**tree["shared"],
                                "attn": tuple(tree["shared"]["attn"])}}
    assert type(plain["shared"]["attn"]) is tuple
    a = M.params_from_numpy(cfg, tree, device="cpu")["shared"]["attn"]
    b = M.params_from_numpy(cfg, plain, device="cpu")["shared"]["attn"]
    assert type(b) is type(a) and b._fields == a._fields
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)


def test_params_from_numpy_takes_a_tree_without_embed():
    cfg, tree = lm_config(configs, "embeds"), _tree("embeds")
    assert "embed" not in tree
    p = M.params_from_numpy(cfg, tree, device="cpu")
    assert "embed" not in p and "shared" not in p
    logits, _ = M.prefill(cfg, p, seq(cfg, torch.tensor(lm_inputs(cfg))))
    assert tuple(logits.shape) == (2, cfg.vocab_padded)


def test_decoder_takes_embeddings():
    """``Decoder`` feeds an embeds model's decode step (B, d) inputs and
    advances its own ``len``: on the CPU every step equals
    ``decode_step`` on a copy of the cache."""
    _, _, cfg, params = _setup("musicgen")
    x = torch.tensor(lm_inputs(cfg, n=LM_PROMPT + 4))
    _, cache = lm.prefill_prompt(cfg, params, x[:, :LM_PROMPT + 1], 4)
    assert cache["k"].shape[2] == LM_PROMPT + 5
    eager = {k: v.clone() for k, v in cache.items()}
    decoder = lm.Decoder(cfg, params, cache)
    for i in range(LM_PROMPT, LM_PROMPT + 4):
        want, eager = M.decode_step(cfg, params, eager, one(cfg, x[:, i]))
        assert torch.equal(decoder(x[:, i]), want)
    assert decoder.graph is None
    assert int(decoder.cache["len"]) == int(eager["len"]) == LM_PROMPT + 4


def test_prefill_prompt_grows_the_shared_sites():
    _, _, cfg, params = _setup("zamba2")
    prompt = torch.tensor(lm_tokens(cfg))
    _, cache = lm.prefill_prompt(cfg, params, prompt, 5)
    for key in ("shared_k", "shared_v"):
        assert cache[key].shape == (2, 2, LM_PROMPT - 1 + 6, cfg.n_kv_heads,
                                    cfg.hd)
        assert not cache[key][:, :, LM_PROMPT - 1:].any()


@pytest.mark.parametrize("case", ["embeds", "musicgen"])
def test_generate_refuses_configs_that_take_embeddings(case):
    _, _, cfg, params = _setup(case)
    with pytest.raises(ValueError, match="input_mode 'embeds'"):
        lm.generate(cfg, params, torch.tensor(lm_inputs(cfg)), 2)


def test_serve_launcher_runs_zamba2_on_cpu(capsys):
    toks = serve.main(["--arch", "zamba2-2.7b", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "6",
                       "--new-tokens", "3"])
    assert tuple(toks.shape) == (2, 3)
    assert "zamba2-2.7b-smoke" in capsys.readouterr().out
