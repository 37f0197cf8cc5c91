"""The port's LM serving path (prefill -> decode_step -> generate) against
the JAX package's, on reduced configs with the reference's parameters:
dense attention, MoE (granite) and Mamba2.

On the CPU the port's kernel wrappers run their plain versions; the
reference runs its own (XLA) attention, expert einsums and SSD.
Tolerance rtol/atol 2e-4, the band tests/test_transformer.py uses
between prefill and decode: fp32 sums in another order, through two
layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.transformer import model as RM
from repro.serving.lm import generate as ref_generate
from repro_torch import configs
from repro_torch.kernels.attention import ops
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import serve
from repro_torch.models.transformer import model as M
from repro_torch.serving import lm

from _torch_cases import LM_CASES, LM_PROMPT, lm_config, lm_tokens, qkv_biases

TOL = dict(rtol=2e-4, atol=2e-4)
N_STEPS = 6


def _setup(case):
    """(reference cfg, reference params, port cfg, port params on CPU)."""
    rcfg, cfg = lm_config(ref_configs, case), lm_config(configs, case)
    tree = jax.tree.map(np.asarray, RM.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    if rcfg.qkv_bias:
        layers = dict(tree["layers"])
        layers["attn"] = layers["attn"]._replace(**qkv_biases(rcfg))
        tree = {**tree, "layers": layers}
    return (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
            M.params_from_numpy(cfg, tree, device="cpu"))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _state_keys(cache):
    """The per-layer entries of a cache of either package: k/v, or the
    Mamba2 conv and ssm states."""
    return [key for key in cache if key != "len"]


def _prefill_len(case):
    return LM_CASES[case].get("prefill", LM_PROMPT)


def _grow(cache, n, ref: bool):
    """Room for ``n`` more tokens in a full-attention cache, as
    ``generate`` makes it (the reference pads, the port concatenates); a
    Mamba2 cache stays as it is."""
    out = dict(cache)
    for key in ("k", "v") if "k" in cache else ():
        c = cache[key]
        if ref:
            pads = [(0, 0)] * c.ndim
            pads[2] = (0, n)
            out[key] = jnp.pad(c, pads)
        else:
            out[key] = torch.cat(
                [c, c.new_zeros((*c.shape[:2], n, *c.shape[3:]))], dim=2)
    return out


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_configs_match_the_reference(case):
    for name in ref_configs.ARCH_NAMES:
        assert dataclasses.asdict(configs.get(name)) == \
            dataclasses.asdict(ref_configs.get(name))
    rcfg, cfg = lm_config(ref_configs, case), lm_config(configs, case)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert (cfg.hd, cfg.vocab_padded, cfg.param_count()) == \
        (rcfg.hd, rcfg.vocab_padded, rcfg.param_count())


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_prefill_then_teacher_forced_decode_match_the_reference(case):
    rcfg, rparams, cfg, params = _setup(case)
    if "prefill" in LM_CASES[case]:
        n = _prefill_len(case) + N_STEPS
    else:
        n = rcfg.sliding_window + 8 if rcfg.sliding_window else LM_PROMPT
    toks = lm_tokens(cfg, n=n)
    prompt, fed = toks[:, :-N_STEPS], toks[:, -N_STEPS:]
    rlogits, rcache = RM.prefill(rcfg, rparams, {"tokens": jnp.asarray(prompt)})
    logits, cache = M.prefill(cfg, params, {"tokens": torch.tensor(prompt)})
    _close(logits, rlogits)
    assert _state_keys(cache) == _state_keys(rcache)
    for key in _state_keys(rcache):
        _close(cache[key], rcache[key])
    assert int(cache["len"]) == int(rcache["len"]) == prompt.shape[1]
    if not cfg.sliding_window:
        rcache, cache = _grow(rcache, N_STEPS, True), _grow(cache, N_STEPS,
                                                            False)

    step = jax.jit(lambda p, c, t: RM.decode_step(rcfg, p, c, {"token": t}))
    for i in range(N_STEPS):
        rlogits, rcache = step(rparams, rcache, jnp.asarray(fed[:, i]))
        logits, cache = M.decode_step(cfg, params, cache,
                                      {"token": torch.tensor(fed[:, i])})
        _close(logits, rlogits)
        for key in _state_keys(rcache):
            _close(cache[key], rcache[key])
        assert int(cache["len"]) == int(rcache["len"])


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_generate_matches_the_reference(case):
    """Greedy tokens equal the reference's at every step, until the first
    step whose reference top-2 logit gap is within 2 x the tolerance
    (there a tie may break either way, and the runs part)."""
    rcfg, rparams, cfg, params = _setup(case)
    prompt = lm_tokens(cfg, n=_prefill_len(case) + 1
                       if "prefill" in LM_CASES[case] else LM_PROMPT)
    n_new = 8
    want = np.asarray(ref_generate(rcfg, rparams, jnp.asarray(prompt),
                                   n_new))
    ops.reset_launches()
    moe_ops.reset_launches()
    ssd_ops.reset_launches()
    got = lm.generate(cfg, params, torch.tensor(prompt), n_new)
    assert got.shape == (prompt.shape[0], n_new) and got.dtype == torch.int32
    # CPU: the plain versions, no kernel
    assert ops.launch_count("decode_attention") == 0
    assert moe_ops.launch_count("moe_gemm") == 0
    assert ssd_ops.launch_count("ssd_chunk") == 0

    # the reference's logits along its own tokens, for the gaps
    _, rcache = RM.prefill(rcfg, rparams,
                           {"tokens": jnp.asarray(prompt[:, :-1])})
    if not rcfg.sliding_window:
        rcache = _grow(rcache, n_new + 1, True)
    step = jax.jit(lambda p, c, t: RM.decode_step(rcfg, p, c, {"token": t}))
    tok = jnp.asarray(prompt[:, -1])
    for i in range(n_new):
        rlogits, rcache = step(rparams, rcache, tok)
        real = np.asarray(rlogits)[:, :rcfg.vocab_size]   # no -1e30 pads
        top2 = np.sort(real, axis=-1)[:, -2:]
        tol = TOL["atol"] + TOL["rtol"] * np.abs(real).max()
        if (got[:, i].numpy() != want[:, i]).any():
            assert (top2[:, 1] - top2[:, 0]).min() <= 2 * tol, i
            break
        tok = jnp.asarray(want[:, i])


def test_backends_agree_and_unknown_backend_is_refused():
    _, _, cfg, params = _setup("gqa_bias")
    prompt = torch.tensor(lm_tokens(cfg, n=10))
    a = lm.generate(cfg, params, prompt, 4, backend="cuda")
    b = lm.generate(cfg, params, prompt, 4, backend="torch")
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        M.prefill(cfg, params, {"tokens": prompt}, backend="pallas")


def test_temperature_sampling_is_seeded():
    _, _, cfg, params = _setup("llama")
    prompt = torch.tensor(lm_tokens(cfg, n=6))

    def draw(seed):
        return lm.generate(cfg, params, prompt, 5, temperature=1.0,
                           generator=torch.Generator().manual_seed(seed))

    a, b = draw(7), draw(7)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size
    assert not torch.equal(a, lm.generate(cfg, params, prompt, 5))


def _shapes(tree):
    """A parameter tree of either package as nested dicts of shapes."""
    if tree is None:
        return None
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _leaves(tree):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["llama", "gqa_bias"])
def test_init_params_shapes_seed_and_placement(case, dtype):
    rcfg, cfg = lm_config(ref_configs, case), lm_config(configs, case)
    p = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                      dtype=dtype)
    assert _shapes(p) == _shapes(RM.init_params(rcfg, jax.random.PRNGKey(0)))
    assert all(t.device.type == "cpu" and t.dtype == dtype
               for t in _leaves(p))
    again = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu", dtype=dtype)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(p), _leaves(again)))
    other = M.init_params(cfg, torch.Generator().manual_seed(1),
                          device="cpu", dtype=dtype)
    assert not torch.equal(p["embed"], other["embed"])
    # the reference's scales: std 0.02 for the embedding, 1/sqrt(d) for wq
    wq_std = p["layers"]["attn"].wq.float().std().item()
    assert abs(wq_std * cfg.d_model ** 0.5 - 1) < 0.1
    assert abs(p["embed"].float().std().item() / 0.02 - 1) < 0.1


@pytest.mark.parametrize("case", ["llama", "llama_swa16"])
def test_init_cache_matches_the_reference(case):
    rcfg, cfg = lm_config(ref_configs, case), lm_config(configs, case)
    want = RM.init_cache(rcfg, 3, 40)
    got = M.init_cache(cfg, 3, 40, device="cpu")
    assert _shapes(got) == _shapes(want)
    assert got["len"].dtype == torch.int32 and int(got["len"]) == 0
    assert not got["k"].any() and got["v"].dtype == torch.float32


def test_params_from_numpy_reads_bf16_trees():
    """A reference tree in bf16 (numpy arrays of ml_dtypes' bfloat16)
    arrives as bf16 tensors holding the same values."""
    rcfg, cfg = lm_config(ref_configs, "gqa_bias"), lm_config(configs,
                                                                "gqa_bias")
    tree = jax.tree.map(np.asarray, RM.init_params(
        rcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    p = M.params_from_numpy(cfg, tree, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in _leaves(p))
    np.testing.assert_array_equal(
        p["layers"]["attn"].wq.float().numpy(),
        np.asarray(tree["layers"]["attn"].wq, np.float32))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "musicgen-medium"])
def test_families_not_ported_yet_are_refused(arch):
    cfg = configs.get(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_serve_launcher_runs_on_cpu(capsys):
    toks = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "6", "--new-tokens", "3"])
    assert tuple(toks.shape) == (2, 3)
    out = capsys.readouterr().out
    assert "llama3.2-1b-smoke" in out and "generated (2, 3)" in out


@pytest.mark.parametrize("case", ["mamba2", "granite_moe"])
def test_init_params_and_cache_match_the_reference_for_moe_and_mamba2(case):
    """Same tree and shapes as the reference's init, the reference's fixed
    Mamba2 ``dt_bias`` and ``A_log``, the same cache layout, and the same
    parameter count."""
    rcfg, cfg = lm_config(ref_configs, case), lm_config(configs, case)
    p = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    assert _shapes(p) == _shapes(rp)
    assert sum(t.numel() for t in _leaves(p)) == \
        sum(np.asarray(t).size for t in _leaves(rp))
    if cfg.is_ssm:
        for name in ("dt_bias", "A_log"):
            np.testing.assert_allclose(
                getattr(p["layers"]["mamba"], name).numpy(),
                np.asarray(getattr(rp["layers"]["mamba"], name)),
                rtol=1e-6, atol=1e-6)
    else:
        std = p["layers"]["moe"].w1.std().item()
        assert abs(std * cfg.d_model ** 0.5 - 1) < 0.1
    assert _shapes(M.init_cache(cfg, 3, 40, device="cpu")) == \
        _shapes(RM.init_cache(rcfg, 3, 40))


@pytest.mark.parametrize("arch", ["mamba2-370m", "granite-moe-3b-a800m"])
def test_serve_launcher_runs_moe_and_mamba2_on_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6",
                       "--new-tokens", "3"])
    assert tuple(toks.shape) == (2, 3)
    assert f"{arch}-smoke" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "llava-next-34b"])
def test_serve_launcher_refuses_what_is_not_ported(arch):
    with pytest.raises((NotImplementedError, SystemExit),
                       match="ROADMAP Queue 1, item 10d"):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu"])
