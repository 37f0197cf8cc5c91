"""The port's compiled execution (``repro_torch.exec.graph``) on the CPU.

On a CUDA device the decode step (``serving.lm.Decoder``) and a compiled
stage's body (``exec.compiler.CompiledStage``) are captured once as CUDA
graphs and replayed; on the CPU they run eagerly, chosen by the device's
type, and never construct a ``torch.cuda.CUDAGraph``.  What a graph
needs beyond that is plain Python and is tested here: the launch counts
a capture takes back and each replay credits, the scratch a graph owns,
the weights' identity a stage keys its graphs on, and the decode loop's
length advanced in place.  The graphs themselves are tested on the card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.transformer import model as RM
import repro_torch
from repro_torch import configs
from repro_torch.core import make_pi_cluster
from repro_torch.exec import graph
from repro_torch.exec.compiler import params_key
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.models.cnn import params_from_numpy, zoo
from repro_torch.models.transformer import model as M
from repro_torch.pipeline import StageExecutor
from repro_torch.serving import lm

from _torch_cases import ZOO_TINY, image, lm_config, lm_tokens, np_params

FRACS = [0.4, 0.35, 0.25]
N_STEPS = 6
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def no_cuda_graph(monkeypatch):
    """``torch.cuda.CUDAGraph`` raises if anything constructs one."""
    class Forbidden:
        def __init__(self, *args, **kwargs):
            raise AssertionError("a CUDA graph was built on the CPU path")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Forbidden)


# -- launch counts under replay ------------------------------------------

def test_credit_gives_back_a_captures_counts_times_replays():
    """A capture's launches are taken back (it ran nothing) and credited
    once per replay, for a Launchers table and for the variant tables of
    moe_gemm and conv2d_fused alike."""
    launchers = _build.Launchers({"k1": None, "k2": None}, {})
    launchers.counts["k1"] = 5                  # launches before the capture
    moe_before = dict(moe_ops.variant_counts)
    conv_before = dict(conv_ops.variant_counts)
    try:
        before = _build.count_snapshot()
        # what one capture records: two k1 and one k2 launch, three
        # moe_gemm stream launches and one ring conv
        launchers.counts["k1"] += 2
        launchers.counts["k2"] += 1
        moe_ops.variant_counts["stream"] += 3
        conv_ops.variant_counts["ring"] += 1
        delta = _build.take_counts(before)
        assert launchers.counts == {"k1": 5, "k2": 0}
        assert moe_ops.variant_counts == moe_before
        assert conv_ops.variant_counts == conv_before
        _build.credit(delta, 4)                 # four replays
        assert launchers.counts == {"k1": 5 + 8, "k2": 4}
        assert launchers.launch_count("k1") == 13
        assert moe_ops.variant_counts["stream"] == moe_before["stream"] + 12
        assert conv_ops.variant_counts["ring"] == conv_before["ring"] + 4
        _build.credit(delta)                    # one more
        assert launchers.counts == {"k1": 15, "k2": 5}
    finally:
        moe_ops.variant_counts.update(moe_before)
        conv_ops.variant_counts.update(conv_before)


def test_reset_keeps_the_tables_that_graphs_credit():
    """Resetting a kernel's counts clears them in place: the table a graph
    credits stays the one the wrapper reads."""
    tables = [moe_ops.variant_counts, conv_ops.variant_counts]
    moe_ops.reset_launches()
    conv_ops.reset_launches()
    assert all(t is u for t, u in zip(tables, [moe_ops.variant_counts,
                                               conv_ops.variant_counts]))
    assert all(any(t is c for c in _build.COUNT_TABLES) for t in tables)
    assert conv_ops.launch_count() == 0
    assert sum(moe_ops.variant_counts.values()) == 0


def test_a_graph_owns_the_scratch_made_while_it_is_built():
    """Inside ``owned_scratch`` a kernel's scratch comes from the graph's
    table and grows there; outside it, from the per-stream table."""
    cpu = torch.device("cpu")
    mine: dict = {}
    with _build.owned_scratch(mine):
        a = _build.scratch(cpu, "ws", 8, torch.float32, zero=True)
        assert mine["ws"] is a and a.numel() == 8 and not a.any()
        assert _build.scratch(cpu, "ws", 4, torch.float32) is a
        b = _build.scratch(cpu, "ws", 16, torch.float32)
        assert mine["ws"] is b and b.numel() == 16
        inner: dict = {}
        with _build.owned_scratch(inner):
            c = _build.scratch(cpu, "ws", 2, torch.int32)
        assert inner["ws"] is c and mine["ws"] is b
    assert not _build._OWNED


# -- where a graph is used -------------------------------------------------

def test_graphs_only_on_cuda_devices_outside_eager():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert graph.enabled(cuda) and not graph.enabled(cpu)
    with graph.eager():
        assert not graph.enabled(cuda)
        with graph.eager():
            assert not graph.enabled(cuda)
        assert not graph.enabled(cuda)
    assert graph.enabled(cuda)


def test_graph_refuses_cpu_tensors(no_cuda_graph):
    with pytest.raises(ValueError, match="CUDA tensors"):
        graph.Graph(lambda x: x + 1, [torch.zeros(3)])


# -- the compiled stage ------------------------------------------------------

def _stage(name, n_frames=None):
    """(compiled stage, params, boundary) of the whole tiny-zoo model
    ``name`` as one stage split FRACS; with ``n_frames``, a frame stack."""
    m = zoo.build(name, **ZOO_TINY[name])
    params = params_from_numpy(np_params(m), device="cpu")
    x = torch.tensor(image(m, n=1))
    if n_frames:
        x = torch.stack([torch.tensor(image(m, seed=1 + f))
                         for f in range(n_frames)])
    ex = StageExecutor(m, frozenset(m.graph.layers), FRACS, backend="cuda")
    boundary = ex.boundary_inputs({}, x)
    return ex._executable(boundary), params, boundary


@pytest.mark.parametrize("form", ["frame", "frames"])
@pytest.mark.parametrize("name", sorted(ZOO_TINY))
def test_stage_entry_points_equal_their_bodies_on_the_cpu(name, form,
                                                          no_cuda_graph):
    """On the CPU ``__call__`` / ``run_frames`` run ``_run`` /
    ``_run_frames`` eagerly (no graph): the same bits; and the frame
    stack's body equals a loop of the one-frame body."""
    cs, params, boundary = _stage(name, 2 if form == "frames" else None)
    if form == "frame":
        got, want = cs(params, boundary), cs._run(params, boundary)
    else:
        got = cs.run_frames(params, boundary)
        want = cs._run_frames(params, boundary)
        for f in range(2):
            one = cs._run(params, {k: v[f] for k, v in boundary.items()})
            for s in one:
                np.testing.assert_allclose(want[s][f].numpy(),
                                           one[s].numpy(), rtol=1e-5,
                                           atol=1e-5)
    assert got.keys() == want.keys() == set(cs.sinks)
    for s in got:
        assert torch.equal(got[s], want[s])
    assert not cs._graphs


def test_params_key_tells_parameter_sets_apart():
    m = zoo.build("vgg16", **ZOO_TINY["vgg16"])
    a = params_from_numpy(np_params(m, seed=0), device="cpu")
    b = params_from_numpy(np_params(m, seed=1), device="cpu")
    nodes = frozenset(m.graph.layers)
    ka = params_key(a, nodes)
    assert ka and ka == params_key(a, nodes)
    assert params_key(b, nodes) != ka
    # the same tensors in another dict: the same weights
    assert params_key({n: dict(p) for n, p in a.items()}, nodes) == ka
    # new values written in place: still where the graph reads them
    first = sorted(a)[0]
    a[first]["w"].mul_(2.0)
    assert params_key(a, nodes) == ka
    # one tensor replaced: another key
    a[first]["w"] = a[first]["w"].clone()
    assert params_key(a, nodes) != ka
    # only the stage's own nodes count
    some = frozenset(sorted(nodes)[:3])
    mixed = {n: (a if n in some else b)[n] for n in a}
    assert params_key(mixed, some) == params_key(a, some)
    # the weights' dtype is part of the key
    half = {n: {k: t.to(torch.bfloat16) for k, t in p.items()}
            for n, p in a.items()}
    assert {e[3] for e in params_key(half, nodes)} == {torch.bfloat16}


# -- the decode loop -----------------------------------------------------------

def _lm(case):
    """(port cfg, port params on the CPU, reference cfg, reference params)
    from the reference's seeded init."""
    rcfg, cfg = lm_config(ref_configs, case), lm_config(configs, case)
    tree = jax.tree.map(np.asarray, RM.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    return (cfg, M.params_from_numpy(cfg, tree, device="cpu"), rcfg,
            jax.tree.map(jnp.asarray, tree))


def _copy_cache(cache):
    return {k: v.clone() for k, v in cache.items()}


@pytest.mark.parametrize("case", ["llama", "mamba2", "granite_moe",
                                  "llama_swa16"])
def test_decoder_advances_len_in_place_as_decode_step_returns_it(
        case, no_cuda_graph):
    """``Decoder`` (one static ``len`` advanced in place, the form a graph
    replays) against a loop of ``decode_step`` fed its own returned
    ``len``: the same logits bit for bit over N_STEPS teacher-forced
    steps, both within TOL of the reference's ``decode_step``."""
    cfg, params, rcfg, rparams = _lm(case)
    prompt = torch.tensor(lm_tokens(cfg, n=12))
    _, cache = lm.prefill_prompt(cfg, params, prompt, N_STEPS)
    start = int(cache["len"])
    loop_cache = _copy_cache(cache)
    decoder = lm.Decoder(cfg, params, _copy_cache(cache))
    _, rcache = RM.prefill(rcfg, rparams,
                           {"tokens": jnp.asarray(prompt[:, :-1].numpy())})
    if "k" in rcache and not rcfg.sliding_window:
        pads = [(0, 0)] * rcache["k"].ndim
        pads[2] = (0, N_STEPS + 1)
        rcache = {**rcache, "k": jnp.pad(rcache["k"], pads),
                  "v": jnp.pad(rcache["v"], pads)}
    step = jax.jit(lambda p, c, t: RM.decode_step(rcfg, p, c, {"token": t}))
    tok = prompt[:, -1]
    for i in range(N_STEPS):
        want, loop_cache = M.decode_step(cfg, params, loop_cache,
                                         {"token": tok})
        got = decoder(tok)
        assert torch.equal(got, want), i
        assert int(decoder.cache["len"]) == int(loop_cache["len"]) \
            == start + i + 1
        rlogits, rcache = step(rparams, rcache, jnp.asarray(tok.numpy()))
        V = cfg.vocab_size
        np.testing.assert_allclose(got[:, :V].numpy(),
                                   np.asarray(rlogits)[:, :V], **TOL)
        tok = want.argmax(dim=-1)
    for key in cache:
        if key != "len":
            assert torch.equal(decoder.cache[key], loop_cache[key]), key
    assert int(cache["len"]) == start     # the caller's len is not moved


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("case", ["llama", "mamba2", "granite_moe"])
def test_cpu_generate_builds_no_graph_and_keeps_its_tokens(
        case, temperature, no_cuda_graph):
    """On the CPU ``generate`` runs every step eagerly: its tokens equal
    a plain loop of ``decode_step`` with the same sampling (greedy, or
    seeded temperature draws)."""
    cfg, params, _, _ = _lm(case)
    prompt = torch.tensor(lm_tokens(cfg, n=10))
    n_new = 5

    def gen():
        return torch.Generator().manual_seed(3)

    got = lm.generate(cfg, params, prompt, n_new, temperature=temperature,
                      generator=gen())
    _, cache = lm.prefill_prompt(cfg, params, prompt, n_new)
    g, tok, want = gen(), prompt[:, -1], []
    for _ in range(n_new):
        logits, cache = M.decode_step(cfg, params, cache, {"token": tok})
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=g)[:, 0]
        else:
            tok = logits.argmax(dim=-1)
        want.append(tok)
    assert torch.equal(got, torch.stack(want, dim=1).to(torch.int32))


def test_runner_copies_out_only_where_outputs_leave_the_call():
    """The stages whose sinks are the model's hand out copies; the others
    may hand out their graph's own outputs, read by the later stages of
    the same call.  On the CPU both forms give the eager results."""
    m = zoo.vgg16(input_size=(40, 40), scale=0.1, head=True)
    params = params_from_numpy(np_params(m), device="cpu")
    dep = repro_torch.compile(m, make_pi_cluster([1.5, 1.2, 1.0, 0.8]),
                              params=params, device="cpu")
    runner = dep.runner
    sinks = set(m.graph.sinks())
    assert len(runner.stages) > 1
    assert runner._copy_out == [bool(sinks & set(ex.sinks))
                                for ex in runner.stages]
    assert runner._copy_out[-1] and not any(runner._copy_out[:-1])
    x = torch.tensor(image(m))
    got = runner(params, x)
    want = m.forward(params, x)
    for s in sinks:
        np.testing.assert_allclose(got[s].numpy(), want[s].numpy(),
                                   rtol=1e-5, atol=1e-6)
