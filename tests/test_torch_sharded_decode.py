"""``decode_step`` on placed params and a cache placed by ``cache_pspecs``
in both modes (``models/transformer/sharded.py``'s ``decode_attention``
and ``mamba2_decode``), ``decode_attention``'s log-sum-exp output, and
``serving.lm`` on placed params, against the JAX package's sharded
``decode_step`` (``jax.jit`` with ``in_shardings`` from its
``param_pspecs``, ``cache_pspecs`` and ``batch_pspecs``, as its dry run
builds it) and against the port's one-device step.

One JAX subprocess on four host devices, a (2, 2) ("data", "model")
mesh, runs the reference while four spawned gloo ranks run the port on a
mesh of host-staged gloo sub-groups (``launch.mesh.HostGloo``, what a
CUDA mesh over gloo gets).  Both start from the same cache: the
reference's one-device prefill of a seeded prompt (grown as ``generate``
grows it), on the reference's weights (``params_from_numpy``), and take
the same teacher-forced tokens.  Full-attention caches hold 6 prompt
tokens and room for 10 (W 16, shards of 8 in ``"sequence"`` mode): the
first two steps find the second shard empty, the third writes into it.
The sliding-window case's ring buffer (window 16) holds 23 prompt
tokens, so its writes cross from slot 7 into slot 8.  Tolerances: the
reference's logits and cache within ``TOL``
(``tests/test_torch_lm.py``'s), the one-device step's within 1e-5 x
max|ref|.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.transformer import model as RM
from repro_torch import configs
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.models.transformer import model as M
from repro_torch.models.transformer import sharded
from repro_torch.serving import lm

from _torch_cases import lm_config, lm_tokens
from _torch_mesh_ranks import body_shard_decode, run_ranks
from test_torch_lm import TOL

ROOT = Path(__file__).resolve().parents[1]
#: the cases: (prompt tokens, room grown for new ones)
CASES = {"llama": (6, 10), "llama_swa16": (23, 0), "granite_moe": (6, 10),
         "mamba2": (6, 0), "zamba2": (6, 10)}
MODES = ("feature", "sequence")
STEPS, BATCH = 3, 2
ONE_REL = 1e-5          # x max|ref|: against the port's one-device step
GEN_NEW = 5

REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.compat import set_mesh
from repro.launch.mesh import make_mesh
from repro.launch.sharding import batch_pspecs, cache_pspecs, param_pspecs
from repro.models.transformer import model as M
from _torch_cases import lm_config

inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
mesh = make_mesh((2, 2), ("data", "model"))
out = {}

def named(specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))

for case in spec["cases"]:
    cfg = lm_config(configs, case)
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    pre = f"{case}_cache_"
    cache0 = {k[len(pre):]: jnp.asarray(inp[k]) for k in spec["keys"][case]
              for k in [pre + k]}
    fed = inp[f"{case}_fed"]
    for mode in spec["modes"]:
        with mesh, set_mesh(mesh):
            p_sh = named(param_pspecs(cfg, params, mesh))
            c_sh = named(cache_pspecs(cfg, cache0, mesh, ("data",),
                                      mode=mode))
            i_sh = named(batch_pspecs(cfg, {"token": fed[:, 0]}, mesh,
                                      ("data",)))
            step = jax.jit(lambda p, c, i: M.decode_step(cfg, p, c, i),
                           in_shardings=(p_sh, c_sh, i_sh))
            p = jax.device_put(params, p_sh)
            c = jax.device_put(cache0, c_sh)
            for t in range(fed.shape[1]):
                logits, c = step(p, c, {"token": jnp.asarray(fed[:, t])})
                out[f"{case}_{mode}_{t}_logits"] = logits
                for k, v in c.items():
                    out[f"{case}_{mode}_{t}_cache_{k}"] = v
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _plain(group):
    """A numpy params tree with each group a plain tuple (spawned ranks
    unpickle no reference type)."""
    return {k: tuple(v) if hasattr(v, "_fields")
            else _plain(v) if isinstance(v, dict) else v
            for k, v in group.items()}


@pytest.fixture(scope="module")
def setup():
    """Per case: (port cfg, numpy weights, the reference's grown prefill
    cache as numpy, the fed tokens (B, STEPS)): the reference's
    one-device prefill of a seeded prompt, in this process."""
    out = {}
    for case, (n, room) in CASES.items():
        rcfg, cfg = lm_config(ref_configs, case), lm_config(configs, case)
        jparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
        toks = lm_tokens(cfg, n=n + STEPS, batch=BATCH)
        _, cache = RM.prefill(rcfg, jparams, {"tokens": jnp.asarray(
            toks[:, :n])})
        cache = {k: np.asarray(v) for k, v in cache.items()}
        for key in ("k", "v", "shared_k", "shared_v"):
            if key in cache and room:
                pads = [(0, 0)] * cache[key].ndim
                pads[2] = (0, room)
                cache[key] = np.pad(cache[key], pads)
        out[case] = (cfg, _plain(jax.tree.map(np.asarray, jparams)), cache,
                     toks[:, n:])
    return out


@pytest.fixture(scope="module")
def ref_run(setup, tmp_path_factory):
    """The reference on four host devices, started in one subprocess that
    runs while the port's ranks do: (process, its directory)."""
    d = tmp_path_factory.mktemp("decode_ref")
    arrays = {}
    for case, (_, _, cache, fed) in setup.items():
        arrays[f"{case}_fed"] = fed
        arrays.update({f"{case}_cache_{k}": v for k, v in cache.items()})
    np.savez(d / "in.npz", **arrays)
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}",
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": str(d)}
    spec = {"cases": list(CASES), "modes": list(MODES),
            "keys": {c: list(s[2]) for c, s in setup.items()}}
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(d / "in.npz"),
         str(d / "out.npz"), json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(setup, ref_run):
    """The port's sharded decode on four gloo ranks: every rank's
    results."""
    cfg, _, cache, fed = setup["llama"]
    prompt = lm_tokens(cfg, n=8, batch=BATCH, seed=5)
    return run_ranks(body_shard_decode, 4, setup, MODES,
                     ("llama", prompt, GEN_NEW))


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


@pytest.fixture(scope="module")
def one(setup):
    """The port's one-device steps from the same cache: per case, each
    step's (logits, cache) as numpy."""
    out = {}
    with torch.no_grad():
        for case, (cfg, tree, cache, fed) in setup.items():
            params = M.params_from_numpy(cfg, tree, device="cpu")
            c = {k: torch.tensor(v) for k, v in cache.items()}
            steps = []
            for t in range(STEPS):
                logits, c = M.decode_step(cfg, params, c,
                                          {"token": torch.as_tensor(fed[:, t])})
                steps.append((logits.numpy(),
                              {k: v.numpy().copy() for k, v in c.items()}))
            out[case] = steps
    return out


CASE_MODES = [(c, m) for c in CASES for m in MODES]
IDS = [f"{c}-{m}" for c, m in CASE_MODES]


@pytest.mark.parametrize("case,mode", CASE_MODES, ids=IDS)
def test_sharded_decode_matches_the_reference(case, mode, ranks, ref):
    """Each step's logits and every written cache leaf (gathered) within
    TOL of the reference's ``decode_step`` under ``jax.jit`` with its
    cache placed by ``cache_pspecs(mode)`` on the same (2, 2) mesh."""
    for t, step in enumerate(ranks[0][case, mode]["steps"]):
        want = ref[f"{case}_{mode}_{t}_logits"]
        np.testing.assert_allclose(step["logits"], want, **TOL)
        for key, got in step["cache"].items():
            want = ref[f"{case}_{mode}_{t}_cache_{key}"]
            assert got.shape == want.shape, key
            np.testing.assert_allclose(got, want, **TOL, err_msg=key)


@pytest.mark.parametrize("case,mode", CASE_MODES, ids=IDS)
def test_sharded_decode_matches_one_device(case, mode, ranks, one):
    """Each step's logits and every cache leaf within 1e-5 x max|ref| of
    the port's one-device ``decode_step`` from the same cache, ``len``
    equal, the same bits on every rank."""
    for t, step in enumerate(ranks[0][case, mode]["steps"]):
        logits, cache = one[case][t]
        err = np.abs(step["logits"] - logits).max()
        assert err <= ONE_REL * np.abs(logits).max(), (t, err)
        for key, want in cache.items():
            got = step["cache"][key]
            if key == "len":
                assert got == want
                continue
            err = np.abs(got - want).max()
            assert err <= ONE_REL * np.abs(want).max(), (t, key, err)
    for r in ranks[1:]:
        for a, b in zip(r[case, mode]["steps"], ranks[0][case, mode]["steps"]):
            assert np.array_equal(a["logits"], b["logits"])
            assert all(np.array_equal(a["cache"][k], b["cache"][k])
                       for k in a["cache"])


@pytest.mark.parametrize("case,mode", CASE_MODES, ids=IDS)
def test_sharded_decode_writes_the_cache_in_place(case, mode, ranks):
    """The returned cache holds the placed cache's own DTensors in their
    placements (``len`` a replicated DTensor, one longer), on every rank;
    a sequence-mode attention cache is split on W over ``model`` (the
    combine path runs), feature mode's on the head dim, and Mamba2's conv
    state on its channels in both."""
    kv = {"feature": ["S(1)", "S(4)"], "sequence": ["S(1)", "S(2)"]}[mode]
    want = {"len": ["R", "R"], "k": kv, "v": kv, "shared_k": kv,
            "shared_v": kv, "conv": ["S(1)", "S(3)"],
            "ssm": ["S(1)", "S(4)"]}
    for r in ranks:
        got = r[case, mode]
        assert got["in_place"] and got["len"] == "DTensor"
        assert got["places"] == {k: want[k] for k in got["places"]}


def test_sharded_generate_gives_the_one_device_tokens(ranks, setup):
    """``generate`` on placed params: the one-device tokens, as a DTensor,
    on every rank; the cache keeps the placements ``prefill`` gives it
    (batch over ``data``, kv heads over ``model``) and ``len`` stays a
    plain tensor."""
    cfg, tree, _, _ = setup["llama"]
    prompt = lm_tokens(cfg, n=8, batch=BATCH, seed=5)
    params = M.params_from_numpy(cfg, tree, device="cpu")
    with torch.no_grad():
        want = lm.generate(cfg, params, torch.as_tensor(prompt), GEN_NEW)
    for r in ranks:
        got = r["generate"]
        assert got["type"] == "DTensor"
        np.testing.assert_array_equal(got["tokens"], want.numpy())
        assert got["cache"] == {"len": [], "k": ["S(1)", "S(3)"],
                                "v": ["S(1)", "S(3)"]}


def test_decoder_makes_no_graph_on_placed_params(ranks):
    """The ``Decoder`` on placed params keeps from capturing (chosen by
    the params' type): a host-staged collective cannot be captured."""
    for r in ranks:
        assert r["generate"]["captured"] == (False, False)


def test_mixed_inputs_raise(ranks):
    """Plain params with a placed cache, and placed params with a plain
    cache, raise ``ValueError`` on every rank."""
    for r in ranks:
        plain_params, plain_cache = r["generate"]["mixed"]
        assert "is a DTensor and the params are plain" in plain_params
        assert "cache['k'] is a plain tensor" in plain_cache
        assert all("launch.sharding.distribute" in m
                   for m in r["generate"]["mixed"])


def test_host_staged_groups_carry_the_decode(ranks):
    """The combine's all-gather and the redistributions went through the
    host-staged gloo sub-groups, the same count on every rank."""
    for r in ranks:
        assert r["collectives"] == ranks[0]["collectives"]
        assert ("all_gather", "direct") in r["collectives"]


@pytest.mark.parametrize("valid_len", [0, 1, 9, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_lse_matches_float64_logsumexp(valid_len, dtype):
    """The plain version's lse (and the wrapper's on the CPU): the
    float64 ``logsumexp`` of the scaled scores over the valid entries,
    within 1e-5 x max(1, |ref|); -1e30 with no valid entry."""
    g = torch.Generator().manual_seed(valid_len)
    q = torch.randn((2, 4, 3, 32), generator=g).to(dtype)
    k, v = (torch.randn((2, 16, 4, 32), generator=g).to(dtype)
            for _ in range(2))
    vl = torch.tensor([valid_len], dtype=torch.int32)
    o, lse = attn_ref.decode_attention_ref(q, k, v, vl[0], with_lse=True)
    assert lse.shape == (2, 4, 3) and lse.dtype == torch.float32
    s = torch.einsum("bkgd,bwkd->bkgw", q.double(), k.double()) / 32 ** 0.5
    if valid_len:
        want = torch.logsumexp(s[..., :valid_len], dim=-1)
    else:
        want = torch.full(lse.shape, -1e30, dtype=torch.float64)
    assert ((lse.double() - want).abs()
            <= 1e-5 * want.abs().clamp_min(1)).all()
    torch.testing.assert_close(o, attn_ref.decode_attention_ref(q, k, v,
                                                                vl[0]))
    o2, lse2 = attn_ops.decode_attention(q, k, v, vl, with_lse=True)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


@pytest.mark.parametrize("valid", [3, 8, 9, 16],
                         ids=["second_empty", "boundary", "crossed", "full"])
def test_combining_two_halves_gives_the_whole(valid):
    """``sharded.combine`` of the two halves' (o, lse) of a 16-entry
    cache, each half attending over its entries below ``valid`` (a half
    with none weighs 0), within 1e-6 of the whole cache's output."""
    g = torch.Generator().manual_seed(valid)
    q = torch.randn((2, 4, 3, 32), generator=g)
    k, v = (torch.randn((2, 16, 4, 32), generator=g) for _ in range(2))
    whole = attn_ref.decode_attention_ref(q, k, v, valid)
    parts = [attn_ref.decode_attention_ref(
        q, k[:, r * 8:(r + 1) * 8], v[:, r * 8:(r + 1) * 8],
        min(max(valid - r * 8, 0), 8), with_lse=True) for r in (0, 1)]
    got = sharded.combine(torch.stack([o for o, _ in parts]),
                          torch.stack([lse for _, lse in parts]))
    torch.testing.assert_close(got, whole, rtol=0, atol=1e-6)
