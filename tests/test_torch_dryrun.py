"""The port's launch tooling (``repro_torch.launch.dryrun``, ``profile``,
``report`` and ``repro_torch.configs.shapes``) against the JAX
package's: the counterparts of ``test_dryrun_single_combo`` and
``test_long_context_variants``, the input specs leaf for leaf, the
records' keys, and a reduced dense step's census against the
reference's compiled HLO (one JAX subprocess on 4 host devices, the port
on a fake (2, 2) mesh).  Also the sharded-path faults the dry run found
at the production mesh: 8 kv heads over a ``model`` axis of 16, the
FFN's input after attention, and the loss's label gather."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro import configs as ref_configs
from repro.configs import shapes as ref_shapes
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.launch import dryrun, profile, report
from repro_torch.launch.hlo_analysis import Census, Largest
from repro_torch.launch.mesh import make_mesh, make_test_mesh
from repro_torch.models.transformer import sharded
from repro_torch.training import tree
from repro_torch.training.steps import loss_and_grads

ROOT = Path(__file__).resolve().parents[1]
#: the reference's record keys (``src/repro/launch/dryrun.py::run_combo``)
KEYS = {"arch", "shape", "mesh", "opts", "n_devices", "kind", "params",
        "active_params", "variant", "ok", "lower_s", "compile_s", "memory",
        "roofline", "model_flops_per_device", "useful_flops_ratio",
        "wall_s"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes",
          "generated_code_bytes"}
ROOF = {"flops", "bytes_accessed", "coll_bytes", "coll_breakdown",
        "compute_s", "memory_s", "collective_s", "dominant"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def decode_rec(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    rec = dryrun.run_combo("llama3.2-1b", "decode_32k", False, out,
                           force=True, save_census=True, device="cpu")
    return rec, out


def test_dryrun_single_combo(decode_rec):
    """The reference's test: Llama-3.2-1B x decode_32k at full width on
    the 16 x 16 mesh (a fake group of 256 ranks) runs, with the
    reference's keys.  Its census is pinned: ``chip_smoke.py``'s phase 11
    holds the card's torch to the same numbers."""
    rec, _ = decode_rec
    assert rec["ok"], rec.get("error")
    assert rec["roofline"]["flops"] > 0
    assert KEYS <= set(rec) and MEMORY == set(rec["memory"])
    assert ROOF <= set(rec["roofline"])
    assert (rec["mesh"], rec["n_devices"], rec["kind"]) == ("16x16", 256,
                                                            "decode")
    assert rec["memory"]["generated_code_bytes"] == 0
    assert rec["memory"]["argument_bytes"] > 0
    pin = _chip_smoke().DRYRUN_PIN
    ro = rec["roofline"]
    assert {"flops": ro["flops"], "bytes": ro["bytes_accessed"],
            "coll": ro["coll_breakdown"]} == pin


def test_the_record_and_census_are_saved(decode_rec):
    rec, out = decode_rec
    path = out / "llama3.2-1b__decode_32k__pod1.json"
    assert json.loads(path.read_text())["roofline"] == rec["roofline"]
    census = profile.load(path.with_suffix(".census.json.gz"))
    assert census.flops == rec["roofline"]["flops"]
    text = profile.listing(census, top=3)
    for head in ("totals:", "collectives by kind:", "top 3 entries by FLOPs:",
                 "top 3 individual collective ops:"):
        assert head in text
    assert "decode_attention" in text and "all-gather" in text
    # resumable: the saved record comes back without a run
    again = dryrun.run_combo("llama3.2-1b", "decode_32k", False, out,
                             device="cpu")
    assert again == json.loads(path.read_text())


def test_prefill_runs_at_the_production_mesh(tmp_path):
    """Llama's prefill at 16 x 16: its FFN takes whole rows after the
    attention block (before, DTensor's sharding propagation refused the
    MLP's product on a strided sequence shard)."""
    rec = dryrun.run_combo("llama3.2-1b", "prefill_32k", False, tmp_path,
                           force=True, device="cpu")
    assert rec["ok"], rec.get("error")
    by = rec["roofline"]
    assert by["flops"] > 0 and by["dtype"] == "bfloat16"


def test_a_failing_combo_is_recorded(tmp_path):
    """A combo that raises inside ``run_combo`` (an arch ``configs.get``
    does not know) is recorded with ``ok`` false, its error and
    traceback."""
    rec = dryrun.run_combo("no-such-arch", "prefill_32k", False, tmp_path,
                           force=True, device="cpu", opts={"ring": True})
    assert rec["ok"] is False
    assert rec["error"] and "Traceback" in rec["traceback"]
    assert rec["opts"] == ["ring"]
    assert (tmp_path / "no-such-arch__prefill_32k__pod1__ring.json").exists()


def test_the_ring_prefill_runs_at_the_production_mesh(tmp_path, capsys):
    """``--opt ring`` on Llama's prefill_32k at 16 x 16 (placed params, a
    fake group of 256) is ``ok``: each layer's attention rings over
    ``model`` on each rank's rows, 15 hand-offs of its k/v block a layer
    (the last rotation skipped): 16 x 15 collective-permutes on rank 0,
    each k and v of (2, 2048, 8, 64) in bf16, pinned in
    ``chip_smoke.py::DRYRUN_RING_PIN`` (phase 11 holds the card's torch to
    it); no ``flash_prefill`` call."""
    pin = _chip_smoke().DRYRUN_RING_PIN
    assert pin == {"counts": 16 * 15, "bytes": 16 * 15 * 2 * (
        2 * 2048 * 8 * 64) * 2}
    rc = dryrun.main(["--arch", "llama3.2-1b", "--shape", "prefill_32k",
                      "--opt", "ring", "--device", "cpu", "--save-census",
                      "--out", str(tmp_path)])
    assert rc == 0 and "1/1 combos OK" in capsys.readouterr().out
    path = tmp_path / "llama3.2-1b__prefill_32k__pod1__ring.json"
    rec = json.loads(path.read_text())
    assert rec["ok"] and rec["opts"] == ["ring"]
    coll = rec["roofline"]["coll_breakdown"]
    assert {k: coll[k]["collective-permute"] for k in coll} == pin
    census = profile.load(path.with_suffix(".census.json.gz"))
    assert "flash_prefill" not in census.by_computation


def test_main_writes_a_record(tmp_path, capsys):
    rc = dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                      "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads((tmp_path / "llama3.2-1b__long_500k__pod1.json")
                     .read_text())
    assert rec["ok"] and KEYS <= set(rec)
    assert rec["variant"] == "llama3.2-1b-swa8192"
    assert "1/1 combos OK" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_main_refuses_cuda_without_a_card(tmp_path):
    with pytest.raises(SystemExit, match="no CUDA device"):
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])


def test_fake_group_refuses_a_started_group():
    with dryrun.fake_group(4):
        with pytest.raises(RuntimeError, match="already started"):
            with dryrun.fake_group(4):
                pass


def test_long_context_variants():
    long = shapes.SHAPES["long_500k"]
    for name in configs.ARCH_NAMES:
        cfg = shapes.arch_for_shape(configs.get(name), long)
        assert cfg.supports_long_context, name
        assert cfg.name == ref_shapes.arch_for_shape(
            ref_configs.get(name), ref_shapes.SHAPES["long_500k"]).name


def _leaves(specs, ref: bool) -> dict:
    if ref:
        flat = jax.tree_util.tree_flatten_with_path(specs)[0]
        return {jax.tree_util.keystr(p): (tuple(s.shape), str(s.dtype))
                for p, s in flat}
    out = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(prefix + f"[{k!r}]", v)
        else:
            out[prefix] = (tuple(t.shape), str(t.dtype).removeprefix(
                "torch."))
    walk("", specs)
    return out


@pytest.mark.parametrize("shape", sorted(shapes.SHAPES))
def test_input_specs_match_the_reference(shape):
    """Every arch's fake inputs have the reference's keys, shapes and
    dtypes (the decode cache is ``init_cache`` under ``FakeTensorMode``),
    on the device asked for, allocating nothing."""
    assert shapes.SHAPES[shape] == shapes.InputShape(
        *map(lambda f: getattr(ref_shapes.SHAPES[shape], f),
             ("name", "seq_len", "global_batch", "kind")))
    for name in configs.ARCH_NAMES:
        got = shapes.input_specs(configs.get(name), shapes.SHAPES[shape],
                                 device="cuda")
        want = ref_shapes.input_specs(ref_configs.get(name),
                                      ref_shapes.SHAPES[shape])
        assert _leaves(got, False) == _leaves(want, True), name
        for t in tree.leaves(got):
            assert t.device.type == "cuda"


def test_heads_are_whole_where_the_kv_heads_do_not_divide():
    """``sharded.heads``: a (B, S, K D) projection split over ``model``
    is viewed as K heads only where K divides over it; 8 kv heads over a
    ``model`` axis of 16 (Llama-3.2-1B at 16 x 16) are gathered first."""
    with dryrun.fake_group(4):
        mesh = make_mesh((1, 4), ("data", "model"), "cpu")
        with FakeTensorMode():
            t = DTensor.from_local(torch.empty(2, 3, 16), mesh,
                                   [Replicate(), Shard(2)], run_check=False,
                                   shape=(2, 3, 64), stride=(192, 64, 1))
            assert sharded.heads(t, 4) is t
            assert tuple(sharded.heads(t, 2).placements) == (Replicate(),
                                                             Replicate())
            assert tuple(sharded.heads(t, 2).reshape(2, 3, 2, 32).shape) \
                == (2, 3, 2, 32)


def test_the_sharded_loss_zeros_no_global_logits():
    """The loss's label gather on placed params runs on local shards
    (``sharded.token_nll``): its backward zeros this rank's logits, never
    a replicated tensor of the global (B, S, V) (DTensor's own gather
    backward does, which at 16 x 16 is 539 GB a rank for Llama's
    train_4k).  ``Largest`` is ``launch.hlo_analysis``'s watcher."""
    cfg = configs.get("llama3.2-1b").reduced(n_layers=1, d_model=64)
    B, S = 4, 16
    with dryrun.fake_group(4):
        mesh = make_test_mesh(4, device_type="cpu")
        mode = FakeTensorMode()
        fn, (params, _, batch), _ = dryrun.build_step(
            cfg, shapes.InputShape("t", S, B, "train"), mesh, {}, "cpu",
            mode)
        largest = Largest()
        with mode, Census(), largest:
            loss_and_grads(cfg, params, batch)
    assert largest.most < B * S * cfg.vocab_padded


def test_the_sharded_train_step_holds_no_whole_vocab():
    """The reduced train step (``make_train_step``: the loss, its
    gradients and AdamW) on (data 2, model 2): no dispatch on rank 0
    makes a tensor with the whole padded vocab as a dim (the loss keeps
    the logits' vocab split, ``sharded.token_nll``; only the (V,) mask of
    padded slots is whole), and none has more elements than this rank's
    logits, B_loc S V / m (B_loc S = d here, so the embedding's and the
    head's slices are that size too)."""
    cfg = dataclasses.replace(configs.get("llama3.2-1b").reduced(
        n_layers=1, d_model=64), vocab_size=1000)
    B, S, m = 4, 32, 2
    assert cfg.vocab_padded > cfg.vocab_size
    with dryrun.fake_group(4):
        mesh = make_test_mesh(4, device_type="cpu")
        mode = FakeTensorMode()
        fn, args, _ = dryrun.build_step(
            cfg, shapes.InputShape("t", S, B, "train"), mesh, {}, "cpu",
            mode)
        watch = Largest(cfg.vocab_padded)
        with mode, Census(), watch:
            fn(*args)
    assert watch.vocab_rows == []
    assert 0 < watch.most <= (B // 2) * S * cfg.vocab_padded // m


def test_the_step_all_gathers_fall_by_the_logits_gather():
    """The logits' all-gather is gone: on (data 2, model 2), rank 0's
    all-gathers in ``sharded.token_nll``'s forward and backward on
    placed (B, S, V) fp32 logits are the vocab slices' log-sum-exps
    alone, B_loc S m 4 bytes, where the parent gathered the logits,
    B_loc S V 4 bytes (the census counts an all-gather at its result's
    bytes); and the whole ``loss_and_grads`` of the reduced Llama
    all-gathers less than that gather of the logits alone."""
    cfg = configs.get("llama3.2-1b").reduced(n_layers=1, d_model=64)
    B, S, m = 4, 16, 2
    rows, V = (B // 2) * S, cfg.vocab_padded
    with dryrun.fake_group(4):
        mesh = make_test_mesh(4, device_type="cpu")
        mode = FakeTensorMode()
        _, (params, _, batch), _ = dryrun.build_step(
            cfg, shapes.InputShape("t", S, B, "train"), mesh, {}, "cpu",
            mode)
        with mode:
            logits = DTensor.from_local(
                torch.empty(B // 2, S, V // m, requires_grad=True), mesh,
                [Shard(0), Shard(2)], run_check=False, shape=(B, S, V),
                stride=(S * V, V, 1))
            labels = DTensor.from_local(
                torch.zeros(B // 2, S, dtype=torch.long), mesh,
                [Shard(0), Replicate()], run_check=False, shape=(B, S),
                stride=(S, 1))
        with mode, Census() as loss:
            sharded.token_nll(logits, labels).sum().backward()
        with mode, Census() as step:
            loss_and_grads(cfg, params, batch)
    assert [(n, k) for n, k, _ in loss.census.coll_ops
            if k == "all-gather"] == [(rows * m * 4, "all-gather")]
    assert step.census.coll_bytes["all-gather"] < rows * V * 4


def test_report_renders_records_of_either_package(decode_rec):
    """A record in the reference's schema (its mesh name, no ``dtype``)
    and the port's render into the same columns of both tables."""
    rec, _ = decode_rec
    ref = json.loads(json.dumps(rec))
    ref["roofline"].pop("dtype")
    ref.pop("device")
    ref["arch"] = "reference"
    failed = {"arch": "x", "shape": "decode_32k", "mesh": "pod1",
              "ok": False, "error": "boom"}
    for table in (report.roofline_table([rec, ref]),
                  report.dryrun_table([rec, ref, failed])):
        rows = table.splitlines()[2:]
        assert {r.count("|") for r in rows} == {10}
        assert any("| reference |" in r for r in rows)
        assert any("| llama3.2-1b |" in r for r in rows)
    assert "FAILED: boom" in report.dryrun_table([failed])
    assert report.roofline_table([rec], mesh="pod2").count("\n") == 1


# -- a reduced dense step against the reference's compiled HLO ---------------

PARITY = {"arch": "llama3.2-1b", "reduced": {"n_layers": 2, "d_model": 128},
          "shapes": {"decode": [64, 4, "decode", "bfloat16"],
                     "train": [64, 4, "train", "float32"]}}

REFERENCE = """
import json, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.compat import set_mesh
from repro.configs.shapes import InputShape, input_specs
from repro.launch.hlo_analysis import _dot_flops, analyze_hlo, parse_hlo
from repro.launch.mesh import batch_axes, make_test_mesh
from repro.launch.sharding import batch_pspecs, cache_pspecs, param_pspecs
from repro.models.transformer import model as M
from repro.training.optim import AdamW, AdamWState
from repro.training.steps import make_train_step

spec = json.loads(sys.argv[1])
cfg = configs.get(spec["arch"]).reduced(**spec["reduced"])
mesh = make_test_mesh(4)
daxes = batch_axes(mesh)
named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                               is_leaf=lambda x: isinstance(x, P))
out = {}
for name, (S, B, kind, dtype) in spec["shapes"].items():
    shape, dt = InputShape(name, S, B, kind), getattr(jnp, dtype)
    specs = input_specs(cfg, shape, dt)
    params = jax.eval_shape(
        lambda: M.init_params(cfg, jax.random.PRNGKey(0), dtype=dt))
    p_shard = named(param_pspecs(cfg, params, mesh))
    with mesh, set_mesh(mesh):
        if kind == "train":      # the reference's dryrun.build_lowered
            opt = AdamW(lr=1e-4)
            opt_shape = jax.eval_shape(lambda: opt.init(params))
            o_specs = AdamWState(P(), param_pspecs(cfg, opt_shape.m, mesh),
                                 param_pspecs(cfg, opt_shape.v, mesh))
            jitted = jax.jit(make_train_step(cfg, opt), in_shardings=(
                p_shard, named(o_specs),
                named(batch_pspecs(cfg, specs, mesh, daxes))))
            lowered = jitted.lower(params, opt_shape, specs)
        else:
            jitted = jax.jit(lambda p, c, i: M.decode_step(cfg, p, c, i),
                             in_shardings=(
                p_shard, named(cache_pspecs(cfg, specs["cache"], mesh,
                                            daxes)),
                named(batch_pspecs(cfg, specs["inputs"], mesh, daxes))))
            lowered = jitted.lower(params, specs["cache"], specs["inputs"])
    compiled = lowered.compile()
    text = compiled.as_text()
    census = analyze_hlo(text)
    comps, _ = parse_hlo(text)
    # the attention's products carry batch dims (rank >= 3 results); the
    # projections' and the MLP's are 2-D
    attn = 0.0
    for cname, comp in comps.items():
        m = census.by_computation.get(cname, {}).get("mult", 0.0)
        for op in comp.ops:
            dims = op.result.split("[", 1)[-1].split("]", 1)[0]
            if op.opcode == "dot" and dims.count(",") >= 2:
                attn += _dot_flops(op, comp.symbols) * m
    tokens = B * (S if kind == "train" else 1)
    out[name] = {
        "argument_bytes": compiled.memory_analysis().argument_size_in_bytes,
        "flops": census.flops, "attention_flops": attn,
        "model_flops_per_device":
            (6 if kind == "train" else 2) * cfg.active_param_count()
            * tokens / 4}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """(the reference's numbers, the port's records and censuses)."""
    d = tmp_path_factory.mktemp("parity")
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": str(d)}
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         json.dumps(PARITY)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    cfg = configs.get(PARITY["arch"]).reduced(**PARITY["reduced"])
    port = {}
    with dryrun.fake_group(4):
        mesh = make_test_mesh(4, device_type="cpu")
        for name, (S, B, kind, _) in PARITY["shapes"].items():
            port[name] = dryrun.measure(cfg, shapes.InputShape(name, S, B,
                                                               kind),
                                        mesh, {}, "cpu")
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.splitlines()[-1]), port, cfg


@pytest.mark.parametrize("name", sorted(PARITY["shapes"]))
def test_argument_bytes_and_model_flops_match_the_reference(parity, name):
    """Rank 0's inputs (params, AdamW state and batch, or params, cache
    and token, each placed by the port's ``param_pspecs``,
    ``batch_pspecs`` and ``cache_pspecs``) are the reference's compiled
    argument size to the byte; the model FLOPs are the same formula on
    the same counts."""
    ref, port, _ = parity
    fields, _ = port[name]
    assert fields["memory"]["argument_bytes"] == ref[name]["argument_bytes"]
    assert fields["model_flops_per_device"] == \
        ref[name]["model_flops_per_device"]


def test_decode_flops_match_the_reference(parity):
    """One decode step: the projections, the head and the attention over
    every cache entry (the port's ``decode_attention`` work counts all W,
    as the reference's XLA decode computes them) are the reference's
    FLOPs exactly."""
    ref, port, _ = parity
    assert port["decode"][1].flops == ref["decode"]["flops"]


def test_train_flops_match_the_reference_but_for_the_named_terms(parity):
    """One train step of the reduced Llama (2 layers, d 128, 4 heads and
    4 kv heads of 32, d_ff 256) on (data 2, model 2), T = 128 tokens a
    device.  The terms where the packages differ, each by formula:

    * attention: the reference's XLA attention computes every (q, kv)
      block, fully masked ones included (``src/repro/models/transformer/
      layers.py:86-142``): 8 products of S x S a layer (scores and P V,
      again in remat's recompute, and four in the backward); the port's
      kernels count their causal pairs: 2 x 2 products forward and in the
      recompute (``flash_prefill``) and 5 in the backward
      (``flash_prefill_bwd``);
    * what is left, within 5%: XLA keeps some of the forward's
      projections for the backward where eager remat runs them again
      (about 4% here).

    The MLP runs on its ``d_ff`` slices (``sharded.mlp``), so its
    backward products are the reference's: no term for a gathered w2.
    The dense config has no Mamba2 gathers, and the loss keeps the vocab
    split (``sharded.token_nll``)."""
    ref, port, cfg = parity
    census = port["train"][1]
    L, S, B, m = cfg.n_layers, 64, 4 // 2, 2
    K, G, D = cfg.n_kv_heads // m, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    pair = 2.0 * B * K * G * D
    causal = S * (S + 1) // 2
    assert ref["train"]["attention_flops"] == L * 8 * pair * S * S
    kernels = {n: census.by_computation[n]["flops"]
               for n in ("flash_prefill", "flash_prefill_bwd")}
    assert kernels == {"flash_prefill": L * 4 * pair * causal,
                       "flash_prefill_bwd": L * 5 * pair * causal}
    port_mm = census.flops - sum(kernels.values())
    ref_mm = ref["train"]["flops"] - ref["train"]["attention_flops"]
    assert abs(port_mm - ref_mm) <= 0.05 * ref_mm, (port_mm, ref_mm)
