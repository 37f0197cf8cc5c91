"""The LM-side examples, ``examples/{lm_generate,train_tiny,
pico_pod_pipeline}_torch.py``, each run through its ``main`` on the CPU.

lm_generate's tokens come from the port's own weights and are not
compared across packages (each family's parity is in
``test_torch_lm.py``); train_tiny trains TRAIN_STEPS steps, not 200,
and its loss must still fall; the pod pipeline's stage split and period
on the four-H100 cluster must equal the JAX package's plan of the same
cluster, and its four gloo ranks' result the monolithic forward (the
example holds it within 2e-5).  About 25 s on one CPU worker (26 s
alone; 12 s of test time in a run of the whole suite on six workers of
an 8-core CPU).
"""

import importlib
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.api import PlanSpec as RefPlanSpec
from repro.core import Cluster as RefCluster
from repro.core import Device as RefDevice
from repro.core import plan as ref_plan
from repro.models.graph_export import export_graph as ref_export_graph
from repro_torch.launch.roofline import LINK_BYTES_PER_S, PEAK_FLOPS
from repro_torch.training import checkpoint

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

# train_tiny's steps here (the example's default is 200)
TRAIN_STEPS = 40


def example(name):
    return importlib.import_module(name)


@pytest.fixture(autouse=True)
def _one_thread():
    """The examples' small tensors run about as fast on one thread, and the
    other test workers need the cores (eight threads a worker ran these
    tests ten times slower beside two other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lm_generate_runs_every_family(capsys):
    mod = example("lm_generate_torch")
    got = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert list(got) == list(mod.FAMILIES)
    for name, toks in got.items():
        vocab = ref_configs.get(name).reduced(n_layers=2,
                                              d_model=128).vocab_size
        assert toks.shape == (4, 16) and toks.dtype == torch.int32
        assert 0 <= int(toks.min()) and int(toks.max()) < vocab
        assert f"{name:22s}" in out
    assert "batched prefill+decode serving works across families ✓" in out
    # seeded: a second run gives the same tokens
    again = mod.main(["--device", "cpu"])
    assert all(torch.equal(got[n], again[n]) for n in got)


def test_train_tiny_reduces_the_loss_and_checkpoints(capsys, monkeypatch,
                                                     tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got = example("train_tiny_torch").main(
        ["--steps", str(TRAIN_STEPS), "--device", "cpu"])
    out = capsys.readouterr().out
    assert got["steps"] == len(got["losses"]) == TRAIN_STEPS
    assert got["last"] < got["first"]
    assert all(np.isfinite(got["losses"]))
    assert got["ckpt"] == str(tmp_path / "repro_torch_tiny_ckpt")
    assert (tmp_path / "repro_torch_tiny_ckpt.npz").exists()
    assert "checkpoint saved to" in out and "loss " in out
    # the checkpoint restores into the config's tree, trained away from
    # the seeded init
    from repro_torch import configs
    from repro_torch.models.transformer import model as M
    from repro_torch.training import tree
    cfg = configs.get("llama3.2-1b").reduced(n_layers=2, d_model=128)
    init = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    saved = checkpoint.load(tmp_path / "repro_torch_tiny_ckpt", init)
    moved = [not torch.equal(a, b) for a, b in zip(tree.leaves(saved),
                                                   tree.leaves(init))]
    assert len(moved) > 0 and any(moved)


def test_pico_pod_pipeline_split_and_ranks(capsys):
    mod = example("pico_pod_pipeline_torch")
    got = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    # the JAX package plans the same four-H100 cluster
    cluster = RefCluster([RefDevice(f"h100-{i}",
                                    capacity=PEAK_FLOPS["float32"])
                          for i in range(mod.N_STAGES)],
                         bandwidth=LINK_BYTES_PER_S)
    cfg = ref_configs.get("llama3.2-1b").reduced(n_layers=8, d_model=128)
    pico = ref_plan(ref_export_graph(cfg, seq_len=64), cluster, (64, 1),
                    spec=RefPlanSpec(max_diameter=2))
    assert got["stages"] == [(s.first_piece, s.last_piece,
                              [d.name for d in s.devices])
                             for s in pico.pipeline.stages]
    assert got["period"] == pico.period
    assert len(got["stages"]) == mod.N_STAGES
    assert got["max_diff"] <= 2e-5
    assert "matches the monolithic forward ✓" in out
    assert "tpu" not in out.lower()
