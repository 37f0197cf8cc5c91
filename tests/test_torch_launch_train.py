"""The train launcher (``repro_torch.launch.train``) sharded over
``torchrun``'s ranks: with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` in the environment it starts the
process group, builds the mesh by the reference's shape rule, places the
params by ``param_pspecs`` and each batch by ``batch_pspecs``, and runs
the sharded ``make_train_step``; without them the one-device path runs.
Held: every step's loss within 1e-5 relative of the one-device
launcher's on the same arguments, the params in their specs' placements,
a real ``torchrun`` run, and the device and backend rule.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train

from _torch_mesh_ranks import body_launch_train, run_ranks

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--reduced", "--steps", "3", "--batch", "4", "--seq", "32",
        "--device", "cpu"]
LOSS_REL = 1e-5


@pytest.fixture(scope="module")
def one_device():
    """The one-device launcher's losses on ARGV (no torchrun
    environment)."""
    assert not train.under_torchrun()
    return train.main(ARGV).losses


def test_launcher_on_four_torchrun_ranks_matches_one_device(one_device):
    """Four ranks under torchrun's environment, gloo on the CPU: a (2, 2)
    ("data", "model") mesh, every step's loss on every rank within 1e-5
    relative of the one-device launcher's, the final params in their
    ``param_pspecs`` placements."""
    res = run_ranks(body_launch_train, 4, ARGV, backend=None)
    assert len(one_device) == 3
    for r in res:
        assert r["mesh"] == {"data": 2, "model": 2}
        assert r["placed"]
        assert r["losses"] == res[0]["losses"]
        for got, want in zip(r["losses"], one_device):
            assert abs(got - want) <= LOSS_REL * abs(want), (got, want)


def test_real_torchrun_runs_two_ranks_and_rank_zero_prints():
    """``python -m torch.distributed.run --nproc-per-node 2`` of the
    launcher, 2 steps on the CPU: exit 0, a (2, 1) mesh, and each line
    once (rank 0 prints, the other rank does not)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for key in train.TORCHRUN_ENV:
        env.pop(key, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port", str(port), "-m",
         "repro_torch.launch.train", "--reduced", "--steps", "2", "--batch",
         "4", "--seq", "32", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert [ln.split()[0] for ln in lines] == ["arch", "step", "step",
                                               "done:"], lines
    assert "{'data': 2, 'model': 1}: 2 ranks, backend gloo" in lines[0]


@pytest.mark.parametrize("spec,local_rank,want", [
    ("cuda", "3", "cuda:3"), ("cuda:0", "3", "cuda:0"), ("cpu", "1", "cpu")])
def test_rank_device_rule(spec, local_rank, want, monkeypatch):
    """Under torchrun ``--device cuda`` is ``cuda:LOCAL_RANK``; a device
    with an index is taken as given (ranks may share one card); the CPU
    stays the CPU.  The backend is NCCL on the card and gloo on the
    CPU."""
    monkeypatch.setenv("LOCAL_RANK", local_rank)
    device = train.rank_device(spec)
    assert device == torch.device(want)
    assert train.default_backend(device) == ("gloo" if want == "cpu"
                                             else "nccl")


def test_torchrun_without_a_card_stops(monkeypatch):
    """``--device cuda`` under torchrun's environment on a machine without
    a card stops with a message, before any process group: no CPU run
    instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks its absence")
    for key, value in zip(train.TORCHRUN_ENV,
                          ("0", "1", "0", "localhost", "1")):
        monkeypatch.setenv(key, value)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    assert not torch.distributed.is_initialized()
