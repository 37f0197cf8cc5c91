"""The CNN-side examples, ``examples/{quickstart,serve_pipeline,
dist_pipeline}_torch.py``, and the plan CLI's launcher,
``tools/plan_cli_torch.py``, on the CPU.

Each example runs through its ``main``, where its own numerics checks
run (the quickstart's pipelined-vs-monolithic check and its save/load
round-trip, dist_pipeline's bit-identical recovery), and its planner and
model-time figures must *equal* the JAX package's library on the same
arguments (the planner, the simulator and the server's model-time
arithmetic are framework-free copies).  Two commands hold the script
entry: ``python examples/quickstart_torch.py --device cpu`` and the
launcher's plan, then ``--load --validate --execute --device cpu``.
About 70 s on one CPU worker (69.6 s alone; 76 s of test time in a run
of the whole suite on six workers of an 8-core CPU).
"""

import importlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import repro
from repro.core import make_pi_cluster as ref_pi_cluster
from repro.data.pipeline import RequestStream as RefRequestStream
from repro.models.cnn import zoo as ref_zoo
from repro.serving import PipelineServer as RefPipelineServer

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))


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


def _stages(pipeline) -> list:
    return [(s.first_piece, s.last_piece, [d.name for d in s.devices])
            for s in pipeline.stages]


def _command(argv, tmp_path) -> subprocess.Popen:
    """``python <argv>`` from the repo root, the port on its path,
    ``tmp_path`` its temporary directory and one thread, started (not
    waited for)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_quickstart_equals_the_reference(capsys, monkeypatch, tmp_path):
    # the command runs while main and the reference plan run here
    (tmp_path / "cmd").mkdir()
    proc = _command(["examples/quickstart_torch.py", "--device", "cpu"],
                    tmp_path / "cmd")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got = example("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "pipelined execution matches monolithic forward ✓ on cpu" in out
    assert "is bit-identical ✓" in out
    assert got["path"] == str(tmp_path / "quickstart_torch_plan.json")

    model = ref_zoo.inceptionv3(input_size=(128, 128), scale=0.25)
    dep = repro.compile(model, ref_pi_cluster([1.5, 1.2, 1.0, 0.8]))
    rep = dep.simulate(frames=32)
    want = {"pieces": len(dep.partition.pieces),
            "objective": dep.partition.objective,
            "stages": _stages(dep.pipeline), "period": dep.period,
            "latency": dep.latency,
            "throughput_per_min": rep.throughput_per_min,
            "avg_utilization": rep.avg_utilization,
            "avg_redundancy": rep.avg_redundancy,
            "avg_memory": rep.avg_memory}
    assert {k: got[k] for k in want} == want

    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr
    assert "pipelined execution matches monolithic forward ✓ on cpu" \
        in stdout
    assert "is bit-identical ✓" in stdout
    assert (tmp_path / "cmd" / "quickstart_torch_plan.json").exists()


def test_serve_pipeline_equals_the_reference(capsys):
    got = example("serve_pipeline_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "served every request on cpu ✓" in out

    model = ref_zoo.resnet34(input_size=(128, 128), scale=0.25)
    server = RefPipelineServer(
        model, ref_pi_cluster([1.5, 1.5, 1.2, 1.2, 0.8, 0.8])).load()
    H, W = model.input_size[1], model.input_size[0]
    requests = RefRequestStream(rate_per_s=0.8 / server.pico.period,
                                seed=0).generate(
        24, lambda rng, i: rng.standard_normal((1, H, W, 3)).astype(
            np.float32))
    outputs, stats = server.serve(requests)
    lat = np.array(stats.per_request)
    want = {"served": stats.served, "period": server.pico.period,
            "latency": server.pico.latency,
            "throughput_per_min": stats.model_throughput_per_min,
            "per_request": list(stats.per_request),
            "p50": np.percentile(lat, 50), "p95": np.percentile(lat, 95)}
    assert {k: got[k] for k in want} == want
    assert [{k: tuple(v.shape) for k, v in o.items()}
            for o in got["outputs"]] == [
        {k: tuple(v.shape) for k, v in o.items()} for o in outputs]


def test_dist_pipeline_equals_the_reference(capsys):
    got = example("dist_pipeline_torch").main(
        ["--device", "cpu", "--peer-timeout", "4"])
    out = capsys.readouterr().out
    assert got["validation"].ok and got["validation"].bit_identical
    assert got["streamed"].completed == 6 and not got["streamed"].dropped
    assert len(got["dead"]) == 1
    assert "all outputs bit-identical ✓" in out

    model = ref_zoo.squeezenet(input_size=(64, 64), scale=0.1)
    cluster = ref_pi_cluster([1.5, 1.2, 1.0], bandwidth_mbps=50.0)
    dep = repro.compile(model, cluster)
    assert got["stages"] == _stages(dep.pipeline)
    assert got["period"] == dep.period
    dep2 = dep.replan(cluster.restricted(
        [d for d in cluster.devices if d.name not in got["dead"]]))
    assert got["replanned"] == _stages(dep2.pipeline)
    assert got["replanned_period"] == dep2.period


def test_dist_pipeline_keeps_the_references_drill_timeout():
    """The drill's default is the JAX example's 0.6 s; the test above
    passes 4 s (0.6 s flakes under CPU load, as the JAX package's own
    killed-worker test does)."""
    assert example("dist_pipeline_torch").PEER_TIMEOUT_S == 0.6


def test_plan_cli_launcher_plans_and_executes(tmp_path):
    path = tmp_path / "plan.json"
    proc = _command(["tools/plan_cli_torch.py", "--model", "squeezenet",
                     "--scale", "0.25", "--input", "48", "--devices", "2",
                     "--out", str(path), "--device", "cpu"], tmp_path)
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr
    assert f"saved deployment artifact -> {path}" in stdout
    proc = _command(["tools/plan_cli_torch.py", "--load", str(path),
                     "--validate", "--execute", "--device", "cpu"], tmp_path)
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr
    assert "validate: schema v1 ok, round-trip ok" in stdout
    assert "execute: pipelined outputs match monolithic forward ✓ on cpu" \
        in stdout
    # the artifact is the JAX package's document: its planner gives the
    # same plan
    ref = repro.Deployment.load(str(path))
    model = ref_zoo.squeezenet(input_size=(48, 48), scale=0.25)
    dep = repro.compile(model, ref_pi_cluster([1.5, 1.2]))
    assert _stages(ref.pipeline) == _stages(dep.pipeline)
    assert ref.period == dep.period
