"""The port's operational CLIs (``repro_torch.tools.plan`` and
``repro_torch.tools.trace``) against the JAX package's.

Both CLIs drive framework-free copies (planner, artifacts, trace codec),
so on the CPU they must print the same text as the reference's, except
the port's device: ``describe()`` ends its first line with "; runs on
<device>".  Artifacts and traces written by either package go through
the other's tool.  ``--execute`` runs here with ``--device cpu`` (the
conv kernel's plain version); without ``--device`` the port's CLI wants
a card and stops without one.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro
import repro_torch
from repro.core import make_pi_cluster as ref_pi_cluster
from repro.models.cnn import zoo as ref_zoo
from repro.tools import plan as ref_plan_cli
from repro_torch.api.specs import DeploySpec
from repro_torch.core import make_pi_cluster
from repro_torch.exec.autotune import clear_installed
from repro_torch.models.cnn import zoo
from repro_torch.tools import plan as plan_cli
from repro_torch.tools import trace as trace_cli

ROOT = Path(__file__).resolve().parents[1]
# tests/test_api.py's tiny plan: squeezenet at a quarter width, 48 x 48,
# two Pis
TINY = ["--model", "squeezenet", "--scale", "0.25", "--input", "48",
        "--devices", "2"]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _isolate_installed():
    clear_installed()
    yield
    clear_installed()


def _reference_trace_tool():
    """A private instance of the JAX package's trace tool, made while
    the calling test's capture is in place: its ``summarize`` binds
    ``sys.stdout`` when the module runs, and ``sys.modules`` keeps the
    instance ``tests/test_obs.py`` imports under its own capture."""
    spec = importlib.util.find_spec("repro.tools.trace")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# -- the plan CLI ----------------------------------------------------------

def test_plan_save_load_validate_execute_on_the_cpu(tmp_path, capsys):
    """Plan, save, then ``--load --validate --execute``: the reference's
    validate line, and one seeded frame through the pipelined stages
    within rtol = atol = 1e-5 of the monolithic forward."""
    out = tmp_path / "plan.json"
    rc, text, _ = _run(plan_cli.main, TINY + CPU + ["--out", str(out)],
                       capsys)
    assert rc == 0 and out.exists()
    assert f"saved deployment artifact -> {out}" in text
    assert text.splitlines()[0].endswith("; runs on cpu")
    rc, text, err = _run(plan_cli.main, ["--load", str(out), "--validate",
                                         "--execute"] + CPU, capsys)
    assert rc == 0, err
    assert "validate: schema v1 ok, round-trip ok, simulated period" in text
    line = [ln for ln in text.splitlines() if ln.startswith("execute:")]
    assert len(line) == 1
    assert line[0].startswith("execute: pipelined outputs match monolithic "
                              "forward ✓ on cpu")
    assert "limit 1e-05 + 1e-05 x |ref|" in line[0]


def test_execute_fails_on_a_wrong_output(tmp_path, capsys, monkeypatch):
    """``--execute`` holds the pipelined outputs at 1e-5: an output off
    by more gives exit code 1 and the worst difference."""
    out = tmp_path / "plan.json"
    assert plan_cli.main(TINY + CPU + ["--out", str(out)]) == 0
    run = repro_torch.Deployment.run

    def off(self, frames, params=None):
        return {k: v + 1e-3 for k, v in run(self, frames, params).items()}

    monkeypatch.setattr(repro_torch.Deployment, "run", off)
    rc, text, err = _run(plan_cli.main, ["--load", str(out), "--validate",
                                         "--execute"] + CPU, capsys)
    assert rc == 1 and "execute:" not in text
    assert "FAIL: pipelined outputs differ" in err


def test_plan_describe_is_the_references(capsys):
    """The same flags plan the same deployment: ``describe()`` equal line
    for line, the port's first line with its device after it."""
    for argv in (TINY, TINY + ["--freqs", "1.5,0.8", "--max-diameter", "3"],
                 ["--model", "vgg16", "--scale", "0.1", "--input", "40",
                  "--devices", "3", "--n-split", "3"]):
        rc, want, _ = _run(ref_plan_cli.main, argv, capsys)
        assert rc == 0
        rc, got, _ = _run(plan_cli.main, argv + CPU, capsys)
        assert rc == 0
        want, got = want.splitlines(), got.splitlines()
        assert got[0] == want[0] + "; runs on cpu"
        assert got[1:] == want[1:]


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_artifacts_cross_between_the_clis(tmp_path, capsys, direction):
    """An artifact one package's CLI wrote passes the other's ``--load
    --validate`` with the same validate line; the port's also runs it
    (``--execute``)."""
    path = tmp_path / "plan.json"
    write, read = ((plan_cli.main, ref_plan_cli.main)
                   if direction == "port_to_reference"
                   else (ref_plan_cli.main, plan_cli.main))
    extra = CPU if write is plan_cli.main else []
    assert write(TINY + extra + ["--out", str(path)]) == 0
    capsys.readouterr()
    extra = CPU + ["--execute"] if read is plan_cli.main else []
    rc, text, err = _run(read, ["--load", str(path), "--validate"] + extra,
                         capsys)
    assert rc == 0, err
    rc, own, _ = _run(write, ["--load", str(path), "--validate"]
                      + (CPU if write is plan_cli.main else []), capsys)
    assert rc == 0
    pick = [ln for ln in own.splitlines() if ln.startswith("validate:")]
    assert pick and pick[0] in text.splitlines()


def test_backend_takes_either_packages_names(tmp_path, capsys):
    """``--backend torch`` and ``--backend xla`` write the same document
    (the JAX package's word on the wire), and so do ``cuda`` and
    ``pallas``; the loaded deployment names the port's backend."""
    docs = {}
    for name in ("torch", "xla", "cuda", "pallas"):
        path = tmp_path / f"{name}.json"
        assert plan_cli.main(TINY + CPU + ["--backend", name,
                                           "--out", str(path)]) == 0
        doc = json.loads(path.read_text())
        for part in ("partition", "pipeline"):
            doc["payload"]["pico"][part]["wall_time_s"] = 0.0
        docs[name] = doc["payload"]
    capsys.readouterr()
    assert docs["torch"] == docs["xla"] and docs["cuda"] == docs["pallas"]
    assert docs["xla"]["exec_spec"]["backend"] == "xla"
    assert docs["pallas"]["exec_spec"]["backend"] == "pallas"
    dep = repro_torch.Deployment.load(tmp_path / "xla.json", device="cpu")
    assert dep.exec_spec.backend == "torch"


@pytest.mark.parametrize("load", [False, True], ids=["plan", "load"])
def test_no_card_and_no_device_flag_stops(tmp_path, monkeypatch, load):
    """Without a card the CLI stops with ``SystemExit`` unless it is
    given ``--device cpu``: nothing falls back to the CPU on its own."""
    path = tmp_path / "plan.json"
    assert plan_cli.main(TINY + CPU + ["--out", str(path)]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--load", str(path), "--validate"] if load else TINY
    with pytest.raises(SystemExit, match="no CUDA device: pass --device cpu"):
        plan_cli.main(argv)
    with pytest.raises(SystemExit, match="no CUDA device"):
        plan_cli.main(argv + ["--device", "cuda"])
    assert plan_cli.main(argv + CPU) == 0


def test_missing_model_is_a_usage_error(capsys):
    rc, _, err = _run(plan_cli.main, [], capsys)
    assert rc == 2 and "need --model to plan or --load" in err
    assert ref_plan_cli.main([]) == 2


def test_plan_module_runs_as_a_command(tmp_path):
    """``python -m repro_torch.tools.plan`` plans, saves and validates
    in a child process that imports neither jax nor repro."""
    path = tmp_path / "plan.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import runpy, sys\n"
            "sys.argv = ['plan'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('repro_torch.tools.plan',"
            " run_name='__main__')\n"
            "finally:\n"
            "    bad = sorted(m for m in sys.modules\n"
            "                 if m.split('.')[0] in ('jax', 'repro'))\n"
            "    assert not bad, bad\n")
    for argv in (TINY + CPU + ["--out", str(path)],
                 ["--load", str(path), "--validate", "--execute"] + CPU):
        proc = subprocess.run([sys.executable, "-c", code, *argv], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
    assert "execute: pipelined outputs match" in proc.stdout


# -- the trace tool ----------------------------------------------------------

@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """tests/test_obs.py's ``traced_deployment``, timing-only, through
    both packages: VGG16 at 64 x 64 and an eighth of its width on four
    Pis, 8 frames, each trace saved."""
    d = tmp_path_factory.mktemp("traces")
    freqs = [1.5, 1.2, 1.0, 0.8]
    ref_dep = repro.compile(ref_zoo.vgg16(input_size=(64, 64), scale=0.125),
                            ref_pi_cluster(freqs, bandwidth_mbps=50.0))
    ref_dep.runtime(repro.DeploySpec(trace=True),
                    real_compute=False).run(n_frames=8)
    dep = repro_torch.compile(zoo.vgg16(input_size=(64, 64), scale=0.125),
                              make_pi_cluster(freqs, bandwidth_mbps=50.0),
                              device="cpu")
    dep.runtime(DeploySpec(trace=True), real_compute=False).run(n_frames=8)
    return {"reference": (ref_dep, str(ref_dep.save_trace(d / "ref.json"))),
            "port": (dep, str(dep.save_trace(d / "port.json")))}


def _sig(spans, host_clocked=False):
    """Spans as plain tuples; the lifecycle's ``plan`` span, timed by the
    host's clock, left out unless asked for."""
    return [(s.name, s.ts, s.dur, s.track, tuple(s.attrs)) for s in spans
            if host_clocked or s.name != "plan"]


def test_the_runtime_traces_are_the_references(traces):
    ref_dep, _ = traces["reference"]
    dep, _ = traces["port"]
    assert _sig(dep.tracer.spans) == _sig(ref_dep.tracer.spans)
    assert sum(s.name == "plan" for s in dep.tracer.spans) == 1


@pytest.mark.parametrize("saved_by", ["reference", "port"])
def test_trace_summary_is_the_references(traces, saved_by, capsys):
    """Both tools print the same summary of one trace file, whichever
    package saved it."""
    _, path = traces[saved_by]
    rc, want, _ = _run(_reference_trace_tool().main, [path], capsys)
    assert rc == 0
    rc, got, _ = _run(trace_cli.main, [path], capsys)
    assert rc == 0
    assert got == want
    assert "(8 frames)" in got and "per-device compute" in got
    assert "bubble fraction" in got


@pytest.mark.parametrize("saved_by", ["reference", "port"])
def test_trace_validate_is_the_references(traces, saved_by, tmp_path,
                                          capsys):
    ref_trace_cli = _reference_trace_tool()
    _, path = traces[saved_by]
    rc, want, _ = _run(ref_trace_cli.main, [path, "--validate"], capsys)
    assert rc == 0
    rc, got, _ = _run(trace_cli.main, [path, "--validate"], capsys)
    assert rc == 0 and got == want
    assert got.startswith("valid chrome trace: ")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X"}]}))
    rc, _, want_err = _run(ref_trace_cli.main, [str(bad), "--validate"],
                           capsys)
    assert rc == 1
    rc, _, err = _run(trace_cli.main, [str(bad), "--validate"], capsys)
    assert rc == 1 and err == want_err
    assert err.startswith("INVALID: ")
    rc, _, err = _run(trace_cli.main, [str(bad)], capsys)
    assert rc == 1 and err.startswith("cannot summarize: ")


def test_bubble_fraction_is_the_references(traces):
    """On the same spans both packages' ``bubble_fraction`` agree; on the
    two runs' spans without the host-clocked ``plan`` span too (the
    virtual timelines are equal)."""
    ref_trace_cli = _reference_trace_tool()
    ref_dep, _ = traces["reference"]
    dep, _ = traces["port"]
    for spans in (ref_dep.tracer.spans, dep.tracer.spans):
        assert trace_cli.bubble_fraction(spans) \
            == ref_trace_cli.bubble_fraction(spans)
    ref_spans = [s for s in ref_dep.tracer.spans if s.name != "plan"]
    spans = [s for s in dep.tracer.spans if s.name != "plan"]
    got = trace_cli.bubble_fraction(spans)
    assert got == ref_trace_cli.bubble_fraction(ref_spans)
    assert 0.0 <= got < 1.0
    assert 0.0 <= trace_cli.bubble_fraction(dep.tracer.spans) < 1.0


def test_trace_module_runs_as_a_command(traces):
    """``python -m repro_torch.tools.trace`` in a child process: the
    same validation line and summary as in-process."""
    _, path = traces["port"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = []
    for extra in (["--validate"], []):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.tools.trace", path, *extra],
            env=env, capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout)
    assert outs[0].startswith("valid chrome trace: ")
    assert "(8 frames)" in outs[1]
