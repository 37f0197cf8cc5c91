"""The port (``src/repro_torch``), ``chip_smoke.py``,
``tools/kernel_times.py``, ``tools/gloo_cuda_check.py``, the ``_torch``
examples and ``tools/plan_cli_torch.py`` stand alone: they import
neither ``jax`` nor the JAX package ``repro``."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.api.specs import ExecSpec as RefExecSpec, PlanSpec as RefPlanSpec
from repro_torch.api.specs import ExecSpec, PlanSpec

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the examples' counterparts in the port, one beside each of the JAX
# package's, and the plan CLI's launcher
EXAMPLES = ("quickstart", "lm_generate", "train_tiny", "pico_pod_pipeline",
            "dist_pipeline", "fleet_routing", "nasnet_dnc", "runtime_churn",
            "serve_pipeline", "serving_multitenant")
FILES = (sorted(PORT.rglob("*.py"))
         + [ROOT / "chip_smoke.py", ROOT / "tools" / "kernel_times.py",
            ROOT / "tools" / "gloo_cuda_check.py",
            ROOT / "tools" / "plan_cli_torch.py",
            ROOT / "tools" / "gen_experiments_torch.py"]
         + [ROOT / "examples" / f"{name}_torch.py" for name in EXAMPLES])
# modules the subprocess import must reach by name (the walk finds the
# rest): the mesh builders, the pipeline over them, the sharding rules and
# the local-shard boundaries
NAMED = ("repro_torch.launch.mesh", "repro_torch.pipeline.runner",
         "repro_torch.launch.sharding",
         "repro_torch.models.transformer.sharded")
# `import jax`, `from jax...`, `import repro`, `from repro.x` — but not
# `repro_torch`
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|,|$)",
                       re.M)


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        f"assert set({NAMED!r}) <= set(names), names\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "repro_torch.compile, repro_torch.Deployment\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20   # every submodule imported
    # quiet: no module prints or parses arguments when imported (the
    # CLIs, repro_torch.tools.*, run only under __main__)
    assert proc.stdout.splitlines() == [proc.stdout.split()[-1]]
    assert "usage:" not in proc.stderr


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_source_has_no_jax_or_repro_import(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_every_example_has_its_counterpart():
    """Each of the JAX package's examples has a ``_torch`` file beside it,
    and every ``_torch`` example is scanned."""
    ref = {p.stem for p in (ROOT / "examples").glob("*.py")
           if not p.stem.endswith("_torch")}
    ported = {p.stem for p in (ROOT / "examples").glob("*_torch.py")}
    assert ref == set(EXAMPLES)
    assert ported == {f"{name}_torch" for name in EXAMPLES}
    assert (ROOT / "tools" / "plan_cli.py").exists()


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import plan", "import repro",
                 "    from repro.exec import backends"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import plan",
                 "from .core import graph", "# see the repro.core docs"):
        assert not FORBIDDEN.search(line), line


def test_specs_read_the_jax_packages_payloads():
    """The port keeps the reference spec payloads, so one document reads
    in both packages."""
    ref = RefExecSpec(backend="pallas", mode="eager", cache_size=7)
    assert ExecSpec.from_json(ref.to_json()).to_dict() == ref.to_dict()
    ref = RefPlanSpec(t_lim=0.5, n_split=4)
    assert PlanSpec.from_json(ref.to_json()).to_dict() == ref.to_dict()
