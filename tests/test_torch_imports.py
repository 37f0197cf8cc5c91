"""The port (``src/repro_torch``), ``chip_smoke.py`` and
``tools/kernel_times.py`` stand alone: they import neither ``jax`` nor
the JAX package ``repro``."""

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
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                     ROOT / "tools" / "kernel_times.py"]
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
