"""Build and load the port's CUDA kernels: ``nvcc`` -> ``.so`` -> ctypes.

Each kernel is one ``.cu`` file with a plain C interface.  It is
compiled at first use, for Hopper (``sm_90a``), from the source in the
checkout into ``build/kernels/`` at the repository root (listed in
``.gitignore``), under a name keyed by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is not.
Nothing here runs at import time: this module imports on machines with
no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[Path, ctypes.CDLL] = {}
#: seconds each library took to build in this process (0.0 = reused),
#: and the compiler's output (``-Xptxas -v``: registers, spills, smem)
BUILD_LOG: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); the port's "
                           "kernels build only where one is installed")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(src: Path) -> Path:
    """Compile ``src`` into a shared library unless a build of the same
    source and flags exists; returns the library's path."""
    src = Path(src)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.exists():
        BUILD_LOG.setdefault(out.name, (0.0, ""))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    BUILD_LOG[out.name] = (time.perf_counter() - t0,
                           proc.stdout + proc.stderr)
    return out


def library(src: Path) -> ctypes.CDLL:
    """The loaded library built from ``src`` (built on first call)."""
    src = Path(src).resolve()
    lib = _LOADED.get(src)
    if lib is None:
        lib = _LOADED[src] = ctypes.CDLL(str(build(src)))
    return lib
