"""Build and load the port's CUDA kernels: ``nvcc`` -> ``.so`` -> ctypes.

Each kernel is one ``.cu`` file with a plain C interface.  It is
compiled at first use, for Hopper (``sm_90a``), from the source in the
checkout into ``build/kernels/`` at the repository root (listed in
``.gitignore``), under a name keyed by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is not.
:class:`Launchers` binds a set of them and counts their launches;
:func:`split_ranges` is how a kernel that splits work across the blocks
of a cluster shares it out.  Nothing here runs at import time: this
module imports on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: headers shared by the kernels (``#include "hopper.cuh"``); part of every
#: build's hash, so editing one rebuilds every kernel
INCLUDE_DIR = Path(__file__).resolve().parent / "include"
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
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.exists():
        BUILD_LOG.setdefault(out.name, (0.0, ""))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR),
                           "-o", str(tmp), str(src)],
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


#: the dtype code each launcher takes as its first argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def split_ranges(n: int, parts: int) -> list[tuple[int, int]]:
    """[a, b) of each of ``parts`` blocks that share n items, in rank
    order, balanced (sizes differ by at most one), together [0, n) once:
    rank r takes [r n / parts, (r + 1) n / parts), as the kernels that
    split work across a cluster compute it."""
    return [(r * n // parts, (r + 1) * n // parts) for r in range(parts)]


class Launchers:
    """The ``extern "C"`` launchers ``<name>_launch`` of a set of kernel
    sources, bound with ctypes at first use, each with a count of its
    launches.

    A launcher takes a dtype code (:data:`DTYPE_CODES`), its own
    arguments, then the stream, and returns a ``cudaError_t``.
    ``argtypes[name]`` is its whole ctypes signature: a pointer passed
    where none is declared is cut to 32 bits, so it must follow the C
    prototype one for one.
    """

    def __init__(self, sources: dict[str, Path],
                 argtypes: dict[str, list]):
        self.sources, self.argtypes = sources, argtypes
        self.counts = dict.fromkeys(sources, 0)
        self._fns: dict = {}

    def launch(self, name: str, like: torch.Tensor, *args) -> None:
        """Launch kernel ``name`` for ``like``'s dtype on the current
        stream of ``like``'s device; raise if the runtime refuses it."""
        fn = self._fns.get(name)
        if fn is None:
            fn = getattr(library(self.sources[name]), f"{name}_launch")
            fn.argtypes = self.argtypes[name]
            fn.restype = ctypes.c_int
            self._fns[name] = fn
        err = fn(DTYPE_CODES[like.dtype], *args,
                 torch.cuda.current_stream(like.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed with CUDA error {err}")
        self.counts[name] += 1

    def launch_count(self, name: str) -> int:
        """Launches of kernel ``name`` since creation or :meth:`reset`."""
        return self.counts[name]

    def reset(self) -> None:
        for name in self.counts:
            self.counts[name] = 0
