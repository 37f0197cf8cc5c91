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

Two things here serve the CUDA graphs of ``repro_torch.exec.graph``.
Every table of launch counts is registered (:func:`count_table`), so a
graph can take back what its capture added (:func:`take_counts`: a
capture launches nothing) and credit it at each replay
(:func:`credit`).  And a kernel's scratch buffers (:func:`scratch`) come
from the table of the graph being captured while there is one, so they
live as long as the graph that reads them.

A census of a call (``repro_torch.launch.hlo_analysis``) counts each
kernel's work, not its launch: a wrapper passes the FLOPs and bytes of
its call to :func:`record_work`, and the census takes them while it is
active in this process, from any thread: on cuda tensors autograd runs
a backward on a device thread of its own (on fake tensors the wrappers
launch nothing and record the same).  What a wrapper runs in torch around its kernel (its allocations,
``ssd_chunk_bwd``'s finish) is covered by that work, so the census
leaves it out (:func:`quiet`).

Thread workers (``repro_torch.dist`` in thread mode) launch kernels and
capture graphs in one process at once.  So the stack of scratch tables
being built is each thread's own, every count goes through :func:`bump`
under :data:`COUNT_LOCK`, and a graph holds that lock across its capture
(:func:`capture_counts`): another thread's launches in that window wait
to be counted until the capture has taken back its own, so what it
takes back is its thread's alone.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
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
#: every table of launch counts in the process, in registration order
#: (each :class:`Launchers`' counts, the variant counts of conv2d_fused
#: and moe_gemm, the plan counts of moe_gemm_bwd)
COUNT_TABLES: list[dict[str, int]] = []
#: scratch tensors of launches outside a capture, per (device, stream)
_SCRATCH: dict[tuple, dict[str, torch.Tensor]] = {}
#: guards every count table: each count goes through :func:`bump` under
#: it, and a graph's capture holds it (:func:`capture_counts`)
COUNT_LOCK = threading.RLock()
#: one build or load of a library at a time in this process
_LIBRARY_LOCK = threading.Lock()


class _ThreadStack(threading.local):
    """A stack of its own in each thread; false while empty."""

    def __init__(self):
        self.items: list = []

    def __bool__(self) -> bool:
        return bool(self.items)


#: the scratch tables of the graphs this thread is building, innermost last
_OWNED = _ThreadStack()
#: the census active in this process, if any (at most one), shared by
#: every thread
CENSUS: list = []
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
    with _LIBRARY_LOCK:
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


def count_table(table: dict[str, int]) -> dict[str, int]:
    """Register ``table`` (name -> launches) for the graphs to rewind and
    credit; returns it.  Reset it in place, never rebind it."""
    COUNT_TABLES.append(table)
    return table


def bump(table: dict[str, int], name: str, n: int = 1) -> None:
    """Count ``n`` launches of ``name`` in ``table`` (a :func:`count_table`),
    under :data:`COUNT_LOCK`: no thread's count is lost to another's, and
    none lands inside another thread's capture window."""
    with COUNT_LOCK:
        table[name] += n


def count_snapshot() -> list[dict[str, int]]:
    """A copy of every count table, to diff against later."""
    with COUNT_LOCK:
        return [dict(t) for t in COUNT_TABLES]


def take_counts(before: list[dict[str, int]]) -> list[dict[str, int]]:
    """Set every count table back to ``before`` (a :func:`count_snapshot`)
    and return what was added since, table by table: the launches a
    graph's capture recorded and did not run."""
    delta = []
    with COUNT_LOCK:
        for i, table in enumerate(COUNT_TABLES):
            old = before[i] if i < len(before) else {}
            delta.append({k: n - old.get(k, 0) for k, n in table.items()
                          if n != old.get(k, 0)})
            for k in table:
                table[k] = old.get(k, 0)
    return delta


@contextlib.contextmanager
def capture_counts():
    """Around a graph's capture: holds :data:`COUNT_LOCK` (so captures in
    one process take turns) and fills the list it yields, on exit, with
    what the capture added to the count tables (:func:`take_counts`).
    Other threads keep launching meanwhile; their counts wait for the
    lock, so the launches taken back are this capture's alone."""
    with COUNT_LOCK:
        before = count_snapshot()
        delta: list[dict[str, int]] = []
        try:
            yield delta
        finally:
            delta.extend(take_counts(before))


def credit(delta: list[dict[str, int]], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a :func:`take_counts` result) to the
    count tables: ``times`` replays of a graph launch its nodes again."""
    with COUNT_LOCK:
        for table, d in zip(COUNT_TABLES, delta):
            for k, n in d.items():
                table[k] += n * times


@contextlib.contextmanager
def owned_scratch(table: dict[str, torch.Tensor]):
    """Within the block, :func:`scratch` hands out ``table``: the scratch
    of a graph being warmed up and captured, kept on the graph.  The
    stack is this thread's: another thread's scratch is not affected."""
    _OWNED.items.append(table)
    try:
        yield table
    finally:
        _OWNED.items.pop()


def scratch(device: torch.device, name: str, numel: int,
            dtype: torch.dtype, zero: bool = False) -> torch.Tensor:
    """A kernel's scratch tensor ``name`` of at least ``numel`` elements
    on ``device`` (zeroed when it is made, if ``zero``), kept for the
    current stream, or in the table of the graph being built
    (:func:`owned_scratch`).  It grows by replacement, which a capture
    may not do (an earlier node may read the old tensor): the warm-up
    before a capture sizes it, and a capture that would grow it raises."""
    if _OWNED:
        table = _OWNED.items[-1]
    else:
        key = (device, torch.cuda.current_stream(device).cuda_stream)
        table = _SCRATCH.setdefault(key, {})
    held = table.get(name)
    if held is None or held.numel() < numel:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"scratch {name!r} would grow to {numel} "
                               f"during a CUDA graph capture; the warm-up "
                               f"before it sizes it")
        make = torch.zeros if zero else torch.empty
        held = table[name] = make(numel, dtype=dtype, device=device)
    return held


def record_work(name: str, work: tuple[float, float]) -> None:
    """Count one call of kernel ``name`` doing ``work`` (FLOPs, bytes) in
    the census active in this process; nothing without one."""
    with COUNT_LOCK:
        if CENSUS:
            CENSUS[-1].kernel(name, *work)


@contextlib.contextmanager
def quiet():
    """Within the block, the census active in this process (if any) counts
    no torch op: a kernel wrapper's own allocations and finish, which its
    :func:`record_work` covers."""
    census = CENSUS[-1] if CENSUS else None
    if census is not None:
        census.quiet += 1
    try:
        yield
    finally:
        if census is not None:
            census.quiet -= 1


def fake_call(name: str, work: tuple[float, float], out):
    """A kernel wrapper's answer on fake tensors: ``out`` (empty tensors of
    the kernel's outputs), with ``work`` recorded (:func:`record_work`);
    nothing is launched or counted as a launch."""
    record_work(name, work)
    return out


def refuse_grad(kernel: str, why: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and one of
    ``tensors`` (``None`` allowed) requires grad: the kernel ``kernel``
    has no backward, and its output would carry no ``grad_fn``, so a
    backward through it would leave its inputs' gradients silently
    missing.  ``why`` says where its backward stands.  Reads host flags
    only, so it is legal inside a CUDA graph capture.  The wrappers call
    it on their CUDA path; on the CPU they run their plain versions,
    which autograd differentiates."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: inputs require grad, and the kernel has no "
            f"backward on the card: {why}")


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
        self.counts = count_table(dict.fromkeys(sources, 0))
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
        bump(self.counts, name)

    def launch_count(self, name: str) -> int:
        """Launches of kernel ``name`` since creation or :meth:`reset`:
        one at each host call outside a graph capture, and a graph's
        nodes again at each of its replays (:func:`credit`)."""
        return self.counts[name]

    def reset(self) -> None:
        for name in self.counts:
            self.counts[name] = 0
