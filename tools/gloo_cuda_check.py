"""Whether the gloo backend moves CUDA tensors intact, on one card.

Two spawned gloo ranks, both on ``cuda:0``, run one case each time:

* ``send``: rank 0 sends a seeded CUDA tensor with ``dist.send``, rank 1
  receives into a CUDA tensor with ``dist.recv`` and compares the bits
  with the same seeded tensor;
* ``all_reduce``: each rank sums a CUDA tensor (rank 0 the seeded one,
  rank 1 zeros) with ``dist.all_reduce`` and compares the bits with the
  seeded tensor.

A case runs in its own pair of processes under a time limit, so a rank
that dies (a host read of device memory) or hangs is reported, not
fatal.  Prints one line a case: ``equal``, ``differ``, the exit codes of
ranks that died, or ``timed out``; and, in the last line, the card.

    python3 tools/gloo_cuda_check.py [--mib 16] [--timeout 60]

On an NVIDIA H100 with torch 2.11 (CUDA 12.8) the ``send`` case ends in
gloo's TCP transport (``writev ... Bad address``: it reads the device
pointer on the host) and the sending rank aborts, while ``all_reduce`` is
equal.  So ``repro_torch.pipeline.microbatch_pipeline`` stages a CUDA
tensor through the host under gloo, chosen by the backend's name.
Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import queue
import socket
import subprocess
import time
import traceback
from datetime import timedelta


def _seeded(n: int):
    import torch
    g = torch.Generator().manual_seed(0)
    return torch.randn(n, generator=g).cuda()


def _rank(case, rank, port, n, timeout, results) -> None:
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=2, rank=rank,
                                timeout=timedelta(seconds=timeout))
        want = _seeded(n)
        if case == "send":
            if rank == 0:
                dist.send(want, dst=1)
                got = want
            else:
                got = torch.empty_like(want)
                dist.recv(got, src=0)
        else:
            got = want.clone() if rank == 0 else torch.zeros_like(want)
            dist.all_reduce(got)
        torch.cuda.synchronize()
        results.put((rank, torch.equal(got, want)))
        dist.destroy_process_group()
    except Exception:
        results.put((rank, traceback.format_exc()))


def check(case: str, n: int, timeout: float) -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank, daemon=True,
                         args=(case, r, port, n, timeout, results))
             for r in range(2)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    while len(got) < 2 and time.monotonic() < deadline:
        try:
            rank, value = results.get(timeout=0.5)
            got[rank] = value
        except queue.Empty:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join()
    died = {r: p.exitcode for r, p in enumerate(procs)
            if r not in got and p.exitcode}
    if died:
        return f"rank died: exit codes {died} (negative: signal)"
    if len(got) < 2:
        return f"timed out after {timeout:.0f} s"
    if any(isinstance(v, str) for v in got.values()):
        return "raised: " + " | ".join(
            v.strip().splitlines()[-1] for v in got.values()
            if isinstance(v, str))
    return "equal" if all(got.values()) else \
        f"differ (ranks equal: {got})"


def main() -> None:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    n = args.mib * 2 ** 20 // 4
    for case in ("send", "all_reduce"):
        print(f"gloo {case} of a CUDA fp32 tensor ({args.mib} MiB, two "
              f"ranks on cuda:0): {check(case, n, args.timeout)}",
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")


if __name__ == "__main__":
    main()
