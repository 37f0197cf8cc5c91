"""Whether the gloo backend moves CUDA tensors intact, on one card.

Two spawned gloo ranks, both on ``cuda:0``, run one case each time:

* ``send``: rank 0 sends a seeded CUDA tensor with ``dist.send``, rank 1
  receives into a CUDA tensor with ``dist.recv`` and compares the bits
  with the same seeded tensor;
* ``all_reduce``: each rank sums a CUDA tensor (rank 0 the seeded one,
  rank 1 zeros) with ``dist.all_reduce`` and compares the bits with the
  seeded tensor;
* ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single`` and ``broadcast``: the other collectives of
  ``torch.distributed``, each on seeded CUDA tensors (a rank's input the
  seeded tensor times rank + 1; sums of two such terms are exact),
  compared with the result computed on the host;
* ``functional_*``: the same all-gather, reduce-scatter, all-reduce and
  all-to-all through ``torch.distributed._functional_collectives``, the
  calls DTensor's redistributions make (its all-gather and
  reduce-scatter go to gloo's coalesced variants).

A case runs in its own pair of processes under a time limit, so a rank
that dies (a host read of device memory) or hangs is reported, not
fatal.  Prints one line a case: ``equal``, ``differ``, the exit codes of
ranks that died, or ``timed out``; and, in the last line, the card.

    python3 tools/gloo_cuda_check.py [--mib 16] [--timeout 60] \
        [--cases send all_reduce ...]

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


CASES = ("send", "all_reduce", "all_gather_into_tensor",
         "reduce_scatter_tensor", "all_to_all_single", "broadcast",
         "functional_all_gather", "functional_reduce_scatter",
         "functional_all_reduce", "functional_all_to_all")


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
        mine = want * (rank + 1)
        if case == "send":
            if rank == 0:
                dist.send(want, dst=1)
                got = want
            else:
                got = torch.empty_like(want)
                dist.recv(got, src=0)
        elif case == "all_reduce":
            got = want.clone() if rank == 0 else torch.zeros_like(want)
            dist.all_reduce(got)
        elif case == "all_gather_into_tensor":
            got = torch.empty(2 * n, device="cuda")
            dist.all_gather_into_tensor(got, mine)
            want = torch.cat([want, want * 2])
        elif case == "reduce_scatter_tensor":
            got = torch.empty(n // 2, device="cuda")
            dist.reduce_scatter_tensor(got, mine)
            want = (want * 3).chunk(2)[rank]
        elif case == "all_to_all_single":
            got = torch.empty_like(mine)
            dist.all_to_all_single(got, mine)
            want = torch.cat([want.chunk(2)[rank], (want * 2).chunk(2)[rank]])
        elif case == "broadcast":
            got = want.clone() if rank == 0 else torch.zeros_like(want)
            dist.broadcast(got, src=0)
        else:
            import torch.distributed._functional_collectives as funcol
            group = dist.group.WORLD
            op = case.removeprefix("functional_")
            if op == "all_gather":
                got = funcol.all_gather_tensor(mine, 0, group)
                want = torch.cat([want, want * 2])
            elif op == "reduce_scatter":
                got = funcol.reduce_scatter_tensor(mine, "sum", 0, group)
                want = (want * 3).chunk(2)[rank]
            elif op == "all_reduce":
                got = funcol.all_reduce(mine, "sum", group)
                want = want * 3
            else:
                got = funcol.all_to_all_single(mine, None, None, group)
                want = torch.cat([want.chunk(2)[rank],
                                  (want * 2).chunk(2)[rank]])
            got = funcol.wait_tensor(got)
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
    ap.add_argument("--cases", nargs="+", choices=CASES, default=CASES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    n = args.mib * 2 ** 20 // 4
    for case in args.cases:
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
