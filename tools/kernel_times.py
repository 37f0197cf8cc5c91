"""Time one of the port's kernels on the card, per shape and dtype.

Each case runs the case function of ``chip_smoke.py`` of the tree at
``--root`` (``ssd_case`` or ``prefill_case``: the kernel against its
plain version, two calls the same bits, CUDA-event ms) with the
kernel's device ms from ``torch.profiler``; a ``flash_prefill`` case
also gives SDPA's device ms and the bound.  ``--g`` forces
``ssd_chunk``'s heads a y block (2 or 4) in place of ``ops.plan``'s
choice, to hold the plan against the other G; it needs a tree whose
``kernels/ssd/ops.py`` has ``plan``.  To compare two trees on one card,
run the script once per tree in turns (parent, change, change, parent):

    python3 tools/kernel_times.py --kernel ssd_chunk --root <tree> \\
        [--g 2 4] [--shapes edges]
    python3 tools/kernel_times.py --kernel flash_prefill --root <tree> \\
        [--shapes all] [--dtypes float32 bfloat16]

Prints one line a case: tree tag, shape (and plan where the tree has
one), dtype, ok, max error, ms (events) and device ms.  Needs a CUDA
card; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

# ssd_chunk (BC, Q, H, P, N): mamba2-370m's prefill chunk and a
# 1024-token prompt's, then the kernel's edges (chip_smoke.py runs the
# same)
SSD_PATH = [(4, 511, 32, 64, 128), (16, 256, 32, 64, 128)]
SSD_EDGES = [(64, 256, 3, 64, 128), (16, 511, 6, 64, 128),
             (1, 511, 32, 64, 128), (1, 1030, 32, 64, 128),
             (2, 256, 4, 128, 8), (64, 256, 2, 64, 128),
             (2, 511, 32, 64, 128)]
# flash_prefill (q (B, S, K, G, D), window): Llama-3.2-1B's and
# granite's prefill, then the edges chip_smoke.py runs (qwen1.5-0.5b's
# prefill at G = 1 among them)
PREFILL_PATH = [((4, 511, 8, 4, 64), 0), ((4, 511, 8, 3, 64), 0)]
PREFILL_EDGES = [((2, 37, 8, 4, 64), 0), ((2, 200, 8, 4, 64), 32),
                 ((2, 256, 16, 1, 64), 0), ((1, 256, 8, 8, 128), 0),
                 ((2, 300, 8, 4, 8), 0), ((2, 300, 8, 4, 40), 0),
                 ((1, 130, 2, 64, 32), 0), ((4, 511, 16, 1, 64), 0)]


def _ssd_inputs(shape, dtype):
    """The inputs ``ssd_case`` makes for ``shape`` (its seed 0)."""
    import torch
    import torch.nn.functional as F
    bc, q, h, p, n = shape
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*size):
        return torch.randn(size, generator=gen, device="cuda")

    dt_bias = torch.log(torch.expm1(torch.linspace(1e-3, 0.1, h,
                                                   device="cuda")))
    x = randn(bc, q, h, p).to(dtype)
    dt = F.softplus(randn(bc, q, h) + dt_bias).to(dtype)
    A = (-torch.linspace(1.0, 16.0, h, device="cuda")).to(dtype)
    return x, dt, A, randn(bc, q, n).to(dtype), randn(bc, q, n).to(dtype)


def ssd_times(cs, tag, shapes, gs, dtypes) -> None:
    import torch
    from repro_torch.kernels.ssd import ops

    planned = getattr(ops, "plan", None)
    for shape in shapes:
        for g in gs or [None]:
            if g is not None:          # the plan's grid and smem for this G
                def forced(bc, q, h, p, n, dtype=torch.float32, g=g):
                    esz = torch.empty((), dtype=dtype).element_size()
                    return ops.Plan(g, ops._grid(bc, q, h, p, n, g),
                                    ops.smem_bytes(g, n, esz))
                ops.plan = forced
            for dt in dtypes:
                r = cs.ssd_case(shape, dt)
                xs = _ssd_inputs(shape, getattr(torch, dt))
                dev = cs.device_ms(lambda: ops.ssd_chunk(*xs))
                print(f"{tag} G{'-' if g is None else g} {r['desc']} {dt} "
                      f"{'ok' if r['ok'] else 'FAIL'} err {r['err']:.3g} "
                      f"ms {r['ms']:.4f} device {dev:.4f}", flush=True)
            if planned is not None:
                ops.plan = planned


def prefill_times(cs, tag, cases, dtypes) -> None:
    import torch
    from repro_torch.kernels.attention import ops

    planner = getattr(ops, "prefill_plan", None)
    for shape, window in cases:
        for dt in dtypes:
            plan = ""
            if planner is not None:
                p = planner(*shape, getattr(torch, dt))
                plan = f" rows{p.rows} DP{p.dp} grid{p.grid}"
            r = cs.prefill_case(shape, window, dt)
            # 0: the profiler caught no launch (a tree whose device_ms
            # does not take the window again)
            share = (f"{100 * r['bound_ms'] / r['dev_ms']:.1f}%"
                     if r["dev_ms"] else "-")
            print(f"{tag} q{shape} w{window}{plan} {dt} "
                  f"{'ok' if r['ok'] else 'FAIL'} err {r['err']:.3g} "
                  f"ms {r['ms']:.4f} device {r['dev_ms']:.4f} sdpa "
                  f"{r['library_dev_ms']:.4f} bound {r['bound_ms']:.5f} "
                  f"({share})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=["ssd_chunk", "flash_prefill"],
                    default="ssd_chunk")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default=None, help="printed first on each line")
    ap.add_argument("--g", type=int, nargs="*", default=[],
                    help="ssd_chunk: force these G in turn (default: "
                    "ops.plan's)")
    ap.add_argument("--shapes", choices=["path", "edges", "all"],
                    default="path")
    ap.add_argument("--dtypes", nargs="*", default=None,
                    help="default: both for ssd_chunk, float32 for "
                    "flash_prefill")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(args.root) / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)        # puts <root>/src first on sys.path

    tag = args.tag or args.root
    pick = {"path": (True, False), "edges": (False, True),
            "all": (True, True)}[args.shapes]
    if args.kernel == "ssd_chunk":
        shapes = SSD_PATH * pick[0] + SSD_EDGES * pick[1]
        ssd_times(cs, tag, shapes, args.g,
                  args.dtypes or ["float32", "bfloat16"])
    else:
        cases = PREFILL_PATH * pick[0] + PREFILL_EDGES * pick[1]
        prefill_times(cs, tag, cases, args.dtypes or ["float32"])


if __name__ == "__main__":
    main()
