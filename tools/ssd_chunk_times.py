"""Time the port's ``ssd_chunk`` kernel on the card, per shape and dtype.

Each case runs ``chip_smoke.ssd_case`` of the tree at ``--root`` (the
kernel against its plain version, two calls the same bits, CUDA-event
ms) and adds the kernel's device ms from ``torch.profiler``.  ``--g``
forces the heads a y block (2 or 4) in place of ``ops.plan``'s choice,
to hold the plan against the other G; it needs a tree whose
``kernels/ssd/ops.py`` has ``plan``.  To compare two trees on one card,
run the script once per tree in turns (parent, change, change, parent):

    python3 tools/ssd_chunk_times.py --root <tree> [--g 2 4] [--shapes edges]

Prints one line a case: tree tag, G, plan, dtype, ok, max error,
ms (events) and device ms.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

# mamba2-370m's prefill chunk and a 1024-token prompt's
PATH = [(4, 511, 32, 64, 128), (16, 256, 32, 64, 128)]
# the kernel's edges (chip_smoke.py phase 5 runs the same)
EDGES = [(64, 256, 3, 64, 128), (16, 511, 6, 64, 128),
         (1, 511, 32, 64, 128), (1, 1030, 32, 64, 128),
         (2, 256, 4, 128, 8), (64, 256, 2, 64, 128), (2, 511, 32, 64, 128)]


def _inputs(shape, dtype):
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default=None, help="printed first on each line")
    ap.add_argument("--g", type=int, nargs="*", default=[],
                    help="force these G in turn (default: ops.plan's)")
    ap.add_argument("--shapes", choices=["path", "edges", "all"],
                    default="path")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_chunk_times: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(args.root) / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)        # puts <root>/src first on sys.path
    from repro_torch.kernels.ssd import ops

    tag = args.tag or args.root
    shapes = {"path": PATH, "edges": EDGES, "all": PATH + EDGES}[args.shapes]
    planned = getattr(ops, "plan", None)
    for shape in shapes:
        for g in args.g or [None]:
            if g is not None:          # the plan's grid and smem for this G
                def forced(bc, q, h, p, n, dtype=torch.float32, g=g):
                    esz = torch.empty((), dtype=dtype).element_size()
                    return ops.Plan(g, ops._grid(bc, q, h, p, n, g),
                                    ops.smem_bytes(g, n, esz))
                ops.plan = forced
            for dt in ("float32", "bfloat16"):
                r = cs.ssd_case(shape, dt)
                xs = _inputs(shape, getattr(torch, dt))
                dev = cs.device_ms(lambda: ops.ssd_chunk(*xs))
                print(f"{tag} G{'-' if g is None else g} {r['desc']} {dt} "
                      f"{'ok' if r['ok'] else 'FAIL'} err {r['err']:.3g} "
                      f"ms {r['ms']:.4f} device {dev:.4f}", flush=True)
            if planned is not None:
                ops.plan = planned


if __name__ == "__main__":
    main()
