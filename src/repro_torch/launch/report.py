"""Generate the §Dry-run / §Roofline markdown tables from the dry-run
JSON records; the counterpart of the JAX package's ``launch/report.py``.
The two packages' records have the same keys, so either renders.

    PYTHONPATH=src python -m repro_torch.launch.report \\
        [--dir experiments/dryrun_torch] [--kind roofline|dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path

#: a mesh tag and the names records give it: a run's tag (``pod1``), and
#: the mesh an ok record names (``16x16``)
MESHES = {"pod1": ("pod1", "16x16"), "pod2": ("pod2", "pod2x16x16")}


def load(dirpath: str):
    recs = []
    for f in sorted(glob.glob(f"{dirpath}/*.json")):
        recs.append(json.loads(Path(f).read_text()))
    return recs


def fmt_s(x: float) -> str:
    return f"{x:.2e}"


def roofline_table(recs, mesh="pod1") -> str:
    out = ["| arch | shape | compute s | memory s | collective s | "
           "dominant | model FLOPs/dev | useful ratio | what would move the "
           "dominant term |",
           "|---|---|---|---|---|---|---|---|---|"]
    hints = {
        ("collective", "train"): "shard experts/FFN to cut all-reduce "
                                 "volume; overlap grads with compute",
        ("collective", "decode"): "keep KV local (shard batch not heads); "
                                  "pipeline layers over pods",
        ("collective", "prefill"): "sequence-shard attention (ring) to "
                                   "avoid activation all-gathers",
        ("memory", "train"): "fuse mask/softmax (less HBM traffic), bf16 "
                             "master copies, larger per-step compute",
        ("memory", "decode"): "batch more sequences per step to amortize "
                              "weight reads (decode is weight-bound)",
        ("memory", "prefill"): "larger attention blocks / fused kernels to "
                               "raise arithmetic intensity",
        ("compute", "train"): "near roofline: only kernel-level gains left",
        ("compute", "prefill"): "near roofline: only kernel-level gains",
        ("compute", "decode"): "near roofline",
    }
    names = MESHES.get(mesh, (mesh,))
    for r in recs:
        if r.get("mesh") not in names or not r.get("ok"):
            continue
        ro = r["roofline"]
        hint = hints.get((ro["dominant"], r["kind"]), "")
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(ro['compute_s'])} | "
            f"{fmt_s(ro['memory_s'])} | {fmt_s(ro['collective_s'])} | "
            f"**{ro['dominant']}** | {fmt_s(r['model_flops_per_device'])} | "
            f"{r['useful_flops_ratio']:.2f} | {hint} |")
    return "\n".join(out)


def dryrun_table(recs) -> str:
    out = ["| arch | shape | mesh | lower+compile s | arg GB/dev | "
           "temp GB/dev | FLOPs/dev | coll bytes/dev | collectives |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"FAILED: {r.get('error', '')} | | | | | |")
            continue
        ro = r["roofline"]
        counts = ro["coll_breakdown"]["counts"]
        csum = ", ".join(f"{k.split('-')[-1][:4]}:{int(v)}"
                         for k, v in sorted(counts.items()) if v)
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['lower_s'] + r['compile_s']:.0f} | "
            f"{r['memory']['argument_bytes'] / 1e9:.2f} | "
            f"{r['memory']['temp_bytes'] / 1e9:.2f} | "
            f"{fmt_s(ro['flops'])} | {fmt_s(ro['coll_bytes'])} | {csum} |")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--kind", default="roofline",
                    choices=["roofline", "dryrun"])
    ap.add_argument("--mesh", default="pod1")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    if args.kind == "roofline":
        print(roofline_table(recs, args.mesh))
    else:
        print(dryrun_table(recs))


if __name__ == "__main__":
    main()
