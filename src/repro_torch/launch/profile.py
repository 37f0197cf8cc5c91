"""Profile a saved dry-run census: totals, collectives by kind, the top
entries by FLOPs and the largest individual collectives, in H100 seconds
at the peaks of ``launch/roofline.py``; the counterpart of the JAX
package's ``launch/profile.py`` (which reads a saved HLO).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k --save-census --device cpu
    PYTHONPATH=src python -m repro_torch.launch.profile \\
        experiments/dryrun_torch/mixtral-8x7b__train_4k__pod1.census.json.gz
"""

from __future__ import annotations

import argparse
import gzip
import json
from pathlib import Path

from .hlo_analysis import HloCensus
from .roofline import HBM_BYTES_PER_S, LINK_BYTES_PER_S, PEAK_FLOPS


def load(path) -> HloCensus:
    """The census saved at ``path`` (``.census.json.gz`` or plain JSON)."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as fh:
        return HloCensus.from_dict(json.load(fh))


def listing(census: HloCensus, top: int = 10,
            dtype: str = "bfloat16") -> str:
    """The three listings of one census as text."""
    peak = PEAK_FLOPS[dtype]
    out = [f"totals: {census.flops:.3e} FLOPs "
           f"({census.flops / peak:.3f} s at {dtype})   "
           f"{census.hbm_bytes:.3e} HBM B "
           f"({census.hbm_bytes / HBM_BYTES_PER_S:.3f} s)   "
           f"{census.total_coll_bytes:.3e} coll B "
           f"({census.total_coll_bytes / LINK_BYTES_PER_S:.3f} s)",
           "", "collectives by kind:"]
    for k, v in sorted(census.coll_bytes.items(), key=lambda kv: -kv[1]):
        out.append(f"  {k:20s} {v:.3e} B  x{int(census.coll_counts[k])}")
    out += ["", f"top {top} entries by FLOPs:"]
    rows = sorted(census.by_computation.items(),
                  key=lambda kv: -kv[1]["flops"])[:top]
    for n, d in rows:
        out.append(f"  {n[:56]:56s} mult={d['mult']:8.0f} "
                   f"flops={d['flops']:.3e} coll={d['coll_bytes']:.3e}")
    out += ["", f"top {top} individual collective ops:"]
    for b, kind, name in sorted(census.coll_ops,
                                key=lambda t: -t[0])[:top]:
        out.append(f"  {b / 1e9:8.3f} GB {kind:18s} {name}")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("census", help=".census.json.gz (or plain JSON) file")
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    # the step's dtype is in the dry run's record beside the census
    rec = Path(str(args.census).removesuffix(".census.json.gz") + ".json")
    dtype = (json.loads(rec.read_text())["roofline"].get("dtype", "bfloat16")
             if rec.exists() else "bfloat16")
    print(listing(load(args.census), args.top, dtype))


if __name__ == "__main__":
    main()
