"""Training launcher: the train loop of one arch on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 5 --batch 4 --seq 512                      # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --reduced --steps 50 --batch 8 --seq 64 --device cpu   # CPU, small

The reference's launcher shards the train step over the host's mesh;
this one is still single-device: its sharding over ``torchrun``'s ranks
is ROADMAP Queue 1, item 12d.  The pieces are ported:
``launch/mesh.py`` builds multi-rank meshes, ``launch/sharding.py``
places params and batches by the reference's rules, and
``training.make_train_step(act_pspec=, moe_pspec=)`` runs on them.  Weights
are random from ``--seed``.  On the card every family the launcher takes
trains: the dense archs (llama, qwen, command-r) through the attention
kernels and their backward, the MoE archs (granite, mixtral) through
those and ``moe_gemm`` with its backward, Mamba2 (mamba2) through
``ssd_chunk`` and its backward kernel ``ssd_chunk_bwd``, and the hybrid
(zamba2) through all of them.  The archs that take embeddings (llava,
musicgen) stop as the reference's launcher stops them.

The optimizer's update is functional, as the reference's: at the update
the old params, m and v, the gradients, the clipped gradients and the
new m, v and params are alive at once, about 8 copies of the params.
So granite-moe-3b-a800m at full depth (3.37 G params, 13.5 GB in fp32)
needs about 108 GB and does not fit one 80 GB card; at 16 of its 32
layers it does (8 x 7.05 GB, plus the activations).  zamba2-2.7b at
full depth (9.7 GB in fp32) needs about 8 x 9.7 = 78 GB before any
activation, so one card trains it at reduced depth (24 of its 54
layers); the launcher has no depth option, as the reference's has
none: ``training.loop.train`` takes any config.
"""

from __future__ import annotations

import argparse

import torch

from .. import configs
from ..training.loop import TrainReport, train


def main(argv: list[str] | None = None) -> TrainReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="run the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback to cpu)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=2, d_model=128)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} takes embeddings; "
                         "train it via the dry-run path")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on "
                         "the CPU")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch {cfg.name} ({cfg.param_count()/1e6:.1f} M params) on "
          f"{name}")
    rep = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, seed=args.seed, log_every=10, warmup=10,
                device=device)
    print(f"done: {rep.tokens / rep.wall_s:.0f} tok/s")
    return rep


if __name__ == "__main__":
    main()
