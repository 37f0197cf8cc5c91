"""Train a small decoder LM (reduced llama3.2 family config) for a few
hundred steps on the synthetic token stream with PyTorch — exercises the
training substrate end to end (data -> AdamW + cosine LR -> ckpt).

The counterpart of ``examples/train_tiny.py`` in the port
(``repro_torch``): the same config, steps, batch, sequence, learning
rate and loss check, on ``--device`` (default ``cuda``: the attention
kernels and their backward; ``cpu`` runs their plain versions).

    PYTHONPATH=src python examples/train_tiny_torch.py [--steps 200] \\
        [--device cpu]
"""

import argparse
import os
import tempfile

import repro_torch
from repro_torch import configs
from repro_torch.training.loop import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback to cpu)")
    args = ap.parse_args(argv)
    device = repro_torch.require_device(args.device)

    cfg = configs.get("llama3.2-1b").reduced(n_layers=2, d_model=128)
    print(f"arch: {cfg.name} ({cfg.param_count()/1e6:.1f} M params) on "
          f"{device}")

    ckpt = os.path.join(tempfile.gettempdir(), "repro_torch_tiny_ckpt")
    rep = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=3e-3, log_every=25, ckpt_path=ckpt, device=device)
    first = sum(rep.losses[:10]) / 10
    last = sum(rep.losses[-10:]) / 10
    print(f"loss {first:.3f} -> {last:.3f} over {rep.steps} steps "
          f"({rep.tokens/rep.wall_s:.0f} tok/s)")
    assert last < first, "training failed to reduce loss"
    print(f"checkpoint saved to {ckpt}.npz ✓")
    return {"first": first, "last": last, "steps": rep.steps,
            "losses": rep.losses, "ckpt": ckpt}


if __name__ == "__main__":
    main()
