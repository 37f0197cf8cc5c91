"""Serving launcher: prefill + batched decode of one arch on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --prompt-len 16 --new-tokens 32          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --reduced --device cpu                              # CPU, small

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b

Dense, MoE (granite, mixtral), Mamba2 and hybrid (zamba2) archs run.
Weights are random from ``--seed``, as in the JAX package's launcher.
The archs that take embeddings (llava, musicgen) have no token loop and
stop as the reference's launcher stops them, pointing at the dry run
(``python -m repro_torch.launch.dryrun``, which runs their decode step on
fake tensors); their ``prefill`` and ``decode_step`` run from the
library.
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import configs
from ..api.deployment import require_device
from ..models.transformer import model as M
from ..serving.lm import generate


def main(argv: list[str] | None = None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="run the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback to cpu)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=2, d_model=128)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} takes embeddings; use the dry-run "
                         f"for its serve_step: python -m "
                         f"repro_torch.launch.dryrun --arch {args.arch} "
                         f"--shape decode_32k")
    device = require_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch {cfg.name}: {cfg.param_count()/1e6:.1f} M params, "
          f"device {name}")
    params = M.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    prompt = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed + 1))
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompt, args.new_tokens,
                    temperature=args.temperature,
                    generator=torch.Generator(device=device).manual_seed(
                        args.seed + 2))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = args.batch * args.new_tokens
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({total/dt:.1f} tok/s, wall clock of a first call: on the "
          f"card it includes building any kernel not built yet)")
    print("sample:", toks[0].tolist())
    return toks


if __name__ == "__main__":
    main()
