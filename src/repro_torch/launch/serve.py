"""Serving launcher: prefill + batched decode of one arch on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --prompt-len 16 --new-tokens 32          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --reduced --device cpu                              # CPU, small

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m

Dense, MoE (granite, mixtral) and Mamba2 archs run.  Weights are random
from ``--seed``, as in the JAX package's launcher.  What the port lacks
yet (zamba2's shared block, the embeddings input of llava and musicgen)
stops with a message naming ROADMAP Queue 1, item 10d.
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import configs
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
        raise SystemExit(f"{args.arch} takes embeddings, which the port "
                         f"does not serve yet (ROADMAP Queue 1, item 10d)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions on the CPU")
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
