"""Serve a small LM with batched requests on PyTorch: prefill + KV-cache
decode across the assigned-architecture families (dense / MoE / SSM /
hybrid).

The counterpart of ``examples/lm_generate.py`` in the port
(``repro_torch``): the same four families, sizes, prompt shape and
token count, on ``--device`` (default ``cuda``: the attention, MoE and
SSD kernels; ``cpu`` runs their plain versions).  The weights and the
prompt are the port's own seeded draws, so the tokens differ from the
JAX example's.

    PYTHONPATH=src python examples/lm_generate_torch.py [--device cpu]
"""

import argparse
import time

import torch

import repro_torch
from repro_torch import configs
from repro_torch.models.transformer import model as M
from repro_torch.serving.lm import generate

FAMILIES = ("llama3.2-1b", "mixtral-8x7b", "mamba2-370m", "zamba2-2.7b")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback to cpu)")
    device = repro_torch.require_device(ap.parse_args(argv).device)

    out = {}
    for name in FAMILIES:
        cfg = configs.get(name).reduced(n_layers=2, d_model=128)
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device=device)
        prompt = torch.randint(0, cfg.vocab_size, (4, 12),
                               generator=torch.Generator().manual_seed(1)
                               ).to(device)
        t0 = time.time()
        toks = generate(cfg, params, prompt, n_new=16)
        dt = time.time() - t0
        assert toks.shape == (4, 16)
        print(f"{name:22s} ({cfg.family:6s}) generated {tuple(toks.shape)} "
              f"in {dt:.1f}s on {device}; sample: {toks[0, :8].tolist()}")
        out[name] = toks.cpu()
    print("batched prefill+decode serving works across families ✓")
    return out


if __name__ == "__main__":
    main()
