"""Training launcher: the train loop of one arch, on one device or
sharded over ``torchrun``'s ranks with the production sharding rules.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 5 --batch 4 --seq 512                      # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --reduced --steps 50 --batch 8 --seq 64 --device cpu   # CPU, small
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen1.5-0.5b --steps 3 --batch 4 --seq 512   # 4 cards
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --reduced --steps 5 --batch 4 --seq 32 --device cpu   # 4 CPU ranks

Under ``torchrun`` (its ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` in the environment) the launcher does
what the reference's does on its host's mesh: it starts the process
group, builds the mesh by the reference's shape rule
(``launch.mesh.make_test_mesh``: 1 -> (1, 1), 2 -> (2, 1), 4 -> (2, 2)
("data", "model")), draws the same weights as the one-device path
(``init_params`` on the host from ``--seed``), places them by
``param_pspecs``, places each ``TokenStream`` batch by ``batch_pspecs``
over the data axes (the reference's dry run does; its launcher leaves the
batch to ``jit``) and runs ``training.make_train_step`` on them with
``cosine_schedule(lr, 10, steps)``.  Every rank computes the same loss;
rank 0 prints.  No checkpoint is written, as the reference's launcher
writes none.  Without that environment the one-device path runs.

Device and backend under ``torchrun``: ``--device cuda`` is
``cuda:LOCAL_RANK``; a device with an index (``cuda:0``) is taken as
given, so several ranks can share one card; ``--device cpu`` runs on the
host.  The backend is ``nccl`` on the card and ``gloo`` on the CPU
unless ``--backend`` names one; gloo on the card gets host-staged
sub-groups (``launch.mesh.make_mesh``).  A choice that does not work
fails (NCCL refuses two ranks on one card), and nothing switches after a
failure.

Weights are random from ``--seed``.  On the card every family the
launcher takes trains: the dense archs (llama, qwen, command-r) through
the attention kernels and their backward, the MoE archs (granite,
mixtral) through those and ``moe_gemm`` with its backward kernel
``moe_gemm_bwd``, Mamba2 (mamba2) through ``ssd_chunk`` and its
backward kernel ``ssd_chunk_bwd``, and the hybrid (zamba2) through all
of them.  The
archs that take embeddings (llava, musicgen) stop as the reference's
launcher stops them.

The optimizer's update is functional, as the reference's: at the update
the old params, m and v, the gradients, the clipped gradients and the
new m, v and params are alive at once, about 8 copies of the params (of
each rank's shards, when sharded).  So granite-moe-3b-a800m at full
depth (3.37 G params, 13.5 GB in fp32) needs about 108 GB and does not
fit one 80 GB card; at 16 of its 32 layers it does (8 x 7.05 GB, plus
the activations).  zamba2-2.7b at full depth (9.7 GB in fp32) needs
about 8 x 9.7 = 78 GB before any activation, so one card trains it at
reduced depth (24 of its 54 layers); the launcher has no depth option,
as the reference's has none: ``training.loop.train`` takes any config.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from .. import configs
from ..data.pipeline import TokenStream
from ..models.transformer.model import init_params
from ..training import AdamW, cosine_schedule, make_train_step
from ..training.loop import TrainReport, train
from .mesh import batch_axes, make_test_mesh
from .sharding import batch_pspecs, distribute, param_pspecs

#: the environment ``torchrun`` gives each rank
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def under_torchrun() -> bool:
    """Whether this process is a rank that ``torchrun`` started."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def rank_device(spec: str) -> torch.device:
    """A rank's device for ``--device spec``: ``cuda`` without an index is
    ``cuda:LOCAL_RANK``; any other device as given."""
    device = torch.device(spec)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def default_backend(device: torch.device) -> str:
    """The process group's backend on ``device``: NCCL on the card, gloo
    on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


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
                    help="torch device (default cuda; no fallback to cpu); "
                         "under torchrun cuda is cuda:LOCAL_RANK")
    ap.add_argument("--backend", default=None,
                    help="process-group backend under torchrun (default "
                         "nccl on the card, gloo on the CPU)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=2, d_model=128)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} takes embeddings; "
                         "train it via the dry-run path")
    device = rank_device(args.device) if under_torchrun() \
        else torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on "
                         "the CPU")
    if under_torchrun():
        return train_sharded(cfg, args, device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch {cfg.name} ({cfg.param_count()/1e6:.1f} M params) on "
          f"{name}")
    rep = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, seed=args.seed, log_every=10, warmup=10,
                device=device)
    print(f"done: {rep.tokens / rep.wall_s:.0f} tok/s")
    return rep


def train_sharded(cfg, args, device: torch.device) -> TrainReport:
    """The train loop on ``torchrun``'s ranks (this process one of them):
    the process group (``args.backend`` or :func:`default_backend`), the
    mesh (:func:`launch.mesh.make_test_mesh`), the params and each batch
    placed by the rules, ``make_train_step`` on them.  Returns this
    rank's report (every rank's losses are the same); the group is
    destroyed at the end."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()       # the mesh then keeps this rank's device
    backend = args.backend or default_backend(device)
    dist.init_process_group(backend)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        mesh = make_test_mesh(device_type=device.type)
        say = print if rank == 0 else (lambda *a, **k: None)
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        say(f"arch {cfg.name} ({cfg.param_count()/1e6:.1f} M params) on "
            f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}: {world} "
            f"ranks, backend {backend}, rank 0 on {device} ({name})",
            flush=True)
        params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                             device="cpu")
        params = distribute(params, param_pspecs(cfg, params, mesh), mesh)
        opt = AdamW(lr=cosine_schedule(args.lr, 10, args.steps))
        state, step = opt.init(params), make_train_step(cfg, opt)
        stream = iter(TokenStream(cfg.vocab_size, args.batch, args.seq,
                                  seed=args.seed, device="cpu"))
        daxes = batch_axes(mesh)
        rep = TrainReport()
        t0 = time.time()
        for i in range(args.steps):
            ts = time.perf_counter()
            batch = next(stream)
            batch = distribute(batch, batch_pspecs(cfg, batch, mesh, daxes),
                               mesh)
            params, state, loss = step(params, state, batch)
            rep.losses.append(float(loss))
            rep.step_s.append(time.perf_counter() - ts)
            rep.tokens += args.batch * args.seq
            if i % 10 == 0 or i == args.steps - 1:
                say(f"step {i:4d}  loss {rep.losses[-1]:.4f}  "
                    f"({rep.tokens / max(time.time() - t0, 1e-9):.0f} "
                    f"tok/s)", flush=True)
        rep.steps = args.steps
        rep.wall_s = time.time() - t0
        rep.params = params
        say(f"done: {rep.tokens / rep.wall_s:.0f} tok/s")
        return rep
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
