"""PICO across cards on PyTorch: plan a decoder's pipeline split with the
PICO DP, then EXECUTE it as a GPipe-style pipeline over a
``torch.distributed`` mesh axis, where stage-boundary activations are
the only cross-rank traffic.

The counterpart of ``examples/pico_pod_pipeline.py`` in the port
(``repro_torch``).  The split is planned on four H100s described by the
card's own figures (``launch/roofline.py``) and run by four spawned
gloo ranks (``microbatch_pipeline``); on ``cuda`` the four ranks share
the one card (NCCL takes no two ranks on one card), on ``cpu`` they run
the plain versions.  The pipelined result must equal the monolithic
forward within 2e-5.

    PYTHONPATH=src python examples/pico_pod_pipeline_torch.py [--device cpu]
"""

import argparse
import multiprocessing as mp
import queue
import socket
import time
import traceback
from datetime import timedelta

import torch

import repro_torch
from repro_torch import configs
from repro_torch.api import PlanSpec
from repro_torch.core import Cluster, Device, plan
from repro_torch.launch.roofline import LINK_BYTES_PER_S, PEAK_FLOPS
from repro_torch.models.graph_export import export_graph
from repro_torch.models.transformer import model as M
from repro_torch.models.transformer.layers import (attention_prefill, mlp,
                                                   rms_norm)
from repro_torch.training import tree

N_STAGES = 4
N_MICRO = 6
RANKS_TIMEOUT_S = 300.0
cfg = configs.get("llama3.2-1b").reduced(n_layers=8, d_model=128)


def h100_cluster(n: int) -> Cluster:
    """``n`` H100s at the card's fp32 peak (the example runs fp32),
    joined by NVLink.  The power fields keep ``Device``'s defaults: the
    period that ``plan`` optimises does not read them."""
    return Cluster([Device(f"h100-{i}", capacity=PEAK_FLOPS["float32"])
                    for i in range(n)], bandwidth=LINK_BYTES_PER_S)


def stage_fn(sid, lp, x):
    """Apply this stage's slice of ``params["layers"]``, layer by layer."""
    for i in range(lp["ln1"].shape[0]):
        one = tree.map_(lambda a: a[i], lp)
        h, _ = attention_prefill(
            one["attn"], rms_norm(x, one["ln1"], cfg.norm_eps),
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
            rope_theta=cfg.rope_theta, sliding_window=cfg.sliding_window)
        x = x + h
        x = x + mlp(one["mlp"], rms_norm(x, one["ln2"], cfg.norm_eps))
    return x


def build(device):
    """The stage params (leaves (N_STAGES, L / N_STAGES, ...)) and the
    microbatches' embeddings (N_MICRO, 2, 64, d), the same seeded draws
    in every process."""
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device=device)
    toks = torch.randint(0, cfg.vocab_size, (N_MICRO, 2, 64),
                         generator=torch.Generator().manual_seed(1))
    xs = params["embed"][toks.to(device)]
    stages = tree.map_(lambda a: a.reshape(N_STAGES, -1, *a.shape[1:]),
                       params["layers"])
    return stages, xs


def rank_main(rank, port, device, results):
    """One gloo rank: the pipeline over a ("stage",) mesh of N_STAGES
    ranks; rank 0 puts the result on ``results``."""
    import torch.distributed as dist
    from repro_torch.launch import make_mesh
    from repro_torch.pipeline import microbatch_pipeline
    try:
        torch.set_num_threads(1)
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=N_STAGES, rank=rank,
                                timeout=timedelta(seconds=RANKS_TIMEOUT_S))
        try:
            mesh = make_mesh((N_STAGES,), ("stage",),
                             device_type=device.type)
            stages, xs = build(device)
            out = microbatch_pipeline(stage_fn, stages, xs, mesh,
                                      axis="stage")
            results.put((rank, True, out.cpu() if rank == 0 else None))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(device) -> torch.Tensor:
    """Spawn the N_STAGES ranks on a free localhost port; rank 0's
    result.  A rank's failure, or RANKS_TIMEOUT_S, stops every rank."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=rank_main, daemon=True,
                         args=(r, port, device, results))
             for r in range(N_STAGES)]
    for p in procs:
        p.start()
    got, out = set(), None
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        while len(got) < N_STAGES:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"ranks: {sorted(got)} returned, "
                                       f"exit codes {dead}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got.add(rank)
            out = value if rank == 0 else out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback to cpu)")
    device = repro_torch.require_device(ap.parse_args(argv).device)

    # 1. PICO plans the stage split (graph export -> Alg.1 pieces -> Alg.2)
    g = export_graph(cfg, seq_len=64)
    pico = plan(g, h100_cluster(N_STAGES), (64, 1),
                spec=PlanSpec(max_diameter=2))
    print(f"PICO split {cfg.n_layers} layers into "
          f"{len(pico.pipeline.stages)} stages; period "
          f"{pico.period*1e6:.1f} us (modeled on {N_STAGES} H100s)")

    # 2. materialize the split: this reduced config is uniform, so the DP's
    #    balanced answer is contiguous equal layer ranges
    assert cfg.n_layers % N_STAGES == 0

    # 3. run N_MICRO microbatches through the 4-stage pipeline on 4 ranks
    out = run_ranks(device)

    # 4. reference: monolithic forward of the same stack, in this process
    stages, ref = build(device)
    for s in range(N_STAGES):
        lp = tree.map_(lambda a: a[s], stages)
        ref = torch.stack([stage_fn(s, lp, x) for x in ref])
    torch.testing.assert_close(out, ref.cpu(), rtol=2e-5, atol=2e-5)
    print(f"{N_STAGES}-stage pipeline over {N_STAGES} gloo ranks on "
          f"{device} matches the monolithic forward ✓ (out "
          f"{tuple(out.shape)})")
    print(f"cross-stage traffic per tick: one (2, 64, {cfg.d_model}) "
          f"activation via ring_shift — the paper's 'narrow waist' on the "
          f"stage axis")
    return {"stages": [(s.first_piece, s.last_piece,
                        [d.name for d in s.devices])
                       for s in pico.pipeline.stages],
            "period": pico.period,
            "max_diff": (out - ref.cpu()).abs().max().item()}


if __name__ == "__main__":             # required: the ranks spawn
    main()
