"""Multi-rank runs of the port's mesh, GPipe pipeline and ring attention
(``repro_torch.launch.mesh``, ``repro_torch.pipeline.microbatch_pipeline``,
``repro_torch.models.transformer.ring_attention``):
spawned ``torch.distributed`` ranks with a time limit, and the bodies they
run.  Imports neither ``jax`` nor ``repro``: each spawned rank imports this
module, and the ``cuda``-marked test runs it on a machine without JAX."""

import multiprocessing as mp
import queue
import socket
import time
import traceback
from datetime import timedelta

import numpy as np

#: the time limit of one multi-rank run, spawn to last result
RUN_TIMEOUT_S = 120.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(body, rank, world, port, backend, results, args):
    import os
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        if backend is None:
            # torchrun's environment: the body starts the group itself
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                              LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                              MASTER_PORT=str(port))
            results.put((rank, True, body(rank, world, *args)))
            return
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=RUN_TIMEOUT_S))
        try:
            results.put((rank, True, body(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(body, world: int, *args, backend: str = "gloo",
              timeout: float = RUN_TIMEOUT_S) -> list:
    """``body(rank, world, *args)`` in ``world`` spawned ranks of one
    process group (``backend``, ``tcp://localhost`` on a free port;
    ``backend=None``: no group, but torchrun's environment variables,
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``, for a body that starts the group itself);
    returns each rank's result, by rank.  A rank that raises fails the
    run with its traceback, one that dies with no result with its exit
    code; past ``timeout`` seconds (a P2P deadlock) every rank is killed
    and the run raises ``TimeoutError``."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(body, r, world, port, backend, results, args))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks: {sorted(got)} returned "
                                   f"within {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                died = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in got and p.exitcode}
                if died and results.empty():
                    raise RuntimeError(f"ranks exited with {died} and no "
                                       "result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(0.1, min(10.0, deadline - time.monotonic())))
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


# -- the bodies' pieces -------------------------------------------------------

def tanh_stage(sid, w, x):
    """``test_microbatch_pipeline_exact``'s stage: tanh(x @ w)."""
    import torch
    return torch.tanh(x @ w)


def sequential(ws, xs):
    """The stages composed one after another on every microbatch, in
    torch: what the pipeline must return."""
    import torch
    ref = torch.as_tensor(xs)
    for w in torch.as_tensor(ws):
        ref = torch.tanh(ref @ w)
    return ref.numpy()


def llama_stage_fn(cfg, backend: str):
    """The stage of a layer stack split into pipeline stages
    (``examples/pico_pod_pipeline.py``'s): ``rms_norm``, attention,
    ``mlp``, once for each layer of the stage's slice of
    ``params["layers"]``."""
    from repro_torch.models.transformer.layers import (attention_prefill,
                                                       mlp, rms_norm)
    from repro_torch.training import tree

    def stage_fn(sid, lp, x):
        for i in range(lp["ln1"].shape[0]):
            one = tree.map_(lambda a: a[i], lp)
            h, _ = attention_prefill(
                one["attn"], rms_norm(x, one["ln1"], cfg.norm_eps),
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
                rope_theta=cfg.rope_theta,
                sliding_window=cfg.sliding_window, backend=backend)
            x = x + h
            x = x + mlp(one["mlp"], rms_norm(x, one["ln2"], cfg.norm_eps))
        return x
    return stage_fn


def split_stages(layers, n_stages: int):
    """``params["layers"]`` (leaves stacked on L) as n_stages stages of
    L / n_stages contiguous layers: leaves (n_stages, L / n_stages, ...)."""
    from repro_torch.training import tree
    return tree.map_(lambda a: a.reshape(n_stages, -1, *a.shape[1:]),
                     layers)


def llama_params(cfg, leaves):
    """The port's parameter tree of ``cfg`` with the reference's leaves
    (in ``jax.tree.leaves`` order), on the CPU."""
    import torch
    from repro_torch.models.transformer import model as M
    from repro_torch.training import tree
    like = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return tree.unflatten(like, [torch.from_numpy(np.asarray(a))
                                 for a in leaves])


def _hand_offs_since(before: dict) -> dict:
    """The ring hand-offs by transport since ``before`` (a copy of
    ``launch.mesh.HAND_OFFS``)."""
    from repro_torch.launch import mesh as mesh_mod
    return {k: n - before[k] for k, n in mesh_mod.HAND_OFFS.items()}


def _raised(fn) -> str:
    """The message of the ``ValueError`` ``fn()`` raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


# -- rank bodies (module-level: spawned ranks import them) -------------------

def body_four(rank, world, inputs, llama, ring):
    """The 4-rank CPU run: every case of the pipeline and mesh tests that
    needs four ranks, and ring attention over the 4-rank line (``ring``:
    q, k, v and a reduced Llama's (cfg, numpy params tree, tokens));
    returns this rank's results."""
    import torch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer.ring_attention import ring_attention
    from repro_torch.pipeline import microbatch_pipeline

    def pipe(mesh, ws, xs):
        return microbatch_pipeline(tanh_stage, torch.as_tensor(ws),
                                   torch.as_tensor(xs), mesh).numpy()

    ws, xs = inputs["ws"], inputs["xs"]
    line = mesh_mod.make_mesh((4,), ("stage",), device_type="cpu")
    grid = mesh_mod.make_mesh((2, 2), ("data", "stage"), device_type="cpu")
    before = dict(mesh_mod.HAND_OFFS)
    out = {"exact": pipe(line, ws, xs)}
    out["exact_hand_offs"] = _hand_offs_since(before)
    out.update(micro2=pipe(line, ws, inputs["xs2"]),
               micro1=pipe(line, ws, inputs["xs1"]),
               mesh22=pipe(grid, ws[:2], xs))

    cfg, leaves, toks = llama
    params = llama_params(cfg, leaves)
    xs_l = params["embed"][torch.as_tensor(toks).long()]
    out["llama"] = microbatch_pipeline(
        llama_stage_fn(cfg, "cuda"), split_stages(params["layers"], 4),
        xs_l, line).numpy()

    (q, k, v), (cfg_r, ptree, toks_r) = ring
    with torch.no_grad():
        out["ring"] = {
            "o": ring_attention(*(torch.tensor(t) for t in (q, k, v)), line,
                                "stage").numpy(),
            "logits": M.forward(cfg_r, M.params_from_numpy(cfg_r, ptree,
                                                           "cpu"),
                                {"tokens": torch.tensor(toks_r)},
                                ring=(line, "stage")).numpy()}

    test_mesh = mesh_mod.make_test_mesh(device_type="cpu")
    out["test_mesh"] = (tuple(test_mesh.shape), test_mesh.mesh_dim_names)
    out["make_mesh"] = [(tuple(m.shape), m.mesh_dim_names)
                        for m in (line, grid)]
    pod = mesh_mod.make_mesh((1, 2, 2), ("pod", "data", "model"), "cpu")
    out["batch_axes"] = [mesh_mod.batch_axes(m)
                         for m in (test_mesh, pod, line)]
    out["raises"] = {
        "production": _raised(
            lambda: mesh_mod.make_production_mesh(device_type="cpu")),
        "production_multi_pod": _raised(
            lambda: mesh_mod.make_production_mesh(multi_pod=True,
                                                  device_type="cpu")),
        "world": _raised(lambda: mesh_mod.make_mesh((2,), ("stage",),
                                                    device_type="cpu")),
        "leading_dim": _raised(lambda: pipe(line, ws[:3], xs)),
        "shape": _raised(lambda: microbatch_pipeline(
            lambda sid, w, x: (x @ w)[..., :8], torch.as_tensor(ws),
            torch.as_tensor(xs), line)),
        "dtype": _raised(lambda: microbatch_pipeline(
            lambda sid, w, x: (x @ w).double(), torch.as_tensor(ws),
            torch.as_tensor(xs), line)),
    }
    return out


def body_small(rank, world, inputs):
    """A 1- or 2-rank CPU run: the pipeline over every rank (world size 1:
    one stage, no P2P) and ``make_test_mesh``'s shape."""
    import torch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.pipeline import microbatch_pipeline
    line = mesh_mod.make_mesh((world,), ("stage",), device_type="cpu")
    test_mesh = mesh_mod.make_test_mesh(device_type="cpu")
    out = microbatch_pipeline(tanh_stage, torch.as_tensor(inputs["ws"][:world]),
                              torch.as_tensor(inputs["xs"]), line)
    return {"pipe": out.numpy(),
            "test_mesh": (tuple(test_mesh.shape), test_mesh.mesh_dim_names)}


def body_cuda_two(rank, world, cfg, toks):
    """Two gloo ranks on ``cuda:0``: a two-stage reduced Llama through the
    ``flash_prefill`` kernel; returns the pipeline's output, the
    one-process run of the same stages (rank 0), the hand-offs by
    transport and the kernel's launches of the call."""
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.transformer import model as M
    from repro_torch.pipeline import microbatch_pipeline, runner

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cuda")
    xs = params["embed"][torch.as_tensor(toks, device="cuda").long()]
    stages = split_stages(params["layers"], world)
    fn = llama_stage_fn(cfg, "cuda")
    line = mesh_mod.make_mesh((world,), ("stage",))
    hand_offs = dict(runner.HAND_OFFS)
    attn_ops.reset_launches()
    out = microbatch_pipeline(fn, stages, xs, line)
    torch.cuda.synchronize()
    res = {"out": out.cpu().numpy(),
           "launches": attn_ops.launch_count("flash_prefill"),
           "hand_offs": {k: n - hand_offs[k]
                         for k, n in runner.HAND_OFFS.items()}}
    if rank == 0:
        from repro_torch.training import tree
        seq = []
        for x in xs:
            for s in range(world):
                x = fn(s, tree.map_(lambda a: a[s], stages), x)
            seq.append(x)
        res["sequential"] = torch.stack(seq).cpu().numpy()
    return res


def body_ring(rank, world, inputs, attn_cases, models):
    """The 8-rank CPU run of ring attention on a (2, 4) ("data", "model")
    mesh: ``ring_attention``'s output and its dq, dk, dv for each of
    ``attn_cases`` ({name: (B, S, K, G, D, window)}, inputs and the
    output gradient from ``inputs``), a bf16 forward, and for each of
    ``models`` ({name: (cfg, numpy params tree)}) ``forward``,
    ``prefill`` and ``loss_and_grads`` with ``ring=(mesh, "model")``,
    and a 62-token forward (no multiple of 4: the blockwise path);
    the hand-offs of each call by transport."""
    import torch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer.ring_attention import ring_attention
    from repro_torch.training import loss_and_grads, tree

    mesh = mesh_mod.make_mesh((2, 4), ("data", "model"), device_type="cpu")
    ring = (mesh, "model")
    out = {"coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model"))}
    for name, (*_, w) in attn_cases.items():
        q, k, v = (torch.tensor(inputs[f"{name}_{t}"]).requires_grad_(True)
                   for t in "qkv")
        before = dict(mesh_mod.HAND_OFFS)
        o = ring_attention(q, k, v, mesh, "model", sliding_window=w)
        fwd = _hand_offs_since(before)
        (o * torch.tensor(inputs[f"{name}_do"])).sum().backward()
        out[name] = {"o": o.detach().numpy(), "dq": q.grad.numpy(),
                     "dk": k.grad.numpy(), "dv": v.grad.numpy(),
                     "hand_offs": fwd, "bwd_hand_offs": _hand_offs_since(
                         {k_: before[k_] + fwd[k_] for k_ in before})}
    q, k, v = (torch.tensor(inputs[f"s64_{t}"]) for t in "qkv")
    out["bf16"] = ring_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 mesh, "model").float().numpy()
    out["raises"] = {
        "axis_size": _raised(lambda: ring_attention(q, k, v, mesh, "model",
                                                    axis_size=2)),
        "seq": _raised(lambda: ring_attention(q[:, :62], k[:, :62],
                                              v[:, :62], mesh, "model")),
        "shape": _raised(lambda: ring_attention(q, k[..., :8], v, mesh,
                                                "model"))}

    for name, (cfg, ptree) in models.items():
        params = M.params_from_numpy(cfg, ptree, device="cpu")
        toks = torch.tensor(inputs[f"{name}_tokens"])
        batch = {"tokens": toks,
                 "labels": torch.tensor(inputs[f"{name}_labels"])}
        before = dict(mesh_mod.HAND_OFFS)
        with torch.no_grad():
            logits = M.forward(cfg, params, {"tokens": toks}, ring=ring)
            fwd = _hand_offs_since(before)
            last, cache = M.prefill(cfg, params, {"tokens": toks}, ring=ring)
        loss, grads = loss_and_grads(cfg, params, batch, ring=ring)
        res = {"logits": logits.numpy(), "last": last.numpy(),
               "cache": {k_: t.numpy() for k_, t in cache.items()},
               "loss": float(loss),
               "grads": [g.numpy() for g in tree.leaves(grads)],
               "hand_offs": fwd}
        with torch.no_grad():
            before = dict(mesh_mod.HAND_OFFS)
            short = {"tokens": toks[:, :62]}
            res["short"] = M.forward(cfg, params, short, ring=ring).numpy()
            res["short_hand_offs"] = _hand_offs_since(before)
            res["short_plain"] = M.forward(cfg, params, short).numpy()
        out[name] = res
    return out


def body_cuda_ring(rank, world, inputs, windows):
    """Gloo ranks on ``cuda:0``: ``ring_attention`` over the line of every
    rank, forward and backward, for each window; the one-process
    ``FlashPrefill`` (the flash_prefill kernel and its backward kernel) on
    the same inputs on rank 0; the hand-offs by transport."""
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.transformer.ring_attention import ring_attention

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    line = mesh_mod.make_mesh((world,), ("model",))
    out = {}
    for w in windows:
        q, k, v, do = (torch.tensor(inputs[t], device="cuda")
                       for t in ("q", "k", "v", "do"))
        runs = [("ring", lambda q, k, v, w=w: ring_attention(
            q, k, v, line, "model", sliding_window=w))]
        if rank == 0:
            runs.append(("one", lambda q, k, v, w=w:
                         attn_ops.FlashPrefill.apply(q, k, v, w)))
        for name, fn in runs:
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            before = dict(mesh_mod.HAND_OFFS)
            o = fn(*leaves)
            (o * do).sum().backward()
            torch.cuda.synchronize()
            out[(name, w)] = {
                "o": o.detach().cpu().numpy(),
                **{f"d{t}": x.grad.cpu().numpy()
                   for t, x in zip("qkv", leaves)},
                "hand_offs": _hand_offs_since(before)}
    return out


# -- sharding: the rules as DTensor placements --------------------------------

def _full(tree_):
    """Every DTensor leaf of ``tree_`` gathered (every rank calls this, in
    the same order), as numpy arrays in ``jax.tree.leaves``' order."""
    from repro_torch.launch.sharding import full
    from repro_torch.training import tree
    return [full(t).detach().cpu().numpy() for t in tree.leaves(tree_)]


def _placed_as(tree_, params, specs, mesh) -> bool:
    """Whether every leaf of ``tree_`` is a DTensor in the placements of
    its param's spec."""
    from repro_torch.launch.sharding import placements
    from repro_torch.training import tree
    return all(tuple(t.placements) == placements(s, mesh)
               for t, s in zip(tree.leaves(tree_), tree.leaves(specs)))


def _placed_params(cfg, ptree, tokens, mesh, device):
    """(params, specs, batch): the reference's params tree as the port's,
    placed by ``param_pspecs``, and a {tokens, labels} batch placed by
    ``batch_pspecs`` over the mesh's data axes."""
    import torch
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models.transformer import model as M
    params = M.params_from_numpy(cfg, ptree, device=device)
    specs = S.param_pspecs(cfg, params, mesh)
    toks = torch.as_tensor(tokens, device=device)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    batch = S.distribute(batch, S.batch_pspecs(cfg, batch, mesh,
                                               batch_axes(mesh)), mesh)
    return S.distribute(params, specs, mesh), specs, batch


def body_shard_step(rank, world, cfg, ptree, tokens, lr, eps):
    """The 8-rank CPU run of ``tests/test_multidevice.py``'s
    ``test_sharded_train_step``: a (2, 4) ("data", "model") mesh, the
    reference's weights placed by ``param_pspecs``, one
    ``make_train_step`` step (AdamW ``lr``, ``eps``).  Returns the loss,
    the new params gathered, and whether the new params, m and v have
    their specs' placements."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import AdamW, make_train_step

    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    params, specs, batch = _placed_params(cfg, ptree, tokens, mesh, "cpu")
    opt = AdamW(lr=lr, eps=eps)
    new, state, loss = make_train_step(cfg, opt)(params, opt.init(params),
                                                 batch)
    return {"loss": float(loss), "params": _full(new),
            "placed": [_placed_as(t, params, specs, mesh)
                       for t in (new, state.m, state.v)]}


def body_shard_grads(rank, world, models, tokens, act_pspec, moe_pspec):
    """The 4-rank CPU run on a (2, 2) ("data", "model") mesh of host-staged
    gloo sub-groups (``launch.mesh.HostGloo``): for each of
    ``models`` ({name: (cfg, numpy params tree)}) ``loss_and_grads`` with
    ``act_pspec`` (and ``moe_pspec`` for an MoE config) on the params
    placed by ``param_pspecs``, the gradients gathered and whether they
    have their params' placements; ``prefill`` with ``act_pspec`` of the
    first model (the last logits and the cache gathered); the clipped
    ``AdamW.update`` of the first model's placed gradients; the
    ``ValueError`` of a ``moe_pspec`` off the data axes; and the
    collectives the sub-groups carried, by kind and path."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding as S
    from repro_torch.models.transformer import model as M
    from repro_torch.training import AdamW, loss_and_grads

    # the sub-groups a CUDA mesh over gloo gets (host-staged gloo), here
    # on host tensors: what the card runs, but for the copies
    axes = ("data", "model")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=axes,
                            backend_override=mesh_mod.host_staged(axes))
    act = S.P(*act_pspec)
    out = {"backend": torch.distributed.get_backend(mesh.get_group("model"))}
    for i, (name, (cfg, ptree)) in enumerate(models.items()):
        params, specs, batch = _placed_params(cfg, ptree, tokens[name], mesh,
                                              "cpu")
        moe = S.P(*moe_pspec) if cfg.is_moe else None
        loss, grads = loss_and_grads(cfg, params, batch, act_pspec=act,
                                     moe_pspec=moe)
        out[name] = {"loss": float(loss), "grads": _full(grads),
                     "placed": _placed_as(grads, params, specs, mesh)}
        if i == 0:
            with torch.no_grad():
                last, cache = M.prefill(cfg, params,
                                        {"tokens": batch["tokens"]},
                                        act_pspec=act)
            out[name]["last"] = S.full(last).numpy()
            out[name]["cache"] = {k: S.full(t).numpy()
                                  for k, t in cache.items()}
            # a clip that engages and an eps that keeps the update
            # proportional to the clipped gradient: the global norm shows
            opt = AdamW(lr=1e3, weight_decay=0.0, grad_clip=1e-3, eps=1.0)
            new, _ = opt.update(grads, opt.init(params), params)
            out[name]["clipped"] = _full(new)
        if cfg.is_moe:
            out[name]["moe_pspec_raises"] = _raised(lambda: M.forward(
                cfg, params, {"tokens": batch["tokens"]},
                moe_pspec=S.P(None, ("data",), None, None)))
    out["collectives"] = dict(mesh_mod.COLLECTIVES)
    return out


def body_sharded_loss(rank, world, cases, tokens):
    """The 4-rank CPU run of ``tests/test_torch_sharded_loss.py`` on a
    (2, 2) ("data", "model") gloo mesh: for each of ``cases`` ({name:
    (arch, vocab or None, numpy params tree)}, the arch reduced to 2
    layers of d 128), on the params placed by ``param_pspecs``,
    ``loss_and_grads`` (the loss, the gradients gathered, whether they
    have their params' placements, and how often ``sharded.mlp`` met
    placed inputs), then ``sharded.token_nll`` of the placed logits
    against the plain expression on the same logits gathered, and the
    placements of both.  The configs are built here from names: a
    config's class imports the port when a rank unpickles it, and the
    parent's hand-over of the next rank's arguments waits on that."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer import sharded
    from repro_torch.training import loss_and_grads

    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    calls = {"mlp": 0}
    inner = sharded.mlp

    def counted(layer, p, x):
        calls["mlp"] += sharded.placed(x)
        return inner(layer, p, x)
    sharded.mlp = counted           # model.py calls it through the module
    out = {}
    for name, (arch, vocab, ptree) in cases.items():
        cfg = configs.get(arch).reduced(n_layers=2, d_model=128)
        if vocab:
            cfg = dataclasses.replace(cfg, vocab_size=vocab)
        params, specs, batch = _placed_params(cfg, ptree, tokens[name], mesh,
                                              "cpu")
        calls["mlp"] = 0
        loss, grads = loss_and_grads(cfg, params, batch)
        out[name] = {"loss": float(loss), "grads": _full(grads),
                     "placed": _placed_as(grads, params, specs, mesh),
                     "mlp_calls": calls["mlp"]}
        with torch.no_grad():
            logits = M.forward(cfg, params,
                               {"tokens": batch["tokens"]}).float()
            labels = batch["labels"].long()
            nll = sharded.token_nll(logits, labels)
            plain = sharded.token_nll(S.full(logits), S.full(labels))
        out[name].update(nll=S.full(nll).numpy(), plain=plain.numpy(),
                         places={k: [repr(p) for p in t.placements]
                                 for k, t in (("logits", logits),
                                              ("nll", nll))})
    return out


def body_cuda_shard(rank, world, cfg, tokens):
    """Gloo ranks on ``cuda:0``, a (1, world) ("data", "model") mesh: the
    reduced Llama's ``loss_and_grads`` through the kernels (attention and
    its backward on each rank's kv heads) on params placed by
    ``param_pspecs``; the loss, the gradients gathered, the kernels'
    launches, and on rank 0 the one-process kernel path's loss and
    gradients."""
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import model as M
    from repro_torch.training import loss_and_grads, tree

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((1, world), ("data", "model"))
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cuda")
    toks = torch.as_tensor(tokens, device="cuda")
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    placed = S.distribute(params, S.param_pspecs(cfg, params, mesh), mesh)
    pbatch = S.distribute(batch, S.batch_pspecs(cfg, batch, mesh,
                                                ("data",)), mesh)
    attn_ops.reset_launches()
    loss, grads = loss_and_grads(cfg, placed, pbatch,
                                 act_pspec=S.P(("data",), "model", None))
    torch.cuda.synchronize()
    res = {"loss": float(loss), "grads": _full(grads),
           "launches": {n: attn_ops.launch_count(n)
                        for n in ("flash_prefill", "flash_prefill_bwd")}}
    if rank == 0:
        loss1, grads1 = loss_and_grads(cfg, params, batch)
        res["one"] = (float(loss1), [g.cpu().numpy()
                                     for g in tree.leaves(grads1)])
    return res


# -- ring attention on placed params ------------------------------------------

def body_ring_sharded(rank, world, models, tokens, acts, moe_pspec, extra):
    """The 4-rank CPU run of ring attention on placed params, a (2, 2)
    ("data", "model") mesh of host-staged gloo sub-groups
    (``launch.mesh.HostGloo``) with ``ring=(mesh, "model")``: for each of
    ``models`` ({name: (cfg, numpy params tree)}) and each of ``acts``
    ({key: act_pspec entries or None}) ``forward``, ``prefill`` and
    ``loss_and_grads`` (``moe_pspec`` for an MoE config) on the params
    placed by ``param_pspecs``, each gathered, the gradients' placements,
    the ring's hand-offs of the forward and of the gradient call.  On the
    ``extra`` model: the forward of the first S - 1 tokens (no multiple
    of the axis: the blockwise path), one ``decode_step`` on the cache of
    the ring prefill and of the prefill without the ring (grown by one
    slot), their caches' placements, and the ``ValueError`` of a ring
    over another mesh."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding as S
    from repro_torch.models.transformer import model as M
    from repro_torch.models.transformer import sharded
    from repro_torch.training import loss_and_grads

    axes = ("data", "model")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=axes,
                            backend_override=mesh_mod.host_staged(axes))
    ring = (mesh, "model")
    out = {"coord": tuple(mesh.get_coordinate())}
    for name, (cfg, ptree) in models.items():
        params, specs, batch = _placed_params(cfg, ptree, tokens[name], mesh,
                                              "cpu")
        moe = S.P(*moe_pspec) if cfg.is_moe else None
        toks = {"tokens": batch["tokens"]}
        for key, act in acts.items():
            kw = dict(ring=ring, act_pspec=S.P(*act) if act else None,
                      moe_pspec=moe)
            before = dict(mesh_mod.HAND_OFFS)
            with torch.no_grad():
                logits = M.forward(cfg, params, toks, **kw)
                fwd = _hand_offs_since(before)
                last, cache = M.prefill(cfg, params, toks, **kw)
            before = dict(mesh_mod.HAND_OFFS)
            loss, grads = loss_and_grads(cfg, params, batch, **kw)
            out[name, key] = {
                "logits": S.full(logits).numpy(), "last": S.full(last).numpy(),
                "cache": {k: S.full(t).numpy() for k, t in cache.items()},
                "loss": float(loss), "grads": _full(grads),
                "placed": _placed_as(grads, params, specs, mesh),
                "hand_offs": fwd, "grad_hand_offs": _hand_offs_since(before)}
        if name != extra:
            continue
        with torch.no_grad():
            short = {"tokens": toks["tokens"][:, :-1]}
            before = dict(mesh_mod.HAND_OFFS)
            res = {"short": S.full(M.forward(cfg, params, short,
                                             ring=ring)).numpy(),
                   "short_hand_offs": _hand_offs_since(before)}
            token = {"token": toks["tokens"][:, -1]}
            for label, r in (("ring", ring), ("plain", None)):
                _, cache = M.prefill(cfg, params, toks, ring=r)
                cache = {k: sharded.grow(t, 2, 1) if k in ("k", "v") else t
                         for k, t in cache.items()}
                res[f"{label}_places"] = {
                    k: [repr(p) for p in t.placements]
                    for k, t in cache.items() if sharded.placed(t)}
                step, _ = M.decode_step(cfg, params, cache, token)
                res[f"{label}_step"] = S.full(step).numpy()
            line = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
            res["other_mesh"] = _raised(lambda: M.forward(
                cfg, params, toks, ring=(line, "model")))
        out[name, "extra"] = res
    return out


# -- sharded decode: decode_step on a placed cache ----------------------------

def body_shard_decode(rank, world, cases, modes, gen):
    """The 4-rank CPU run of ``decode_step`` on placed params and a placed
    cache, a (2, 2) ("data", "model") mesh of host-staged gloo sub-groups
    (``launch.mesh.HostGloo``, as a CUDA mesh over gloo gets).  ``cases``:
    {name: (cfg, numpy params tree, numpy cache, fed tokens (B, n))}; for
    each case and each of ``modes`` the params placed by ``param_pspecs``,
    the cache by ``cache_pspecs(mode)``, n teacher-forced steps, each
    step's logits and cache gathered, whether the cache came back as the
    same tensors in the same placements, and its k (or conv)
    placements.  ``gen`` (a case name, a prompt, new tokens): ``generate``
    on that case's placed params (the tokens gathered), whether its
    ``Decoder`` kept from capturing, and the messages of the mixed-input
    ``ValueError``s."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding as S
    from repro_torch.models.transformer import model as M
    from repro_torch.serving import lm

    axes = ("data", "model")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=axes,
                            backend_override=mesh_mod.host_staged(axes))
    out = {}
    with torch.no_grad():
        for name, (cfg, ptree, cache_np, fed) in cases.items():
            plain = M.params_from_numpy(cfg, ptree, device="cpu")
            params = S.distribute(plain, S.param_pspecs(cfg, plain, mesh),
                                  mesh)
            for mode in modes:
                cache = {k: torch.as_tensor(v) for k, v in cache_np.items()}
                cache = S.distribute(cache, S.cache_pspecs(
                    cfg, cache, mesh, ("data",), mode), mesh)
                places = {k: tuple(t.placements) for k, t in cache.items()}
                steps, in_place = [], True
                for t in range(fed.shape[1]):
                    logits, new = M.decode_step(
                        cfg, params, cache,
                        {"token": torch.as_tensor(fed[:, t])})
                    in_place = in_place and all(
                        new[k] is cache[k] for k in cache if k != "len") \
                        and all(tuple(new[k].placements) == places[k]
                                for k in new)
                    cache = new
                    steps.append({"logits": S.full(logits).numpy(),
                                  "cache": {k: S.full(v).numpy()
                                            for k, v in cache.items()}})
                out[name, mode] = {"steps": steps, "in_place": in_place,
                                   "places": {k: [str(p) for p in v]
                                              for k, v in places.items()},
                                   "len": type(cache["len"]).__name__}
        name, prompt, n_new = gen
        cfg, ptree, cache_np, _ = cases[name]
        plain = M.params_from_numpy(cfg, ptree, device="cpu")
        params = S.distribute(plain, S.param_pspecs(cfg, plain, mesh), mesh)
        toks = lm.generate(cfg, params, torch.as_tensor(prompt), n_new)
        _, cache = lm.prefill_prompt(cfg, params, torch.as_tensor(prompt),
                                     n_new)
        decoder = lm.Decoder(cfg, params, cache)
        decoder(torch.as_tensor(prompt[:, -1]).long())
        plain_cache = {k: torch.as_tensor(v) for k, v in cache_np.items()}
        placed_cache = S.distribute(plain_cache, S.cache_pspecs(
            cfg, plain_cache, mesh, ("data",)), mesh)
        token = {"token": torch.as_tensor(prompt[:, -1])}
        out["generate"] = {
            "tokens": S.full(toks).numpy(), "type": type(toks).__name__,
            "captured": (decoder.capture, decoder.graph is not None),
            "cache": {k: [str(p) for p in getattr(t, "placements", ())]
                      for k, t in cache.items()},
            "mixed": [_raised(lambda: M.decode_step(cfg, plain, placed_cache,
                                                    token)),
                      _raised(lambda: M.decode_step(cfg, params, plain_cache,
                                                    token))]}
    out["collectives"] = dict(mesh_mod.COLLECTIVES)
    return out


# -- the train launcher under torchrun's environment --------------------------

def body_launch_train(rank, world, argv):
    """A rank that ``torchrun`` would start (its environment set by
    ``run_ranks(backend=None)``): ``launch.train.main(argv)``, which
    starts and ends the process group.  Returns the losses and whether
    the final params are in their ``param_pspecs`` placements."""
    from repro_torch import configs
    from repro_torch.launch import sharding as S
    from repro_torch.launch import train
    from repro_torch.training import tree

    rep = train.main(argv)
    leaves = tree.leaves(rep.params)
    mesh = leaves[0].device_mesh
    cfg = configs.get("llama3.2-1b").reduced(n_layers=2, d_model=128)
    specs = S.param_pspecs(cfg, rep.params, mesh)
    return {"losses": rep.losses,
            "placed": all(tuple(t.placements) == S.placements(s, mesh)
                          for t, s in zip(leaves, tree.leaves(specs))),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}


def body_cuda_sdecode(rank, world, cfg, toks, steps):
    """Gloo ranks on ``cuda:0``, a (1, world) ("data", "model") mesh: the
    reduced Llama's ``prefill_prompt`` cache (one process, the kernel
    path) placed by ``cache_pspecs`` in each mode, ``steps`` decode steps
    through the ``decode_attention`` kernel on local shards, each step's
    logits gathered and launches counted; rank 0 also runs the
    one-process kernel path's steps."""
    import torch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import model as M
    from repro_torch.serving import lm

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((1, world), ("data", "model"))
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cuda")
    prompt = torch.as_tensor(toks, device="cuda")
    placed = S.distribute(params, S.param_pspecs(cfg, params, mesh), mesh)
    res = {}
    with torch.no_grad():
        _, cache0 = lm.prefill_prompt(cfg, params, prompt, steps)
        feed = prompt[:, -1].long()
        for mode in ("feature", "sequence", None):
            cache = {k: v.clone() for k, v in cache0.items()}
            if mode is not None:
                cache = S.distribute(cache, S.cache_pspecs(
                    cfg, cache, mesh, ("data",), mode), mesh)
            elif rank:
                break
            out, launches = [], []
            for _ in range(steps):
                attn_ops.reset_launches()
                logits, cache = M.decode_step(
                    cfg, placed if mode else params, cache, {"token": feed})
                torch.cuda.synchronize()
                launches.append(attn_ops.launch_count("decode_attention"))
                out.append(S.full(logits).cpu().numpy())
            res[mode or "one"] = {"logits": out, "launches": launches,
                                  "places": [str(p) for p in getattr(
                                      cache["k"], "placements", ())]}
    return res
