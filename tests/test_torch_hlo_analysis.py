"""The port's per-device census (``repro_torch.launch.hlo_analysis``)
against the JAX package's HLO census on the same functions (the
counterpart of ``tests/test_hlo_analysis.py``), its rules for bytes and
collectives, the DTensor trap (a per-device count on a fake 16 x 16
mesh, cold and warm), and every LM kernel wrapper on fake tensors: no
launch, the kernel's shapes and dtypes, its ``work(...)`` recorded."""

import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.kernels import _build
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.moe_gemm import ref as moe_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.dryrun import fake_group
from repro_torch.launch.mesh import gather_axis, make_mesh, ring_shift


def _reference_flops(fn, *avals) -> float:
    return analyze_hlo(jax.jit(fn).lower(*avals).compile().as_text()).flops


def _census(fn, *args):
    with H.Census() as c:
        out = fn(*args)
    return out, c.census


# -- the arithmetic, against the reference's census -------------------------

def test_chained_products_count_exactly():
    """L = 12 products of (64, 64) count 2 L M^3 exactly (the reference's
    scan, within its 5%)."""
    L, M = 12, 64
    rng = np.random.default_rng(0)
    ws = torch.tensor(rng.standard_normal((L, M, M), dtype=np.float32))
    x = torch.tensor(rng.standard_normal((M, M), dtype=np.float32))

    def chain(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    _, c = _census(chain, ws, x)
    expect = 2 * L * M ** 3
    assert c.flops == expect
    assert c.by_computation["aten.mm.default"]["mult"] == L

    def scan(ws, x):
        return jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, ws)[0]
    ref = _reference_flops(scan, jax.ShapeDtypeStruct((L, M, M), jnp.float32),
                           jax.ShapeDtypeStruct((M, M), jnp.float32))
    assert abs(ref - expect) / expect < 0.05


def test_nested_loops_count_their_products():
    Lo, Li, M = 4, 5, 16
    ws = torch.ones((Lo, Li, M, M))

    def nested(ws, x):
        for row in ws:
            for w in row:
                x = x @ w
        return x

    _, c = _census(nested, ws, torch.ones((M, M)))
    assert c.flops == 2 * Lo * Li * M ** 3
    assert c.by_computation["aten.mm.default"]["mult"] == Lo * Li

    def ref_nested(ws, x):
        def outer(x, wrow):
            return jax.lax.scan(lambda x, w: (x @ w, None), x, wrow)[0], None
        return jax.lax.scan(outer, x, ws)[0]
    ref = _reference_flops(ref_nested,
                           jax.ShapeDtypeStruct((Lo, Li, M, M), jnp.float32),
                           jax.ShapeDtypeStruct((M, M), jnp.float32))
    assert abs(ref - c.flops) / c.flops < 0.05


def test_the_census_finds_each_op():
    x = torch.ones((8, 8))
    y, c = _census(lambda x: torch.sum(x * 2), x)
    assert set(c.by_computation) == {"aten.mul.Tensor", "aten.sum.default"}
    assert all(e["mult"] == 1 and e["flops"] == 0
               for e in c.by_computation.values())
    # mul reads x and writes x * 2; sum reads it and writes one float
    assert c.hbm_bytes == 3 * 256 + 4
    assert c.flops == 0 and c.total_coll_bytes == 0


def test_bytes_views_allocations_in_place_and_indexed_writes():
    x = torch.ones((4, 16))
    _, c = _census(lambda x: x.view(16, 4).t(), x)
    assert c.hbm_bytes == 0                        # views move nothing
    _, c = _census(lambda: torch.empty((1000,)))
    assert c.hbm_bytes == 0                        # nor allocations
    _, c = _census(lambda x: x.add_(1.0), x)
    assert c.hbm_bytes == 256                      # read and written once
    cache = torch.zeros((2, 100, 8))
    slot = torch.tensor([3])
    row = torch.ones((2, 1, 8))
    _, c = _census(lambda: cache.index_copy_(1, slot, row))
    assert c.hbm_bytes == 8 + 2 * 64               # index, values, written


def test_census_roundtrip_and_refuses_nesting():
    _, c = _census(lambda x: x @ x, torch.ones((4, 4)))
    assert H.HloCensus.from_dict(c.to_dict()) == c
    with H.Census():
        with pytest.raises(RuntimeError, match="another census"):
            with H.Census():
                pass


def test_kernel_work_from_another_thread_counts():
    """On cuda tensors autograd runs a backward on a device thread of its
    own: a kernel's work recorded in another thread belongs to the census
    of the call."""
    with H.Census() as c:
        t = threading.Thread(target=_build.record_work,
                             args=("k", (10.0, 4.0)))
        t.start()
        t.join()
    assert c.census.by_computation == {"k": {"mult": 1, "flops": 10.0,
                                             "coll_bytes": 0.0,
                                             "hbm_bytes": 4.0}}


# -- collectives and the per-device count ------------------------------------

def test_collectives_by_kind_on_a_fake_group():
    """c10d all-gather (``gather_axis``) and a ring hand-off
    (``ring_shift``) count their results' bytes under the reference's
    kinds; a DTensor redistribution counts its functional collective."""
    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        group = mesh.get_group("model")
        x = torch.zeros((3, 5))
        _, c = _census(lambda: gather_axis(x, group, 0))
        assert c.coll_bytes == {"all-gather": 2 * 60}
        assert c.coll_counts == {"all-gather": 1}
        _, c = _census(lambda: ring_shift([x], group, 0, 2))
        assert c.coll_bytes == {"collective-permute": 60}
        t = DTensor.from_local(torch.zeros((3, 5)), mesh,
                               [Shard(0), Replicate()], run_check=False)
        _, c = _census(lambda: t.redistribute(mesh, [Replicate(),
                                                     Replicate()]))
        assert c.coll_bytes == {"all-gather": 2 * 60}
        assert c.coll_ops == [(120, "all-gather", "_c10d_functional."
                               "all_gather_into_tensor.default")]


@pytest.mark.parametrize("fake", [False, True], ids=["zeros", "fake"])
def test_a_shard_to_shard_redistribution_counts_one_all_to_all(fake):
    """DTensor's Shard(0) -> Shard(1) over ``model`` on a CPU mesh falls
    back to an all-gather and a chunk (gloo has no all-to-all); the census
    counts it as the all-to-all it stands for: one, of the bytes it counts
    for ``all_to_all_single`` of the same local tensor, and no gather.  On
    zeros and on fake tensors (the dry run's)."""
    import torch.distributed._functional_collectives as funcol
    with fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        with FakeTensorMode() if fake else contextlib.nullcontext():
            loc = torch.zeros((4, 8))
            t = DTensor.from_local(loc, mesh, [Replicate(), Shard(0)],
                                   run_check=False, shape=(8, 8),
                                   stride=(8, 1))
            y, c = _census(lambda: t.redistribute(mesh, [Replicate(),
                                                         Shard(1)]))
            _, single = _census(lambda: funcol.wait_tensor(
                funcol.all_to_all_single(loc, None, None,
                                         mesh.get_group("model"))))
        assert tuple(y.to_local().shape) == (8, 4)
        assert single.coll_counts == {"all-to-all": 1}
        assert c.coll_counts == single.coll_counts
        assert c.coll_bytes == single.coll_bytes == {"all-to-all": 128}
        assert c.coll_ops == [(128, "all-to-all", H.ALLTOALL_OP)]
        assert c.hbm_bytes == 128


def test_the_dtensor_trap_counts_one_device():
    """x (2048, 2048) [Shard(0), Replicate()] @ W (2048, 8192)
    [Replicate(), Shard(1)] on a fake (16, 16) mesh: rank 0's product,
    (128 x 2048) @ (2048 x 512), is 2.68e8 FLOPs, on a cold sharding
    cache and a warm one: never the global product (6.87e10) and never
    the global-shape metadata op of the sharding propagator (6.90e10 on
    the first call)."""
    want = 2 * 128 * 2048 * 512
    with fake_group(256):
        mesh = make_mesh((16, 16), ("data", "model"), "cpu")
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(128, 2048), mesh,
                                   [Shard(0), Replicate()], run_check=False,
                                   shape=(2048, 2048), stride=(2048, 1))
            w = DTensor.from_local(torch.empty(2048, 512), mesh,
                                   [Replicate(), Shard(1)], run_check=False,
                                   shape=(2048, 8192), stride=(8192, 1))
            for _ in range(2):
                y, c = _census(lambda: x @ w)
                assert c.flops == want
                assert c.by_computation["aten.mm.default"]["mult"] == 1
                assert tuple(y.shape) == (2048, 8192)


# -- the LM kernels on fake tensors ------------------------------------------

def _real(shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape, dtype=np.float32)) \
        .to(dtype)


def _fake(mode, t, requires_grad=False):
    """A fake tensor of ``t``'s shape and dtype: on ``cuda`` (no card
    needed), or on the CPU where it requires grad (the autograd engine
    takes a CUDA tensor's device and aborts without a card)."""
    with mode:
        f = torch.empty(t.shape, dtype=t.dtype,
                        device="cpu" if requires_grad else "cuda")
    return f.requires_grad_(requires_grad)


def _same_meta(a, b):
    assert tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype


def _kernel_entry(c, name, work, calls=1):
    e = c.by_computation[name]
    assert e["mult"] == calls and e["flops"] == work[0]
    assert e["hbm_bytes"] == work[1]


@pytest.fixture
def launches():
    """Every LM kernel's launch counts before and after the test: fake
    inputs launch nothing."""
    def counts():
        return {(m.__name__, n): m.launch_count(n)
                for m in (attn_ops, moe_ops, ssd_ops) for n in m.SOURCES}
    before = counts()
    yield
    assert counts() == before


PREFILL = [((2, 9, 2, 3, 16), 0, torch.float32),
           ((1, 70, 1, 4, 64), 16, torch.float32),
           ((2, 33, 2, 2, 32), 0, torch.bfloat16)]


@pytest.mark.parametrize("shape,window,dtype", PREFILL)
def test_flash_prefill_on_fake_tensors(shape, window, dtype, launches):
    b, s, k, g, d = shape
    q, kk, vv = (_real(sh, dtype, i) for i, sh in
                 enumerate([shape, (b, s, k, d), (b, s, k, d)]))
    plain = attn_ops.flash_prefill(q, kk, vv, sliding_window=window)
    mode = FakeTensorMode()
    fq, fk, fv = (_fake(mode, t) for t in (q, kk, vv))
    out, c = _census(lambda: attn_ops.flash_prefill(
        fq, fk, fv, sliding_window=window))
    _same_meta(out, plain)
    assert out.device.type == "cuda"
    work = attn_ops.flash_prefill_work(shape, window, q.element_size())
    _kernel_entry(c, "flash_prefill", work)
    assert (c.flops, c.hbm_bytes) == work
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
    assert work[0] == 4.0 * b * k * g * d * pairs


@pytest.mark.parametrize("shape,window", [(s, w) for s, w, dt in PREFILL
                                          if dt == torch.float32])
def test_flash_prefill_backward_on_fake_tensors(shape, window, launches):
    b, s, k, g, d = shape
    real = [_real(sh, seed=i).requires_grad_(True) for i, sh in
            enumerate([shape, (b, s, k, d), (b, s, k, d)])]
    y = attn_ref.flash_prefill_ref(*real, window)
    plain = torch.autograd.grad(y, real, torch.ones_like(y))
    mode = FakeTensorMode()
    fake = [_fake(mode, t.detach(), True) for t in real]

    def step():
        with mode:
            o = attn_ops.FlashPrefill.apply(*fake, window)
            return torch.autograd.grad(o, fake, torch.ones_like(o))
    grads, c = _census(step)
    for got, want in zip(grads, plain):
        _same_meta(got, want)
    _kernel_entry(c, "flash_prefill",
                  attn_ops.flash_prefill_work(shape, window, 4))
    _kernel_entry(c, "flash_prefill_bwd",
                  attn_ops.flash_prefill_bwd_work(shape, window))


def test_flash_prefill_bwd_refuses_bf16_on_fake_tensors():
    mode = FakeTensorMode()
    q = _fake(mode, _real((1, 8, 1, 2, 16), torch.bfloat16))
    k = _fake(mode, _real((1, 8, 1, 16), torch.bfloat16))
    with pytest.raises(NotImplementedError, match="no bf16 backward"):
        attn_ops.flash_prefill_bwd(q, k, k, q, q)


def test_fake_tensors_are_refused_where_the_kernel_refuses():
    mode = FakeTensorMode()
    q = _fake(mode, _real((1, 8, 1, 2, 12)))          # head dim 12
    k = _fake(mode, _real((1, 8, 1, 12)))
    with pytest.raises(ValueError, match="head dim 12"):
        attn_ops.flash_prefill(q, k, k)
    x = _fake(mode, _real((2, 4, 8)).double())
    w = _fake(mode, _real((2, 8, 4)).double())
    with pytest.raises(ValueError, match="not supported"):
        moe_ops.moe_gemm(x, w)
    with pytest.raises(ValueError, match="takes float32"):
        moe_ops.moe_gemm_nt(x, x)
    with pytest.raises(ValueError, match="past the grid"):
        moe_ops.moe_gemm_tn(_fake(mode, torch.empty(65536, 1, 1)),
                            _fake(mode, torch.empty(65536, 1, 1)))


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_on_fake_tensors(lse, dtype, launches):
    b, k, g, d, w = 2, 2, 4, 64, 40
    q, kk, vv = (_real(sh, dtype, i) for i, sh in
                 enumerate([(b, k, g, d), (b, w, k, d), (b, w, k, d)]))
    vl = torch.tensor([17], dtype=torch.int32)
    plain = attn_ops.decode_attention(q, kk, vv, vl, with_lse=lse)
    mode = FakeTensorMode()
    fq, fk, fv = (_fake(mode, t) for t in (q, kk, vv))
    with mode:
        fvl = torch.zeros((1,), dtype=torch.int32, device="cuda")
    out, c = _census(lambda: attn_ops.decode_attention(fq, fk, fv, fvl,
                                                       with_lse=lse))
    for got, want in zip(*((out, plain) if lse else ((out,), (plain,)))):
        _same_meta(got, want)
    work = attn_ops.decode_attention_work((b, k, g, d), w, q.element_size(),
                                          with_lse=lse)
    _kernel_entry(c, "decode_attention", work)
    # all W entries counted: the valid length is unknown on fake tensors
    assert work == attn_ops.decode_attention_work(
        (b, k, g, d), w, q.element_size(), valid_len=w, with_lse=lse)
    assert work[0] == 4.0 * b * k * g * d * w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_on_fake_tensors(dtype, launches):
    e, cc, d, f = 3, 10, 16, 24
    x, w = _real((e, cc, d), dtype), _real((e, d, f), dtype, 1)
    plain = moe_ops.moe_gemm(x, w)
    mode = FakeTensorMode()
    out, c = _census(lambda: moe_ops.moe_gemm(_fake(mode, x),
                                              _fake(mode, w)))
    _same_meta(out, plain)
    work = moe_ops.work(e, cc, d, f, x.element_size())
    _kernel_entry(c, "moe_gemm", work)
    assert work == (2.0 * e * cc * d * f,
                    (x.numel() + w.numel() + plain.numel())
                    * x.element_size())


def test_moe_gemm_backward_on_fake_tensors(launches):
    """``MoeGemm``'s backward: two ``moe_gemm_bwd`` calls (dx = dy wᵀ,
    dw = xᵀ dy) on x, w and dy as they lie, each with its own work; their
    FLOPs are ``bwd_work``'s; the census holds no transpose or copy of an
    operand; nothing launches."""
    e, cc, d, f = 3, 10, 16, 24
    x = _real((e, cc, d)).requires_grad_(True)
    w = _real((e, d, f), seed=1).requires_grad_(True)
    y = moe_ref.moe_gemm_ref(x, w)
    plain = torch.autograd.grad(y, (x, w), torch.ones_like(y))
    mode = FakeTensorMode()
    fx, fw = _fake(mode, x.detach(), True), _fake(mode, w.detach(), True)

    def step():
        with mode:
            o = moe_ops.MoeGemm.apply(fx, fw)
            return torch.autograd.grad(o, (fx, fw), torch.ones_like(o))
    grads, c = _census(step)
    for got, want in zip(grads, plain):
        _same_meta(got, want)
    _kernel_entry(c, "moe_gemm", moe_ops.work(e, cc, d, f, 4))
    dx = moe_ops.work(e, cc, f, d, 4)       # (E, C, F) x (E, F, D)
    dw = moe_ops.work(e, d, cc, f, 4)       # (E, D, C) x (E, C, F)
    entry = c.by_computation["moe_gemm_bwd"]
    assert entry["mult"] == 2
    assert entry["flops"] == dx[0] + dw[0] == moe_ops.bwd_work(e, cc, d, f)[0]
    assert entry["hbm_bytes"] == dx[1] + dw[1]
    moved = [k for k in c.by_computation
             if k.startswith(("aten.clone", "aten.copy", "aten.transpose",
                              "aten.contiguous", "aten.permute"))]
    assert moved == []


SSD = [((3, 64, 4, 16, 32), torch.float32), ((2, 40, 2, 8, 16),
                                             torch.bfloat16)]


def _ssd_inputs(shape, dtype, grad=False):
    bc, q, h, p, n = shape
    ts = [_real((bc, q, h, p), seed=0), _real((bc, q, h), seed=1).abs(),
          -_real((h,), seed=2).abs(), _real((bc, q, n), seed=3),
          _real((bc, q, n), seed=4)]
    return [t.to(dtype).requires_grad_(grad) for t in ts]


@pytest.mark.parametrize("shape,dtype", SSD)
def test_ssd_chunk_on_fake_tensors(shape, dtype, launches):
    real = _ssd_inputs(shape, dtype)
    plain = ssd_ops.ssd_chunk(*real)
    mode = FakeTensorMode()
    fake = [_fake(mode, t) for t in real]
    out, c = _census(lambda: ssd_ops.ssd_chunk(*fake))
    for got, want in zip(out, plain):
        _same_meta(got, want)
    work = ssd_ops.ssd_chunk_work(*shape, real[0].element_size())
    _kernel_entry(c, "ssd_chunk", work)
    assert (c.flops, c.hbm_bytes) == work


def test_ssd_chunk_backward_on_fake_tensors(launches):
    shape = SSD[0][0]
    real = _ssd_inputs(shape, torch.float32, grad=True)
    y, st = ssd_ref.ssd_chunk_ref(*real)
    plain = torch.autograd.grad((y, st), real,
                                (torch.ones_like(y), torch.ones_like(st)))
    mode = FakeTensorMode()
    fake = [_fake(mode, t.detach(), True) for t in real]

    def step():
        with mode:
            y, st = ssd_ops.SsdChunk.apply(*fake)
            return torch.autograd.grad((y, st), fake, (torch.ones_like(y),
                                                       torch.ones_like(st)))
    grads, c = _census(step)
    for got, want in zip(grads, plain):
        _same_meta(got, want)
    _kernel_entry(c, "ssd_chunk", ssd_ops.ssd_chunk_work(*shape, 4))
    _kernel_entry(c, "ssd_chunk_bwd", ssd_ops.ssd_chunk_bwd_work(*shape))
