"""The backward of the port's SSD intra-chunk step on the CPU:
``ssd_chunk_bwd_ref`` (the plain version of the ``ssd_chunk_bwd``
kernel, written out as formulas) against ``jax.vjp`` of the reference's
``ssd_chunk_ref`` and against ``torch.autograd`` of the port's
``ssd_chunk_ref``; ``SsdChunk`` (the autograd Function ``ssd_chunked``
uses) on CPU tensors; and ``ssd_chunked``'s gradients against
``jax.vjp`` of the reference's, on both backends.

Tolerances, each from fp32 sums taken in another order:
- dx, ddt, dB and dC within 1e-5 x max|reference gradient|;
- dA within 1e-4 x max|dA|: dA sums da x dt over every chunk and
  position, and da is a reverse cumsum of dcum whose terms cancel, so
  each fp32 evaluation carries about 1e-5 of max|dA| (the reference's own
  fp32 vjp and the port's autograd are each that far from a float64
  evaluation of the same formulas; the two differ by up to 2e-5 here);
- ``ssd_chunked``'s leaves within 2e-5 x max|leaf| (dA's within 1e-4,
  for the same reason), the inter-chunk scan adding its own sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ref import ssd_chunk_ref as ref_ssd_chunk_ref
from repro.models.transformer import layers as RL
from repro_torch.kernels.ssd import ops, ref
from repro_torch.models.transformer import layers as L

from _torch_cases import SSD_CASES, ssd_inputs

REL, REL_DA, CHUNKED_REL = 1e-5, 1e-4, 2e-5
NAMES = ("dx", "ddt", "dA", "dB", "dC")
#: cases where the reference's cum falls past -88 within the chunk, so its
#: exp above the diagonal overflows and its vjp's ddt and dA are NaN
REF_NAN = {"q128_p64", "q150_h6"}
#: a 256-position chunk whose decays sum past -100 (cum_last about -200):
#: the reference's vjp is NaN, the port's gradients are finite
OVERFLOW = (1, 256, 2, 16, 16)
CASES = {**SSD_CASES, "decay_overflow": OVERFLOW}


def _inputs(case, seed=0):
    """x, dt, A, B, C and the output gradients dy, dst, fp32 numpy."""
    bc, q, h, p, n = CASES[case]
    rng = np.random.default_rng(seed + 11)
    return (*ssd_inputs(bc, q, h, p, n, seed),
            rng.standard_normal((bc, q, h, p)).astype(np.float32),
            rng.standard_normal((bc, h, p, n)).astype(np.float32))


def _close(got, want, name, rel=REL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    limit = (REL_DA if name == "dA" else rel) * np.abs(want).max()
    assert err <= limit, (name, err, np.abs(want).max())


def _reference_vjp(arrays):
    out, vjp = jax.vjp(ref_ssd_chunk_ref, *map(jnp.asarray, arrays[:5]))
    return [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, arrays[5:])))]


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_bwd_ref_matches_jax_vjp_of_the_reference(case):
    """All five gradients against ``jax.vjp`` of the reference's
    ``ssd_chunk_ref`` (what XLA differentiates when the reference
    trains).  The reference's vjp is finite here but for the two cases
    whose decays overflow above the diagonal (its ddt and dA are NaN
    there, the port's finite); the other three are held there too."""
    arrays = _inputs(case)
    want = _reference_vjp(arrays)
    got = ref.ssd_chunk_bwd_ref(*map(torch.tensor, arrays))
    nan = {n for n, w in zip(NAMES, want) if not np.isfinite(w).all()}
    assert nan == ({"ddt", "dA"} if case in REF_NAN else set())
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert torch.isfinite(g).all()
        if name not in nan:
            _close(g.numpy(), w, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_ref_matches_autograd_of_the_plain_forward(case):
    """All five gradients against ``torch.autograd`` of the port's
    ``ssd_chunk_ref``, which masks before the exp too; in the decay
    overflow case the reference's vjp is NaN and both are finite."""
    arrays = _inputs(case)
    args = [torch.tensor(a) for a in arrays]
    got = ref.ssd_chunk_bwd_ref(*args)
    leaves = [t.clone().requires_grad_() for t in args[:5]]
    want = torch.autograd.grad(ref.ssd_chunk_ref(*leaves), leaves,
                               tuple(args[5:]))
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all() and torch.isfinite(w).all()
        _close(g.numpy(), w.numpy(), name)
    if case == "decay_overflow":
        x, dt, A = arrays[:3]
        assert (np.cumsum(dt * A, axis=1)[:, -1] < -100).all()
        assert not all(np.isfinite(w).all() for w in _reference_vjp(arrays))


@pytest.mark.parametrize("case", ["q37", "h5_p20_n12", "decay_overflow"])
def test_ssd_chunk_function_runs_the_plain_backward_on_cpu(case,
                                                           monkeypatch):
    """``SsdChunk.apply`` on CPU tensors: the plain forward, bit for bit,
    and in the backward one call of the wrapper ``ops.ssd_chunk_bwd``
    (its CPU path, the plain backward); no kernel launches."""
    args = [torch.tensor(a) for a in _inputs(case)]
    calls = []
    real = ops.ssd_chunk_bwd

    def spy(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(ops, "ssd_chunk_bwd", spy)
    ops.reset_launches()
    leaves = [t.clone().requires_grad_() for t in args[:5]]
    y, st = ops.SsdChunk.apply(*leaves)
    assert y.grad_fn is not None and st.grad_fn is not None
    for a, b in zip((y, st), ref.ssd_chunk_ref(*args[:5])):
        assert torch.equal(a.detach(), b)
    got = torch.autograd.grad((y, st), leaves, tuple(args[5:]))
    assert len(calls) == 1
    want = ref.ssd_chunk_bwd_ref(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launch_count("ssd_chunk") == 0
    assert ops.launch_count("ssd_chunk_bwd") == 0


@pytest.mark.parametrize("which", ["state", "output"])
def test_state_only_and_output_only_gradients(which):
    """A loss on the state alone (dy arrives as zeros, as with one chunk,
    where only h_final reads the state) or on y alone (dst as zeros):
    ``SsdChunk``'s gradients equal autograd's of the plain forward."""
    args = [torch.tensor(a) for a in _inputs("q73")]
    weight = args[6] if which == "state" else args[5]

    def loss(outs):
        return (outs[1 if which == "state" else 0] * weight).sum()

    leaves = [t.clone().requires_grad_() for t in args[:5]]
    got = torch.autograd.grad(loss(ops.SsdChunk.apply(*leaves)), leaves)
    plain = [t.clone().requires_grad_() for t in args[:5]]
    want = torch.autograd.grad(loss(ref.ssd_chunk_ref(*plain)), plain,
                               allow_unused=True)   # the state reads no C
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all()
        if w is None:
            assert which == "state" and name == "dC"
            assert not g.any()
        else:
            _close(g.numpy(), w.numpy(), name)


def test_ssd_chunk_function_refuses_bf16_under_grad():
    """fp32 training only: a bf16 step that needs a gradient raises; under
    ``torch.no_grad``, or with nothing that requires grad, it runs."""
    x, dt, A, Bm, Cm = (torch.tensor(a).bfloat16()
                        for a in _inputs("q16")[:5])
    with pytest.raises(NotImplementedError, match="ssd_chunk.*bf16"):
        ops.SsdChunk.apply(x, dt, A, Bm.requires_grad_(), Cm)
    with torch.no_grad():
        y, st = ops.SsdChunk.apply(x, dt, A, Bm, Cm)
    assert y.dtype == st.dtype == torch.bfloat16 and y.grad_fn is None
    Bm.requires_grad_(False)
    y, _ = ops.SsdChunk.apply(x, dt, A, Bm, Cm)
    assert y.grad_fn is None


def test_ssd_chunk_bwd_wrapper_runs_the_plain_version_on_cpu():
    args = [torch.tensor(a) for a in _inputs("q37")]
    got = ops.ssd_chunk_bwd(*args)
    want = ref.ssd_chunk_bwd_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ssd_chunk_bwd_refuses_bad_shapes():
    x, dt, A, Bm, Cm, dy, dst = (torch.tensor(a) for a in _inputs("q16"))
    for args in [(x, dt, A, Bm, Cm, dy[:, :-1], dst),     # dy shorter
                 (x, dt, A, Bm, Cm, dy, dst[..., :-1]),   # dst of another N
                 (x, dt, A, Bm, Cm, dy, dst[:, :1]),      # dst of another H
                 (x, dt[:, :8], A, Bm, Cm, dy, dst),      # dt shorter
                 (x, dt, A, Bm, Cm[..., :4], dy, dst)]:   # C of another N
        with pytest.raises(ValueError):
            ops.ssd_chunk_bwd(*args)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("S,chunk,with_h0", [(37, 8, False), (37, 8, True),
                                             (32, 16, True)])
def test_ssd_chunked_gradients_match_jax_vjp(S, chunk, with_h0, backend):
    """Gradients of ``ssd_chunked`` with respect to x, dt, A, B, C, Dskip
    and h0 for seeded cotangents of (y, h_final), against ``jax.vjp`` of
    the reference's: one chunk (S = 37, which no tile of 64 or more
    divides, so the chunk is all of S) and two chunks of 16, on inputs
    where the reference is finite.  ``backend="cuda"`` on the CPU runs
    ``SsdChunk`` (the plain backward), ``"torch"`` autograd of the plain
    forward."""
    B, H, P, N = 2, 3, 8, 16
    arrays = list(ssd_inputs(B, S, H, P, N, seed=1))
    rng = np.random.default_rng(2)
    arrays.append(np.linspace(0.5, 1.5, H).astype(np.float32))     # Dskip
    arrays.append((0.1 * rng.standard_normal((B, H, P, N))).astype(
        np.float32) if with_h0 else None)
    cot = (rng.standard_normal((B, S, H, P)).astype(np.float32),
           rng.standard_normal((B, H, P, N)).astype(np.float32))
    live = [a is not None for a in arrays]

    def ref_fn(*xs):
        full = iter(xs)
        a = [next(full) if ok else None for ok in live]
        return RL.ssd_chunked(*a[:6], chunk=chunk, h0=a[6])

    _, vjp = jax.vjp(ref_fn, *(jnp.asarray(a) for a in arrays if a is not None))
    want = vjp(tuple(map(jnp.asarray, cot)))
    leaves = [torch.tensor(a).requires_grad_() for a in arrays
              if a is not None]
    full = iter(leaves)
    a = [next(full) if ok else None for ok in live]
    y, h = L.ssd_chunked(*a[:6], chunk=chunk, h0=a[6], backend=backend)
    ops.reset_launches()
    got = torch.autograd.grad((y, h), leaves, tuple(map(torch.tensor, cot)))
    assert ops.launch_count("ssd_chunk_bwd") == 0
    names = ["x", "dt", "A", "B", "C", "Dskip", "h0"]
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all() and torch.isfinite(g).all()
        _close(g.numpy(), w, "dA" if name == "A" else name, CHUNKED_REL)


# -- the backward's launch plan (plain Python; the C side derives the same,
# held equal on the card by tests/test_torch_cuda.py) ----------------------

@pytest.mark.parametrize("shape,want", [
    # mamba2's and zamba2's training folds: P 64, N 128 / 64, G 4
    ((8, 256, 32, 64, 128), (64, 128, 4, (8, 8, 8), 196112)),
    ((8, 256, 80, 64, 64), (64, 64, 4, (20, 8, 8), 163344)),
    # Q = 511 at one chunk: eight tiles, a column and a row block each
    ((4, 511, 32, 64, 128), (64, 128, 4, (8, 4, 16), 196112)),
    # H = 6: a second group of two live heads; P and N below 64 padded
    ((8, 256, 6, 64, 128), (64, 128, 4, (2, 8, 8), 196112)),
    ((4, 256, 8, 32, 16), (64, 64, 4, (2, 4, 8), 163344)),
    # P past 64: padded to 128, two heads a group (the registers of dx)
    ((2, 130, 6, 96, 40), (128, 64, 2, (3, 2, 6), None)),
    ((1, 64, 1, 128, 128), (128, 128, 2, (1, 1, 2), 206352)),
])
def test_bwd_plan_at_the_training_folds_and_edges(shape, want):
    """Widths, G, grid (head groups, chunks, a column and a row block of
    each 64-position tile) and shared memory; the fp32 sizes at the
    training folds are the ones the C side reported on the card."""
    pl = ops.bwd_plan(*shape)
    assert (pl.pw, pl.nw, pl.g, pl.grid) == want[:4]
    if want[4] is not None:
        assert pl.smem == want[4]
    assert pl.smem <= ops.SMEM_MAX


@pytest.mark.parametrize("shape", [(1, 64, 2, 136, 16), (1, 64, 2, 16, 130),
                                   (1, 0, 2, 16, 16), (1, 64, 0, 16, 16)])
def test_bwd_plan_refuses_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError, match="ssd_chunk_bwd"):
        ops.bwd_plan(*shape)
