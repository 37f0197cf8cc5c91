"""The backward of the port's grouped expert GEMM on the CPU: ``MoeGemm``
(the autograd Function the ``moe`` layer uses) and the plain versions of
its two products (``moe_gemm_nt_ref``, ``moe_gemm_tn_ref``) against
``jax.vjp`` of the reference's ``moe_gemm_ref`` (the einsum the Pallas
kernel computes); the wrapper calls its backward makes (``moe_gemm_nt``
and ``moe_gemm_tn`` on x, w and dy as saved, no transposed copies); the
backward kernel's plans (``ops.bwd_plan``); the bf16 refusal; and the
``moe`` layer's gradients against ``jax.grad`` of the reference's, on
both backends, with and without dropped assignments.

Tolerances (fp32 sums in another order than XLA's):
- dx and dw within 1e-5 x max|reference gradient| (worst seen 8.7e-7);
- the layer's gradients (x, router, w1, w3, w2) within 2e-5 x
  max|reference gradient| of each (worst seen 3.4e-7): the expert
  products, the k-way combine and the softmax's backward each sum in
  another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm.ref import moe_gemm_ref as ref_moe_gemm_ref
from repro.models.transformer import layers as RL
from repro_torch.kernels.moe_gemm import ops, ref
from repro_torch.models.transformer import layers as L

from _torch_cases import MOE_GEMM_CASES, moe_gemm_inputs
from test_torch_moe import _moe_inputs

REL = 1e-5
LAYER_REL = 2e-5


def _dy(e, c, f, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((e, c, f)).astype(np.float32)


def _close(got, want, rel=REL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max(initial=0.0)
    assert err <= rel * np.abs(want).max(initial=0.0), \
        (err, np.abs(want).max(initial=0.0))


@pytest.fixture
def spy(monkeypatch):
    """Every call of the three wrappers, in order, as (name, a, b): the
    forward's ``ops.moe_gemm`` and the backward's ``ops.moe_gemm_nt`` and
    ``ops.moe_gemm_tn`` (``MoeGemm`` looks them up in their module, so
    they go through the spy)."""
    calls = []

    def wrap(name):
        real = getattr(ops, name)

        def call(a, b):
            calls.append((name, a, b))
            return real(a, b)
        monkeypatch.setattr(ops, name, call)

    for name in ("moe_gemm", "moe_gemm_nt", "moe_gemm_tn"):
        wrap(name)
    return calls


def _names(calls):
    return [name for name, _, _ in calls]


def _same(a, b):
    """``a`` is ``b`` as a tensor: the same storage, offset, shape and
    strides (no copy, no transposed view)."""
    return (a.data_ptr(), a.shape, a.stride()) == \
        (b.data_ptr(), b.shape, b.stride())


@pytest.mark.parametrize("case", sorted(MOE_GEMM_CASES))
def test_moe_gemm_function_matches_jax_vjp_of_the_reference(case):
    """dx and dw of ``MoeGemm.apply`` on CPU tensors (the wrapper's plain
    version, twice in the backward) against ``jax.vjp`` of the
    reference's ``moe_gemm_ref``; no kernel launches."""
    e, c, d, f = MOE_GEMM_CASES[case]
    x, w = moe_gemm_inputs(e, c, d, f)
    dy = _dy(e, c, f)
    out, vjp = jax.vjp(ref_moe_gemm_ref, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    ops.reset_launches()
    xt, wt = (torch.tensor(a).requires_grad_() for a in (x, w))
    y = ops.MoeGemm.apply(xt, wt)
    assert y.grad_fn is not None
    _close(y.detach().numpy(), out)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.tensor(dy))
    assert dx.shape == (e, c, d) and dw.shape == (e, d, f)
    assert dx.dtype == dw.dtype == torch.float32
    _close(dx.numpy(), want_dx)
    _close(dw.numpy(), want_dw)
    assert ops.launch_count("moe_gemm") == 0
    assert ops.launch_count("moe_gemm_bwd") == 0


@pytest.mark.parametrize("case", sorted(MOE_GEMM_CASES))
def test_backward_plain_versions_match_jax_vjp_of_the_reference(case):
    """``moe_gemm_nt_ref(dy, w)`` (dx) and ``moe_gemm_tn_ref(x, dy)`` (dw),
    the einsums the kernel is held to, against ``jax.vjp`` of the
    reference's ``moe_gemm_ref``, each on the tensors as given."""
    e, c, d, f = MOE_GEMM_CASES[case]
    x, w = moe_gemm_inputs(e, c, d, f)
    dy = _dy(e, c, f)
    _, vjp = jax.vjp(ref_moe_gemm_ref, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    xt, wt, dyt = map(torch.tensor, (x, w, dy))
    dx, dw = ref.moe_gemm_nt_ref(dyt, wt), ref.moe_gemm_tn_ref(xt, dyt)
    assert dx.shape == (e, c, d) and dw.shape == (e, d, f)
    assert dx.dtype == dw.dtype == torch.float32
    _close(dx.numpy(), want_dx)
    _close(dw.numpy(), want_dw)


@pytest.mark.parametrize("needs", [("x", "w"), ("x",), ("w",)],
                         ids=["x_and_w", "x", "w"])
def test_backward_is_two_wrapper_calls_on_transposed_operands(needs, spy):
    """The backward calls one wrapper for each input that needs a
    gradient, on x, w and dy as saved: dx = moe_gemm_nt(dy, w), dy wᵀ,
    and dw = moe_gemm_tn(x, dy), xᵀ dy; each operand is the tensor
    itself (its storage, shape and strides), so no contiguous transposed
    copy is made.  Each gradient equals that call made directly."""
    e, c, d, f = MOE_GEMM_CASES["d36_c20"]
    x, w = map(torch.tensor, moe_gemm_inputs(e, c, d, f))
    dy = torch.tensor(_dy(e, c, f))
    xt = x.clone().requires_grad_("x" in needs)
    wt = w.clone().requires_grad_("w" in needs)
    y = ops.MoeGemm.apply(xt, wt)
    assert _names(spy) == ["moe_gemm"]
    spy.clear()
    y.backward(dy)
    want = {"x": ("moe_gemm_nt", dy, wt), "w": ("moe_gemm_tn", xt, dy)}
    assert _names(spy) == [want[n][0] for n in needs]
    for (_, a, b), n in zip(spy, needs):
        assert _same(a, want[n][1]) and _same(b, want[n][2])
    if "x" in needs:
        assert torch.equal(xt.grad, ops.moe_gemm_nt(dy, w))
    else:
        assert xt.grad is None
    if "w" in needs:
        assert torch.equal(wt.grad, ops.moe_gemm_tn(x, dy))
    else:
        assert wt.grad is None


# (layout, e, m, n, k, aligned) -> (rows, vec): dx and dw of granite's
# training products and of mixtral's experts at C 64 (dx's 64-row tile),
# C 12 and 4, then rows that are not multiples of 4 (4-byte loads), a
# pointer off 16 bytes, and m at the 64-row edge
BWD_PLANS = {
    "granite_dx": (("nt", 40, 512, 1536, 512, True), (128, True)),
    "granite_dw": (("tn", 40, 1536, 512, 512, True), (128, True)),
    "mixtral_dx": (("nt", 8, 64, 4096, 14336, True), (64, True)),
    "mixtral_dw": (("tn", 8, 4096, 14336, 64, True), (128, True)),
    "c12_dx": (("nt", 4, 12, 1024, 256, True), (64, True)),
    "c10_dw": (("tn", 4, 1024, 256, 10, True), (128, True)),
    "c4_dw": (("tn", 40, 1536, 512, 4, True), (128, True)),
    "d30_f12_dx": (("nt", 2, 24, 30, 12, True), (64, False)),
    "d30_f12_dw": (("tn", 2, 30, 12, 24, True), (64, False)),
    "nt_k_odd": (("nt", 2, 200, 64, 13, True), (128, False)),
    "tn_m_odd": (("tn", 2, 13, 64, 200, True), (64, False)),
    "tn_n_odd": (("tn", 2, 200, 66, 8, True), (128, False)),
    "unaligned": (("nt", 40, 512, 1536, 512, False), (128, False)),
    "m64": (("tn", 3, 64, 64, 64, True), (64, True)),
    "m68": (("tn", 3, 68, 64, 64, True), (128, True)),
}


@pytest.mark.parametrize("case", sorted(BWD_PLANS))
def test_bwd_plan_takes_its_tile_and_loads_from_the_shape(case):
    """``ops.bwd_plan``: a 64-row tile where the output has at most 64
    rows, else 128; 16-byte loads only where a's, b's and out's rows are
    multiples of 4 and the pointers aligned; its count key."""
    args, (rows, vec) = BWD_PLANS[case]
    plan = ops.bwd_plan(*args)
    assert (plan.layout, plan.rows, plan.vec) == (args[0], rows, vec)
    assert plan.name in ops.bwd_plan_counts
    assert plan.name == f"{args[0]}{rows}" + ("" if vec else "_b4")


@pytest.mark.parametrize("args", [
    ("nt", 65536, 4, 4, 4), ("tn", 1, 65535 * 128 + 1, 4, 4),
    ("nt", 1, 65535 * 128 + 1, 4, 4), ("tm", 1, 4, 4, 4)],
    ids=["experts", "tn_row_tiles", "nt_row_tiles", "layout"])
def test_bwd_plan_refuses_what_the_grid_does_not_take(args):
    """Past 65535 experts or 65535 row tiles (the grid's y and z), and a
    layout that is not ``nt`` or ``tn``: ``ValueError``, as the C side
    refuses them; the largest that fit plan."""
    with pytest.raises(ValueError, match="moe_gemm_bwd"):
        ops.bwd_plan(*args)
    assert ops.bwd_plan("nt", 65535, 128 * 65535, 4, 4).rows == 128
    assert ops.bwd_plan("tn", 1, 128 * 65535, 4, 4).rows == 128


def test_backward_wrappers_check_their_shapes():
    """The wrappers refuse operands whose shapes do not meet, on the CPU
    too, and their CPU route is the plain version."""
    a, b = torch.ones(2, 3, 4), torch.ones(2, 5, 4)
    assert torch.equal(ops.moe_gemm_nt(a, b), ref.moe_gemm_nt_ref(a, b))
    with pytest.raises(ValueError, match="moe_gemm_nt"):
        ops.moe_gemm_nt(a, torch.ones(2, 5, 3))
    with pytest.raises(ValueError, match="moe_gemm_tn"):
        ops.moe_gemm_tn(a, b)
    with pytest.raises(ValueError, match="moe_gemm_tn"):
        ops.moe_gemm_tn(a, torch.ones(3, 3, 4))


def test_moe_gemm_function_refuses_bf16_under_grad():
    """fp32 training only: a bf16 product that needs a gradient raises;
    without one it runs, as the plain wrapper does."""
    x, w = (torch.tensor(a).bfloat16()
            for a in moe_gemm_inputs(*MOE_GEMM_CASES["e4"]))
    for marked in (x, w):
        marked.requires_grad_()
        with pytest.raises(NotImplementedError, match="moe_gemm.*bf16"):
            ops.MoeGemm.apply(x, w)
        marked.requires_grad_(False)
    y = ops.MoeGemm.apply(x, w)
    assert y.dtype == torch.bfloat16 and y.grad_fn is None
    assert torch.equal(y, ops.moe_gemm(x, w))
    with torch.no_grad():
        y = ops.MoeGemm.apply(x.requires_grad_(), w)
    assert y.dtype == torch.bfloat16 and y.grad_fn is None


def _ref_layer_grads(arrays, top_k):
    """jax.grad of sum(out * cot) + aux of the reference's ``moe`` with
    respect to x, router, w1, w3 and w2."""
    x, router, w1, w3, w2, cot = map(jnp.asarray, arrays)

    def loss(x, router, w1, w3, w2):
        out, aux = RL.moe(RL.MoeParams(router, w1, w3, w2), x, top_k)
        return jnp.sum(out * cot) + aux

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(x, router, w1, w3, w2)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("skew,top_k", [(0.0, 2), (0.0, 3), (6.0, 2)])
def test_moe_layer_gradients_match_jax_grad(skew, top_k, backend, spy):
    """The layer's gradients with respect to x, router, w1, w3 and w2
    against the reference's, with the skew that drops assignments.
    ``backend="cuda"`` runs the three products through ``MoeGemm`` (on
    the CPU its plain versions): 3 ``moe_gemm`` calls forward, then 3
    ``moe_gemm_nt`` and 3 ``moe_gemm_tn`` backward; ``"torch"`` calls
    none."""
    arrays = _moe_inputs(skew)
    rng = np.random.default_rng(7)
    cot = rng.standard_normal(arrays[0].shape).astype(np.float32)
    want = _ref_layer_grads([*arrays, cot], top_k)
    leaves = [torch.tensor(a).requires_grad_() for a in arrays]
    out, aux = L.moe(L.MoeParams(*leaves[1:]), leaves[0], top_k,
                     backend=backend)
    assert _names(spy) == (["moe_gemm"] * 3 if backend == "cuda" else [])
    got = torch.autograd.grad((out * torch.tensor(cot)).sum() + aux, leaves)
    names = sorted(_names(spy))
    assert names == (["moe_gemm"] * 3 + ["moe_gemm_nt"] * 3
                     + ["moe_gemm_tn"] * 3 if backend == "cuda" else [])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), w, LAYER_REL)
