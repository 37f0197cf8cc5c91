"""The backward of the port's grouped expert GEMM on the CPU: ``MoeGemm``
(the autograd Function the ``moe`` layer uses) against ``jax.vjp`` of the
reference's ``moe_gemm_ref`` (the einsum the Pallas kernel computes); the
two wrapper calls its backward makes, on transposed operands; the bf16
refusal; and the ``moe`` layer's gradients against ``jax.grad`` of the
reference's, on both backends, with and without dropped assignments.

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
    """The shapes of every ``ops.moe_gemm`` call, in order (the backward
    looks the wrapper up in its module, so it goes through the spy)."""
    calls = []
    real = ops.moe_gemm

    def moe_gemm(x, w):
        calls.append((tuple(x.shape), tuple(w.shape),
                      x.is_contiguous() and w.is_contiguous()))
        return real(x, w)

    monkeypatch.setattr(ops, "moe_gemm", moe_gemm)
    return calls


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


@pytest.mark.parametrize("needs", [("x", "w"), ("x",), ("w",)],
                         ids=["x_and_w", "x", "w"])
def test_backward_is_two_wrapper_calls_on_transposed_operands(needs, spy):
    """The backward calls the wrapper once for each input that needs a
    gradient: dx = moe_gemm(dy, wᵀ) with dy (E, C, F) and wᵀ (E, F, D),
    dw = moe_gemm(xᵀ, dy) with xᵀ (E, D, C); the transposes are
    contiguous.  Each gradient equals that call made directly."""
    e, c, d, f = MOE_GEMM_CASES["d36_c20"]
    x, w = map(torch.tensor, moe_gemm_inputs(e, c, d, f))
    dy = torch.tensor(_dy(e, c, f))
    xt = x.clone().requires_grad_("x" in needs)
    wt = w.clone().requires_grad_("w" in needs)
    y = ops.MoeGemm.apply(xt, wt)
    assert spy == [((e, c, d), (e, d, f), True)]
    spy.clear()
    want = {"x": ((e, c, f), (e, f, d), True),
            "w": ((e, d, c), (e, c, f), True)}
    y.backward(dy)
    assert spy == [want[n] for n in needs]
    if "x" in needs:
        assert torch.equal(xt.grad, ref.moe_gemm_ref(
            dy, w.transpose(1, 2).contiguous()))
    else:
        assert xt.grad is None
    if "w" in needs:
        assert torch.equal(wt.grad, ref.moe_gemm_ref(
            x.transpose(1, 2).contiguous(), dy))
    else:
        assert wt.grad is None


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
    the CPU its plain version): 3 wrapper calls forward, 6 backward;
    ``"torch"`` calls none."""
    arrays = _moe_inputs(skew)
    rng = np.random.default_rng(7)
    cot = rng.standard_normal(arrays[0].shape).astype(np.float32)
    want = _ref_layer_grads([*arrays, cot], top_k)
    leaves = [torch.tensor(a).requires_grad_() for a in arrays]
    out, aux = L.moe(L.MoeParams(*leaves[1:]), leaves[0], top_k,
                     backend=backend)
    assert len(spy) == (3 if backend == "cuda" else 0)
    got = torch.autograd.grad((out * torch.tensor(cot)).sum() + aux, leaves)
    assert len(spy) == (9 if backend == "cuda" else 0)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), w, LAYER_REL)
