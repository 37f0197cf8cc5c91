"""The backward of the port's prefill attention on the CPU:
``flash_prefill_bwd_ref`` (the plain version of the ``flash_prefill_bwd``
kernel, written out as formulas) against ``torch.autograd`` of
``flash_prefill_ref`` and against ``jax.vjp`` of the reference's
``blockwise_causal_attention``; ``FlashPrefill`` (the autograd Function
the LM uses) against plain autograd; and the guard that keeps a kernel
without a backward from being differentiated on the card.

Tolerance: each gradient within 1e-5 x max|reference gradient| (fp32
sums in another order; the gradients are O(1) here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import layers as RL
from repro_torch.kernels import _build
from repro_torch.kernels.attention import ops, ref

from _torch_cases import prefill_inputs

REL = 1e-5
# (B, S, K, G, D, window): G 1 and 4, a window or none, D 64 and 80
# (zamba2's), a ragged S that no 64-row tile divides, G = 3
BWD_CASES = {
    "g1_d64": (1, 64, 2, 1, 64, 0),
    "g4_d64": (2, 48, 1, 4, 64, 0),
    "g4_d64_w16": (1, 80, 2, 4, 64, 16),
    "g1_d80": (1, 70, 2, 1, 80, 0),
    "g1_d80_w9": (2, 37, 1, 1, 80, 9),
    "g3_d16_s37": (1, 37, 2, 3, 16, 0),
}


def _inputs(case, seed=0):
    """q, k, v and an output gradient ``do``, fp32 numpy."""
    b, s, k, g, d, _ = BWD_CASES[case]
    q, kk, v = prefill_inputs(b, s, k, g, d, seed)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape)
    return q, kk, v, do.astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_bwd_ref_matches_autograd_of_the_plain_forward(case):
    w = BWD_CASES[case][-1]
    q, k, v, do = (torch.tensor(a) for a in _inputs(case))
    o = ref.flash_prefill_ref(q, k, v, w)
    got = ref.flash_prefill_bwd_ref(q, k, v, o, do, w)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ref.flash_prefill_ref(qa, ka, va, w),
                               (qa, ka, va), do)
    for g, gw in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == gw.shape
        _close(g.numpy(), gw.numpy())


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_bwd_ref_matches_jax_vjp_of_the_reference(case):
    """dq, dk, dv against ``jax.vjp`` of the reference's
    ``blockwise_causal_attention`` (what XLA differentiates when the
    reference trains)."""
    w = BWD_CASES[case][-1]
    arrays = _inputs(case)
    out, vjp = jax.vjp(lambda q, k, v: RL.blockwise_causal_attention(
        q, k, v, sliding_window=w), *map(jnp.asarray, arrays[:3]))
    want = vjp(jnp.asarray(arrays[3]))
    q, k, v, do = (torch.tensor(a) for a in arrays)
    got = ref.flash_prefill_bwd_ref(q, k, v, torch.tensor(np.asarray(out)),
                                    do, w)
    for g, gw in zip(got, want):
        _close(g.numpy(), gw)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_prefill_function_matches_plain_autograd_on_cpu(case):
    """``FlashPrefill.apply`` on CPU tensors: the plain forward, and in
    the backward the wrapper's CPU path (the plain backward); no kernel
    launches."""
    w = BWD_CASES[case][-1]
    q, k, v, do = (torch.tensor(a) for a in _inputs(case))
    ops.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.FlashPrefill.apply(*leaves, w)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), ref.flash_prefill_ref(q, k, v, w))
    got = torch.autograd.grad(out, leaves, do)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_prefill_ref(*plain, w), plain, do)
    for g, gw in zip(got, want):
        _close(g.numpy(), gw.numpy())
    assert ops.launch_count("flash_prefill") == 0
    assert ops.launch_count("flash_prefill_bwd") == 0


def test_flash_prefill_bwd_wrapper_runs_the_plain_version_on_cpu():
    q, k, v, do = (torch.tensor(a) for a in _inputs("g4_d64_w16"))
    o = ops.flash_prefill(q, k, v, sliding_window=16)
    got = ops.flash_prefill_bwd(q, k, v, o, do, sliding_window=16)
    want = ref.flash_prefill_bwd_ref(q, k, v, o, do, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_prefill_bwd_refuses_bad_shapes():
    q, k, v, do = (torch.tensor(a) for a in _inputs("g1_d64"))
    o = ref.flash_prefill_ref(q, k, v)
    bad = [(q, k, v, o[:, :-1], do), (q, k, v, o, do[..., :-8]),
           (q, k[:, :-1], v, o, do), (q[0], k, v, o, do)]
    for args in bad:
        with pytest.raises(ValueError):
            ops.flash_prefill_bwd(*args)
    with pytest.raises(ValueError, match="sliding_window"):
        ops.flash_prefill_bwd(q, k, v, o, do, sliding_window=-1)


def test_flash_prefill_function_refuses_bf16_under_grad():
    """fp32 training only: a bf16 attention that needs a gradient raises,
    naming the roadmap item; without one it runs."""
    q, k, v, _ = (torch.tensor(a).bfloat16() for a in _inputs("g1_d64"))
    with pytest.raises(NotImplementedError, match="item 11"):
        ops.FlashPrefill.apply(q.requires_grad_(), k, v, 0)
    q.requires_grad_(False)
    out = ops.FlashPrefill.apply(q, k, v, 0)
    assert out.dtype == torch.bfloat16 and out.grad_fn is None


@pytest.mark.parametrize("grad_mode", [True, False])
@pytest.mark.parametrize("marked", [0, 1, 2])
def test_refuse_grad_on_cpu_tensors(grad_mode, marked):
    """The guard raises exactly when grad mode is on and an input
    requires grad, naming the kernel and why; ``None`` inputs are
    skipped."""
    ts = [torch.zeros(3), torch.ones(2), None]
    if marked < 2:
        ts[marked].requires_grad_()
    with torch.set_grad_enabled(grad_mode):
        if grad_mode and marked < 2:
            with pytest.raises(NotImplementedError,
                               match="ssd_chunk.*item 11c"):
                _build.refuse_grad("ssd_chunk", "ROADMAP Queue 1, item 11c",
                                   *ts)
        else:
            _build.refuse_grad("ssd_chunk", "ROADMAP Queue 1, item 11c", *ts)
