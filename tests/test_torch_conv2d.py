"""The port's conv kernel module (``repro_torch.kernels.conv2d``) against
the JAX package's Pallas kernel (interpret mode) and its oracle.

On the CPU the wrapper runs the plain PyTorch version, so these tests
hold that version — and the wrapper's shape logic around it — to the
Pallas kernel.  The CUDA kernel itself is held to the plain version in
``tests/test_torch_cuda.py`` (``cuda``-marked, skips without a card).

Tolerance atol = rtol = 1e-5 in fp32: both sides sum the same
KH*KW*CI products of O(1) values in fp32, in different orders, which
moves the result by a few ULP of the O(1)-sized outputs.
"""

import numpy as np
import pytest
import torch

from repro.kernels.conv2d.ops import conv2d_fused as jax_conv2d_fused
from repro.kernels.conv2d.ref import conv2d_fused_ref as jax_conv2d_ref
from repro_torch.kernels._build import split_ranges
from repro_torch.kernels.conv2d import ops, ref

from _torch_cases import (CONV_CASE_PLANS, CONV_CASES, CONV_PLAN_CASES,
                          VGG16_LAUNCHES, conv_inputs)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, device="cpu"):
    return None if a is None else torch.tensor(a, device=device)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_matches_pallas_kernel_and_oracle(case):
    x_shape, w_shape, stride, pool, relu, bias = CONV_CASES[case]
    x, w, b = conv_inputs(x_shape, w_shape, bias)
    kw = dict(stride=stride, relu=relu, pool=pool)
    want_kernel = np.asarray(jax_conv2d_fused(x, w, b, interpret=True, **kw))
    want_ref = np.asarray(jax_conv2d_ref(x, w, b, **kw))
    got_wrapper = ops.conv2d_fused(_t(x), _t(w), _t(b), **kw).numpy()
    got_plain = ref.conv2d_fused_ref(_t(x), _t(w), _t(b), **kw).numpy()
    assert got_wrapper.shape == want_kernel.shape == want_ref.shape
    for got in (got_wrapper, got_plain):
        np.testing.assert_allclose(got, want_kernel, **TOL)
        np.testing.assert_allclose(got, want_ref, **TOL)


@pytest.mark.parametrize("pool", [None, (2, 2)])
def test_input_smaller_than_kernel_gives_empty_output(pool):
    """The JAX wrapper falls back to its oracle here; the port returns
    the same empty shape without a launch."""
    x, w, b = conv_inputs((1, 2, 5, 3), (3, 3, 3, 4), True)
    want = np.asarray(jax_conv2d_fused(x, w, b, pool=pool, interpret=True))
    got = ops.conv2d_fused(_t(x), _t(w), _t(b), pool=pool)
    assert tuple(got.shape) == want.shape
    assert got.numel() == 0


def test_conv2d_is_the_fused_kernel_without_epilogue():
    x, w, _ = conv_inputs((1, 10, 9, 4), (3, 3, 4, 6), False)
    got = ops.conv2d(_t(x), _t(w), stride=2).numpy()
    want = np.asarray(jax_conv2d_ref(x, w, None, stride=(2, 2)))
    np.testing.assert_allclose(got, want, **TOL)


def test_stride_normalization_and_validation():
    assert ops.normalize_stride(2) == (2, 2)
    assert ops.normalize_stride((1, 3)) == (1, 3)
    with pytest.raises(ValueError):
        ops.normalize_stride(0)


def test_wrapper_rejects_bad_shapes_and_devices():
    x, w, b = (torch.zeros(1, 5, 5, 4), torch.zeros(3, 3, 4, 6),
               torch.zeros(6))
    with pytest.raises(ValueError):
        ops.conv2d_fused(x, torch.zeros(3, 3, 5, 6))          # CI differs
    with pytest.raises(ValueError):
        ops.conv2d_fused(x, w, torch.zeros(5))                # bias shape
    with pytest.raises(ValueError):
        ops.conv2d_fused(x[0], w)                             # not 4-d
    with pytest.raises(ValueError):
        ops.conv2d_fused(x, w, b, pool=(0, 2))
    with pytest.raises(ValueError):                           # no kernel
        ops.conv2d_fused(x.to("meta"), w.to("meta"))


def test_kernel_checks_before_a_launch():
    """What the wrapper refuses before it would launch the CUDA kernel
    (checked here on CPU tensors: the checks are device-independent)."""
    x, w, b = (torch.zeros(1, 5, 5, 4), torch.zeros(3, 3, 4, 6),
               torch.zeros(6))
    ops._check_cuda(x, w, b, (2, 2))                          # accepted
    bad = [(x.double(), w.double(), b.double(), None),        # dtype
           (x, w.double(), b, None),                          # mixed dtype
           (x.transpose(1, 2), w, b, None),                   # strided x
           (x, w, b, (9, 9))]                                 # pool > tile
    for args in bad:
        with pytest.raises(ValueError):
            ops._check_cuda(*args)


def test_ctypes_signature_matches_the_c_prototype():
    """ctypes checks only the argument count of a foreign call, and a
    pointer passed as a C int is cut to 32 bits: the wrapper's argtypes
    must follow the ``extern "C"`` prototype in the source, one for one."""
    import ctypes
    import re
    src = ops.SOURCE.read_text()
    proto = re.search(r'extern "C" int conv2d_fused_launch\(([^)]*)\)', src)
    params = [p.strip() for p in proto.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert ops.ARGTYPES == want


def test_plain_version_on_cpu_launches_nothing():
    ops.reset_launches()
    x, w, b = conv_inputs((1, 6, 6, 3), (3, 3, 3, 4), True)
    ops.conv2d_fused(_t(x), _t(w), _t(b), relu=True, pool=(2, 2))
    assert ops.launch_count() == 0


def _plan(x_shape, w_shape, stride=(1, 1), pool=None):
    kh, kw, _, co = w_shape
    return tuple(ops.plan(*x_shape, kh, kw, co, stride, pool))


def _assert_k_ranges_cover_k(k, split):
    """The K ranges the blocks of a cluster walk: ``split`` of them, whole
    BK slices, non-empty, in rank order, together [0, K) once."""
    ranges = [(a * ops.BK, min(k, b * ops.BK))
              for a, b in split_ranges(-(-k // ops.BK), split)]
    assert len(ranges) == split
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    for a, b in ranges:
        assert a < b and a % ops.BK == 0
    assert max(b - a for a, b in ranges) - min(b - a for a, b in ranges) \
        <= ops.BK


@pytest.mark.parametrize("i", range(len(VGG16_LAUNCHES)))
def test_plan_of_each_vgg16_launch(i):
    """The plan of the 15 launches of a single-frame VGG16 runner call:
    the RGB stem through the general variant, 128 x 64 tiles split 1-8
    ways where they give enough blocks, 64 x 64 split 8 ways for the
    14 x 14 layers (32 tiles, K = 4608)."""
    x_shape, w_shape, pool, want = VGG16_LAUNCHES[i]
    assert _plan(x_shape, w_shape, pool=pool) == want
    kh, kw, ci, _ = w_shape
    _assert_k_ranges_cover_k(kh * kw * ci, want[2])


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_plan_of_each_conv_case(case):
    x_shape, w_shape, stride, pool, _, _ = CONV_CASES[case]
    want = CONV_CASE_PLANS[case]
    assert _plan(x_shape, w_shape, stride, pool) == want
    kh, kw, ci, _ = w_shape
    _assert_k_ranges_cover_k(kh * kw * ci, want[2])


@pytest.mark.parametrize("case", sorted(CONV_PLAN_CASES))
def test_plan_of_each_edge_case(case):
    x_shape, w_shape, stride, pool, _, _, want = CONV_PLAN_CASES[case]
    assert _plan(x_shape, w_shape, stride, pool) == want
    kh, kw, ci, _ = w_shape
    _assert_k_ranges_cover_k(kh * kw * ci, want[2])


def test_plan_rules():
    """Misaligned or odd channel counts take the general variant; a split
    never leaves a block fewer than MIN_SPLIT_SLICES slices of K nor
    passes MAX_SPLIT; the pool window always fits the tile."""
    assert _plan((1, 30, 30, 512), (3, 3, 512, 512))[0] == "ring"
    assert ops.plan(1, 30, 30, 512, 3, 3, 512, aligned=False)[0] == \
        "general"
    assert _plan((1, 30, 30, 512), (3, 3, 512, 510))[0] == "general"
    for x_shape, w_shape, pool in [((1, 16, 16, 8), (3, 3, 8, 8), None),
                                   ((1, 9, 9, 4), (1, 1, 4, 4), None),
                                   ((1, 64, 64, 512), (3, 3, 512, 512),
                                    (8, 8)),
                                   ((4, 8, 8, 2048), (3, 3, 2048, 64),
                                    None)]:
        variant, (bm, bn), split = _plan(x_shape, w_shape, pool=pool)
        kh, kw, ci, _ = w_shape
        slices = -(-kh * kw * ci // ops.BK)
        assert 1 <= split <= ops.MAX_SPLIT
        assert split == 1 or slices >= split * ops.MIN_SPLIT_SLICES
        assert (bm, bn) in ops.TILES
        assert (pool or (1, 1))[0] * (pool or (1, 1))[1] <= bm


def test_variant_counts_stay_at_zero_on_cpu():
    ops.reset_launches()
    x, w, b = conv_inputs((1, 6, 6, 4), (3, 3, 4, 4), True)
    ops.conv2d_fused(_t(x), _t(w), _t(b))
    assert ops.variant_counts == dict.fromkeys(ops.VARIANTS, 0)
