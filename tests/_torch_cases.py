"""Shared inputs of the port's tests (``tests/test_torch_*.py``), made with
numpy from a seed so that both packages get the same numbers.  Imports
neither ``jax`` nor ``torch``: the ``cuda``-marked tests run on a
machine without JAX."""

import numpy as np

# the JAX package's tiny zoo sizes (tests/test_exec_equivalence.py)
ZOO_TINY = {
    "vgg16": dict(input_size=(40, 40), scale=0.1, head=False),
    "yolov2": dict(input_size=(64, 64), scale=0.05),
    "resnet34": dict(input_size=(64, 64), scale=0.1),
    "inceptionv3": dict(input_size=(96, 96), scale=0.1),
    "squeezenet": dict(input_size=(64, 64), scale=0.1),
    "mobilenetv3": dict(input_size=(64, 64), scale=0.1),
    "nasnet": dict(n_cells=2, input_size=(48, 48), scale=0.15),
}

# conv kernel cases: (x shape, w shape, stride, pool, relu, bias)
CONV_CASES = {
    "plain": ((2, 9, 11, 8), (3, 3, 8, 16), (1, 1), None, False, False),
    "stride2_tail": ((1, 12, 12, 5), (3, 3, 5, 7), (2, 2), None, True, True),
    "stride1x2": ((1, 13, 11, 6), (3, 3, 6, 9), (1, 2), None, False, True),
    "k1x7": ((1, 9, 15, 8), (1, 7, 8, 12), (1, 1), None, True, True),
    "k7x1": ((1, 15, 9, 8), (7, 1, 8, 12), (1, 1), None, True, True),
    "stem7x7s2": ((1, 20, 20, 3), (7, 7, 3, 16), (2, 2), None, True, True),
    "pool_odd": ((2, 13, 13, 5), (3, 3, 5, 7), (1, 1), (2, 2), True, True),
    "stride2_pool_odd": ((1, 17, 15, 8), (3, 3, 8, 8), (2, 2), (2, 2), True,
                         False),
    "tail_pool3": ((1, 14, 16, 13), (3, 3, 13, 70), (1, 1), (3, 3), False,
                   True),
}


def conv_inputs(x_shape, w_shape, bias, seed=0):
    """x, w (scaled by 1/sqrt(fan_in)) and an optional bias, fp32."""
    rng = np.random.default_rng(seed)
    kh, kw, ci, co = w_shape
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal(w_shape) / np.sqrt(kh * kw * ci)).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(co)).astype(np.float32) if bias else None
    return x, w, b


def np_params(m, seed=0):
    """Reference-layout weights ``{layer: {"w", "b"}}`` for either
    package's model ``m``: the JAX init's shapes and scales, plus a
    nonzero bias."""
    rng = np.random.default_rng(seed)
    params = {}
    for n, spec in m.graph.layers.items():
        if spec.kind == "conv":
            shape = (spec.kernel[1], spec.kernel[0], spec.in_channels,
                     spec.out_channels)
        elif spec.kind == "fc":
            shape = (spec.in_channels, spec.out_channels)
        else:
            continue
        fan_in = int(np.prod(shape[:-1]))
        params[n] = {
            "w": (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32),
            "b": (0.1 * rng.standard_normal(spec.out_channels)).astype(
                np.float32)}
    return params


def image(m, seed=1, n=1):
    """An (n, H, W, C) fp32 input for model ``m``."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, m.input_size[1], m.input_size[0], m.in_channels)
    ).astype(np.float32)
