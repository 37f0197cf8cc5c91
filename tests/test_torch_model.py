"""The port's CNN zoo and layer backends against the JAX package's.

Every zoo builder must emit the same graph, and ``forward`` with the
reference's parameters (carried over by ``params_from_numpy``) must give
the reference's outputs, on both backends.

Tolerance rtol = 1e-4, atol = 1e-5: outputs pass through up to ~50
fp32 layers whose sums run in different orders in XLA and PyTorch, so
per-layer ULP differences compound; 1e-4 relative is still ~1000x
below any layer-semantics error (a wrong pad or flatten order moves
outputs by O(1)).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api.artifacts import model_to_dict
from repro.core.graph import LayerSpec
from repro.exec.backends import apply_layer as ref_apply_layer
from repro.models.cnn import zoo as ref_zoo
from repro_torch.exec.backends import apply_layer, get_backend
from repro_torch.models.cnn import params_from_numpy, zoo

from _torch_cases import ZOO_TINY, image, np_params

TOL = dict(rtol=1e-4, atol=1e-5)

BACKENDS = {"xla": "torch", "pallas": "cuda"}   # reference -> port


@pytest.mark.parametrize("name", sorted(ZOO_TINY))
def test_zoo_graphs_identical(name):
    ref = ref_zoo.build(name, **ZOO_TINY[name])
    port = zoo.build(name, **ZOO_TINY[name])
    assert model_to_dict(port) == model_to_dict(ref)
    assert [dataclasses.astuple(port.graph.layers[n]) for n in port.graph.layers] \
        == [dataclasses.astuple(ref.graph.layers[n]) for n in ref.graph.layers]
    assert set(port.graph.edges) == set(ref.graph.edges)
    assert port.full_sizes == ref.full_sizes


def test_full_width_vgg16_graph_identical():
    ref = ref_zoo.vgg16(input_size=(224, 224), scale=1.0, head=True)
    port = zoo.vgg16(input_size=(224, 224), scale=1.0, head=True)
    assert model_to_dict(port) == model_to_dict(ref)
    kinds = [s.kind for s in port.graph.layers.values()]
    assert (kinds.count("conv"), kinds.count("pool"), kinds.count("fc")) \
        == (13, 5, 2)


@pytest.mark.parametrize("name,backend", [(n, "xla") for n in sorted(ZOO_TINY)]
                         + [("vgg16", "pallas"), ("resnet34", "pallas")])
def test_forward_matches_reference(name, backend):
    """Reference params through numpy; the reference's forward on its
    backend vs the port's on the counterpart (Pallas in interpret mode,
    the port's ``cuda`` backend as its plain version on the CPU)."""
    ref = ref_zoo.build(name, **ZOO_TINY[name])
    port = zoo.build(name, **ZOO_TINY[name])
    p_ref = np_params(ref)
    p_port = params_from_numpy(p_ref, device="cpu")
    x = image(ref)
    want = ref.forward(p_ref, x, backend=backend)
    got = port.forward(p_port, torch.tensor(x), backend=BACKENDS[backend])
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_init_shapes_scales_and_seed():
    ref = ref_zoo.vgg16(input_size=(40, 40), scale=0.25, head=True)
    port = zoo.vgg16(input_size=(40, 40), scale=0.25, head=True)
    p_ref = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    p_port = port.init(torch.Generator().manual_seed(0), device="cpu")
    assert p_port.keys() == p_ref.keys()
    for n, spec in port.graph.layers.items():
        if n not in p_port:
            continue
        for k in ("w", "b"):
            assert tuple(p_port[n][k].shape) == p_ref[n][k].shape
            assert p_port[n][k].dtype == torch.float32
        assert not p_port[n]["b"].any()
        fan_in = (spec.kernel[0] * spec.kernel[1] * spec.in_channels
                  if spec.kind == "conv" else spec.in_channels)
        std = p_port[n]["w"].std().item() * np.sqrt(fan_in)
        assert 0.8 < std < 1.2, (n, std)
    again = port.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(again[n]["w"], p_port[n]["w"]) for n in p_port)


def test_params_from_numpy_keeps_layout():
    p = {"conv1": {"w": np.arange(24, dtype=np.float32).reshape(1, 2, 3, 4),
                   "b": np.zeros(4, np.float32)}}
    t = params_from_numpy(p, device="cpu")
    assert tuple(t["conv1"]["w"].shape) == (1, 2, 3, 4)
    assert t["conv1"]["w"].is_contiguous()
    np.testing.assert_array_equal(t["conv1"]["w"].numpy(), p["conv1"]["w"])


# ---------------------------------------------------------------------------
# the three layout traps of the layer backends
# ---------------------------------------------------------------------------

def _spec(kind, k=(3, 3), s=(1, 1), p=(0, 0), cin=4, cout=4):
    """The reference's LayerSpec; the port's has the same fields."""
    return LayerSpec("l", kind, k, s, p, cin, cout)


@pytest.mark.parametrize("pad_w", [(0, 0), (1, 0), (0, 1), (2, 1)])
def test_pool_pads_with_minus_inf_then_valid_window(pad_w):
    """All-negative input: zero padding would win the max at the border,
    -inf padding never does."""
    x = -1.0 - np.random.default_rng(0).random((1, 7, 6, 4)).astype(
        np.float32)
    spec = _spec("pool", k=(3, 3), s=(2, 2), p=(1, 1))
    want = np.asarray(ref_apply_layer(spec, None, x, True, pad_w))
    got = apply_layer(spec, None, torch.tensor(x), True, pad_w).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got < 0).all()


def test_fc_flattens_in_nhwc_order():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 2, 3, 5)).astype(np.float32)
    p = {"w": rng.standard_normal((30, 7)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    spec = _spec("fc", k=(1, 1), cin=30, cout=7)
    want = np.asarray(ref_apply_layer(spec, p, x, True))
    got = apply_layer(spec, params_from_numpy({"l": p}, "cpu")["l"],
                      torch.tensor(x), True).numpy()
    assert got.shape == want.shape == (2, 1, 1, 7)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("pad_w", [(1, 0), (0, 1), (1, 1)])
def test_conv_tile_pads_w_asymmetrically_and_h_fully(pad_w, backend):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 6, 5, 4)).astype(np.float32)
    p = {"w": rng.standard_normal((3, 3, 4, 6)).astype(np.float32) / 6,
         "b": rng.standard_normal(6).astype(np.float32)}
    spec = _spec("conv", p=(1, 1), cout=6)
    want = np.asarray(ref_apply_layer(spec, p, x, True, pad_w,
                                      backend=backend))
    got = apply_layer(spec, params_from_numpy({"l": p}, "cpu")["l"],
                      torch.tensor(x), True, pad_w,
                      backend=BACKENDS[backend]).numpy()
    assert got.shape == want.shape == (1, 6, 5 + sum(pad_w) - 2, 6)
    np.testing.assert_allclose(got, want, **TOL)


def test_reference_backend_names_are_refused_with_the_mapping():
    with pytest.raises(ValueError, match="'cuda'"):
        get_backend("pallas")
