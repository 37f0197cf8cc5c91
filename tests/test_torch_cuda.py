"""The port's CUDA kernel on the card, held to its plain version.

Every test here is marked ``cuda`` and skips where there is no card.
The file imports neither ``jax`` nor ``repro``, so it runs on the GPU
machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import make_pi_cluster
from repro_torch.kernels.conv2d import ops, ref
from repro_torch.models.cnn import params_from_numpy, zoo

from _torch_cases import CONV_CASES, conv_inputs, image, np_params


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, device):
    return None if a is None else torch.tensor(a, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_kernel_matches_plain_version(case, cuda):
    """fp32 kernel vs the plain version on the card: 1e-4 x max(1,
    max|ref|), for sums taken in another order than cuBLAS's."""
    x_shape, w_shape, stride, pool, relu, bias = CONV_CASES[case]
    x, w, b = (_t(a, cuda) for a in conv_inputs(x_shape, w_shape, bias))
    kw = dict(stride=stride, relu=relu, pool=pool)
    before = ops.launch_count()
    got = ops.conv2d_fused(x, w, b, **kw)
    torch.cuda.synchronize()
    assert ops.launch_count() == before + 1
    want = ref.conv2d_fused_ref(x, w, b, **kw)
    assert got.shape == want.shape
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_bf16_and_empty_output(cuda):
    x, w, b = (_t(a, cuda).bfloat16()
               for a in conv_inputs((1, 18, 18, 40), (3, 3, 40, 72), True))
    got = ops.conv2d_fused(x, w, b, relu=True, pool=(2, 2))
    want = ref.conv2d_fused_ref(x, w, b, relu=True, pool=(2, 2))
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item()
    before = ops.launch_count()
    empty = ops.conv2d_fused(x[:, :2].contiguous(), w, b)
    assert tuple(empty.shape) == (1, 0, 16, 72)
    assert ops.launch_count() == before


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    w = torch.zeros(3, 3, 4, 6, device=cuda)
    for args, kw in [((x.double(), w.double()), {}),
                     ((x.transpose(1, 2), w), {}),
                     ((x, w.cpu()), {}),
                     ((x, w), {"pool": (9, 9)})]:
        with pytest.raises(ValueError):
            ops.conv2d_fused(*args, **kw)


@pytest.mark.cuda
def test_deployment_runs_through_the_kernel(cuda):
    """Tiny VGG16 with its head on a 4-Pi plan: the ``cuda`` deployment
    launches the kernel and agrees with the same deployment on the CPU
    (plain version) to rtol 1e-4 / atol 1e-5."""
    m = zoo.vgg16(input_size=(40, 40), scale=0.1, head=True)
    p = np_params(m)
    cluster = make_pi_cluster([1.5, 1.2, 1.0, 0.8])
    dep = repro_torch.compile(m, cluster, params=params_from_numpy(p, cuda))
    x = image(m)
    ops.reset_launches()
    got = dep.run(x)
    assert ops.launch_count() > 0
    want = repro_torch.compile(m, cluster, params=params_from_numpy(p, "cpu"),
                               device="cpu").run(x)
    for k in want:
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5)
