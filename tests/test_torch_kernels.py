"""The port's depthwise 5x5 kernels: the plain PyTorch version against the
JAX package's Pallas kernels (interpret mode on the CPU), and the wrappers'
routing and checks.  The CUDA kernel itself is held against the plain
version in ``tests/test_torch_cuda.py``, on a card.

Tolerance: atol 2e-5, as in ``tests/test_kernels.py`` (fp32 sums of 25
products in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch.kernels import depthwise as tdw
from nvae_tpu.kernels.depthwise import depthwise_conv5x5, fused_swish_depthwise5x5

ATOL = 2e-5
SHAPES = [(2, 4, 4, 256), (2, 8, 8, 128), (2, 16, 16, 192)]


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(5, 5, 1, c) * 0.1).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fuse_swish", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_fused_matches_pallas(shape, fuse_swish, with_bias):
    x, k, b = _inputs(shape)
    want = fused_swish_depthwise5x5(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b) if with_bias else None,
        fuse_swish=fuse_swish, interpret=True,
    )
    got = tdw.fused_swish_depthwise5x5_plain(
        torch.from_numpy(x), torch.from_numpy(k),
        torch.from_numpy(b) if with_bias else None, fuse_swish=fuse_swish,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_thin_entry_matches_pallas_dw_kernel(shape):
    x, k, _ = _inputs(shape, seed=1)
    # c_block 64 divides every test width (the Pallas kernel asserts it).
    want = depthwise_conv5x5(jnp.asarray(x), jnp.asarray(k), interpret=True,
                             c_block=64)
    before = tdw.depthwise_conv5x5.launches
    got = tdw.depthwise_conv5x5(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert tdw.depthwise_conv5x5.launches == before  # CPU: plain version


def test_cpu_tensor_takes_plain_version_without_counting():
    x, k, b = _inputs((2, 4, 4, 64))
    xt, kt, bt = map(torch.from_numpy, (x, k, b))
    before = tdw.fused_swish_depthwise5x5.launches
    got = tdw.fused_swish_depthwise5x5(xt, kt, bt)
    want = tdw.fused_swish_depthwise5x5_plain(xt, kt, bt)
    assert torch.equal(got, want)
    assert tdw.fused_swish_depthwise5x5.launches == before


def test_non_cpu_tensor_never_falls_back():
    """Anything not on the CPU goes to the kernel path, which raises for a
    device it cannot launch on instead of running the plain version."""
    x = torch.empty(2, 4, 4, 32, device="meta")
    k = torch.empty(5, 5, 1, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdw.fused_swish_depthwise5x5(x, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdw.depthwise_conv5x5(x, k)


@pytest.mark.parametrize("case,exc,match", [
    ("kernel_shape", ValueError, "kernel must be"),
    ("bias_shape", ValueError, "bias must be"),
    ("dtype", TypeError, "float32"),
    ("strided_x", ValueError, "contiguous"),
    ("plane", ValueError, "shared memory"),
])
def test_wrapper_checks(case, exc, match):
    x = torch.zeros(2, 8, 8, 32)
    k = torch.zeros(5, 5, 1, 32)
    b = None
    if case == "kernel_shape":
        k = torch.zeros(3, 3, 1, 32)
    elif case == "bias_shape":
        b = torch.zeros(16)
    elif case == "dtype":
        x = x.double()
    elif case == "strided_x":
        x = torch.zeros(2, 32, 8, 8).permute(0, 2, 3, 1)
    elif case == "plane":
        x = torch.zeros(1, 8, 512, 32)
    with pytest.raises(exc, match=match):
        tdw._check(x, k, b)


def test_path_shapes_fit_one_block():
    """Every shape of the sampling path fits the kernel's shared memory."""
    for h, c in ((4, 1536), (8, 768), (16, 384), (32, 192)):
        tdw._check(torch.empty(1, h, h, c, device="meta"),
                   torch.empty(5, 5, 1, c, device="meta"), None)
