"""The port's depthwise 5x5 kernels: the plain PyTorch versions against the
JAX package's Pallas kernels (interpret mode on the CPU), and the wrappers'
routing and checks.  The CUDA kernels themselves are held against the plain
versions in ``tests/test_torch_cuda.py``, on a card.

Tolerances: the forward at atol 2e-5, as in ``tests/test_kernels.py`` (fp32
sums of 25 products in another order); the gradients of the autograd
Function (dx, dW, db) against ``jax.vjp`` of the Pallas op at atol 3e-5
after dividing by the largest |JAX gradient|, as ``tests/test_kernels.py``
does (dW and db sum B*H*W products).
"""

import jax
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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fuse_swish", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_function_backward_matches_pallas_vjp(shape, fuse_swish, with_bias):
    """The Function's CPU backward (the plain dx and dW/db formulas) against
    the Pallas op's custom VJP under the same ``dy``."""
    x, k, b = _inputs(shape, seed=2)
    dy = np.random.RandomState(7).randn(*shape).astype(np.float32)
    args = (x, k, b) if with_bias else (x, k)

    def pallas(x_, k_, *b_):
        return fused_swish_depthwise5x5(x_, k_, b_[0] if b_ else None,
                                        fuse_swish=fuse_swish, interpret=True)

    _, vjp = jax.vjp(pallas, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    tensors = [torch.from_numpy(a).requires_grad_() for a in args]
    counts = (tdw.fused_swish_depthwise5x5_dx.launches,
              tdw.fused_swish_depthwise5x5_dw.launches)
    y = tdw.fused_swish_depthwise5x5(*tensors, *(() if with_bias else (None,)),
                                     fuse_swish=fuse_swish)
    y.backward(torch.from_numpy(dy))
    assert counts == (tdw.fused_swish_depthwise5x5_dx.launches,
                      tdw.fused_swish_depthwise5x5_dw.launches)
    for t, w in zip(tensors, want):
        denom = float(jnp.abs(w).max()) + 1e-9
        np.testing.assert_allclose(t.grad.numpy() / denom,
                                   np.asarray(w) / denom, atol=3e-5)


@pytest.mark.parametrize("fuse_swish,with_bias", [(True, True), (False, False)])
def test_function_gradcheck_float64(fuse_swish, with_bias):
    rng = np.random.RandomState(3)
    inputs = [torch.from_numpy(rng.randn(2, 5, 6, 3)),
              torch.from_numpy(0.3 * rng.randn(5, 5, 1, 3))]
    if with_bias:
        inputs.append(torch.from_numpy(0.1 * rng.randn(3)))
    for t in inputs:
        t.requires_grad_()

    def fn(x, k, *b):
        return tdw.fused_swish_depthwise5x5(x, k, b[0] if b else None,
                                            fuse_swish=fuse_swish)

    # Hundreds of tiny convolutions: one thread each, or they wait on
    # thread pools that other test workers keep busy.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert torch.autograd.gradcheck(fn, inputs)
    finally:
        torch.set_num_threads(threads)


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
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdw.fused_swish_depthwise5x5_dx(x, k, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdw.fused_swish_depthwise5x5_dw(x, x)


@pytest.mark.parametrize("case,exc,match", [
    ("kernel_shape", ValueError, "kernel must be"),
    ("bias_shape", ValueError, "bias must be"),
    ("dtype", TypeError, "float32"),
    ("strided_x", ValueError, "contiguous"),
    ("plane", ValueError, "shared memory"),
    ("operand_shape", ValueError, "operand 0 has shape"),
    ("operand_strided", ValueError, "operand 0 must be contiguous"),
])
def test_wrapper_checks(case, exc, match):
    x = torch.zeros(2, 8, 8, 32)
    k = torch.zeros(5, 5, 1, 32)
    b = None
    others = ()
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
    elif case == "operand_shape":
        others = (torch.zeros(2, 8, 4, 32),)
    elif case == "operand_strided":
        others = (torch.zeros(2, 32, 8, 8).permute(0, 2, 3, 1),)
    with pytest.raises(exc, match=match):
        tdw._check(x, k, b, *others)


def test_path_shapes_fit_one_block():
    """Every shape of the sampling and training path fits the kernels'
    shared memory, and dW/db's stage 1 has between 1 and one block per
    (batch row, row tile) unit along its batch axis."""
    for h, c in ((4, 1536), (8, 768), (16, 384), (32, 192)):
        x = torch.empty(144, h, h, c, device="meta")
        tdw._check(x, torch.empty(5, 5, 1, c, device="meta"), None, x)
        units = 144 * -(-h // min(h, 8))
        assert 1 <= tdw.dw_parts(x.shape) <= units
