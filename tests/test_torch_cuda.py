"""Tests of the port that need a CUDA card; each skips without one.

This file imports neither JAX nor ``nvae_tpu``, so it also runs where only
the port is installed (the repository's ``conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The kernel is held against its plain PyTorch version at atol 2e-5; the
debug-size sampler on the card against the same weights and injected noise
on the CPU at atol 1e-4.
"""

import numpy as np
import pytest
import torch

from nvae_torch import debug_config
from nvae_torch.kernels import depthwise as tdw
from nvae_torch.models.nvae import NVAE, decoder_noise_shapes

pytestmark = pytest.mark.cuda

ATOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, device, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    arrays = (rng.randn(*shape), rng.randn(5, 5, 1, c) * 0.1, rng.randn(c) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.parametrize("shape,with_bias", [
    ((4, 4, 4, 1536), True), ((4, 8, 8, 768), True),
    ((4, 16, 16, 384), False), ((4, 32, 32, 192), False),
    ((3, 6, 10, 40), True),  # ragged strip and channel chunk
    ((2, 21, 9, 32), False),  # ragged tile
])
def test_cuda_kernel_matches_plain(cuda_device, shape, with_bias):
    x, k, b = _inputs(shape, cuda_device)
    b = b if with_bias else None
    for fuse in (True, False):
        before = tdw.fused_swish_depthwise5x5.launches
        got = tdw.fused_swish_depthwise5x5(x, k, b, fuse_swish=fuse)
        assert tdw.fused_swish_depthwise5x5.launches == before + 1
        want = tdw.fused_swish_depthwise5x5_plain(x, k, b, fuse_swish=fuse)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= ATOL
    # Taps with other strides, as DepthwiseConv passes its (C, 1, 5, 5) weight.
    kt = k.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    got = tdw.depthwise_conv5x5(x, kt)
    want = tdw.fused_swish_depthwise5x5_plain(x, k, None, fuse_swish=False)
    assert float((got - want).abs().max()) <= ATOL


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x, k, _ = _inputs((2, 4, 4, 32), cuda_device)
    with pytest.raises(TypeError):
        tdw.fused_swish_depthwise5x5(x.half(), k.half())
    with pytest.raises(ValueError):
        tdw.fused_swish_depthwise5x5(x.permute(0, 2, 1, 3), k)


@pytest.mark.parametrize("depthwise", [False, True])
def test_cuda_sampler_matches_cpu(cuda_device, depthwise):
    from nvae_torch.serving import fp32_convolutions

    cfg = debug_config(use_pallas_kernels=True,
                       postprocess_5x5_depthwise=depthwise)
    cpu = NVAE(cfg, device="cpu", seed=3)
    gpu = NVAE(cfg, device=cuda_device, seed=3)
    rng = np.random.RandomState(0)
    eps = [rng.randn(*s).astype(np.float32) for s in decoder_noise_shapes(cfg, 3)]
    before = tdw.fused_swish_depthwise5x5.launches
    with fp32_convolutions():
        got = gpu.sample(3, 0.8, eps=eps)
    assert tdw.fused_swish_depthwise5x5.launches - before == 3 + 2 * depthwise
    want = cpu.sample(3, 0.8, eps=eps)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)
