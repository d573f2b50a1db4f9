"""Tests of the port that need a CUDA card; each skips without one.

This file imports neither JAX nor ``nvae_tpu``, so it also runs where only
the port is installed (the repository's ``conftest.py`` imports JAX, hence
``--noconftest``)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The forward and dx kernels are held against their plain PyTorch versions at
atol 2e-5, the dW/db kernels at 1e-4 of the largest |dW| (sums of up to
B*H*W products in another order) and bitwise across two runs; the
debug-size sampler on the card against the same weights and injected noise
on the CPU at atol 1e-4; one debug-size training step on the card against
the CPU: metrics at rtol 1e-4, parameters at atol 1e-6 (SGD at lr 1e-5),
BatchNorm running statistics at atol 1e-4.
"""

import numpy as np
import pytest
import torch

from nvae_torch import TrainConfig, debug_config
from nvae_torch.kernels import depthwise as tdw
from nvae_torch.models.nvae import NVAE, decoder_noise_shapes, posterior_noise_shapes

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
    from nvae_torch.device import fp32_math

    cfg = debug_config(use_pallas_kernels=True,
                       postprocess_5x5_depthwise=depthwise)
    cpu = NVAE(cfg, device="cpu", seed=3)
    gpu = NVAE(cfg, device=cuda_device, seed=3)
    rng = np.random.RandomState(0)
    eps = [rng.randn(*s).astype(np.float32) for s in decoder_noise_shapes(cfg, 3)]
    before = tdw.fused_swish_depthwise5x5.launches
    with fp32_math(deterministic=True):
        got = gpu.sample(3, 0.8, eps=eps)
    assert tdw.fused_swish_depthwise5x5.launches - before == 3 + 2 * depthwise
    want = cpu.sample(3, 0.8, eps=eps)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)


BACKWARD_SHAPES = [
    ((4, 4, 4, 1536), True), ((4, 8, 8, 768), True),
    ((4, 16, 16, 384), False), ((4, 32, 32, 192), False),
    ((3, 6, 10, 40), True),  # ragged strip and channel chunk
    ((2, 21, 9, 32), False),  # ragged tile
]


@pytest.mark.parametrize("shape,with_bias", BACKWARD_SHAPES)
def test_cuda_backward_kernels_match_plain(cuda_device, shape, with_bias):
    x, k, _ = _inputs(shape, cuda_device)
    dy = _inputs(shape, cuda_device, seed=1)[0]
    kt = k.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    for fuse in (True, False):
        before = tdw.fused_swish_depthwise5x5_dx.launches
        got = tdw.fused_swish_depthwise5x5_dx(dy, kt, x if fuse else None,
                                              fuse_swish=fuse)
        assert tdw.fused_swish_depthwise5x5_dx.launches == before + 1
        want = tdw.fused_swish_depthwise5x5_dx_plain(dy, k, x, fuse_swish=fuse)
        assert float((got - want).abs().max()) <= ATOL

        before = tdw.fused_swish_depthwise5x5_dw.launches
        dk, db = tdw.fused_swish_depthwise5x5_dw(x, dy, fuse_swish=fuse,
                                                 with_bias=with_bias)
        dk2, db2 = tdw.fused_swish_depthwise5x5_dw(x, dy, fuse_swish=fuse,
                                                   with_bias=with_bias)
        assert tdw.fused_swish_depthwise5x5_dw.launches == before + 2
        dk_want, db_want = tdw.fused_swish_depthwise5x5_dw_plain(
            x, dy, fuse_swish=fuse)
        torch.cuda.synchronize()
        assert torch.equal(dk, dk2)
        scale = float(dk_want.abs().max())
        assert float((dk - dk_want).abs().max()) <= 1e-4 * scale
        if with_bias:
            assert torch.equal(db, db2)
            assert float((db - db_want).abs().max()) <= (
                1e-4 * float(db_want.abs().max()))
        else:
            assert db is None


@pytest.mark.parametrize("fuse,with_bias", [(True, True), (False, False)])
def test_cuda_function_gradients_match_cpu(cuda_device, fuse, with_bias):
    """The fused op on the card has gradients, equal to the CPU Function's:
    x, the taps (a view of a (C, 1, 5, 5) weight, as DepthwiseConv passes
    them) and the bias."""
    shape = (3, 8, 8, 96)
    cpu = _inputs(shape, "cpu")
    g = _inputs(shape, "cpu", seed=2)[0]
    grads = {}
    for dev in ("cpu", cuda_device):
        x = cpu[0].to(dev).detach().requires_grad_()
        w = cpu[1].permute(3, 2, 0, 1).contiguous().to(dev).detach()
        w.requires_grad_()
        b = cpu[2].to(dev).detach().requires_grad_() if with_bias else None
        y = tdw.fused_swish_depthwise5x5(x, w.permute(2, 3, 1, 0), b,
                                         fuse_swish=fuse)
        (y * g.to(dev)).sum().backward()
        grads[str(dev)] = [t.grad for t in (x, w, b) if t is not None]
    for got, want in zip(grads[str(cuda_device)], grads["cpu"]):
        assert got is not None
        scale = max(1.0, float(want.abs().max()))
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("depthwise", [False, True])
def test_cuda_train_step_matches_cpu(cuda_device, depthwise):
    from nvae_torch.nn.spectral import sn_kernel_names
    from nvae_torch.train import optim
    from nvae_torch.train.state import create_train_state
    from nvae_torch.train.step import make_train_step

    cfg = debug_config(use_pallas_kernels=True,
                       postprocess_5x5_depthwise=depthwise)
    tc = TrainConfig(batch_size=4, step_based_warmup=True)
    rng = np.random.RandomState(0)
    batch = (rng.rand(4, 32, 32, 1) > 0.5).astype(np.float32)
    eps = [[rng.randn(*s).astype(np.float32)
            for s in posterior_noise_shapes(cfg, 4)]]
    lr = 1e-5
    sgd = optim.GradientTransformation(
        lambda params: None,
        lambda updates, state, params=None: (
            {k: -lr * u for k, u in updates.items()}, None))
    out = {}
    for dev in ("cpu", cuda_device):
        model, state, _ = create_train_state(cfg, tc, 100, device=dev, seed=3)
        tx = optim.chain(sgd, optim.spectral_projection(sn_kernel_names(model)))
        state.opt_state = tx.init(state.params())
        step = make_train_step(model, tx, tc, 100, 50)
        before = (tdw.fused_swish_depthwise5x5.launches,
                  tdw.fused_swish_depthwise5x5_dx.launches,
                  tdw.fused_swish_depthwise5x5_dw.launches)
        state, metrics = step(state, batch, eps=eps)
        after = (tdw.fused_swish_depthwise5x5.launches,
                 tdw.fused_swish_depthwise5x5_dx.launches,
                 tdw.fused_swish_depthwise5x5_dw.launches)
        launches = [a - b for a, b in zip(after, before)]
        if dev != "cpu":
            assert launches == [3 + 2 * depthwise] * 3
        out[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                         {k: v.detach().cpu() for k, v in
                          model.state_dict().items()})
    (m_gpu, sd_gpu), (m_cpu, sd_cpu) = out[str(cuda_device)], out["cpu"]
    for k in m_cpu:
        np.testing.assert_allclose(m_gpu[k], m_cpu[k], rtol=1e-4, err_msg=k)
    for k in sd_cpu:
        tol = 1e-4 if "running" in k else 1e-6
        assert float((sd_gpu[k] - sd_cpu[k]).abs().max()) <= tol, k
