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
BatchNorm running statistics at atol 1e-4.  The squeeze-excitation gate
against its plain version at atol 1e-5 and bitwise across two runs; a
debug-size ``Trainer.fit`` on the card with its launch counts and hooks.
The bf16 instance of the forward against its plain version: at most one
bf16 ulp at the scale of its products' sum, bitwise across two runs; the bf16-compute sampler on the card
against the CPU at atol 3e-2 on the probabilities.  The bf16 instances of
dx and dW/db against their plain versions: dx within one bf16 ulp plus
``BF16_SUM_ULPS`` fp32 ulps of ``|swish'(x)| sum |dy w|``, dW/db's fp32 sums
at 1e-4 of the largest |dW| and bitwise across two runs; a debug-size bf16
training step on the card with its launch counts.  The metric suite: each
backbone's features on the card against the CPU at relative L2 1e-4 (fp32
both, no TF32); k-NN precision/recall on the card against the CPU within
3 samples of 2,000 (the distances round differently, so a sample on a
sphere's boundary may flip) and the nearest neighbours 99.9% equal; the
fp32 device FID against the fp64 host FID within 1e-4 of the covariances'
summed traces (the terms it is the difference of); the debug-size
protocol on the card with the fused kernel's exact launch count.
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
    ((3, 6, 10, 40), True),  # ragged run and channel chunk
    ((2, 21, 9, 32), False),  # ragged run, odd H
    ((1, 3, 7, 6), True),  # batch 1, H < 5, C % 4 != 0 (4-byte copies)
    ((2, 9, 3, 36), False),  # W < 5
    ((3, 2, 2, 70), True),  # H and W < 5, C % 4 != 0
    ((3, 13, 14, 40), True),  # four runs, odd H: pairs cross images
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
    with pytest.raises(TypeError, match="float32"):
        tdw.fused_swish_depthwise5x5(x.half(), k.half())
    with pytest.raises(ValueError):
        tdw.fused_swish_depthwise5x5(x.permute(0, 2, 1, 3), k)
    xb, kb = x.to(torch.bfloat16), k.to(torch.bfloat16)
    with pytest.raises(TypeError, match="operand 0 must be torch.bfloat16"):
        tdw.fused_swish_depthwise5x5_dx(xb, kb, x)
    with pytest.raises(TypeError, match="operand 0 must be torch.bfloat16"):
        tdw.fused_swish_depthwise5x5_dw(xb, x)
    with pytest.raises(TypeError, match="bfloat16 dy"):
        tdw.fused_swish_depthwise5x5_dx_bf16(x, k, x)
    with pytest.raises(ValueError, match="even channel count"):
        tdw.fused_swish_depthwise5x5(xb[..., :31].contiguous(),
                                     kb[..., :31].contiguous())


@pytest.mark.parametrize("shape,with_bias", [
    ((4, 4, 4, 1536), True), ((4, 8, 8, 768), True),
    ((4, 16, 16, 384), False), ((4, 32, 32, 192), False),
    ((3, 6, 10, 40), True),  # ragged run and channel chunk
    ((2, 21, 9, 32), False),  # ragged run, odd H
    ((1, 3, 7, 6), True),  # C % 8 != 0: the 4-byte copies
    ((3, 2, 2, 70), True),  # H and W < 5, C % 8 != 0
])
def test_cuda_bf16_kernel_matches_plain(cuda_device, shape, with_bias):
    """The bf16 instance of #2 against its plain version: within one bf16
    ulp of the result plus ``BF16_SUM_ULPS`` fp32 ulps of its 25 products'
    sum (``bf16_sum_ulps``); at the path shapes, at least
    ``BF16_MIN_EQUAL_SHARE`` of the outputs bitwise equal; bitwise across
    two runs, counted apart from fp32."""
    x, k, b = _inputs(shape, cuda_device)
    x, k = x.to(torch.bfloat16), k.to(torch.bfloat16)
    b = b if with_bias else None
    for fuse in (True, False):
        before = (tdw.fused_swish_depthwise5x5.launches,
                  tdw.fused_swish_depthwise5x5_bf16.launches)
        got = tdw.fused_swish_depthwise5x5(x, k, b, fuse_swish=fuse)
        again = tdw.fused_swish_depthwise5x5(x, k, b, fuse_swish=fuse)
        assert (tdw.fused_swish_depthwise5x5.launches,
                tdw.fused_swish_depthwise5x5_bf16.launches) == (
                    before[0], before[1] + 2)
        want = tdw.fused_swish_depthwise5x5_plain(x, k, b, fuse_swish=fuse)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and torch.equal(got, again)
        scale = tdw.bf16_sum_scale(x, k, b, fuse_swish=fuse)
        sum_ulps = tdw.bf16_sum_ulps(got, want, scale)
        assert float(sum_ulps.max()) <= tdw.BF16_SUM_ULPS
        if got.numel() >= 10_000:  # 0.1% is 10 outputs or more
            equal = float((got.view(torch.int16) == want.view(torch.int16))
                          .float().mean())
            assert equal >= tdw.BF16_MIN_EQUAL_SHARE


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


@pytest.mark.parametrize("serve_dtype", ["int8", "bfloat16"])
def test_cuda_bf16_sampler_matches_cpu(cuda_device, serve_dtype):
    """bf16 compute and BatchNorm apply, weights in ``serve_dtype``: the
    card's probabilities against the CPU's at atol 3e-2 on injected noise,
    with one bf16 #2 launch per generative cell and none in fp32."""
    from nvae_torch.serving import Sampler

    cfg = debug_config(use_pallas_kernels=True, compute_dtype="bfloat16",
                       bn_apply_dtype="bfloat16")
    sd = NVAE(debug_config(use_pallas_kernels=True), device="cpu",
              seed=3).state_dict()
    rng = np.random.RandomState(0)
    eps = [rng.randn(*s).astype(np.float32) for s in decoder_noise_shapes(cfg, 3)]
    gpu = Sampler(cfg, sd, 3, device=cuda_device, serve_dtype=serve_dtype)
    cpu = Sampler(cfg, sd, 3, device="cpu", serve_dtype=serve_dtype)
    before = (tdw.fused_swish_depthwise5x5.launches,
              tdw.fused_swish_depthwise5x5_bf16.launches)
    got = gpu.apply(lambda m: m.sample(3, 0.8, eps=eps)[0])
    torch.cuda.synchronize()
    assert (tdw.fused_swish_depthwise5x5.launches,
            tdw.fused_swish_depthwise5x5_bf16.launches) == (
                before[0], before[1] + cfg.n_total_groups - 1)
    want = cpu.apply(lambda m: m.sample(3, 0.8, eps=eps)[0])
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=3e-2)


BACKWARD_SHAPES = [
    ((4, 4, 4, 1536), True), ((4, 8, 8, 768), True),
    ((4, 16, 16, 384), False), ((4, 32, 32, 192), False),
    ((3, 6, 10, 40), True),  # ragged run and channel chunk
    ((2, 21, 9, 32), False),  # ragged run, odd H
    ((1, 3, 7, 6), True),  # batch 1, H < 5, C % 4 != 0 (4-byte copies)
    ((2, 9, 3, 36), False),  # W < 5
    ((3, 2, 2, 70), True),  # H and W < 5, C % 4 != 0
    ((3, 13, 14, 40), True),  # four runs, odd H: pairs cross images
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


@pytest.mark.parametrize("shape,with_bias", BACKWARD_SHAPES)
def test_cuda_bf16_backward_kernels_match_plain(cuda_device, shape,
                                                with_bias):
    """The bf16 instances of #3 and #4 against their plain versions, counted
    apart from fp32: dx within its limit (``bf16_dx_scale``) and, at the
    path shapes, at least ``BF16_MIN_EQUAL_SHARE`` bitwise equal; dW/db's
    fp32 sums at 1e-4 of the largest |dW|, bitwise across two runs."""
    bf = torch.bfloat16
    x, k, _ = (t.to(bf) for t in _inputs(shape, cuda_device))
    dy = _inputs(shape, cuda_device, seed=1)[0].to(bf)
    kt = k.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    names = ("fused_swish_depthwise5x5_dx", "fused_swish_depthwise5x5_dx_bf16",
             "fused_swish_depthwise5x5_dw", "fused_swish_depthwise5x5_dw_bf16")
    for fuse in (True, False):
        before = [getattr(tdw, n).launches for n in names]
        got = tdw.fused_swish_depthwise5x5_dx(dy, kt, x if fuse else None,
                                              fuse_swish=fuse)
        dk, db = tdw.fused_swish_depthwise5x5_dw(x, dy, fuse_swish=fuse,
                                                 with_bias=with_bias)
        dk2, db2 = tdw.fused_swish_depthwise5x5_dw(x, dy, fuse_swish=fuse,
                                                   with_bias=with_bias)
        assert [getattr(tdw, n).launches - b
                for n, b in zip(names, before)] == [0, 1, 0, 2]
        want = tdw.fused_swish_depthwise5x5_dx_plain(dy, k, x, fuse_swish=fuse)
        torch.cuda.synchronize()
        assert got.dtype == bf
        scale = tdw.bf16_dx_scale(dy, k, x, fuse_swish=fuse)
        assert float(tdw.bf16_sum_ulps(got, want, scale).max()) <= (
            tdw.BF16_SUM_ULPS)
        if got.numel() >= 10_000:
            equal = float((got.view(torch.int16) == want.view(torch.int16))
                          .float().mean())
            assert equal >= tdw.BF16_MIN_EQUAL_SHARE
        dk_want, db_want = tdw.fused_swish_depthwise5x5_dw_plain(
            x, dy, fuse_swish=fuse)
        assert dk.dtype == torch.float32 and torch.equal(dk, dk2)
        assert float((dk - dk_want).abs().max()) <= (
            1e-4 * float(dk_want.abs().max()))
        if with_bias:
            assert torch.equal(db, db2)
            assert float((db - db_want).abs().max()) <= (
                1e-4 * float(db_want.abs().max()))


# The RGB presets' depthwise shapes (cifar10_dml, celeba64), at 4 rows.
RGB_SHAPES = [(4, h, h, c) for h, c in (
    (4, 2304), (8, 1152), (16, 576), (32, 288), (4, 4608), (8, 2304),
    (16, 1152), (32, 576), (64, 288))]


@pytest.mark.parametrize("shape", RGB_SHAPES)
@pytest.mark.parametrize("fuse,with_bias", [(True, True), (False, False)])
def test_cuda_bf16_kernels_at_the_rgb_shapes(cuda_device, shape, fuse,
                                              with_bias):
    """The bf16 instances of #2, #3 and #4 at the RGB presets' shapes, at
    the path shapes' limits: #2 and #3 (with swish' where ``fuse``) within
    ``BF16_SUM_ULPS`` and at least ``BF16_MIN_EQUAL_SHARE`` bitwise equal,
    #4 within 1e-4 of the largest |dW| and |db|; all bitwise across two
    runs."""
    bf = torch.bfloat16
    x, k, b = _inputs(shape, cuda_device)
    x, k = x.to(bf), k.to(bf)
    b = b if with_bias else None
    dy = _inputs(shape, cuda_device, seed=1)[0].to(bf)
    got = tdw.fused_swish_depthwise5x5(x, k, b, fuse_swish=fuse)
    again = tdw.fused_swish_depthwise5x5(x, k, b, fuse_swish=fuse)
    dk, db = tdw.fused_swish_depthwise5x5_dw(x, dy, fuse_swish=fuse,
                                             with_bias=with_bias)
    dk2, db2 = tdw.fused_swish_depthwise5x5_dw(x, dy, fuse_swish=fuse,
                                               with_bias=with_bias)
    want = tdw.fused_swish_depthwise5x5_plain(x, k, b, fuse_swish=fuse)
    dk_want, db_want = tdw.fused_swish_depthwise5x5_dw_plain(
        x, dy, fuse_swish=fuse)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(dk, dk2)
    scale = tdw.bf16_sum_scale(x, k, b, fuse_swish=fuse)
    assert float(tdw.bf16_sum_ulps(got, want, scale).max()) <= (
        tdw.BF16_SUM_ULPS)
    equal = float((got.view(torch.int16) == want.view(torch.int16))
                  .float().mean())
    assert equal >= tdw.BF16_MIN_EQUAL_SHARE
    assert float((dk - dk_want).abs().max()) <= (
        1e-4 * float(dk_want.abs().max()))
    if with_bias:
        assert torch.equal(db, db2)
        assert float((db - db_want).abs().max()) <= (
            1e-4 * float(db_want.abs().max()))
    before = tdw.fused_swish_depthwise5x5_dx_bf16.launches
    dx = tdw.fused_swish_depthwise5x5_dx(dy, k, x if fuse else None,
                                         fuse_swish=fuse)
    dx2 = tdw.fused_swish_depthwise5x5_dx(dy, k, x if fuse else None,
                                          fuse_swish=fuse)
    assert tdw.fused_swish_depthwise5x5_dx_bf16.launches == before + 2
    dx_want = tdw.fused_swish_depthwise5x5_dx_plain(dy, k, x,
                                                    fuse_swish=fuse)
    torch.cuda.synchronize()
    assert dx.dtype == bf and torch.equal(dx, dx2)
    scale = tdw.bf16_dx_scale(dy, k, x, fuse_swish=fuse)
    assert float(tdw.bf16_sum_ulps(dx, dx_want, scale).max()) <= (
        tdw.BF16_SUM_ULPS)
    equal = float((dx.view(torch.int16) == dx_want.view(torch.int16))
                  .float().mean())
    assert equal >= tdw.BF16_MIN_EQUAL_SHARE


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


def test_cuda_bf16_train_step_matches_cpu(cuda_device):
    """One debug-size training step in bf16 compute and BatchNorm apply
    (depthwise config) on the card and on the CPU, from the same weights
    and noise: 5 launches of each bf16 kernel (#2, #3, #4) and none of the
    fp32 ones; the loss at rtol 5e-3 and the gradient within 0.15 (relative
    L2) of the CPU's: two bf16 runs that round at other places, as
    ``tests/test_torch_bf16_train.py`` holds the port against JAX."""
    from nvae_torch.train import optim
    from nvae_torch.train.state import create_train_state
    from nvae_torch.train.step import make_train_step

    cfg = debug_config(use_pallas_kernels=True, postprocess_5x5_depthwise=True,
                       compute_dtype="bfloat16", bn_apply_dtype="bfloat16")
    tc = TrainConfig(batch_size=4, step_based_warmup=True)
    rng = np.random.RandomState(0)
    batch = (rng.rand(4, 32, 32, 1) > 0.5).astype(np.float32)
    eps = [[rng.randn(*s).astype(np.float32)
            for s in posterior_noise_shapes(cfg, 4)]]
    names = ("fused_swish_depthwise5x5", "fused_swish_depthwise5x5_dx",
             "fused_swish_depthwise5x5_dw", "fused_swish_depthwise5x5_bf16",
             "fused_swish_depthwise5x5_dx_bf16",
             "fused_swish_depthwise5x5_dw_bf16")
    out = {}
    for dev in ("cpu", cuda_device):
        grads = {}

        def record(updates, state, params=None, grads=grads):
            grads.update({k: g.detach().cpu() for k, g in updates.items()})
            return {k: torch.zeros_like(g) for k, g in updates.items()}, state

        model, state, _ = create_train_state(cfg, tc, 100, device=dev, seed=3)
        step = make_train_step(model, optim.GradientTransformation(
            lambda params: None, record), tc, 100, 50)
        before = [getattr(tdw, n).launches for n in names]
        _, metrics = step(state, batch, eps=eps)
        launches = [getattr(tdw, n).launches - b
                    for n, b in zip(names, before)]
        if dev != "cpu":
            assert launches == [0, 0, 0, 5, 5, 5]
        out[str(dev)] = (float(metrics["loss"]), grads)
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = out[str(cuda_device)], out["cpu"]
    assert abs(loss_gpu - loss_cpu) <= 5e-3 * abs(loss_cpu)
    diff = sum(float(((g_gpu[k] - g_cpu[k]) ** 2).sum()) for k in g_cpu)
    norm = sum(float((g ** 2).sum()) for g in g_cpu.values())
    assert (diff / norm) ** 0.5 <= 0.15


def _se_args(shape, device):
    b, h, w, c, hd = shape
    rng = np.random.RandomState(c)
    arrays = (rng.randn(b, h, w, c), 0.1 * rng.randn(c, hd),
              0.1 * rng.randn(hd), 0.1 * rng.randn(hd, c), 0.1 * rng.randn(c))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


SE_MAX_C = 2896  # the most channels the gate takes at 8x8 with hidden 4


@pytest.mark.parametrize("shape,offset", [
    ((4, 8, 8, 128, 8), False), ((6, 4, 4, 256, 16), False),
    ((5, 32, 32, 32, 4), False),
    ((3, 7, 9, 40, 4), False),  # channels not a multiple of 32, odd H * W
    ((2, 1, 1, 5, 4), False),
    ((2, 5, 5, 64, 4), False),  # H * W = 25: not a multiple of the cluster
    ((2, 32, 32, 5, 4), False),  # C % 4 != 0 at a large H * W: 4-byte copies
    ((1, 16, 16, 64, 4), False),  # batch 1
    ((3, 8, 8, 128, 8), True),  # x 4 bytes off alignment: 4-byte copies
    ((1, 8, 8, SE_MAX_C, 4), False),  # the most channels a block takes
])
def test_cuda_se_gate_matches_plain(cuda_device, shape, offset):
    from nvae_torch.kernels.se_gate import se_gate, se_gate_reference

    b, h, w, c, hd = shape
    args = _se_args(shape, cuda_device)
    if offset:
        buf = torch.empty(args[0].numel() + 1, device=cuda_device)
        args[0] = buf[1:].view_as(args[0]).copy_(args[0])
        assert args[0].data_ptr() % 16 == 4
    before = se_gate.launches
    got, again = se_gate(*args), se_gate(*args)
    assert se_gate.launches == before + 2
    want = se_gate_reference(*args)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got, again)
    with pytest.raises(RuntimeError, match="forward only"):
        se_gate(args[0].clone().requires_grad_(), *args[1:])
    strided = torch.zeros(b, h, w, 2 * c, device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        se_gate(strided, *args[1:])
    with pytest.raises(TypeError):
        se_gate(args[0].double(), *args[1:])


def test_cuda_se_gate_refuses_one_channel_too_many(cuda_device):
    from nvae_torch.kernels.se_gate import se_gate

    before = se_gate.launches
    with pytest.raises(ValueError, match="shared memory"):
        se_gate(*_se_args((1, 8, 8, SE_MAX_C + 1, 4), cuda_device))
    assert se_gate.launches == before


def test_cuda_trainer_fit(cuda_device, tmp_path):
    """Two debug-size epochs on the card through ``Trainer.fit``: finite
    metrics, the hooks' images, a checkpoint per epoch, and the fused
    kernels' launches: per step 3 of each of #2, #3, #4; per eval forward,
    sampling call and reconstruction 3 of #2."""
    from nvae_torch.data import make_iterators, synthetic_dataset
    from nvae_torch.train import checkpoint as ckpt
    from nvae_torch.train.trainer import Trainer
    from nvae_torch.utils.logging import MetricsLogger

    cfg = debug_config(use_pallas_kernels=True)
    tc = TrainConfig(epochs=2, batch_size=8, step_based_warmup=True,
                     sample_frequency=1, evaluate_frequency=1,
                     model_save_frequency=1,
                     model_save_dir=str(tmp_path / "models"),
                     tensorboard_log_dir=str(tmp_path / "logs"))
    bundle = synthetic_dataset(n_train=32, n_test=16, seed=0)
    train_iter, test_iter = make_iterators(bundle, 8, device=cuda_device)
    logger = MetricsLogger(tc.tensorboard_log_dir, tensorboard=False)
    trainer = Trainer(cfg, tc, len(train_iter), logger=logger,
                      device=cuda_device)
    names = ("fused_swish_depthwise5x5", "fused_swish_depthwise5x5_dx",
             "fused_swish_depthwise5x5_dw")
    before = [getattr(tdw, n).launches for n in names]
    result = trainer.fit(train_iter, test_iter)
    logger.close()
    launches = [getattr(tdw, n).launches - b for n, b in zip(names, before)]
    steps, evals = 2 * 4, 2 * 2
    assert launches == [3 * (steps + evals + 2 + 2), 3 * steps, 3 * steps]
    assert trainer.state.step == steps
    assert all(np.isfinite(v) for h in result.history for v in h.values())
    assert result.history[-1]["peak_memory_gb"] > 0
    assert ckpt.all_steps(trainer.ckpt_dir) == [4, 8]
    images = tmp_path / "logs" / "images"
    assert (images / "samples_t1.0_step1").is_dir()
    assert (images / "test_reconstruction_step1").is_dir()


def _flat_copy(state):
    from nvae_torch.train import checkpoint as ckpt

    return {k: v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v
            for k, v in ckpt.flatten_state(state).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_graphed_epochs_match_eager(cuda_device, dtype, monkeypatch):
    """Two debug-size epochs of the epoch runner as CUDA graph replays and
    the same epochs run eagerly (``graph=False``) from the same seed: the
    same bits in every parameter, statistic, optimizer leaf and mean
    metric, with cuDNN's deterministic algorithms (its default fp32
    backward sums with atomics: two eager steps differ in their last bits).
    The first step runs eagerly, the second is captured; a replay launches
    3 of each of #2, #3 and #4 in the config's dtype, none of the other,
    and ``replayed`` counts captured launches x replays; a state whose
    optimizer tensors are not the captured ones is refused."""
    import dataclasses

    from nvae_torch.data import synthetic_dataset
    from nvae_torch.train.epoch_runner import make_epoch_runner, stage_dataset
    from nvae_torch.train.state import create_train_state

    cfg = debug_config(use_pallas_kernels=True, compute_dtype=dtype,
                       bn_apply_dtype=dtype)
    tc = TrainConfig(batch_size=8, step_based_warmup=True, ema_decay=0.9)
    data = stage_dataset(synthetic_dataset(n_train=40, n_test=8,
                                           seed=0).train_x, cuda_device)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    spe, out = 4, {}
    for graph in (True, False):
        model, state, tx = create_train_state(cfg, tc, 2 * spe,
                                              device=cuda_device, seed=3)
        run = make_epoch_runner(model, tx, tc, 2 * spe, spe, graph=graph)
        replayed = {fn.__name__: fn.replayed for fn in tdw.COUNTED}
        means = []
        for e in range(2):
            state, m = run(state, data, e)
            means.append(m)
        torch.cuda.synchronize()
        out[graph] = (means, _flat_copy(state))
        if graph:
            assert (run.eager_steps, run.replays) == (1, 2 * spe - 1)
            bf16 = "_bf16" if dtype == "bfloat16" else ""
            want = {fn.__name__: 0 for fn in tdw.COUNTED}
            for name in ("fused_swish_depthwise5x5",
                         "fused_swish_depthwise5x5_dx",
                         "fused_swish_depthwise5x5_dw"):
                want[name + bf16] = 3
            assert run.launches_per_replay == want
            for fn in tdw.COUNTED:
                assert fn.replayed - replayed[fn.__name__] == (
                    want[fn.__name__] * run.replays)
            # New optimizer tensors in place of the captured ones: refused.
            fresh = dataclasses.replace(state,
                                        opt_state=tx.init(state.params()))
            with pytest.raises(RuntimeError, match="rebound"):
                run(fresh, data, 2)
    (m_g, s_g), (m_e, s_e) = out[True], out[False]
    assert m_g == m_e
    assert set(s_g) == set(s_e)
    for k, v in s_g.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, s_e[k]), k
        else:
            assert v == s_e[k], k


def test_cuda_graph_replays_read_a_reseeded_generator(cuda_device):
    """The mechanism the epoch runner relies on: a generator registered
    with a graph and reseeded on the host before each replay draws, in the
    replay, what a fresh generator with that seed draws eagerly."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)
    torch.randn(1000, generator=gen, device=cuda_device)  # warm up
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        a = torch.randn(1000, generator=gen, device=cuda_device)
        b = torch.rand(7, 3, generator=gen, device=cuda_device)
    for seed in (5, 6, 5):
        gen.manual_seed(seed)
        graph.replay()
        ref = torch.Generator(device=cuda_device).manual_seed(seed)
        want_a = torch.randn(1000, generator=ref, device=cuda_device)
        want_b = torch.rand(7, 3, generator=ref, device=cuda_device)
        assert torch.equal(a, want_a) and torch.equal(b, want_b), seed


@pytest.mark.parametrize("name", ["random_conv", "vgg16", "inception"])
def test_cuda_extractor_matches_cpu(cuda_device, name):
    from nvae_torch.eval.features import extract_features, get_extractor

    images = np.random.RandomState(0).rand(4, 32, 32, 1).astype(np.float32)
    got = extract_features(images, get_extractor(name, device=cuda_device))
    want = extract_features(images, get_extractor(name, device="cpu"))
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def test_cuda_precision_recall_and_fid_match_cpu(cuda_device):
    from nvae_torch.eval.frechet import fid_from_features
    from nvae_torch.eval.precision_recall import knn_precision_recall_features

    rng = np.random.RandomState(1)
    real = rng.randn(2000, 64).astype(np.float32)
    gen = (rng.randn(2000, 64) * 0.9 + 0.1).astype(np.float32)
    kw = dict(return_realism=True, return_neighbors=True)
    for rows in (10000, 700):  # full tiles, then streamed ragged blocks
        card = knn_precision_recall_features(real, gen, row_batch_size=rows,
                                             device=cuda_device, **kw)
        cpu = knn_precision_recall_features(real, gen, row_batch_size=rows,
                                            device="cpu", **kw)
        for key in ("precision", "recall"):
            assert abs(card[key] - cpu[key]) <= 3 / 2000, key
        assert 0.0 < card["precision"] < 1.0
        np.testing.assert_allclose(card["realism"], cpu["realism"],
                                   rtol=1e-4)
        same = np.mean(card["nearest_neighbors"] == cpu["nearest_neighbors"])
        assert same >= 0.999
    # The fp32 distance is a difference of traces of size tr(S1) + tr(S2),
    # each carrying the fp32 eigensolver's rounding: its error scales with
    # them, not with the (here small) distance.
    host = fid_from_features(real, gen)
    card_fid = fid_from_features(real, gen, precise=False, device=cuda_device)
    traces = np.trace(np.cov(real, rowvar=False)) + np.trace(
        np.cov(gen, rowvar=False))
    assert abs(card_fid - host) <= 1e-4 * traces


def test_cuda_evaluate_model_launches_the_kernel(cuda_device):
    """The protocol at debug size on the card: the fused kernel once per
    generative cell of every sample call and every NLL posterior pass,
    none of the backward kernels."""
    from nvae_torch.data import make_iterators, synthetic_dataset
    from nvae_torch.eval.evaluate import evaluate_model
    from nvae_torch.train.trainer import Trainer

    cfg = debug_config(use_pallas_kernels=True)
    trainer = Trainer(cfg, TrainConfig(epochs=1, batch_size=8), 2,
                      device=cuda_device)
    _, test_iter = make_iterators(synthetic_dataset(n_train=8, n_test=16),
                                  8, device=cuda_device)
    fns = (tdw.fused_swish_depthwise5x5, tdw.fused_swish_depthwise5x5_dx,
           tdw.fused_swish_depthwise5x5_dw)
    for fn in fns:
        fn.launches = 0
    timings = {}
    ev = evaluate_model(trainer, test_iter, batch_size=8, n_attempts=2,
                        temperatures=(0.8, 1.0), fid_sample_size=16,
                        feature_backbone="random_conv",
                        fid_backbone="random_conv", timings=timings)
    per_call = (cfg.n_total_groups - 1) * cfg.res_cells_per_group
    # Per temperature: 2 attempts x (1 + 4 halves) sample calls and 2 FID
    # batches; then 2 test batches x 2 NLL attempts.
    calls = 2 * (2 * (1 + 4) + 2) + 2 * 2
    assert [fn.launches for fn in fns] == [per_call * calls, 0, 0]
    assert all(np.isfinite(m.fid) for m in ev.sample_metrics)
    assert set(timings) >= {"sampling", "nll", "precision/recall"}


# ---- #2 as the op nvae_torch::fused_swish_dw5x5, and the program artifact --


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_op_launches_the_kernel(cuda_device, dtype, monkeypatch):
    """The op's CUDA implementation is the kernel's launch, counted once a
    call in its instance's wrapper, and never the plain version; its
    output has the fake's layout."""
    x, k, b = _inputs((4, 16, 16, 384), cuda_device)
    x, kt = x.to(dtype), k.to(dtype).permute(3, 2, 0, 1).contiguous()
    taps = kt.permute(2, 3, 1, 0)  # DepthwiseConv's (5, 5, 1, C) view
    want = tdw.fused_swish_depthwise5x5_plain(x, taps, b)
    counted = (tdw.fused_swish_depthwise5x5_bf16 if dtype == torch.bfloat16
               else tdw.fused_swish_depthwise5x5)
    other = (tdw.fused_swish_depthwise5x5 if dtype == torch.bfloat16
             else tdw.fused_swish_depthwise5x5_bf16)

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tdw, "fused_swish_depthwise5x5_plain", plain)
    op = torch.ops.nvae_torch.fused_swish_dw5x5.default
    before = (counted.launches, other.launches)
    got = op(x, taps, b, True)
    assert (counted.launches, other.launches) == (before[0] + 1, before[1])
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= ATOL
    else:
        scale = tdw.bf16_sum_scale(x, taps, b)
        assert float(tdw.bf16_sum_ulps(got, want, scale).max()) <= (
            tdw.BF16_SUM_ULPS)
    fake = op(x.to("meta"), taps.to("meta"), b.to("meta"), True)
    assert (got.shape, got.dtype, got.stride()) == (
        fake.shape, fake.dtype, fake.stride())
    with pytest.raises(ValueError):  # what the kernel does not take raises
        op(x.permute(0, 2, 1, 3), taps, b, True)


@pytest.mark.parametrize("serve_dtype,compute", [
    ("", "float32"), ("bfloat16", "bfloat16"), ("int8", "bfloat16")])
def test_cuda_program_artifact_matches_the_sampler(cuda_device, tmp_path,
                                                   serve_dtype, compute):
    """A debug-size program traced on the card and one traced on the CPU
    (moved to the card at load) give the live sampler's images bitwise,
    with the op's launches per call as the eager call's."""
    import dataclasses

    from nvae_torch.serving import Sampler, export_program, load_artifact

    cfg = dataclasses.replace(debug_config(use_pallas_kernels=True),
                              compute_dtype=compute)
    sd = NVAE(cfg, device="cpu", seed=0).state_dict()
    live = Sampler(cfg, sd, 8, device=cuda_device, serve_dtype=serve_dtype)
    counted = (tdw.fused_swish_depthwise5x5_bf16 if compute == "bfloat16"
               else tdw.fused_swish_depthwise5x5)
    t = torch.linspace(0.6, 1.0, 8)
    before = counted.launches
    want = live(3, t)
    per_call = counted.launches - before
    assert per_call == (cfg.n_total_groups - 1) * cfg.res_cells_per_group
    for where in ("cuda", "cpu"):
        path = str(tmp_path / f"{where}.pt2")
        export_program(path, cfg, sd, 8, per_sample_temperature=True,
                       serve_dtype=serve_dtype, device=where)
        program = load_artifact(path, cuda_device)
        assert program.artifact["op_nodes"] == per_call
        before = counted.launches
        got = program(3, t)
        assert counted.launches - before == per_call
        assert got.device.type == "cuda" and torch.equal(got, want), where
