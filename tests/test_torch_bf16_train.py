"""bf16 training in the port against the JAX package, on the CPU.

- The backward kernels' bf16 instances, as their plain versions, against
  the Pallas ``dx_call`` and ``dw_call`` (interpret mode) on the same bf16
  operands: dx within 1 bf16 ulp (both sum the 25 flipped taps in fp32 and
  round once, in another order); dW/db's fp32 sums within 1e-5 of max |dW|
  (sums over the batch and the plane in another order), and dW after the
  Function's cast to bf16 bitwise equal to JAX's cast wherever the fp32
  sums are.
- The card's dx limit (one bf16 ulp plus ``BF16_SUM_ULPS`` fp32 ulps of
  ``|swish'(x)| * sum |dy * w|``, at least ``BF16_MIN_EQUAL_SHARE`` of
  outputs bitwise equal) takes another fp32 order and refuses a second
  rounding of swish'(x) or of the products.
- Training-mode BatchNorm in both JAX forms (Flax's fp32 ``BatchNorm`` and
  ``_SplitPrecisionBN``) on a bf16 input: output, running statistics and
  the gradients of ``sum(sin(y))``.  The statistics are fp32 sums in
  another order (atol 1e-6 of ``max(1, |value|)``); the fp32 form's output
  and gradients at atol 1e-5 (after dividing by ``max(1, max |JAX
  gradient|)``); the bf16 form rounds its output once from slightly
  different fp32 ``mul`` and ``add``, so at most 1 bf16 ulp apart, and its
  gradients run through bf16 products (rtol 2^-6 of the largest).
- A forward-mode spectral convolution training in bf16: ``u`` from the
  fp32 kernel, the normalized kernel cast after the division, gradients.
- The whole training step (depthwise config, bf16 compute and BatchNorm
  apply) against JAX's ``make_train_step`` with the SGD harness of
  ``tests/test_torch_train_step.py`` at lr 1 (the update is minus the
  gradient): its update within ``STEP_REL_L2`` (relative L2 over every
  parameter) of JAX's, its loss within ``LOSS_RTOL`` and its BatchNorm
  running statistics within ``STEP_STATS_ATOL``; and its distance from the
  port's fp32 step between 0.25 and 1.5 times JAX bf16's distance from
  it, so the port ran bf16 (a silent fp32 path would sit near 0) without
  more error than JAX.
- The fused op receives bf16 operands in training, and its backward
  returns bf16 dx, bf16 dW and fp32 db.
- A generative cell training in bf16, with the fused op and with the plain
  depthwise path, against Flax; ``grad_accum`` 2 and ``parity_frozen_norm``
  in a bf16 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch import config as tcfg
from nvae_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from nvae_torch.kernels import depthwise as tdw
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.nn import blocks as tb
from nvae_torch.nn import spectral as ts
from nvae_torch.train import optim as topt
from nvae_torch.train.state import TrainState as TorchState
from nvae_torch.train.step import make_train_step as torch_train_step
from nvae_tpu import config as jcfg
from nvae_tpu.kernels.depthwise import _make_fused_dw
from nvae_tpu.models import NVAE as JaxNVAE
from nvae_tpu.nn import blocks as jb
from nvae_tpu.nn import spectral as js
from tests.test_torch_bf16 import PATH_SHAPES, _bf16_tensor, bf16_ulps
from tests.test_torch_blocks import _to_port, _variables, _x
from tests.test_torch_sampler import random_flax_variables
from tests.test_torch_train_step import _run, _sgd
from tests.test_torch_trainer import (  # noqa: F401  (a fixture)
    one_torch_thread,
    single_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BF16 = torch.bfloat16
DW_RTOL = 1e-5  # of max |dW|, the fp32 sums
STATS_ATOL = 1e-6  # BatchNorm running statistics, of max(1, |value|)
GRAD_ATOL = 1e-5  # fp32-apply BatchNorm, of max(1, max |JAX gradient|)
BF16_GRAD_RTOL = 2.0 ** -6  # gradients through bf16 products, of the largest
SUM_BF16_RTOL = 2.0 ** -4  # a gradient XLA sums in bf16, of the largest
# The bf16 step against JAX's (one step, debug size): each side's gradient
# lies about 6% (relative L2) from the port's fp32 gradient (measured 6.4%
# and 5.8%), its own roundings, so the two about 8% from each other
# (measured 8.0%); the loss, reconstruction and KL within 2e-3 (measured at
# most 1.8e-3); the running statistics of bf16 activations within 1.4e-2
# of max(1, |value|).
STEP_REL_L2 = 0.15
LOSS_RTOL = 5e-3
STEP_STATS_ATOL = 4e-2
VS_F32_RATIO = (0.25, 1.5)
STEP_CFG = dict(use_pallas_kernels=True, postprocess_5x5_depthwise=True)
BF16_CFG = dict(compute_dtype="bfloat16", bn_apply_dtype="bfloat16")


def _bf16_inputs(shape, seed=0):
    """x, dy (bf16, JAX) and the taps (bf16 values as fp32 (25, C), JAX)."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jnp.bfloat16)
    dy = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jnp.bfloat16)
    k = jnp.asarray((0.2 * rng.randn(5, 5, 1, c)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    return x, dy, k


@pytest.mark.parametrize("shape,bias,fuse", [
    ((2, 4, 4, 64), True, True),
    ((2, 8, 8, 32), False, True),
    ((1, 5, 7, 16), True, False),
])
def test_plain_bf16_backward_matches_pallas(shape, bias, fuse):
    """The Pallas backward through JAX's custom VJP: with bf16 taps (dx in
    bf16, dW cast to bf16 as ``f_bwd`` casts it) and with the same taps
    widened to fp32 (the same dx, and dW's fp32 sums before the cast)."""
    x, dy, k = _bf16_inputs(shape)
    c = shape[-1]
    f = _make_fused_dw(5, fuse, bias, True)
    b = jnp.asarray(0.1 * np.random.RandomState(1).randn(c), jnp.float32)
    outs = {}
    for name, w2d in (("bf16", k.reshape(25, c)),
                      ("f32", k.reshape(25, c).astype(jnp.float32))):
        _, vjp = jax.vjp(f, x, w2d, b)
        outs[name] = vjp(dy)
    (dx_j, dw16_j, _), (dx32_j, dw32_j, db32_j) = outs["bf16"], outs["f32"]
    assert dx_j.dtype == jnp.bfloat16 and dw16_j.dtype == jnp.bfloat16
    assert bf16_ulps(dx_j, dx32_j).max() == 0

    xt, dyt, kt = _bf16_tensor(x), _bf16_tensor(dy), _bf16_tensor(k)
    dx = tdw.fused_swish_depthwise5x5_dx(dyt, kt, xt if fuse else None,
                                         fuse_swish=fuse)
    assert dx.dtype == BF16
    ulps = bf16_ulps(dx, dx_j)
    assert ulps.max() <= 1 and (ulps == 0).mean() > 0.99, (
        ulps.max(), (ulps == 0).mean())

    dk, db = tdw.fused_swish_depthwise5x5_dw(xt, dyt, fuse_swish=fuse)
    assert dk.dtype == torch.float32 and db.dtype == torch.float32
    want = np.asarray(dw32_j).reshape(5, 5, 1, c)
    scale = float(np.abs(want).max())
    assert float(np.abs(dk.numpy() - want).max()) <= DW_RTOL * scale
    if bias:  # JAX's custom VJP returns zeros for an absent bias
        np.testing.assert_allclose(db.numpy(), np.asarray(db32_j),
                                   atol=DW_RTOL * float(np.abs(db32_j).max()))

    # The Function's backward: dx in x's dtype, dW cast to the taps' dtype,
    # db in fp32; dW's bits equal JAX's wherever the fp32 sums are equal.
    xg = xt.clone().requires_grad_()
    kg = kt.clone().requires_grad_()
    bg = torch.tensor(np.asarray(b)).requires_grad_() if bias else None
    y = tdw.fused_swish_depthwise5x5(xg, kg, bg, fuse_swish=fuse)
    y.backward(dyt)
    assert torch.equal(xg.grad, dx)
    assert kg.grad.dtype == BF16
    assert torch.equal(kg.grad, dk.to(BF16))
    same = torch.from_numpy((dk.numpy() == want).reshape(-1))
    assert same.any()
    got16, want16 = kg.grad.reshape(-1), np.asarray(dw16_j).reshape(-1)
    assert bf16_ulps(got16[same], want16[same.numpy()]).max() == 0
    assert bf16_ulps(got16, want16).max() <= 1
    if bias:
        assert bg.grad.dtype == torch.float32
        assert torch.equal(bg.grad, db)


def _stencil_reversed(g: torch.Tensor, taps: torch.Tensor,
                      round_products: bool = False) -> torch.Tensor:
    """The 25 flipped-tap products of the plain bf16 dx summed in fp32 in
    the reverse order (each product rounded to bf16 first, if asked)."""
    _, h, w, c = g.shape
    gp = torch.nn.functional.pad(g, (0, 0, 2, 2, 2, 2))
    taps = torch.flip(taps, dims=(0, 1)).float().reshape(5, 5, c)
    acc = torch.zeros_like(g)
    for i in reversed(range(5)):
        for j in reversed(range(5)):
            p = gp[:, i:i + h, j:j + w, :] * taps[i, j]
            acc = acc + (p.to(BF16).float() if round_products else p)
    return acc


def _ulp_steps(v: torch.Tensor, n: int) -> torch.Tensor:
    """``v`` moved ``n`` fp32 steps up (n > 0) or down."""
    towards = torch.full_like(v, float("inf") if n > 0 else float("-inf"))
    for _ in range(abs(n)):
        v = torch.nextafter(v, towards)
    return v


def _swish_grad_kernel_way(xf: torch.Tensor, steps: int) -> torch.Tensor:
    """swish'(x) as the bf16 dx kernel takes it, in fp32: sigma =
    rcp.approx.ftz(1 + ex2.approx.ftz(x * -log2(e))), then s * fma(x,
    1 - s, 1).  PTX gives ex2.approx at most 2 ulps and rcp.approx at most
    1 ulp from the rounded results; here both are off by twice that,
    ``2 * steps`` and ``steps`` fp32 steps in the sign of ``steps``."""
    e = _ulp_steps(torch.exp2(xf * -1.4426950408889634), 2 * steps)
    s = _ulp_steps(1.0 / (1.0 + e), steps)
    inner = (xf.double() * (1.0 - s).double() + 1.0).float()  # one rounding
    return s * inner


@pytest.mark.parametrize("h,c", PATH_SHAPES)
def test_bf16_dx_limit_takes_another_sum_order_and_refuses_double_rounding(
        h, c):
    """The card's check of bf16 #3 against its plain version passes the same
    products summed in another fp32 order times swish'(x) by another
    formula, or by the kernel's (its sigmoid from the flush-to-zero ex2 and
    rcp approximations, at twice their error bounds either way), and fails
    swish'(x) rounded to bf16 before the product, and the products rounded
    to bf16 before the sum, with either swish'."""
    g = torch.Generator().manual_seed(h)
    dy = torch.randn(2, h, h, c, generator=g).to(BF16)
    x = torch.randn(2, h, h, c, generator=g).to(BF16)
    k = (0.2 * torch.randn(5, 5, 1, c, generator=g)).to(BF16)
    want = tdw.fused_swish_depthwise5x5_dx_plain(dy, k, x)
    scale = tdw.bf16_dx_scale(dy, k, x)
    xf, df = x.float(), dy.float()
    sig = 1.0 / (1.0 + torch.exp(-xf))
    other = _stencil_reversed(df, k) * (sig + xf * sig * (1.0 - sig))
    swish_rounded = _stencil_reversed(df, k) * tdw._swish_grad(xf).to(
        BF16).float()
    products_rounded = _stencil_reversed(df, k, round_products=True) * (
        tdw._swish_grad(xf))
    kernel_way = [_swish_grad_kernel_way(xf, steps) for steps in (2, -2)]
    cases = [(other, True), (swish_rounded, False), (products_rounded, False)]
    for grad in kernel_way:
        cases += [(_stencil_reversed(df, k) * grad, True),
                  (_stencil_reversed(df, k) * grad.to(BF16).float(), False),
                  (_stencil_reversed(df, k, round_products=True) * grad,
                   False)]
    for got, ok in cases:
        got = got.to(BF16)
        sum_ulps = float(tdw.bf16_sum_ulps(got, want, scale).max())
        equal = float((bf16_ulps(got, want) == 0).mean())
        passes = (sum_ulps <= tdw.BF16_SUM_ULPS
                  and equal >= tdw.BF16_MIN_EQUAL_SHARE)
        assert passes is ok, (sum_ulps, equal)


def _leaves(tree) -> dict:
    """A Flax-shaped tree's leaves by key path, as fp32 numpy arrays."""
    return {jax.tree_util.keystr(path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("apply_dtype", [None, BF16])
def test_batchnorm_training_bf16_matches_flax(apply_dtype):
    """Training-mode BatchNorm on a bf16 input, in Flax's fp32 form
    (``apply_dtype`` None: fp32 output) and in ``_SplitPrecisionBN``'s
    (bf16): output, running statistics, and the gradients of
    ``sum(sin(y))`` in fp32."""
    c = 12
    x = jnp.asarray(_x((3, 4, 4, c))).astype(jnp.bfloat16)
    flax_mod = jb.BatchNorm(jnp.float32 if apply_dtype is None
                            else jnp.bfloat16)
    variables = _variables(flax_mod, x, False)
    port = tb.BatchNorm(c, apply_dtype=apply_dtype)
    port.load_state_dict(state_dict_from_flax(variables, port))
    port.train()

    def loss(params, xs):
        y, mut = flax_mod.apply({**variables, "params": params}, xs, True,
                                mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y.astype(jnp.float32))), (y, mut)

    (_, (want, mut)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], x)
    xt = _bf16_tensor(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = port(xt)
    torch.sin(y.float()).sum().backward()
    got = y.detach().permute(0, 2, 3, 1)
    if apply_dtype is None:
        assert want.dtype == jnp.float32 and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    else:
        assert want.dtype == jnp.bfloat16 and got.dtype == BF16
        ulps = bf16_ulps(got, want)
        assert ulps.max() <= 1 and (ulps == 0).mean() > 0.99
    state = flax_tree_from_state_dict(port.state_dict(), port)
    stats = _leaves(state["batch_stats"])
    for k, ref in _leaves(dict(mut)["batch_stats"]).items():
        assert stats[k].dtype == np.float32
        assert np.abs(stats[k] - ref).max() <= STATS_ATOL * max(
            1.0, np.abs(ref).max()), k
    grads = _leaves(flax_tree_from_state_dict(
        {k: p.grad for k, p in port.named_parameters()}, port)["params"])
    pairs = [(grads[k], ref) for k, ref in _leaves(gp).items()]
    assert len(pairs) == 2
    assert xt.grad.dtype == BF16 and gx.dtype == jnp.bfloat16
    gxt = xt.grad.float().permute(0, 2, 3, 1).numpy()
    gx = np.asarray(gx, np.float32)
    if apply_dtype is None:
        # An fp32 gradient (with cancellation: dy less its means) rounded to
        # x's bf16 once on each side: half a bf16 ulp of the largest each.
        assert np.abs(gxt - gx).max() <= 2.0 ** -8 * np.abs(gx).max()
    else:
        pairs.append((gxt, gx))
    for have, ref in pairs:
        if apply_dtype is None:
            tol = GRAD_ATOL * max(1.0, float(np.abs(ref).max()))
        else:
            tol = BF16_GRAD_RTOL * float(np.abs(ref).max())
        assert np.abs(have - ref).max() <= tol, (np.abs(have - ref).max(), tol)


def test_snconv_forward_mode_training_bf16():
    """Forward spectral mode training in bf16: ``u`` from one fp32 power
    iteration on the fp32 kernel, the normalized kernel cast to bf16 after
    the division (``SNConv`` in ``nvae_tpu/nn/spectral.py``), and the fp32
    weight's gradient through the cast."""
    x = _x((2, 8, 8, 5))
    flax_mod = js.SNConv(6, (3, 3), mode="forward", dtype=jnp.bfloat16)
    variables = _variables(flax_mod, jnp.asarray(x), False)
    port = ts.SNConv(5, 6, 3, mode="forward", dtype=BF16)
    port.load_state_dict(state_dict_from_flax(variables, port))
    port.train()

    def loss(params):
        y, mut = flax_mod.apply({**variables, "params": params},
                                jnp.asarray(x), True, mutable=["spectral"])
        return jnp.sum(jnp.sin(y.astype(jnp.float32))), (y, mut)

    (_, (want, mut)), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    y = port(_to_port(x))
    torch.sin(y.float()).sum().backward()
    assert y.dtype == BF16 and port.weight.grad.dtype == torch.float32
    ulps = bf16_ulps(y.detach().permute(0, 2, 3, 1), want)
    assert ulps.max() <= 2 and (ulps == 0).mean() > 0.9
    u = _leaves(flax_tree_from_state_dict(port.state_dict(), port)[
        "spectral"])
    for k, ref in _leaves(dict(mut)["spectral"]).items():
        np.testing.assert_allclose(u[k], ref, atol=1e-6)
    have = _leaves(flax_tree_from_state_dict(
        {k: p.grad for k, p in port.named_parameters()}, port)["params"])
    for k, ref in _leaves(grads).items():
        # The bias's gradient is a sum of 128 bf16 cotangents, which XLA
        # adds in bf16 (partial sums rounded to 2^-8) and PyTorch in fp32.
        rtol = SUM_BF16_RTOL if k.endswith("'bias']") else BF16_GRAD_RTOL
        err = np.abs(have[k] - ref).max()
        assert err <= rtol * np.abs(ref).max(), (k, err)


def test_fused_op_receives_bf16_in_training(monkeypatch):
    """A bf16 training step hands the fused op bf16 x and taps and an fp32
    bias, and its backward returns bf16 dx, bf16 dW and fp32 db; every
    parameter's gradient is fp32."""
    from nvae_torch.config import TrainConfig
    from nvae_torch.train.state import create_train_state
    from nvae_torch.train.step import make_train_step

    seen = {"fwd": set(), "bwd": set()}
    real_apply = ts.fused_swish_depthwise5x5
    real_dx, real_dw = (tdw.fused_swish_depthwise5x5_dx,
                        tdw.fused_swish_depthwise5x5_dw)

    def apply(x, k, b, fuse_swish):
        seen["fwd"].add((x.dtype, k.dtype, None if b is None else b.dtype))
        return real_apply(x, k, b, fuse_swish=fuse_swish)

    def dx(dy, k, x, fuse_swish=True):
        out = real_dx(dy, k, x, fuse_swish=fuse_swish)
        seen["bwd"].add(("dx", dy.dtype, k.dtype, out.dtype))
        return out

    def dw(x, dy, fuse_swish=True, with_bias=True):
        out = real_dw(x, dy, fuse_swish=fuse_swish, with_bias=with_bias)
        seen["bwd"].add(("dw", x.dtype, dy.dtype, out[0].dtype))
        return out

    monkeypatch.setattr(ts, "fused_swish_depthwise5x5", apply)
    monkeypatch.setattr(tdw, "fused_swish_depthwise5x5_dx", dx)
    monkeypatch.setattr(tdw, "fused_swish_depthwise5x5_dw", dw)
    cfg = tcfg.debug_config(n_groups_per_scale=(1, 1), n_latent_per_group=2,
                            **STEP_CFG, **BF16_CFG)
    tc = TrainConfig(batch_size=4)
    model, state, tx = create_train_state(cfg, tc, 10, device="cpu")
    grads = {}

    def record(updates, s, params=None):
        grads.update(updates)
        return {k: torch.zeros_like(g) for k, g in updates.items()}, s

    step = make_train_step(model, topt.GradientTransformation(
        lambda p: None, record), tc, 10, 5)
    _, m = step(state, np.random.RandomState(0).rand(4, 32, 32, 1) > 0.5)
    assert np.isfinite(float(m["loss"]))
    fp32 = torch.float32
    assert seen["fwd"] <= {(BF16, BF16, fp32), (BF16, BF16, None)}
    assert (BF16, BF16, fp32) in seen["fwd"] and (BF16, BF16, None) in seen[
        "fwd"]
    assert seen["bwd"] == {("dx", BF16, BF16, BF16), ("dw", BF16, BF16, fp32)}
    assert grads and all(g.dtype == fp32 for g in grads.values())
    kernels = [m for m in model.modules() if isinstance(m, ts.DepthwiseConv)]
    assert kernels and all(k.weight.grad is None for k in kernels)


def _port_grad_step(overrides, variables, batch, eps):
    """One step of the port with plain SGD at lr 1 (the harness's "grad"
    optimizer, ``tests/test_torch_train_step``) from a Flax tree, with
    injected noise; returns the new state as a Flax tree and the metrics."""
    tm = TorchNVAE(tcfg.debug_config(**overrides), device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables, tm))
    tm.train()
    tx = _sgd(1.0)
    tc = tcfg.TrainConfig(batch_size=batch.shape[0], step_based_warmup=True)
    state = TorchState(0, 0, tm, None, seed=0)
    state.opt_state = tx.init(state.params())
    _, met = torch_train_step(tm, tx, tc, 100, 50)(state, batch, eps=eps)
    return flax_tree_from_state_dict(tm.state_dict(), tm), met


def _update(params, start) -> np.ndarray:
    """Every parameter's change from ``start``, as one vector."""
    start = _leaves(start)
    return np.concatenate([(v - start[k]).ravel()
                           for k, v in sorted(_leaves(params).items())])


def _distance(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def bf16_steps():
    """One step of the depthwise config in bf16 compute and BatchNorm
    apply, plain SGD at lr 1 (its update is minus the gradient), JAX and
    port from the same weights and noise (one JAX compile for the file),
    and the port's fp32 step on the same inputs."""
    noise = []
    with pytest.MonkeyPatch.context() as mp, single_torch_thread():
        (js_, jmet, port, tmet), = _run(mp, {**STEP_CFG, **BF16_CFG}, {},
                                        "grad", 1, noise=noise)
        start = random_flax_variables(
            JaxNVAE(jcfg.debug_config(**STEP_CFG)), seed=4)
        (batch, eps), = noise
        port32, met32 = _port_grad_step(STEP_CFG, start, batch, eps)
    return {
        "jax": (_update(js_.params, start["params"]), jmet),
        "port": (_update(port["params"], start["params"]), tmet),
        "port32": (_update(port32["params"], start["params"]), met32),
        "port_tree": port, "jax_state": js_,
    }


def test_bf16_step_matches_jax(bf16_steps):
    """The port's bf16 step against JAX's: loss and metrics, the parameter
    update, and the BatchNorm running statistics (fp32, from bf16 inputs)."""
    (upd_j, jmet), (upd_t, tmet) = bf16_steps["jax"], bf16_steps["port"]
    assert set(tmet) == set(jmet)
    for k in ("loss", "reconstruction_loss", "kl_loss"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= LOSS_RTOL * abs(
            float(jmet[k])), k
    assert _distance(upd_t, upd_j) <= STEP_REL_L2, _distance(upd_t, upd_j)
    stats = _leaves(bf16_steps["port_tree"]["batch_stats"])
    for k, ref in _leaves(bf16_steps["jax_state"].batch_stats).items():
        err = np.abs(stats[k] - ref) / np.maximum(1.0, np.abs(ref))
        assert err.max() <= STEP_STATS_ATOL, (k, err.max())


def test_bf16_step_is_bf16_and_no_further_from_fp32_than_jax(bf16_steps):
    """The port's bf16 update lies as far from its fp32 update as JAX's bf16
    update does, within [0.25, 1.5] of that: near 0 would mean the port ran
    fp32 where JAX runs bf16, above 1.5 more rounding than JAX's."""
    upd32 = bf16_steps["port32"][0]
    port = _distance(bf16_steps["port"][0], upd32)
    ref = _distance(bf16_steps["jax"][0], upd32)
    lo, hi = VS_F32_RATIO
    assert lo * ref <= port <= hi * ref, (port, ref)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_generative_cell_training_bf16_matches_flax(use_pallas):
    """A generative residual cell training in bf16 compute and BatchNorm
    apply, with the fused Function (``use_pallas``) and with the plain
    depthwise convolution under autograd (JAX's XLA path in bf16): output
    (2^-5 of its largest), running statistics, and the gradients of
    ``sum(sin(y))``: no further from the Flax cell's fp32 gradients
    (relative L2 over every parameter) than 1.5 times JAX's bf16 ones are,
    and more than 1e-3 from them (bf16 rounding; fp32 lies ~1e-6 away).
    Neither a leaf-wise limit nor the step test's lower bound of 0.25 holds
    here: XLA sums a broadcast bias's bf16 cotangents in bf16 and PyTorch
    in fp32 (measured: the port 1.8% from fp32, JAX 7.3%), and several
    biases feed a training-mode BatchNorm, so their gradients are rounding
    alone."""
    x = jnp.asarray(_x((2, 8, 8, 16))).astype(jnp.bfloat16)
    flax_mod = jb.GenerativeResidualCell(16, use_pallas=use_pallas,
                                         bn_dtype=jnp.bfloat16,
                                         dtype=jnp.bfloat16)
    flax32 = jb.GenerativeResidualCell(16, use_pallas=use_pallas)
    variables = _variables(flax_mod, x, False)
    port = tb.GenerativeResidualCell(16, use_pallas=use_pallas)
    for m in port.modules():
        if isinstance(m, (ts.SNConv, ts.DepthwiseConv, tb.SqueezeExcitation)):
            m.dtype = BF16
        elif isinstance(m, tb.BatchNorm):
            m.apply_dtype = BF16
    port.load_state_dict(state_dict_from_flax(variables, port))
    port.train()

    def grads_of(module, xs):
        def loss(params):
            y, mut = module.apply({**variables, "params": params}, xs, True,
                                  mutable=["batch_stats"])
            return jnp.sum(jnp.sin(y.astype(jnp.float32))), (y, mut)

        (_, aux), g = jax.value_and_grad(loss, has_aux=True)(
            variables["params"])
        return aux, _leaves(g)

    (want, mut), g16 = grads_of(flax_mod, x)
    _, g32 = grads_of(flax32, x.astype(jnp.float32))
    y = port(_bf16_tensor(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last))
    torch.sin(y.float()).sum().backward()
    got = y.detach().permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= 2.0 ** -5 * np.abs(want).max()
    stats = _leaves(flax_tree_from_state_dict(port.state_dict(), port)[
        "batch_stats"])
    for k, ref in _leaves(dict(mut)["batch_stats"]).items():
        assert np.abs(stats[k] - ref).max() <= STEP_STATS_ATOL * max(
            1.0, np.abs(ref).max()), k
    have = _leaves(flax_tree_from_state_dict(
        {k: p.grad for k, p in port.named_parameters()}, port)["params"])
    assert all(v.dtype == np.float32 for v in have.values())

    def vec(leaves):
        return np.concatenate([leaves[k].ravel() for k in sorted(g32)])

    port_d = _distance(vec(have), vec(g32))
    jax_d = _distance(vec(g16), vec(g32))
    assert 1e-3 < port_d <= VS_F32_RATIO[1] * jax_d, (port_d, jax_d)


def test_bf16_step_accumulates_and_freezes_norm_as_fp32_does():
    """``grad_accum`` 2 in bf16: the step's gradient is the mean of its two
    microbatches' gradients (each its own bf16 step from the same state,
    noise and BatchNorm statistics chained through them); and
    ``parity_frozen_norm`` in bf16 runs BatchNorm in eval mode inside the
    step: every buffer keeps its bits, the gradients are finite."""
    from nvae_torch.models.nvae import posterior_noise_shapes
    from nvae_torch.train.state import create_train_state

    cfg = tcfg.debug_config(n_groups_per_scale=(1, 1), n_latent_per_group=2,
                            spectral_mode="forward", **STEP_CFG, **BF16_CFG)
    rng = np.random.RandomState(0)
    batch = (rng.rand(8, 32, 32, 1) > 0.5).astype(np.float32)
    eps = [[rng.randn(*s).astype(np.float32)
            for s in posterior_noise_shapes(cfg, 4)] for _ in range(2)]

    def step(train_overrides, x, noise, model_state=None):
        tc = tcfg.TrainConfig(batch_size=x.shape[0], **train_overrides)
        model, state, _ = create_train_state(cfg, tc, 10, device="cpu",
                                             seed=1)
        if model_state is not None:
            model.load_state_dict(model_state)
        grads = {}

        def record(updates, s, params=None):
            grads.update({k: g.clone() for k, g in updates.items()})
            return {k: torch.zeros_like(g) for k, g in updates.items()}, s

        tx = topt.GradientTransformation(lambda p: None, record)
        torch_train_step(model, tx, tc, 10, 5)(state, x, eps=noise)
        return grads, {k: v.clone() for k, v in model.state_dict().items()}

    both, _ = step(dict(grad_accum=2), batch, eps)
    first, after = step({}, batch[:4], eps[:1])
    # The second microbatch starts from the buffers the first left.
    second, _ = step({}, batch[4:], eps[1:], model_state=after)
    for k, g in both.items():
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, (first[k] + second[k]) / 2,
                                   rtol=1e-5, atol=1e-5 * float(
                                       g.abs().max()) + 1e-30)

    start = {k: v.clone() for k, v in TorchNVAE(
        cfg, device="cpu", seed=1).state_dict().items()}
    grads, end = step(dict(parity_frozen_norm=True), batch[:4], eps[:1])
    assert all(torch.isfinite(g).all() for g in grads.values())
    for k, v in start.items():
        if k in end and not any(p == k for p in grads):  # buffers
            assert torch.equal(end[k], v), k
