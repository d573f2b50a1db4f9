"""Each ported block against its Flax module on the same weights, in eval
mode and, for the blocks the training step runs, in training mode.

The Flax variables come from ``jax.eval_shape`` of the module's init, filled
from ``np.random.RandomState`` (random biases, BatchNorm scales and running
statistics included), and reach the port through ``nvae_torch.convert``.
Inputs are NHWC numpy for JAX and the same values as NCHW channels_last
tensors for the port.  In training mode the comparison covers the output,
the updated running statistics (and spectral ``u``), and the gradients of
``sum(sin(y))`` with respect to every input and parameter, mapped back to
the Flax tree by ``flax_tree_from_state_dict``.  Tolerance: atol 1e-5 (fp32,
different summation order), on gradients after dividing by
``max(1, max |JAX gradient|)`` over all of the block's parameters (or over
the input): a parameter's gradient sums over the batch and the plane, and
the bias of a convolution that feeds a training-mode BatchNorm has a true
gradient of 0, so its computed value is rounding noise of that scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from nvae_torch.nn import blocks as tb
from nvae_torch.nn import spectral as ts
from nvae_tpu.nn import blocks as jb
from nvae_tpu.nn import spectral as js
from tests.test_torch_trainer import single_torch_thread


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_module():
    """One intra-op thread for the module's tests and its module-scoped
    fixtures (``tests/test_torch_trainer.py``'s ``single_torch_thread``)."""
    with single_torch_thread():
        yield


ATOL = 1e-5


def _variables(module, *inputs, seed=0):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *inputs)
    )
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name in ("sn_kernel", "dw_kernel", "kernel"):
            rf = int(np.prod(shape[:-2]))
            lim = np.sqrt(6.0 / (rf * shape[-2] + rf * shape[-1]))
            a = rng.uniform(-lim, lim, shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "u":
            a = rng.randn(*shape)
            a = a / np.linalg.norm(a)
        else:  # biases, running means
            a = 0.1 * rng.randn(*shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _to_port(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last
    )


def _check(flax_mod, port_mod, inputs, *extra):
    """Load the Flax weights into ``port_mod`` and compare outputs."""
    variables = _variables(flax_mod, *map(jnp.asarray, inputs), *extra)
    port_mod.load_state_dict(state_dict_from_flax(variables, port_mod))
    port_mod.eval()
    want = flax_mod.apply(variables, *map(jnp.asarray, inputs), *extra)
    with torch.no_grad():
        got = port_mod(*map(_to_port, inputs)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("mode", ["projection", "forward", "penalty", "none"])
@pytest.mark.parametrize("k,bias", [(3, True), (1, False), (5, True)])
def test_snconv(mode, k, bias):
    _check(
        js.SNConv(6, (k, k), use_bias=bias, mode=mode),
        ts.SNConv(5, 6, k, use_bias=bias, mode=mode),
        [_x((2, 8, 8, 5))], False,
    )


@pytest.mark.parametrize("bias", [True, False])
def test_depthwise_conv_unfused(bias):
    _check(js.DepthwiseConv(use_bias=bias),
           ts.DepthwiseConv(16, use_bias=bias), [_x((2, 8, 8, 16))])


def test_batchnorm_running_stats():
    _check(jb.BatchNorm(), tb.BatchNorm(12), [_x((3, 4, 4, 12))], False)


@pytest.mark.parametrize("c", [32, 128])
def test_squeeze_excitation(c):
    _check(jb.SqueezeExcitation(16), tb.SqueezeExcitation(c, 16),
           [_x((2, 4, 4, c))])


def test_rescaler_up():
    _check(jb.Rescaler(8, 2, up=True), tb.Rescaler(16, 8, 2),
           [_x((2, 4, 4, 16))], False)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_generative_residual_cell(use_pallas):
    _check(
        jb.GenerativeResidualCell(16, use_pallas=use_pallas),
        tb.GenerativeResidualCell(16, use_pallas=use_pallas),
        [_x((2, 8, 8, 16))], False,
    )


def test_decoder_sample_combiner():
    _check(jb.DecoderSampleCombiner(12), tb.DecoderSampleCombiner(8, 4, 12),
           [_x((2, 4, 4, 8)), _x((2, 4, 4, 4), seed=2)], False)


@pytest.mark.parametrize("emit_preact", [True, False])
def test_conv_bn_swish(emit_preact):
    _check(
        jb.ConvBNSwish(12, (5, 5), emit_preact=emit_preact),
        tb.ConvBNSwish(6, 12, 5, emit_preact=emit_preact),
        [_x((2, 8, 8, 6))], False,
    )


@pytest.mark.parametrize("depthwise", [False, True])
@pytest.mark.parametrize("upscale", [True, False])
def test_postprocess_cell(depthwise, upscale):
    in_ch = 16 if upscale else 8
    _check(
        jb.PostprocessCell(8, upscale=upscale, depthwise_5x5=depthwise,
                           use_pallas=True),
        tb.PostprocessCell(in_ch, 8, upscale=upscale, depthwise_5x5=depthwise,
                           use_pallas=True),
        [_x((2, 8, 8, in_ch))], False,
    )


def _leaves_close(port_tree, jax_tree, what, scale=False):
    flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    denom = 1.0
    if scale:
        denom = max([1.0] + [float(np.abs(np.asarray(w)).max())
                             for _, w in flat])
    for path, want in flat:
        have = port_tree
        for k in path:
            have = have[k.key]
        want = np.asarray(want)
        np.testing.assert_allclose(have / denom, want / denom, atol=ATOL,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _check_train(flax_mod, port_mod, inputs):
    """Training mode: output, new running statistics / ``u``, and the
    gradients of ``sum(sin(y))`` against Flax with mutable collections."""
    variables = _variables(flax_mod, *map(jnp.asarray, inputs), False)
    port_mod.load_state_dict(state_dict_from_flax(variables, port_mod))
    port_mod.train()
    mutable = [c for c in ("batch_stats", "spectral") if c in variables]

    def loss(params, *xs):
        y, mut = flax_mod.apply({**variables, "params": params}, *xs, True,
                                mutable=mutable)
        return jnp.sum(jnp.sin(y)), (y, mut)

    argnums = tuple(range(len(inputs) + 1))
    (_, (want, mut)), grads = jax.value_and_grad(
        loss, argnums=argnums, has_aux=True,
    )(variables["params"], *map(jnp.asarray, inputs))
    xs = [_to_port(x).requires_grad_() for x in inputs]
    y = port_mod(*xs)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=ATOL)
    state = flax_tree_from_state_dict(port_mod.state_dict(), port_mod)
    for coll in mutable:
        _leaves_close(state[coll], dict(mut)[coll], coll)
    param_grads = flax_tree_from_state_dict(
        {k: p.grad for k, p in port_mod.named_parameters()}, port_mod)
    _leaves_close(param_grads["params"], grads[0], "grad", scale=True)
    for x, g in zip(xs, grads[1:]):
        _leaves_close({"x": x.grad.permute(0, 2, 3, 1).numpy()},
                      {"x": g}, "input grad", scale=True)


@pytest.mark.parametrize("block", [
    "batchnorm", "stem", "stem_down", "factorized_down", "encoder_cell",
    "rescaler_down", "enc_dec_combiner",
])
def test_block_training_mode(block):
    flax_mod, port_mod, shapes = {
        "batchnorm": (jb.BatchNorm(), tb.BatchNorm(12), [(3, 4, 4, 12)]),
        "stem": (jb.StemCell(8), tb.StemCell(8, 8), [(2, 8, 8, 8)]),
        "stem_down": (jb.StemCell(16, downsample=True),
                      tb.StemCell(8, 16, downsample=True), [(2, 16, 16, 8)]),
        "factorized_down": (jb.FactorizedDownsample(16),
                            tb.FactorizedDownsample(8, 16), [(2, 16, 16, 8)]),
        "encoder_cell": (jb.EncoderResidualCell(16),
                         tb.EncoderResidualCell(16), [(2, 8, 8, 16)]),
        "rescaler_down": (jb.Rescaler(32, 2, up=False),
                          tb.Rescaler(16, 32, 2, up=False), [(2, 8, 8, 16)]),
        "enc_dec_combiner": (jb.EncDecCombiner(12), tb.EncDecCombiner(8, 12),
                             [(2, 4, 4, 12), (2, 4, 4, 8)]),
    }[block]
    _check_train(flax_mod, port_mod,
                 [_x(s, seed=i + 1) for i, s in enumerate(shapes)])


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2)])
def test_snconv_forward_mode_training(k, stride):
    """Forward spectral mode while training: the stored ``u`` takes the new
    estimate, sigma comes from the old one, and the gradient treats ``u``
    and ``v`` as constants (JAX's stop_gradient)."""
    _check_train(
        js.SNConv(6, (k, k), strides=(stride, stride), mode="forward"),
        ts.SNConv(5, 6, k, mode="forward", stride=stride),
        [_x((2, 8, 8, 5))],
    )
