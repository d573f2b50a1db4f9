"""The mixture-of-logistics (DML) head of the RGB presets against the JAX
package, on the CPU at debug size: the likelihood's math and gradient, the
head's channel order, a whole training step,
sampling, reconstruction and the IWAE NLL of a DML model; and the depthwise
kernels' launch geometry at the shapes the ``cifar10_dml`` and ``celeba64``
presets give them.

Weights are random, from numpy, in the Flax tree, converted by
``nvae_torch.convert``.  Noise is JAX's own, injected into the port: the
posterior and prior Gaussians recorded from ``jax.random.normal``, the
logistic uniforms from ``jax.random.uniform``, and the component choice as
the Gumbel noise of ``jax.random.categorical``, drawn on JAX's own keys.

Tolerances (fp32 on both sides):

- DML math: log-probabilities at rtol 1e-5 + atol 1e-5 (the same formulas;
  values up to ~60 nats), their gradient at atol 1e-5 of the largest
  |gradient|, the mean and the draw at atol 1e-6;
- the model's outputs (logits, images, ``z``) at atol 1e-4, as
  ``tests/test_torch_sampler.py`` (other summation orders in the
  convolutions);
- the SGD step at lr 1e-5: metrics at rtol 1e-5 (the gradient's norm at
  1e-4, see ``GRAD_NORM_RTOL``), parameters at atol 1e-6,
  BatchNorm statistics at 3e-5 of ``max(1, |value|)``, as
  ``tests/test_torch_train_step.py``; the NLL at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvae_torch import config as tcfg
from nvae_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from nvae_torch.eval.nll import make_nll_fn
from nvae_torch.kernels import depthwise as tdw
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.models.nvae import decoder_noise_shapes
from nvae_torch.nn.spectral import sn_kernel_names
from nvae_torch.ops import dml_log_prob, dml_mean, dml_sample
from nvae_torch.train import optim as topt
from nvae_torch.train.state import TrainState as TorchState
from nvae_torch.train.step import make_train_step as torch_train_step
from nvae_tpu import config as jcfg
from nvae_tpu.eval.nll import make_nll_fn as jax_make_nll_fn
from nvae_tpu.models import NVAE as JaxNVAE
from nvae_tpu.ops import math as jmath
from nvae_tpu.train.optim import spectral_projection as jax_projection
from nvae_tpu.train.state import TrainState as JaxState
from nvae_tpu.train.step import make_train_step as jax_train_step
from tests.test_torch_sampler import random_flax_variables
from tests.test_torch_train_step import (
    BN_STATS_TOL,
    _check_metrics,
    _max_err,
    _sgd,
)
from tests.test_torch_trainer import single_torch_thread

ATOL = 1e-4
N_MIX = 4
DML = dict(likelihood="dml", in_channels=3, n_mix=N_MIX,
           use_pallas_kernels=True)
TOTAL_STEPS, STEPS_PER_EPOCH, SGD_LR = 100, 50, 1e-5
# The gradient's norm sums the squares of every leaf, the largest of them
# sums over 4 x 32 x 32 pixels of three channels' log-likelihoods: the two
# frameworks' summation orders put it 2.1e-5 apart (measured, first step).
GRAD_NORM_RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    with single_torch_thread():
        yield


def rgb_batch(n, size=32, seed=0):
    """RGB images on the 256 levels the data pipeline gives, edges
    included."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, size, size, 3)) / 255.0).astype(
        np.float32)


def models(overrides, seed=0):
    """(JAX model, Flax variables as numpy, the port model on the CPU)."""
    jm = JaxNVAE(jcfg.debug_config(**overrides))
    variables = random_flax_variables(jm, seed=seed)
    tm = TorchNVAE(tcfg.debug_config(**overrides), device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables, tm))
    return jm, variables, tm


def run_steps(overrides, n_steps, batch_size=4, seed=4, variants=({},)):
    """``n_steps`` SGD (lr 1e-5) + spectral projection steps of the JAX
    package's ``make_train_step`` and of the port's, from the same weights,
    on the same RGB batches and posterior noise.  The port runs once per
    entry of ``variants``, each overriding its config (remat off, say).
    Returns per step ``(jax_state, jax_metrics, [(port_tree,
    port_metrics) per variant])``, every port tree carrying the Flax names
    of ``overrides``' model, and the Flax variables they started from."""
    jm, variables, named = models(overrides, seed=seed)
    tc_j = jcfg.TrainConfig(batch_size=batch_size, step_based_warmup=True,
                            binary=False)
    tc_t = tcfg.TrainConfig(batch_size=batch_size, step_based_warmup=True,
                            binary=False)
    ports = []
    for v in variants:
        tm = TorchNVAE(tcfg.debug_config(**{**overrides, **v}), device="cpu")
        tm.load_state_dict(named.state_dict())
        tm.train()
        tx_t = topt.chain(_sgd(SGD_LR),
                          topt.spectral_projection(sn_kernel_names(tm)))
        ts = TorchState(0, 0, tm, None, seed=0)
        ts.opt_state = tx_t.init(ts.params())
        ports.append([tm, ts, torch_train_step(tm, tx_t, tc_t, TOTAL_STEPS,
                                                STEPS_PER_EPOCH)])
    tx_j = optax.chain(optax.sgd(SGD_LR), jax_projection())
    params = variables["params"]
    js = JaxState(step=jnp.zeros((), jnp.int32),
                  epoch=jnp.zeros((), jnp.int32), params=params,
                  batch_stats=variables["batch_stats"],
                  spectral=variables.get("spectral", {}),
                  opt_state=tx_j.init(params), rng=jax.random.PRNGKey(7))
    step_j = jax_train_step(jm, tx_j, tc_j, TOTAL_STEPS, STEPS_PER_EPOCH,
                            donate=False)
    draws, real_normal = [], jax.random.normal

    def normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        jax.debug.callback(lambda v: draws.append(np.array(v, copy=True)),
                           out, ordered=True)
        return out

    out = []
    for i in range(n_steps):
        batch = rgb_batch(batch_size, seed=10 + i)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax.random, "normal", normal)
            js, jmet = step_j(js, batch)
            jax.effects_barrier()
        assert len(draws) == named.cfg.n_total_groups
        eps = list(draws)
        draws.clear()
        results = []
        for port in ports:
            tm, ts, step_t = port
            port[1], tmet = step_t(ts, batch, eps=[eps])
            results.append((flax_tree_from_state_dict(tm.state_dict(), named),
                            tmet))
        out.append((js, jmet, results))
    return out, variables


def check_step(js, jmet, port, tmet, what):
    """The port's step against JAX's, to the module's tolerances."""
    _check_metrics({k: v for k, v in tmet.items() if k != "grad_norm"},
                   {k: v for k, v in jmet.items() if k != "grad_norm"},
                   rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=GRAD_NORM_RTOL)
    err, where = _max_err(port["params"], js.params)
    assert err <= 1e-6, (what, "params", err, where)
    err, where = _max_err(port["batch_stats"], js.batch_stats, scale=True)
    assert err <= BN_STATS_TOL, (what, "batch_stats", err, where)
    if js.spectral:
        err, where = _max_err(port["spectral"], js.spectral)
        assert err <= 1e-6, (what, "u", err, where)


# ---- the math ---------------------------------------------------------------


def dml_inputs(b=2, h=5, w=6, c=3, k=N_MIX, seed=0):
    """Head outputs spanning the three branches, and levels including the
    two edges: log-scales in [-9, 1] (the clamp at -7 included), so that
    some bins hold less than 1e-5 of a component's mass."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, h, w, k)
    means = rng.uniform(-1.2, 1.2, (b, h, w, k, c))
    log_scales = rng.uniform(-9.0, 1.0, (b, h, w, k, c))
    params = np.concatenate(
        [logits, np.stack([means, log_scales], axis=-3).reshape(b, h, w, -1)],
        axis=-1).astype(np.float32)
    x = (rng.randint(0, 256, (b, h, w, c)) / 255.0).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 0, 1] = 1.0
    return params, x


def test_dml_log_prob_and_gradient_match_jax():
    params, x = dml_inputs()
    # The inputs reach every branch: both edges, and the bins whose mass
    # is above and at or below 1e-5.
    _, means, log_scales = jmath._split_dml_params(jnp.asarray(params), 3,
                                                   N_MIX)
    xs = np.asarray(x)[..., None, :] * 2 - 1
    inv = np.exp(-np.asarray(log_scales))
    cen = xs - np.asarray(means)
    with np.errstate(over="ignore"):
        delta = (1 / (1 + np.exp(-inv * (cen + 1 / 255)))
                 - 1 / (1 + np.exp(-inv * (cen - 1 / 255))))
    mid = (xs > -0.999) & (xs < 0.999)
    assert (xs < -0.999).any() and (xs > 0.999).any()
    assert (mid & (delta > 1e-5)).any() and (mid & (delta <= 1e-5)).any()
    assert (np.asarray(log_scales) == -7.0).any()

    want = jmath.dml_log_prob(jnp.asarray(params), jnp.asarray(x), N_MIX)
    p = torch.from_numpy(params).requires_grad_()
    got = dml_log_prob(p, torch.from_numpy(x), N_MIX)
    assert got.shape == (2, 5, 6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    weights = np.random.RandomState(1).rand(2, 5, 6).astype(np.float32)
    (got * torch.from_numpy(weights)).sum().backward()
    grad = jax.grad(lambda q: jnp.sum(
        jmath.dml_log_prob(q, jnp.asarray(x), N_MIX) * weights))(
        jnp.asarray(params))
    assert np.isfinite(p.grad.numpy()).all()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad), rtol=0,
                               atol=1e-5 * float(np.abs(grad).max()))


def test_dml_mean_and_sample_match_jax():
    params, _ = dml_inputs(seed=2)
    np.testing.assert_allclose(
        dml_mean(torch.from_numpy(params), N_MIX, 3).numpy(),
        np.asarray(jmath.dml_mean(jnp.asarray(params), N_MIX, 3)), atol=1e-6)
    key = jax.random.PRNGKey(3)
    want = jmath.dml_sample(jnp.asarray(params), key, N_MIX, 3)
    # JAX's draws on its own split keys: categorical is the argmax of the
    # logits plus Gumbel noise of the key.
    k_mix, k_log = jax.random.split(key)
    gumbel = np.asarray(jax.random.gumbel(k_mix, params.shape[:-1] + (N_MIX,)))
    uniform = np.asarray(jax.random.uniform(
        k_log, params.shape[:-1] + (3,), minval=1e-5, maxval=1.0 - 1e-5))
    mix = np.asarray(jax.random.categorical(k_mix, params[..., :N_MIX]))
    assert (np.argmax(params[..., :N_MIX] + gumbel, -1) == mix).all()
    got = dml_sample(torch.from_numpy(params), N_MIX, 3, gumbel=gumbel,
                     uniform=uniform)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # From a generator: in [0, 1], and the same seed draws the same.
    a = dml_sample(torch.from_numpy(params), N_MIX, 3,
                   generator=torch.Generator().manual_seed(0))
    b = dml_sample(torch.from_numpy(params), N_MIX, 3,
                   generator=torch.Generator().manual_seed(0))
    assert a.shape == (2, 5, 6, 3) and torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    with pytest.raises(ValueError, match="channels"):
        dml_mean(torch.from_numpy(params), N_MIX + 1, 3)
    with pytest.raises(ValueError, match="gumbel has shape"):
        dml_sample(torch.from_numpy(params), N_MIX, 3, gumbel=gumbel[0])


def test_head_splits_in_jax_channel_order():
    """The head's 70 (here 28) channels, NHWC, split as JAX splits them:
    with a zero kernel and distinct biases every pixel's logits are the
    biases in order, and the greyscale image is JAX's mixture mean of
    that vector, not of a permutation of it."""
    tm = TorchNVAE(tcfg.debug_config(**DML), device="cpu", seed=1)
    head = tm.postprocess.head
    n_out = N_MIX * (1 + 2 * 3)
    assert head.weight.shape[0] == n_out
    bias = np.random.RandomState(0).randn(n_out).astype(np.float32)
    with torch.no_grad():
        head.weight.zero_()
        head.bias.copy_(torch.from_numpy(bias))
    x = rgb_batch(2, seed=3)
    out = tm(x, generator=torch.Generator().manual_seed(0))
    assert out.logits.shape == (2, 32, 32, n_out)
    assert (out.logits == torch.from_numpy(bias)).all()
    want = jmath.dml_mean(jnp.asarray(np.broadcast_to(bias, (2, 32, 32,
                                                             n_out))),
                          N_MIX, 3)
    got = tm.reconstruct(x, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---- the model --------------------------------------------------------------


@pytest.fixture(scope="module")
def dml_step():
    """Two SGD steps of the debug DML model, JAX's and the port's."""
    return run_steps(DML, 2)


def test_dml_train_step_matches_jax(dml_step):
    """``debug_config(likelihood="dml", in_channels=3, n_mix=4,
    use_pallas_kernels=True)`` (``tests/test_train.py``'s DML step): loss,
    metrics, the parameters after the update (which track the gradient at
    this learning rate) and the BatchNorm statistics, step by step."""
    steps, variables = dml_step
    for i, (js, jmet, [(port, tmet)]) in enumerate(steps):
        check_step(js, jmet, port, tmet, f"step {i}")
        assert np.isfinite(float(tmet["loss"]))
    # The step moved the head, in Flax's channel order.
    _, _, [(port, _)] = steps[0]
    head = ("postprocess", "SNConv_0", "sn_kernel")
    before = variables["params"]
    for k in head:
        before = before[k]
    moved = port["params"]
    for k in head:
        moved = moved[k]
    assert moved.shape[-1] == N_MIX * 7 and not np.allclose(moved, before)


def _record_sample(monkeypatch, fn):
    """Run ``fn()`` un-jitted with JAX's Gaussian and uniform draws
    recorded, and ``categorical`` replaced by what it computes (the argmax
    of the logits plus the key's Gumbel noise) with the noise recorded."""
    normals, uniforms, gumbels = [], [], []
    real_normal, real_uniform = jax.random.normal, jax.random.uniform
    real_categorical = jax.random.categorical

    def normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        normals.append(np.asarray(out))
        return out

    def uniform(*args, **kwargs):
        out = real_uniform(*args, **kwargs)
        uniforms.append(np.asarray(out))
        return out

    def categorical(key, logits, axis=-1):
        g = jax.random.gumbel(key, logits.shape, logits.dtype)
        gumbels.append(np.asarray(g))
        out = jnp.argmax(logits + g, axis=axis)
        assert (np.asarray(out) == np.asarray(
            real_categorical(key, logits, axis))).all()
        return out

    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal", normal)
        m.setattr(jax.random, "uniform", uniform)
        m.setattr(jax.random, "categorical", categorical)
        out = fn()
    return out, normals, uniforms, gumbels


@pytest.mark.parametrize("greyscale", [True, False])
def test_dml_sample_matches_jax(monkeypatch, greyscale):
    """``NVAE.sample`` of a DML model: the mixture's mean, or a draw with
    the component's Gumbel noise and the logistic uniforms injected."""
    jm, variables, tm = models(DML, seed=1)
    (images, last_s, z1, z2), normals, uniforms, gumbels = _record_sample(
        monkeypatch, lambda: jm.apply(
            variables, 3, 0.8, greyscale, method=JaxNVAE.sample,
            rngs={"sample": jax.random.PRNGKey(5)}))
    assert [e.shape for e in normals] == decoder_noise_shapes(tm.cfg, 3)
    if greyscale:
        assert not uniforms and not gumbels
        got = tm.sample(3, 0.8, True, eps=normals)
    else:
        assert [u.shape for u in uniforms] == [(3, 32, 32, 3)]
        assert [g.shape for g in gumbels] == [(3, 32, 32, N_MIX)]
        got = tm.sample(3, 0.8, False, eps=normals, uniform=uniforms[0],
                        gumbel=gumbels[0])
    for want, have in zip((images, last_s, z1, z2), got):
        assert have.shape == want.shape
        np.testing.assert_allclose(have.numpy(), np.asarray(want), atol=ATOL)
    if not greyscale:  # without injection, from the generator
        a = tm.sample(3, 0.8, False,
                      generator=torch.Generator().manual_seed(2))[0]
        assert a.shape == (3, 32, 32, 3)
        assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_dml_reconstruct_and_sample_with_z_match_jax(monkeypatch):
    jm, variables, tm = models(DML, seed=2)
    x = rgb_batch(3, seed=4)
    want, normals, _, _ = _record_sample(monkeypatch, lambda: jm.apply(
        variables, x, rngs={"sample": jax.random.PRNGKey(5)},
        method=JaxNVAE.reconstruct))
    got = tm.reconstruct(torch.from_numpy(x), eps=normals)
    assert got.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    _, s, z, _ = (t.numpy() for t in tm.sample(
        2, 1.0, generator=torch.Generator().manual_seed(0)))
    want = jm.apply(variables, z, s, method=JaxNVAE.sample_with_z,
                    rngs={"sample": jax.random.PRNGKey(0)})
    np.testing.assert_allclose(tm.sample_with_z(z, s).numpy(),
                               np.asarray(want), atol=ATOL)


def test_dml_iwae_nll_matches_jax(monkeypatch):
    """The IWAE NLL of a DML model (K=2, JAX's ``crop=2`` kept for RGB)."""
    jm, variables, tm = models(DML, seed=3)
    x = rgb_batch(4, seed=5)
    k = 2
    draws, real_normal = [], jax.random.normal

    def normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        jax.debug.callback(lambda v: draws.append(np.array(v, copy=True)),
                           out, ordered=True)
        return out

    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal", normal)
        want = jax_make_nll_fn(jm, n_attempts=k, crop=2)(
            variables, x, jax.random.PRNGKey(4))
        jax.block_until_ready(want)
        jax.effects_barrier()
    g = tm.cfg.n_total_groups
    assert len(draws) == k * g
    tm.train()
    got = make_nll_fn(tm, n_attempts=k, crop=2)(
        torch.from_numpy(x), eps=[draws[i * g:(i + 1) * g] for i in range(k)])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---- the kernels' geometry at the RGB presets' shapes -----------------------

# (batch, H, C) of kernels #2-#4 on the DML presets' paths: the decoder's
# generative cells and the depthwise postprocess, at the training batch
# (cifar10_dml 128, celeba64 64), a sample call of 144, the CLI's sample
# sweep (4 x the batch), the --mode test P&R halves (half the batch), the
# trainer's sample and reconstruction hooks (12, 3) and the card vs CPU
# checks (4).
CIFAR_SHAPES = ((4, 2304), (8, 1152), (16, 576), (32, 288))
CELEBA_SHAPES = ((4, 4608), (8, 2304), (16, 1152), (32, 576), (64, 288))
PRESET_SHAPES = [
    (n, h, c) for shapes, b in ((CIFAR_SHAPES, 128), (CELEBA_SHAPES, 64))
    for h, c in shapes for n in sorted({b, 144, 4 * b, b // 2, 12, 4, 3})
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["fwd", "dx", "dw"])
def test_geometry_at_the_rgb_preset_shapes(kind, dtype):
    """Every RGB path shape has a geometry, in every kind and dtype, none
    raising: the grid covers each (batch row, channel chunk) once, the ring
    fits a block, the C entry's checks pass on the shape; the widest
    plane, 64 columns at 64x64, among them."""
    for n, h, c in PRESET_SHAPES:
        shape = (n, h, h, c)
        geo = tdw.geometry(kind, shape, dtype)
        covered = sorted((k, r) for i in range(geo.blocks)
                         for k in geo.block_chunks(i)
                         for r in geo.batch_rows(i % geo.blocks_per_chunk))
        assert covered == [(k, r) for k in range(-(-c // 32))
                           for r in range(n)], shape
        if dtype == "bfloat16":  # the sliding-row kernel
            assert geo.smem_bytes == tdw._bf16_smem_bytes(
                kind, h, geo.slots_per_pass, geo.ahead,
                geo.chunks_per_block) <= tdw._MAX_SMEM
            assert geo.threads <= 1024  # more waves than one, by design
        else:
            assert geo.smem_bytes == tdw._smem_bytes(
                kind, h, geo.slots_per_pass, geo.ahead) <= tdw._MAX_SMEM
            per_sm = min(4, 233_472 // (geo.smem_bytes + 1024))
            assert geo.blocks <= max(132 * per_sm, geo.groups), shape
        dt = getattr(torch, dtype)
        x = torch.empty(shape, device="meta", dtype=dt)
        taps = (None if kind == "dw"
                else torch.empty(5, 5, 1, c, device="meta", dtype=dt))
        tdw._check(x, taps, None, x, kind=kind)
    assert max(h for _, h, _ in PRESET_SHAPES) == 64
