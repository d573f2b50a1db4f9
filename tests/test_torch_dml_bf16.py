"""bf16 training and sampling of a mixture-of-logistics (DML) model against
the JAX package, on the CPU at debug size: ``likelihood="dml"``, 3
channels, ``compute_dtype`` and ``bn_apply_dtype`` bfloat16 (the RGB
presets' head in the port's bf16 form).

Weights are random, from numpy, in the Flax tree (``nvae_torch.convert``);
the batches are RGB images on 256 levels from a numpy seed; the noise is
JAX's own, injected into the port (``tests/test_torch_dml.py``'s
recording: the Gaussians of ``jax.random.normal``, the logistic uniforms,
the component's Gumbel noise).

- One training step with plain SGD at lr 1 (its update is minus the
  gradient, so the update holds every gradient), at
  ``tests/test_torch_bf16_train.py``'s limits for the bf16 step where they
  apply: loss and reconstruction loss within ``LOSS_RTOL``, the gradient's
  norm within ``STEP_REL_L2``, the BatchNorm running statistics within
  ``STEP_STATS_ATOL`` of ``max(1, |value|)``.  The KL (``kl_loss``,
  ``kl_raw``; beta is 0 on the first step, so neither the loss nor the
  gradient holds any of it) within ``KL_RTOL``: a sum dominated by the
  latents with the smallest prior sigma, whose bf16 rounding moves
  1/sigma^2 by percents; over 8 seeds of weights and batch the two bf16
  KLs lay 0.66-5.3% apart and each 0.06-4.6% from JAX's fp32 KL.
- Every gradient against JAX's fp32 step on the same inputs, not against
  JAX's bf16 step: XLA on the CPU sums B x H x W bf16 terms in bf16, so
  JAX's bf16 update lies 0.70-0.76 (relative L2) from its fp32 update on
  the biases, up to 1.4-4.7 on single leaves at full resolution (the
  postprocess cells' convolution kernels and BatchNorm scales) and
  0.06-0.24 on the other leaves together; the port sums in fp32 and lies
  0.07-0.12 from it.  Against JAX's bf16 update the port's other leaves
  lay 0.10-0.20 apart, past ``STEP_REL_L2`` on some seeds, for JAX's
  error.  So, as measured over 8 seeds: the leaves but the biases and the
  squeeze-excitation ones within ``STEP_REL_L2`` together and each within
  ``LEAF_RTOL`` (measured at most 0.22); the squeeze-excitation leaves
  (small gradients that cancel, sums over the plane of ``dy * x``: the
  two bf16 gradients up to 1.08 and 1.55 from fp32) together no further
  from fp32 than ``VS_F32_RATIO[1]`` times JAX's bf16 (measured
  at most 1.06 times); the biases together within ``PORT_BIAS_RTOL`` of
  fp32 (measured 0.009-0.028), at least ``BF16_FLOOR`` from it (a silent
  fp32 path sits at 4e-6) and no further than ``VS_F32_RATIO[1]`` times
  JAX's bf16; and the cause asserted: JAX's head bias gradient far from
  its fp32 sum, the port's not.
- One bf16 sample call, the mixture's mean (``dml_mean``) and a draw
  (``dml_sample``) on the same uniforms and Gumbel noise: the mean within
  ``tests/test_torch_bf16.py``'s ``PROB_ATOL``; the draw within it at all
  but ``DRAW_FLIP_SHARE`` of the pixels, where bf16 head outputs a rounding
  apart pick another component (an argmax over near ties).
- The IWAE NLL's posterior passes (K=2) within ``LOSS_RTOL``.

The JAX bf16 step is compiled once for the file (a module-scoped
fixture), as in ``tests/test_torch_bf16_train.py``.
"""

import jax
import numpy as np
import pytest
import torch

from nvae_torch import config as tcfg
from nvae_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from nvae_torch.eval.nll import make_nll_fn
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_tpu import config as jcfg
from nvae_tpu.eval.nll import make_nll_fn as jax_make_nll_fn
from nvae_tpu.models import NVAE as JaxNVAE
from tests.test_torch_bf16 import PROB_ATOL
from tests.test_torch_bf16_train import (
    LOSS_RTOL,
    STEP_REL_L2,
    STEP_STATS_ATOL,
    VS_F32_RATIO,
    _leaves,
)
from tests.test_torch_dml import DML, _record_sample, rgb_batch
from tests.test_torch_sampler import random_flax_variables
from tests.test_torch_train_step import _sgd
from tests.test_torch_trainer import single_torch_thread

BF16_CFG = dict(compute_dtype="bfloat16", bn_apply_dtype="bfloat16")
DRAW_FLIP_SHARE = 0.02
KL_RTOL = 0.08
LEAF_RTOL = 0.3
BF16_FLOOR = 1e-3
XLA_BIAS_OFF = 0.3
PORT_BIAS_RTOL = 0.05
HEAD_BIAS = "['postprocess']['SNConv_0']['bias']"
SE = "['SqueezeExcitation_"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_module():
    with single_torch_thread():
        yield


def _jax_grad_step(overrides, variables, batch, normal_draws):
    """JAX's ``make_train_step`` with ``optax.sgd(1.0)`` from
    ``variables``, its Gaussian draws recorded into ``normal_draws``."""
    import jax.numpy as jnp
    import optax

    from nvae_tpu.train.state import TrainState as JaxState
    from nvae_tpu.train.step import make_train_step as jax_train_step

    jm = JaxNVAE(jcfg.debug_config(**overrides))
    tc = jcfg.TrainConfig(batch_size=batch.shape[0], step_based_warmup=True,
                          binary=False)
    tx = optax.sgd(1.0)
    params = variables["params"]
    js = JaxState(step=jnp.zeros((), jnp.int32),
                  epoch=jnp.zeros((), jnp.int32), params=params,
                  batch_stats=variables["batch_stats"],
                  spectral=variables.get("spectral", {}),
                  opt_state=tx.init(params), rng=jax.random.PRNGKey(7))
    step = jax_train_step(jm, tx, tc, 100, 50, donate=False)
    real_normal = jax.random.normal

    def normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        jax.debug.callback(
            lambda v: normal_draws.append(np.array(v, copy=True)), out,
            ordered=True)
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.random, "normal", normal)
        js, met = step(js, batch)
        jax.effects_barrier()
    return js, met


def _port(overrides, variables, train=True):
    tm = TorchNVAE(tcfg.debug_config(**overrides), device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables, tm))
    tm.train(train)
    return tm


def _port_grad_step(overrides, variables, batch, eps):
    """The port's step with SGD at lr 1 from ``variables`` and the noise
    ``eps``: the new state as a Flax tree, and the metrics."""
    from nvae_torch.train.state import TrainState
    from nvae_torch.train.step import make_train_step

    tm = _port(overrides, variables)
    tx = _sgd(1.0)
    tc = tcfg.TrainConfig(batch_size=batch.shape[0], step_based_warmup=True,
                          binary=False)
    state = TrainState(0, 0, tm, None, seed=0)
    state.opt_state = tx.init(state.params())
    _, met = make_train_step(tm, tx, tc, 100, 50)(state, batch, eps=[eps])
    return flax_tree_from_state_dict(tm.state_dict(), tm), met


@pytest.fixture(scope="module")
def dml_bf16():
    """The debug DML model's Flax weights (seed 4), and one bf16 SGD step
    of JAX and of the port on one RGB batch and JAX's noise, beside JAX's
    fp32 step on the same inputs; the updates by leaf."""
    variables = random_flax_variables(
        JaxNVAE(jcfg.debug_config(**DML)), seed=4)
    batch = rgb_batch(4, seed=11)
    draws = []
    js, jmet = _jax_grad_step({**DML, **BF16_CFG}, variables, batch, draws)
    js32, _ = _jax_grad_step(DML, variables, batch, [])
    port, tmet = _port_grad_step({**DML, **BF16_CFG}, variables, batch,
                                 draws)
    start = _leaves(variables["params"])

    def update(params):
        return {k: v - start[k] for k, v in _leaves(params).items()}

    return {"variables": variables, "jax": (jmet, js), "port": (tmet, port),
            "updates": {"jax": update(js.params),
                        "port": update(port["params"]),
                        "jax32": update(js32.params)}}


def test_bf16_dml_step_matches_jax(dml_bf16):
    """Loss and its parts, the gradient's norm, and the BatchNorm running
    statistics after the step."""
    jmet, js = dml_bf16["jax"]
    tmet, port = dml_bf16["port"]
    assert set(tmet) == set(jmet)
    for k, rtol in (("loss", LOSS_RTOL), ("reconstruction_loss", LOSS_RTOL),
                    ("kl_loss", KL_RTOL), ("kl_raw", KL_RTOL),
                    ("grad_norm", STEP_REL_L2)):
        want, got = float(jmet[k]), float(tmet[k])
        assert np.isfinite(got)
        assert abs(got - want) <= rtol * abs(want), (k, got, want)
    assert float(tmet["beta"]) == float(jmet["beta"]) == 0.0
    stats = _leaves(port["batch_stats"])
    for k, ref in _leaves(js.batch_stats).items():
        err = np.abs(stats[k] - ref) / np.maximum(1.0, np.abs(ref))
        assert err.max() <= STEP_STATS_ATOL, (k, err.max())


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _rel_over(upd: dict, keys, of: str, ref: str = "jax32") -> float:
    """Relative L2 of ``upd[of]`` from ``upd[ref]`` over the leaves
    ``keys`` together."""
    def flat(name):
        return np.concatenate([upd[name][k].ravel() for k in keys])

    return _rel(flat(of), flat(ref))


def _is_bias(key: str) -> bool:
    return key.endswith("['bias']")


def test_bf16_dml_gradients_match_jax_fp32_by_leaf(dml_bf16):
    """The gradients but the biases' against JAX's fp32 step: the leaves
    outside the squeeze-excitation gates together within ``STEP_REL_L2``
    and each within ``LEAF_RTOL``; the gates' leaves together no further
    from it than ``VS_F32_RATIO[1]`` times JAX's bf16 ones are."""
    upd = dml_bf16["updates"]
    keys = sorted(k for k in upd["jax32"] if not _is_bias(k))
    gates = [k for k in keys if SE in k]
    rest = [k for k in keys if SE not in k]
    assert gates and len(rest) > 4 * len(gates)
    assert _rel_over(upd, rest, "port") <= STEP_REL_L2
    worst = max((_rel(upd["port"][k], upd["jax32"][k]), k) for k in rest)
    assert worst[0] <= LEAF_RTOL, worst
    port, ref = _rel_over(upd, gates, "port"), _rel_over(upd, gates, "jax")
    assert port <= VS_F32_RATIO[1] * ref, (port, ref)


def test_bf16_dml_update_is_bf16_and_no_further_from_fp32_than_jax(
        dml_bf16):
    """The biases' gradients (the lr-1 update) against JAX's fp32 step's:
    the port's at least ``BF16_FLOOR`` from them, within
    ``PORT_BIAS_RTOL`` and at most ``VS_F32_RATIO[1]`` times JAX's bf16
    distance; and why the bf16 updates are not compared directly: JAX's
    head bias gradient, summed in bf16 by XLA on the CPU, lies far from
    the fp32 sum, the port's not."""
    upd = dml_bf16["updates"]
    biases = sorted(k for k in upd["jax32"] if _is_bias(k))
    port, ref = _rel_over(upd, biases, "port"), _rel_over(upd, biases, "jax")
    assert BF16_FLOOR <= port <= min(PORT_BIAS_RTOL, VS_F32_RATIO[1] * ref), (
        port, ref)
    g32 = upd["jax32"][HEAD_BIAS]
    assert _rel(upd["jax"][HEAD_BIAS], g32) > XLA_BIAS_OFF
    assert _rel(upd["port"][HEAD_BIAS], g32) <= PORT_BIAS_RTOL


@pytest.mark.parametrize("greyscale", [True, False])
def test_bf16_dml_sample_matches_jax(monkeypatch, dml_bf16, greyscale):
    """``NVAE.sample`` in bf16: the mixture's mean (greyscale) or a draw on
    JAX's uniforms and Gumbel noise."""
    variables = dml_bf16["variables"]
    jm = JaxNVAE(jcfg.debug_config(**DML, **BF16_CFG))
    tm = _port({**DML, **BF16_CFG}, variables, train=False)
    t = np.array([0.6, 0.9, 1.2], np.float32)
    (want, *_), normals, uniforms, gumbels = _record_sample(
        monkeypatch, lambda: jm.apply(
            variables, 3, t, greyscale, method=JaxNVAE.sample,
            rngs={"sample": jax.random.PRNGKey(5)}))
    if greyscale:
        got, *_ = tm.sample(3, t, True, eps=normals)
    else:
        got, *_ = tm.sample(3, t, False, eps=normals, uniform=uniforms[0],
                            gumbel=gumbels[0])
    assert got.dtype == torch.float32 and got.shape == (3, 32, 32, 3)
    err = np.abs(got.numpy().astype(np.float64)
                 - np.asarray(want, np.float64))
    if greyscale:
        assert err.max() <= PROB_ATOL, err.max()
    else:
        assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
        off = float((err > PROB_ATOL).mean())
        assert off <= DRAW_FLIP_SHARE, off


def test_bf16_dml_nll_matches_jax(monkeypatch, dml_bf16):
    """The IWAE NLL (K=2, ``crop=2``) of the bf16 DML model: its posterior
    passes on JAX's noise."""
    variables = dml_bf16["variables"]
    jm = JaxNVAE(jcfg.debug_config(**DML, **BF16_CFG))
    tm = _port({**DML, **BF16_CFG}, variables)
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
    got = make_nll_fn(tm, n_attempts=k, crop=2)(
        torch.from_numpy(x), eps=[draws[i * g:(i + 1) * g] for i in range(k)])
    assert np.isfinite(float(got))
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want)), (
        float(got), float(want))
