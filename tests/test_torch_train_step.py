"""The port's whole training step against the JAX package's
``make_train_step``, on the CPU at debug size.

Both sides start from the same weights (random, from numpy, in the Flax tree
and converted by ``nvae_torch.convert``) and draw the same posterior noise:
the JAX step runs jitted with ``jax.random.normal`` patched to hand each draw
to the host through an ordered ``jax.debug.callback``, and the recorded
draws are injected into the port's step.  The Pallas kernels run in
interpret mode on the JAX side; the port's CPU path runs the plain versions
of its kernels inside the same autograd Function the card uses.

Tolerances:

- SGD at lr 1e-5 + spectral projection (a linear update, so the parameters
  track the gradients), 3 steps: parameters and spectral ``u`` at atol 1e-6;
  metrics at rtol 1e-5.  BatchNorm running statistics at 3e-5 of
  ``max(1, |value|)``: they are batch statistics of forward activations, so
  they carry the forward pass's fp32 difference between the two frameworks
  (other summation orders through up to 40 layers; measured at most 1.0e-5
  of ``max(1, |value|)``, at a postprocess variance).  Atol 1e-6 holds
  only between two runs of one program.
- Adamax, 1 step: loss and metrics at rtol 1e-5; each parameter within
  ``2 lr / sigma`` of JAX's (Adamax moves each coordinate by about
  ``lr / sigma`` whatever the gradient's size, so a near-zero gradient whose
  sign differs between the two sides moves it the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvae_torch import config as tcfg
from nvae_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.nn.spectral import sn_kernel_names
from nvae_torch.train import optim as topt
from nvae_torch.train.state import TrainState as TorchState
from nvae_torch.train.step import make_train_step as torch_train_step
from nvae_tpu import config as jcfg
from nvae_tpu.models import NVAE as JaxNVAE
from nvae_tpu.train.optim import find_spectral_state
from nvae_tpu.train.optim import make_optimizer as jax_make_optimizer
from nvae_tpu.train.optim import spectral_projection as jax_projection
from nvae_tpu.train.state import TrainState as JaxState
from nvae_tpu.train.step import make_train_step as jax_train_step
from tests.test_torch_sampler import random_flax_variables

TOTAL_STEPS, STEPS_PER_EPOCH = 100, 50
SGD_LR = 1e-5
BN_STATS_TOL = 3e-5


def _sgd(lr):
    """Test-local plain SGD for the port: ``update = -lr * g``."""
    return topt.GradientTransformation(
        lambda params: None,
        lambda updates, state, params=None: (
            {k: -lr * g for k, g in updates.items()}, None),
    )


def _run(monkeypatch, overrides, train_overrides, optimizer, n_steps,
         batch_size=4):
    """Run ``n_steps`` of both steps from the same weights and noise.
    Returns per step ``(jax_state, jax_metrics, port_tree, port_metrics)``,
    ``port_tree`` the port model's state converted back to a Flax tree."""
    jm = JaxNVAE(jcfg.debug_config(**overrides))
    variables = random_flax_variables(jm, seed=4)
    tc_j = jcfg.TrainConfig(batch_size=batch_size, step_based_warmup=True,
                            **train_overrides)
    tc_t = tcfg.TrainConfig(batch_size=batch_size, step_based_warmup=True,
                            **train_overrides)
    tm = TorchNVAE(tcfg.debug_config(**overrides), device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables, tm))
    tm.train()
    if optimizer == "sgd":
        tx_j = optax.chain(optax.sgd(SGD_LR), jax_projection())
        tx_t = topt.chain(_sgd(SGD_LR), topt.spectral_projection(
            sn_kernel_names(tm)))
    else:
        tx_j = jax_make_optimizer(tc_j, TOTAL_STEPS, tm.cfg.spectral_mode)
        tx_t = topt.make_optimizer(tc_t, TOTAL_STEPS, tm.cfg.spectral_mode,
                                   sn_kernel_names(tm))
    params = variables["params"]
    js = JaxState(
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
        params=params, batch_stats=variables["batch_stats"],
        spectral=variables.get("spectral", {}),
        opt_state=tx_j.init(params), rng=jax.random.PRNGKey(7),
    )
    ts = TorchState(0, 0, tm, None, seed=0)
    ts.opt_state = tx_t.init(ts.params())
    step_j = jax_train_step(jm, tx_j, tc_j, TOTAL_STEPS, STEPS_PER_EPOCH,
                            donate=False)
    step_t = torch_train_step(tm, tx_t, tc_t, TOTAL_STEPS, STEPS_PER_EPOCH)

    draws, real_normal = [], jax.random.normal

    def normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        jax.debug.callback(lambda v: draws.append(np.array(v, copy=True)), out,
                           ordered=True)
        return out

    rng = np.random.RandomState(5)
    accum = train_overrides.get("grad_accum", 1)
    per_mb = sum(tm.cfg.n_groups_per_scale)
    out = []
    for _ in range(n_steps):
        batch = (rng.rand(batch_size, 32, 32, 1) > 0.5).astype(np.float32)
        with monkeypatch.context() as m:
            m.setattr(jax.random, "normal", normal)
            js, jmet = step_j(js, batch)
            jax.effects_barrier()
        assert len(draws) == accum * per_mb
        eps = [draws[i * per_mb:(i + 1) * per_mb] for i in range(accum)]
        draws.clear()
        ts, tmet = step_t(ts, batch, eps=eps)
        out.append((js, jmet, flax_tree_from_state_dict(tm.state_dict(), tm),
                    tmet))
    assert ts.step == n_steps and ts.epoch == int(js.epoch)
    return out


def _max_err(port_tree, jax_tree, scale=False):
    """Largest |port - jax| over the leaves (each over max(1, |jax|) when
    ``scale``), and the leaf it is at."""
    worst = (0.0, None)
    flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    for path, want in flat:
        have = port_tree
        for k in path:
            have = have[k.key]
        want = np.asarray(want)
        err = np.abs(have - want)
        if scale:
            err = err / np.maximum(1.0, np.abs(want))
        if err.max() > worst[0]:
            worst = (float(err.max()), jax.tree_util.keystr(path))
    return worst


def _check_metrics(tmet, jmet, rtol):
    assert set(tmet) == set(jmet), (set(tmet), set(jmet))
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("name,overrides,train_overrides", [
    ("default", dict(use_pallas_kernels=True), {}),
    ("depthwise", dict(use_pallas_kernels=True, postprocess_5x5_depthwise=True),
     {}),
    ("forward_sn_accum2",
     dict(use_pallas_kernels=True, spectral_mode="forward"),
     dict(grad_accum=2)),
])
def test_sgd_steps_match_jax(monkeypatch, name, overrides, train_overrides):
    batch = 8 if train_overrides.get("grad_accum", 1) > 1 else 4
    for js, jmet, port, tmet in _run(monkeypatch, overrides, train_overrides,
                                     "sgd", 3, batch_size=batch):
        _check_metrics(tmet, jmet, rtol=1e-5)
        err, where = _max_err(port["params"], js.params)
        assert err <= 1e-6, (name, "params", err, where)
        err, where = _max_err(port["batch_stats"], js.batch_stats, scale=True)
        assert err <= BN_STATS_TOL, (name, "batch_stats", err, where)
        if js.spectral:
            err, where = _max_err(port["spectral"], js.spectral)
            assert err <= 1e-6, (name, "u", err, where)


def test_adamax_step_with_frozen_norm_matches_jax(monkeypatch):
    """Adamax + projection + EMA (make_optimizer) for one step, with
    ``parity_frozen_norm``: BatchNorm running statistics stay as loaded."""
    overrides = dict(use_pallas_kernels=True)
    (js, jmet, port, tmet), = _run(
        monkeypatch, overrides,
        dict(parity_frozen_norm=True, ema_decay=0.999), "adamax", 1,
    )
    _check_metrics(tmet, jmet, rtol=1e-5)
    lr = jcfg.TrainConfig().learning_rate
    sigmas = find_spectral_state(js.opt_state).sigma
    flat = jax.tree_util.tree_flatten_with_path(js.params)[0]
    sig = dict(jax.tree_util.tree_flatten_with_path(
        sigmas, is_leaf=lambda x: x is None)[0])
    for path, want in flat:
        have = port["params"]
        for k in path:
            have = have[k.key]
        s = sig.get(path)
        bound = 2 * lr / (float(s) if s is not None else 1.0)
        err = float(np.abs(have - np.asarray(want)).max())
        assert err <= bound * (1 + 1e-3), (jax.tree_util.keystr(path), err,
                                           bound)
    jm = JaxNVAE(jcfg.debug_config(**overrides))
    loaded = random_flax_variables(jm, seed=4)["batch_stats"]
    assert _max_err(port["batch_stats"], loaded)[0] == 0.0
    assert _max_err(port["batch_stats"], js.batch_stats)[0] == 0.0
