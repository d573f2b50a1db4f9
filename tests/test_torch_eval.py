"""The port's eval step, IWAE NLL and reconstruction against the JAX
package's on the CPU at debug size, from the same weights (random, from
numpy, in the Flax tree, converted by ``nvae_torch.convert``) and the same
posterior noise (JAX's own draws, recorded by patching
``jax.random.normal`` to hand each draw to the host through an ordered
``jax.debug.callback``, then injected into the port).

Tolerances: the eval step's metrics and the NLL at rtol 1e-5 (sums of a few
thousand fp32 terms through ~40 layers in other summation orders);
reconstructions at atol 1e-5 (probabilities).  The eval step and the NLL
leave every buffer of the model bitwise as it was, and its mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch import config as tcfg
from nvae_torch.convert import state_dict_from_flax
from nvae_torch.eval.nll import make_nll_fn, neg_log_likelihood
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.models.nvae import posterior_noise_shapes
from nvae_torch.train.state import TrainState as TorchState
from nvae_torch.train.step import make_eval_step
from nvae_tpu import config as jcfg
from nvae_tpu.eval.nll import make_nll_fn as jax_make_nll_fn
from nvae_tpu.models import NVAE as JaxNVAE
from nvae_tpu.train.state import TrainState as JaxState
from nvae_tpu.train.step import make_eval_step as jax_make_eval_step
from tests.test_torch_sampler import random_flax_variables
from tests.test_torch_trainer import single_torch_thread


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_module():
    """One intra-op thread for the module's tests and its module-scoped
    fixtures (``tests/test_torch_trainer.py``'s ``single_torch_thread``)."""
    with single_torch_thread():
        yield


RTOL = 1e-5
ATOL = 1e-5

CONFIGS = {
    "default": dict(use_pallas_kernels=True),
    "forward_sn": dict(use_pallas_kernels=True, spectral_mode="forward"),
    "three_scales": dict(use_pallas_kernels=True,
                         n_groups_per_scale=(1, 1, 2)),
}


def _models(name, seed=0):
    overrides = CONFIGS[name]
    jm = JaxNVAE(jcfg.debug_config(**overrides))
    variables = random_flax_variables(jm, seed=seed)
    tm = TorchNVAE(tcfg.debug_config(**overrides), device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables, tm))
    return jm, variables, tm


def _batch(n=4, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 32, 32, 1) > 0.5).astype(np.float32)


def _recorded(monkeypatch, fn):
    """Run ``fn()`` with every ``jax.random.normal`` draw recorded; returns
    (its result, the draws in order)."""
    draws, real_normal = [], jax.random.normal

    def normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        jax.debug.callback(lambda v: draws.append(np.array(v, copy=True)),
                           out, ordered=True)
        return out

    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal", normal)
        out = fn()
        jax.block_until_ready(out)
        jax.effects_barrier()
    return out, draws


def _snapshot(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _assert_unchanged(model, before):
    after = model.state_dict()
    assert set(after) == set(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k


@pytest.mark.parametrize("name,bn_batch_stats", [
    ("default", True), ("default", False), ("forward_sn", True),
    ("three_scales", True),
])
def test_eval_step_matches_jax(monkeypatch, name, bn_batch_stats):
    jm, variables, tm = _models(name)
    x = _batch()
    js = JaxState(step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
                  params=variables["params"],
                  batch_stats=variables["batch_stats"],
                  spectral=variables.get("spectral", {}), opt_state=None,
                  rng=jax.random.PRNGKey(0))
    eval_j = jax_make_eval_step(jm, jcfg.TrainConfig(), bn_batch_stats)
    want, draws = _recorded(
        monkeypatch, lambda: eval_j(js, x, jax.random.PRNGKey(3)))
    assert [d.shape for d in draws] == posterior_noise_shapes(tm.cfg, 4)

    tm.train()
    before = _snapshot(tm)
    eval_t = make_eval_step(tm, tcfg.TrainConfig(), bn_batch_stats)
    got = eval_t(TorchState(0, 0, tm, None, 0), torch.from_numpy(x), eps=draws)
    assert set(got) == set(want) == {"reconstruction_loss", "kl_loss", "elbo"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)
    _assert_unchanged(tm, before)
    assert tm.training
    # From eval mode, with noise from a generator: the mode comes back too.
    tm.eval()
    eval_t(TorchState(0, 0, tm, None, 0), x,
           generator=torch.Generator().manual_seed(0))
    _assert_unchanged(tm, before)
    assert not tm.training


@pytest.mark.parametrize("name", ["default", "forward_sn"])
def test_iwae_nll_matches_jax(monkeypatch, name):
    jm, variables, tm = _models(name, seed=1)
    x = _batch(seed=2)
    k = 3
    nll_j = jax_make_nll_fn(jm, n_attempts=k, crop=2)
    want, draws = _recorded(
        monkeypatch, lambda: nll_j(variables, x, jax.random.PRNGKey(4)))
    g = tm.cfg.n_total_groups
    assert len(draws) == k * g
    eps = [draws[i * g:(i + 1) * g] for i in range(k)]

    tm.train()
    before = _snapshot(tm)
    got = make_nll_fn(tm, n_attempts=k, crop=2)(torch.from_numpy(x), eps=eps)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    _assert_unchanged(tm, before)
    assert tm.training
    with pytest.raises(ValueError, match="one list per attempt"):
        make_nll_fn(tm, n_attempts=k)(x, eps=eps[:1])

    # Mean and std over batches, each with its own seeded noise.
    mean, std = neg_log_likelihood(tm, [x, _batch(seed=3)], seed=5,
                                   n_attempts=2)
    assert np.isfinite(mean) and std >= 0.0
    assert (mean, std) == neg_log_likelihood(tm, [x, _batch(seed=3)], seed=5,
                                             n_attempts=2)
    _assert_unchanged(tm, before)


def test_reconstruct_matches_jax(monkeypatch):
    jm, variables, tm = _models("forward_sn", seed=2)
    x = _batch(n=3, seed=4)
    want, draws = _recorded(monkeypatch, lambda: jax.jit(
        lambda v, x_: jm.apply(v, x_, rngs={"sample": jax.random.PRNGKey(5)},
                               method=JaxNVAE.reconstruct))(variables, x))
    tm.train()
    before = _snapshot(tm)
    got = tm.reconstruct(torch.from_numpy(x), eps=draws)
    assert got.shape == (3, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    _assert_unchanged(tm, before)
    assert tm.training
