"""The port's pipeline against the JAX package's ``PipelineTrainer``, on the
CPU at debug size.

Both start from the same weights (random, from numpy, in the Flax tree and
converted by ``nvae_torch.convert``) and draw the same posterior noise: JAX's
stage programs run with ``jax.random.normal`` patched to hand each draw to
the host through an ordered ``jax.debug.callback`` (every JAX stage on one
CPU device, as JAX's ``devices`` list allows repeats, so the callbacks keep
their order across the stage programs), and the draws are injected into the
port's pipeline as ``eps``.  When the decoder is not the last stage (4
stages), JAX's backward recomputes it and draws the same noise a second
time: each microbatch's first draw is injected.  The Pallas kernels run in
interpret mode on the JAX side; the port's CPU path runs the plain versions
of its kernels.

The limits are ``tests/test_torch_train_step.py``'s: with SGD + spectral
projection, 3 steps, metrics at rtol 1e-5, parameters at atol 1e-6 and
BatchNorm statistics at 3e-5 of ``max(1, |value|)``; with the production
optimizer (Adamax, cosine decay, projection), 1 step, metrics at rtol 1e-5
and each parameter within ``2 lr / sigma`` of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from nvae_torch import config as tcfg
from nvae_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.parallel import PipelineTrainer
from nvae_torch.train import optim as topt
from nvae_torch.train.state import TrainState as TorchState
from nvae_tpu import config as jcfg
from nvae_tpu.models import NVAE as JaxNVAE
from nvae_tpu.parallel import PipelineTrainer as JaxPipelineTrainer
from nvae_tpu.train.optim import find_spectral_state
from nvae_tpu.train.optim import make_optimizer as jax_make_optimizer
from nvae_tpu.train.optim import spectral_projection as jax_projection
from nvae_tpu.train.state import TrainState as JaxState
from tests.test_torch_sampler import random_flax_variables
from tests.test_torch_train_step import (
    BN_STATS_TOL,
    SGD_LR,
    STEPS_PER_EPOCH,
    TOTAL_STEPS,
    _check_metrics,
    _max_err,
    _sgd,
)
from tests.test_torch_trainer import single_torch_thread


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_module():
    with single_torch_thread():
        yield


M = 2


def _adamax_bound_ok(port_params, js_params, sigmas, lr):
    """Each parameter within ``2 lr / sigma`` of JAX's (sigma 1 where the
    kernel has none): Adamax moves a coordinate by about ``lr / sigma``
    whatever its gradient's size."""
    sig = dict(jax.tree_util.tree_flatten_with_path(
        sigmas, is_leaf=lambda x: x is None)[0])
    for path, want in jax.tree_util.tree_flatten_with_path(js_params)[0]:
        have = port_params
        for k in path:
            have = have[k.key]
        s = sig.get(path)
        bound = 2 * lr / (float(s) if s is not None else 1.0)
        err = float(np.abs(have - np.asarray(want)).max())
        assert err <= bound * (1 + 1e-3), (jax.tree_util.keystr(path), err,
                                           bound)


@pytest.mark.parametrize("S,optimizer,n_steps", [(2, "sgd", 3),
                                                 (4, "adamax", 1)])
def test_pipeline_matches_jax(monkeypatch, S, optimizer, n_steps):
    """S stages, 2 microbatches under 1f1b: the port's pipeline against
    JAX's, step by step, from the same weights and noise."""
    overrides = dict(use_pallas_kernels=True)
    jm = JaxNVAE(jcfg.debug_config(**overrides))
    variables = random_flax_variables(jm, seed=4)
    tc_j = jcfg.TrainConfig(batch_size=8, step_based_warmup=True)
    tc_t = tcfg.TrainConfig(batch_size=8, step_based_warmup=True)
    tm = TorchNVAE(tcfg.debug_config(**overrides), device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables, tm))
    tm.train()
    if optimizer == "sgd":
        def factory_j():
            return optax.chain(optax.sgd(SGD_LR), jax_projection())

        def factory_t(keys):
            return topt.chain(_sgd(SGD_LR), topt.spectral_projection(keys))
    else:
        def factory_j():
            return jax_make_optimizer(tc_j, TOTAL_STEPS, "projection")

        factory_t = None  # make_optimizer of tc_t, per stage
    params = variables["params"]
    js = JaxState(
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
        params=params, batch_stats=variables["batch_stats"],
        spectral=variables.get("spectral", {}),
        opt_state=factory_j().init(params), rng=jax.random.PRNGKey(7),
    )
    pp_j = JaxPipelineTrainer(
        jm, tc_j, TOTAL_STEPS, STEPS_PER_EPOCH, n_stages=S,
        n_microbatches=M, devices=[jax.devices()[0]] * S, state=js,
        tx_factory=factory_j)
    pp_t = PipelineTrainer(
        tm, tc_t, TOTAL_STEPS, STEPS_PER_EPOCH, n_stages=S, n_microbatches=M,
        devices=["cpu"] * S, state=TorchState(0, 0, tm, None, seed=0),
        tx_factory=factory_t)
    assert pp_j.schedule == pp_t.schedule == "1f1b"

    draws, real_normal = [], jax.random.normal

    def normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        jax.debug.callback(lambda v: draws.append(np.array(v, copy=True)), out,
                           ordered=True)
        return out

    per_mb = sum(tm.cfg.n_groups_per_scale)
    # The decoder's draws per microbatch: its forward's, and under 4
    # stages its recompute's.
    passes = 1 if "decoder" in pp_t.names[-1] else 2
    rng = np.random.RandomState(5)
    for _ in range(n_steps):
        batch = (rng.rand(8, 32, 32, 1) > 0.5).astype(np.float32)
        with monkeypatch.context() as m:
            m.setattr(jax.random, "normal", normal)
            jmet = pp_j.step(batch)
            jax.effects_barrier()
        assert len(draws) == passes * M * per_mb
        # 1f1b with 2 microbatches: both forward chains, then both
        # backward chains.
        first, again = draws[:M * per_mb], draws[M * per_mb:]
        assert all(np.array_equal(a, b) for a, b in zip(first, again))
        eps = [first[i * per_mb:(i + 1) * per_mb] for i in range(M)]
        draws.clear()
        tmet = pp_t.step(batch, eps=eps)
        _check_metrics(tmet, jmet, rtol=1e-5)
        merged_j = pp_j.merged_state()
        port = flax_tree_from_state_dict(
            pp_t.merged_state().model.state_dict(), tm)
        if optimizer == "sgd":
            err, where = _max_err(port["params"], merged_j.params)
            assert err <= 1e-6, ("params", err, where)
        else:
            _adamax_bound_ok(port["params"], merged_j.params,
                             find_spectral_state(merged_j.opt_state).sigma,
                             tc_j.learning_rate)
        err, where = _max_err(port["batch_stats"], merged_j.batch_stats,
                              scale=True)
        assert err <= BN_STATS_TOL, ("batch_stats", err, where)
    assert pp_t.step_count == pp_j.step_count == n_steps
