"""The port's device-resident epoch runner (``nvae_torch.train.
epoch_runner``, the ``--scan_epochs`` path) on the CPU at debug size:
against the JAX package's ``make_epoch_runner``, against the port's own
per-step loop, and through the trainer and the CLI (resume across the two
paths, the ``grad_accum`` refusal, ``parity_frozen_norm`` ignored as in
JAX).

Against JAX both sides start from the same weights (random, from numpy, in
the Flax tree, converted by ``nvae_torch.convert``) and see the same data:
the test rebuilds JAX's permutation (``fold_in(fold_in(rng, 0x5EED),
epoch)``) and binarization uniforms (``fold_in(fold_in(rng, 0xDA7A),
step)``) and records its posterior draws with ``jax.random.normal``
patched as in ``tests/test_torch_train_step.py``; all three are injected
into the port's runner.  Each JAX runner is compiled once per module.
Tolerances are ``tests/test_torch_train_step.py``'s:

- SGD at lr 1e-5 + spectral projection: parameters and spectral ``u`` at
  atol 1e-6, BatchNorm running statistics at 3e-5 of ``max(1, |value|)``
  (``BN_STATS_TOL``: batch statistics of fp32 activations summed in other
  orders), the epoch's mean metrics at rtol 1e-5;
- Adamax + projection + EMA: mean metrics at rtol 1e-5, each parameter
  (and its EMA) within ``2 lr / sigma`` of JAX's per step (Adamax moves a
  coordinate by about ``lr / sigma`` whatever the gradient's size, so a
  near-zero gradient whose sign differs moves it the other way).

The runner and the per-step loop run one step body: on the CPU they agree
bit for bit.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvae_torch import cli
from nvae_torch import config as tcfg
from nvae_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from nvae_torch.data import make_iterators, synthetic_dataset
from nvae_torch.data.pipeline import prepare_batch
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.nn.spectral import sn_kernel_names
from nvae_torch.train import checkpoint as ckpt
from nvae_torch.train import epoch_runner
from nvae_torch.train import optim as topt
from nvae_torch.train.epoch_runner import (
    data_seed,
    make_epoch_runner,
    shuffle_seed,
    stage_dataset,
)
from nvae_torch.train.state import TrainState as TorchState
from nvae_torch.train.state import create_train_state
from nvae_torch.train.step import make_train_step
from nvae_torch.train.trainer import Trainer
from nvae_torch.utils.logging import MetricsLogger
from nvae_tpu import config as jcfg
from nvae_tpu.models import NVAE as JaxNVAE
from nvae_tpu.train.epoch_runner import make_epoch_runner as jax_epoch_runner
from nvae_tpu.train.optim import find_ema_params as jax_find_ema
from nvae_tpu.train.optim import find_spectral_state
from nvae_tpu.train.optim import make_optimizer as jax_make_optimizer
from nvae_tpu.train.optim import spectral_projection as jax_projection
from nvae_tpu.train.state import TrainState as JaxState
from tests.test_torch_sampler import random_flax_variables
from tests.test_torch_train_step import (
    BN_STATS_TOL,
    SGD_LR,
    _check_metrics,
    _max_err,
    _sgd,
)
from tests.test_torch_trainer import TINY_ARCH, single_torch_thread

TINY = dict(n_groups_per_scale=(1, 1), n_latent_per_group=2,
            use_pallas_kernels=True)
BATCH, STEPS_PER_EPOCH, N_ROWS = 4, 3, 14
TOTAL_STEPS = 100


@pytest.fixture(autouse=True)
def one_torch_thread():
    with single_torch_thread():
        yield


def _images(n=N_ROWS, seed=3):
    """uint8 (n, 28, 28, 1): padded to 32 by both pipelines."""
    return np.random.RandomState(seed).randint(
        0, 256, size=(n, 28, 28, 1)).astype(np.uint8)


# ---- against JAX --------------------------------------------------------------

# Each case: the optimizer, its training settings, epochs to run and steps
# per epoch.  Adamax takes one step, as in tests/test_torch_train_step.py:
# after it the parameters differ by up to 2 lr / sigma, and the next
# step's BatchNorm statistics by more than BN_STATS_TOL.  The Adamax case
# also sets parity_frozen_norm, which both scan runners ignore.
CASES = {
    "sgd": ("sgd", {}, 2, STEPS_PER_EPOCH),
    "adamax_frozen_norm": ("adamax", dict(ema_decay=0.999,
                                          parity_frozen_norm=True), 1, 1),
}


@pytest.fixture(scope="module")
def jax_runs():
    """``name -> (variables, per-epoch (state, means, perm, uniforms,
    eps))`` of JAX's runner, each case compiled once for the module."""
    cache = {}

    def run(name):
        if name in cache:
            return cache[name]
        optimizer, train_overrides, epochs, spe = CASES[name]
        jm = JaxNVAE(jcfg.debug_config(**TINY))
        variables = random_flax_variables(jm, seed=4)
        tc = jcfg.TrainConfig(batch_size=BATCH, step_based_warmup=True,
                              **train_overrides)
        if optimizer == "sgd":
            tx = optax.chain(optax.sgd(SGD_LR), jax_projection())
        else:
            tx = jax_make_optimizer(tc, TOTAL_STEPS, jm.cfg.spectral_mode)
        params = variables["params"]
        rng = jax.random.PRNGKey(7)
        state = JaxState(
            step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
            params=params, batch_stats=variables["batch_stats"],
            spectral=variables.get("spectral", {}),
            opt_state=tx.init(params), rng=rng,
        )
        runner = jax_epoch_runner(jm, tx, tc, TOTAL_STEPS, spe, donate=False)
        data = jnp.asarray(_images())
        draws, real_normal = [], jax.random.normal

        def normal(*args, **kwargs):
            out = real_normal(*args, **kwargs)
            jax.debug.callback(lambda v: draws.append(np.array(v, copy=True)),
                               out, ordered=True)
            return out

        per_step = sum(TINY["n_groups_per_scale"])
        out = []
        for e in range(epochs):
            step0 = int(state.step)
            with pytest.MonkeyPatch.context() as m:
                m.setattr(jax.random, "normal", normal)
                state, means = runner(state, data, jnp.asarray(e))
                jax.effects_barrier()
            perm = np.asarray(jax.random.permutation(
                jax.random.fold_in(jax.random.fold_in(rng, 0x5EED), e),
                N_ROWS))
            uniforms = [np.asarray(jax.random.uniform(
                jax.random.fold_in(jax.random.fold_in(rng, 0xDA7A), s),
                (BATCH, 32, 32, 1))) for s in range(step0, step0 + spe)]
            assert len(draws) == spe * per_step
            eps = [draws[i * per_step:(i + 1) * per_step] for i in range(spe)]
            draws.clear()
            out.append((state, {k: float(v) for k, v in means.items()}, perm,
                        uniforms, eps))
        cache[name] = variables, out
        return cache[name]

    return run


def _port_runner(name, variables, frozen_norm=None):
    optimizer, train_overrides, _, spe = CASES[name]
    if frozen_norm is not None:
        train_overrides = dict(train_overrides, parity_frozen_norm=frozen_norm)
    tc = tcfg.TrainConfig(batch_size=BATCH, step_based_warmup=True,
                          **train_overrides)
    tm = TorchNVAE(tcfg.debug_config(**TINY), device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables, tm))
    if optimizer == "sgd":
        tx = topt.chain(_sgd(SGD_LR), topt.spectral_projection(
            sn_kernel_names(tm)))
    else:
        tx = topt.make_optimizer(tc, TOTAL_STEPS, tm.cfg.spectral_mode,
                                 sn_kernel_names(tm))
    state = TorchState(0, 0, tm, None, seed=0)
    state.opt_state = tx.init(state.params())
    run = make_epoch_runner(tm, tx, tc, TOTAL_STEPS, spe)
    return state, run


def _run_port(name, variables, epochs, frozen_norm=None):
    """Per epoch ``(state, means, tree, ema_tree, flat)``: the state's
    step and epoch, and copies of what the run holds in place (the model
    as a Flax tree, the EMA parameters, the checkpoint's flat dict)."""
    state, run = _port_runner(name, variables, frozen_norm)
    data = stage_dataset(_images(), "cpu")
    out = []
    for e, (_, _, perm, uniforms, eps) in enumerate(epochs):
        state, means = run(state, data, e, perm=np.array(perm), uniforms=[
            torch.from_numpy(np.array(u)) for u in uniforms], eps=eps)
        model = state.model
        ema = topt.find_ema_params(state.opt_state)
        out.append((state, means,
                    flax_tree_from_state_dict(model.state_dict(), model),
                    None if ema is None
                    else flax_tree_from_state_dict(ema, model), _flat(state)))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_epoch_runner_matches_jax(jax_runs, name):
    variables, jax_epochs = jax_runs(name)
    port = _run_port(name, variables, jax_epochs)
    lr = jcfg.TrainConfig().learning_rate
    for e, ((js, jmeans, *_), (ts, tmeans, tree, ema, _)) in enumerate(
            zip(jax_epochs, port)):
        assert ts.step == int(js.step) == (e + 1) * CASES[name][3]
        assert ts.epoch == int(js.epoch)
        _check_metrics(tmeans, jmeans, rtol=1e-5)
        err, where = _max_err(tree["batch_stats"], js.batch_stats, scale=True)
        assert err <= BN_STATS_TOL, (name, "batch_stats", err, where)
        if CASES[name][0] == "sgd":
            err, where = _max_err(tree["params"], js.params)
            assert err <= 1e-6, (name, "params", err, where)
            if js.spectral:
                err, where = _max_err(tree["spectral"], js.spectral)
                assert err <= 1e-6, (name, "u", err, where)
            continue
        # Adamax: each coordinate within 2 lr / sigma per step.
        steps = int(js.step)
        sig = dict(jax.tree_util.tree_flatten_with_path(
            find_spectral_state(js.opt_state).sigma,
            is_leaf=lambda x: x is None)[0])
        for have_tree, want_tree in ((tree["params"], js.params),
                                     (ema["params"],
                                      jax_find_ema(js.opt_state))):
            for path, want in jax.tree_util.tree_flatten_with_path(
                    want_tree)[0]:
                have = have_tree
                for k in path:
                    have = have[k.key]
                s = sig.get(path)
                bound = 2 * steps * lr / (float(s) if s is not None else 1.0)
                err = float(np.abs(have - np.asarray(want)).max())
                assert err <= bound * (1 + 1e-3), (
                    jax.tree_util.keystr(path), err, bound)
        # Training mode despite parity_frozen_norm, in both packages: the
        # running statistics moved off the loaded ones.
        assert _max_err(tree["batch_stats"], variables["batch_stats"])[0] > 0


def test_frozen_norm_is_ignored_bitwise(jax_runs):
    """The port's runner with and without parity_frozen_norm: the same
    bits (the forward runs in training mode either way, as in JAX)."""
    variables, jax_epochs = jax_runs("adamax_frozen_norm")
    (_, ma, *_, a), = _run_port("adamax_frozen_norm", variables, jax_epochs,
                                True)
    (_, mb, *_, b), = _run_port("adamax_frozen_norm", variables, jax_epochs,
                                False)
    assert ma == mb
    _assert_same(a, b)


# ---- against the port's per-step loop ------------------------------------------


def _flat(state):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in ckpt.flatten_state(state).items()}


def _assert_same(a, b):
    assert set(a) == set(b)
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v.cpu(), b[k].cpu()), k
        else:
            assert v == b[k], k


def test_epoch_runner_equals_per_step_loop_bitwise():
    """Two epochs of the runner and the same steps through make_train_step
    over the batches and noise the runner draws (its permutation, its
    binarization seeds, ``step_seed`` posterior noise): the same bits in
    every parameter, statistic, optimizer leaf and mean metric."""
    cfg = tcfg.debug_config(**TINY)
    tc = tcfg.TrainConfig(batch_size=BATCH, step_based_warmup=True,
                          ema_decay=0.9)
    data = stage_dataset(_images(), "cpu")
    total = 2 * STEPS_PER_EPOCH
    model, state, tx = create_train_state(cfg, tc, total, device="cpu",
                                          seed=3)
    run = make_epoch_runner(model, tx, tc, total, STEPS_PER_EPOCH)
    _, ref, ref_tx = create_train_state(cfg, tc, total, device="cpu", seed=3)
    step = make_train_step(ref.model, ref_tx, tc, total, STEPS_PER_EPOCH)
    for e in range(2):
        state, means = run(state, data, e)
        perm = torch.randperm(N_ROWS, generator=torch.Generator().manual_seed(
            shuffle_seed(3, e)))
        sums = {}
        for i in range(STEPS_PER_EPOCH):
            rows = data[perm[i * BATCH:(i + 1) * BATCH]]
            gen = torch.Generator().manual_seed(data_seed(3, ref.step))
            ref, m = step(ref, prepare_batch(rows, gen))
            for k, v in m.items():
                sums[k] = v if k not in sums else sums[k] + v
        assert means == {k: float(v) / STEPS_PER_EPOCH
                         for k, v in sums.items()}
        assert (state.step, state.epoch) == (ref.step, ref.epoch)
        _assert_same(_flat(state), _flat(ref))
    assert int(state.opt_state[0][0].count) == total


# ---- the trainer and the CLI ------------------------------------------------------


def _train_cfg(tmp_path, **kw):
    base = dict(batch_size=8, step_based_warmup=True, epochs=2,
                model_save_frequency=1, sample_frequency=0,
                evaluate_frequency=0, ema_decay=0.9,
                model_save_dir=str(tmp_path / "models"),
                tensorboard_log_dir=str(tmp_path / "logs"))
    base.update(kw)
    return tcfg.TrainConfig(**base)


def _iters(seed=0):
    bundle = synthetic_dataset(n_train=40, n_test=16, seed=seed)
    return make_iterators(bundle, 8, seed=seed, device="cpu")


def test_fit_scan_epochs_with_eval_hooks_and_checkpoints(tmp_path):
    tc = _train_cfg(tmp_path, scan_epochs=True, sample_frequency=1,
                    evaluate_frequency=1)
    train_iter, test_iter = _iters()
    logger = MetricsLogger(tc.tensorboard_log_dir, tensorboard=False)
    trainer = Trainer(tcfg.debug_config(**TINY), tc, len(train_iter),
                      logger=logger, device="cpu")
    result = trainer.fit(train_iter, test_iter)
    logger.close()
    spe = len(train_iter)
    assert trainer.state.step == 2 * spe and trainer.state.epoch == 1
    assert len(result.history) == 2 and not result.interrupted
    assert all(np.isfinite(v) for h in result.history for v in h.values())
    assert trainer._epoch_runner.graph is None  # no graph on the CPU
    assert ckpt.all_steps(trainer.ckpt_dir) == [spe, 2 * spe]
    dirs = os.listdir(tmp_path / "logs" / "images")
    for e in (0, 1):
        assert f"samples_t0.7_step{e}" in dirs
        assert f"test_reconstruction_step{e}" in dirs
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert sum("test/elbo" in r for r in lines) == 2
    assert [r["step"] for r in lines if "train/loss" in r] == [0, 1]


def _continue_one_epoch(trainer, path, train_iter):
    """Epoch 1 from the trainer's state on ``path``, outside fit."""
    state = trainer.state
    if path == "scan":
        run = make_epoch_runner(trainer.model, trainer.tx, trainer.train_cfg,
                                trainer.total_steps, len(train_iter),
                                target_size=train_iter.target_size)
        state, _ = run(state, stage_dataset(train_iter.images, "cpu"), 1)
        return state
    for batch in train_iter.epoch(1):
        state, _ = trainer.step_fn(state, batch)
    return state


@pytest.mark.parametrize("first,second", [
    ("scan", "scan"), ("step", "scan"), ("scan", "step")])
def test_resume_across_the_two_paths(tmp_path, first, second):
    """A checkpoint from either path resumes on either: a run on the second
    path resumed from the first path's step-``spe`` checkpoint ends where
    the restored state, continued one epoch on the second path outside
    ``fit``, ends; two scan runs agree with an unbroken one."""
    train_iter, _ = _iters()
    spe = len(train_iter)
    a = Trainer(tcfg.debug_config(**TINY),
                _train_cfg(tmp_path, scan_epochs=first == "scan"), spe,
                device="cpu")
    a.fit(train_iter)
    tc_b = _train_cfg(tmp_path, scan_epochs=second == "scan", resume_from=1)
    b = Trainer(tcfg.debug_config(**TINY), tc_b, spe, device="cpu")
    b.fit(train_iter)
    assert b.state.step == 2 * spe
    assert int(b.state.opt_state[0][0].count) == 2 * spe
    ref = Trainer(tcfg.debug_config(**TINY), tc_b, spe, device="cpu")
    assert ref.maybe_resume() == 1
    ref.state = _continue_one_epoch(ref, second, train_iter)
    _assert_same(_flat(b.state), _flat(ref.state))
    if first == second:
        _assert_same(_flat(b.state), _flat(a.state))


def test_scan_epochs_refuses_grad_accum(tmp_path):
    train_iter, _ = _iters()
    tc = _train_cfg(tmp_path, scan_epochs=True, grad_accum=2)
    with pytest.raises(ValueError, match="grad_accum"):
        Trainer(tcfg.debug_config(**TINY), tc, len(train_iter), device="cpu")
    model, _, tx = create_train_state(tcfg.debug_config(**TINY), tc, 4,
                                      device="cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        make_epoch_runner(model, tx, tc, 4, 2)
    with pytest.raises(ValueError, match="grad_accum"):
        cli.main(["--mode", "train", "--cpu", "--dataset", "synthetic",
                  "--debug", "--batch_size", "4", *TINY_ARCH, "--use_pallas",
                  "--scan_epochs", "--grad_accum", "2",
                  "--model_save_dir", str(tmp_path / "m"),
                  "--tensorboard_log_dir", str(tmp_path / "l")])


def test_sigterm_is_honoured_at_the_epoch_end(tmp_path):
    """SIGTERM during a scan epoch: the epoch runs to its end (as in JAX),
    the state is saved, and fit returns interrupted."""
    train_iter, _ = _iters()
    spe = len(train_iter)
    tc = _train_cfg(tmp_path, scan_epochs=True, epochs=5,
                    model_save_frequency=0)
    trainer = Trainer(tcfg.debug_config(**TINY), tc, spe, device="cpu")
    real = epoch_runner.EpochRunner.__call__

    def call(self, *args, **kwargs):
        os.kill(os.getpid(), signal.SIGTERM)
        return real(self, *args, **kwargs)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(epoch_runner.EpochRunner, "__call__", call)
        result = trainer.fit(train_iter)
    assert result.interrupted and len(result.history) == 1
    assert trainer.state.step == spe
    assert ckpt.latest_step(trainer.ckpt_dir) == spe
