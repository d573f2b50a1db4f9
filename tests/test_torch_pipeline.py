"""The port's pipeline (``nvae_torch/parallel/pipeline.py``) on the CPU at
debug size, every stage on the CPU (``devices=["cpu"] * S``).

The contract under test is JAX's (``tests/test_pipeline.py``): a pipeline
step with M microbatches over S stages is the ``grad_accum=M`` step of the
port's own ``make_train_step`` -- the same noise, the same chain of
BatchNorm and spectral buffers, the mean of the microbatches' gradients,
and per-stage optimizers that together are the whole model's.  The limits
are JAX's: loss within 1e-4 relative, parameters and BatchNorm statistics
within 2e-6 after each of 3 steps (SGD at lr 1e-5).  Against the JAX
package's own pipeline: ``tests/test_torch_pipeline_jax.py``.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from nvae_torch import cli
from nvae_torch.config import TrainConfig, debug_config
from nvae_torch.nn.spectral import sn_kernel_names
from nvae_torch.parallel import PipelineTrainer, stage_names
from nvae_torch.parallel.pipeline import (
    check_layout,
    merge_opt_states,
    pipeline_dp,
)
from nvae_torch.train import checkpoint as ckpt
from nvae_torch.train import optim as topt
from nvae_torch.train.state import TrainState, create_train_state
from nvae_torch.train.step import make_train_step
from nvae_torch.train.trainer import Trainer
from tests.test_torch_trainer import (
    _cli_argv,
    _jsonl,
    _kernel_wrappers,
    no_tensorboard,  # noqa: F401  (a fixture)
    single_torch_thread,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_module():
    with single_torch_thread():
        yield


TOTAL_STEPS, STEPS_PER_EPOCH = 12, 4
LR = 1e-5
LOSS_RTOL = 1e-4
STATE_ATOL = 2e-6


def _sgd(lr=LR):
    """Plain SGD: ``update = -lr * g``."""
    return topt.GradientTransformation(
        lambda params: None,
        lambda updates, state, params=None: (
            {k: -lr * g for k, g in updates.items()}, None))


def _sgd_chain(mode):
    """SGD with the spectral strategy of ``mode``, as a stage factory of
    the spectral kernels' names."""
    def factory(keys):
        if mode == "projection":
            return topt.chain(_sgd(), topt.spectral_projection(keys))
        if mode == "penalty":
            return topt.chain(_sgd(), topt.spectral_tracking(keys))
        return _sgd()

    return factory


def _setup(mode="projection", M=2, production=False, ema_decay=0.0,
           **overrides):
    """Debug-size weights (seed 3) on the CPU, the ``grad_accum=M``
    training config and the whole model's optimizer (SGD with ``mode``'s
    spectral strategy, or ``make_optimizer``'s production chain)."""
    cfg = debug_config(spectral_mode=mode, use_pallas_kernels=True,
                       **overrides)
    tc = TrainConfig(epochs=3, batch_size=8, grad_accum=M,
                     step_based_warmup=True, learning_rate=LR,
                     ema_decay=ema_decay)
    model, state, tx = create_train_state(cfg, tc, TOTAL_STEPS, device="cpu",
                                          seed=3)
    if not production:
        tx = _sgd_chain(mode)(sn_kernel_names(model))
        state.opt_state = tx.init(state.params())
    return tc, state, tx


def _copy(state):
    return TrainState(state.step, state.epoch, copy.deepcopy(state.model),
                      copy.deepcopy(state.opt_state), state.seed)


# The RGB preset's form at debug size: the mixture-of-logistics head on 3
# channels, every cell rematerialized.
DML_REMAT = dict(likelihood="dml", in_channels=3, n_mix=4, remat=True)


def _batches(n, batch=8, channels=1):
    """Binarized greyscale batches, or for ``channels=3`` RGB batches on
    the 256 levels the data pipeline gives."""
    rng = np.random.RandomState(42)
    if channels == 3:
        return [(rng.randint(0, 256, (batch, 32, 32, 3)) / 255.0).astype(
            np.float32) for _ in range(n)]
    return [(rng.rand(batch, 32, 32, 1) < 0.4).astype(np.float32)
            for _ in range(n)]


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _run_single(state, tx, tc, batches):
    """The ``grad_accum`` step over ``batches``: the final state, and each
    step's metrics and model state."""
    step = make_train_step(state.model, tx, tc, TOTAL_STEPS, STEPS_PER_EPOCH)
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append((_metrics(m), copy.deepcopy(state.model.state_dict())))
    return state, out


def _pipeline(state, tc, S, M, tx_factory=None, schedule=None):
    return PipelineTrainer(
        state.model, dataclasses.replace(tc, grad_accum=1), TOTAL_STEPS,
        STEPS_PER_EPOCH, n_stages=S, n_microbatches=M, devices=["cpu"] * S,
        state=state, tx_factory=tx_factory, schedule=schedule)


def _run_pipeline(pp, batches):
    """Pipeline steps over ``batches``: each step's metrics and merged
    model state."""
    out = []
    for b in batches:
        m = pp.step(b)
        out.append((_metrics(m),
                    copy.deepcopy(pp.merged_state().model.state_dict())))
    return out


def _losses(run):
    return [m["loss"] for m, _ in run]


def _max_delta(a, b):
    assert list(a) == list(b)
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _assert_losses(ref, got, rtol=LOSS_RTOL):
    assert len(ref) == len(got)
    for loss_r, loss_p in zip(_losses(ref), _losses(got)):
        assert np.isfinite(loss_p)
        assert abs(loss_r - loss_p) <= rtol * max(abs(loss_r), 1.0)


def test_stage_names():
    """The groupings of ``nvae_tpu.parallel.stage_names``; 5 stages
    raise."""
    from nvae_tpu.parallel import stage_names as jax_stage_names

    for n in range(1, 5):
        assert stage_names(n) == jax_stage_names(n)
    with pytest.raises(ValueError, match="1-4 stages"):
        stage_names(5)


@pytest.mark.parametrize("mode", ["projection", "forward", "penalty"])
@pytest.mark.parametrize("S,M", [(2, 2), (3, 2), (4, 2), (4, 4)])
def test_lockstep_with_grad_accum_step(S, M, mode):
    """S stages over M microbatches equal the ``grad_accum=M`` step over 3
    SGD steps: every metric (the penalties' too: ``spectral_loss`` in
    penalty mode) and every parameter, BatchNorm statistic and
    forward-mode ``u`` after each step."""
    tc, state, tx = _setup(mode, M)
    pp = _pipeline(_copy(state), tc, S, M, _sgd_chain(mode))
    batches = _batches(3)
    _, ref = _run_single(_copy(state), tx, tc, batches)
    got = _run_pipeline(pp, batches)
    _assert_losses(ref, got)
    for (m_r, sd_r), (m_p, sd_p) in zip(ref, got):
        assert set(m_r) == set(m_p)
        for k in m_r:
            np.testing.assert_allclose(m_p[k], m_r[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        assert _max_delta(sd_r, sd_p) <= STATE_ATOL


@pytest.mark.parametrize("S", [2, 4])
def test_lockstep_dml_remat_rgb(S):
    """The DML head, remat and RGB together (``cifar10_dml``'s and
    ``celeba64``'s forms at debug size), M=2: the remat cells run again
    inside a stage's recompute, the DML loss sits in the last stage, and
    the pipeline equals the ``grad_accum=2`` step over 3 SGD steps (every
    metric, parameter and BatchNorm statistic after each step).  A remat
    cell's second run updates no buffer: a second BatchNorm update would
    move the statistics by far more than the limit."""
    M = 2
    tc, state, tx = _setup(M=M, **DML_REMAT)
    assert state.model.cfg.remat and state.model.cfg.likelihood == "dml"
    pp = _pipeline(_copy(state), tc, S, M, _sgd_chain("projection"))
    batches = _batches(3, channels=3)
    _, ref = _run_single(_copy(state), tx, tc, batches)
    got = _run_pipeline(pp, batches)
    _assert_losses(ref, got)
    for (m_r, sd_r), (m_p, sd_p) in zip(ref, got):
        assert set(m_r) == set(m_p)
        for k in m_r:
            np.testing.assert_allclose(m_p[k], m_r[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        assert _max_delta(sd_r, sd_p) <= STATE_ATOL
    # The same model without remat (the same seed, so the same weights)
    # reaches the same state: no cell's second run updated a buffer.
    tc0, state0, tx0 = _setup(M=M, **{**DML_REMAT, "remat": False})
    assert _max_delta(state0.model.state_dict(),
                      state.model.state_dict()) == 0.0
    _, plain = _run_single(state0, tx0, tc0, batches)
    _assert_losses(plain, got)
    for (_, sd_r), (_, sd_p) in zip(plain, got):
        assert _max_delta(sd_r, sd_p) <= STATE_ATOL
    # The statistics moved (each step updates them once): the equality
    # above is not that of untouched buffers.
    start = state.model.state_dict()
    stats = [k for k in start if k.endswith("running_var")]
    assert stats and max(float((got[0][1][k] - start[k]).abs().max())
                         for k in stats) > 100 * STATE_ATOL


def _opt_delta(a, b):
    """Largest difference between two optimizer states' tensors, which
    must have the same structure."""
    ta, tb = topt.state_tensors(a), topt.state_tensors(b)
    assert len(ta) == len(tb)
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(ta, tb))


def test_production_optimizer_and_ema():
    """Adamax with cosine decay, the spectral projection and the EMA, per
    stage: the merged Adamax moments, spectral ``u`` and sigma and the EMA
    (``ema_params``) are the single step's, in its layout, after 3 steps
    (parameters within JAX's production bound, 3 lr a step)."""
    tc, state, tx = _setup(M=2, production=True, ema_decay=0.9)
    pp = _pipeline(_copy(state), tc, 2, 2)
    batches = _batches(3)
    ref_state, ref = _run_single(_copy(state), tx, tc, batches)
    got = _run_pipeline(pp, batches)
    _assert_losses(ref, got)
    assert _max_delta(ref[-1][1], got[-1][1]) <= 3 * LR * len(batches)
    merged = pp.merged_state()
    # The whole model's layout: the same checkpoint keys, then the same
    # moments, counts, u and sigma.
    assert (ckpt.flatten_state(merged).keys()
            == ckpt.flatten_state(ref_state).keys())
    assert _opt_delta(merged.opt_state, ref_state.opt_state) <= STATE_ATOL
    assert topt.find_spectral_state(merged.opt_state).u
    ema, ref_ema = pp.ema_params(), topt.find_ema_params(ref_state.opt_state)
    assert list(ema) == list(ref_ema)
    assert _max_delta(ema, ref_ema) <= 3 * LR * len(batches)
    assert _max_delta(ema, {k: p.detach() for k, p
                            in state.model.named_parameters()}) > 0
    plain = _pipeline(_copy(state), dataclasses.replace(tc, ema_decay=0.0),
                      2, 2)
    assert plain.ema_params() is None


@pytest.mark.parametrize("S", [2, 3])
def test_1f1b_equals_gpipe_bitwise(S):
    """The two dispatch orders give the same losses and state bit for bit;
    gpipe stashes all M microbatch inputs a stage, 1f1b at most 2."""
    M = 4
    tc, state, _ = _setup(M=1)
    runs = {}
    for schedule in ("gpipe", "1f1b"):
        pp = _pipeline(_copy(state), tc, S, M, _sgd_chain("projection"),
                       schedule)
        assert pp.schedule == schedule
        runs[schedule] = (_run_pipeline(pp, _batches(2)), pp.peak_stash)
    (g, stash_g), (f, stash_f) = runs["gpipe"], runs["1f1b"]
    assert [m for m, _ in g] == [m for m, _ in f]
    assert _max_delta(g[-1][1], f[-1][1]) == 0.0
    assert stash_g == M and stash_f <= 2


def test_checkpoints_restore_on_any_topology(tmp_path):
    """A pipeline's merged state has the single device's layout: its
    checkpoint restores into a single-device template bit for bit, EMA
    included, and into a pipeline of another stage count with the
    optimizer state (``restore_opt``); ``merged_state`` then
    ``load_state(restore_opt=True)`` continues exactly as an uninterrupted
    run."""
    tc, state, _ = _setup(M=2, production=True, ema_decay=0.9)
    batches = _batches(4)
    whole = _pipeline(_copy(state), tc, 2, 2)
    full = _run_pipeline(whole, batches)

    pp = _pipeline(_copy(state), tc, 2, 2)
    _run_pipeline(pp, batches[:2])
    mid = pp.merged_state()
    assert mid.step == 2
    ckpt.save_checkpoint(str(tmp_path / "c"), mid.step, mid)
    restored = ckpt.restore_checkpoint(str(tmp_path / "c"), _copy(state))
    assert _max_delta(restored.model.state_dict(),
                      mid.model.state_dict()) == 0.0
    assert _opt_delta(restored.opt_state, mid.opt_state) == 0.0

    # Another stage count resumes from it and ends where the 2-stage run
    # that never stopped ends.
    pp4 = _pipeline(_copy(state), tc, 4, 2)
    pp4.load_state(restored, restore_opt=True)
    assert pp4.step_count == 2
    assert _opt_delta(merge_opt_states(pp4.opt), mid.opt_state) == 0.0
    rest = _run_pipeline(pp4, batches[2:])
    assert _losses(rest) == _losses(full[2:])
    assert _max_delta(rest[-1][1], full[-1][1]) == 0.0
    assert _max_delta(pp4.ema_params(), whole.ema_params()) == 0.0

    # A checkpoint of another optimizer chain is refused.
    sgd = _pipeline(_copy(state), tc, 2, 2, _sgd_chain("projection"))
    with pytest.raises(ValueError, match="does not match"):
        sgd.load_state(restored, restore_opt=True)


def test_callers_state_is_left_untouched():
    """The stages own copies: the caller's model and optimizer state keep
    their bits through construction, steps and merges."""
    tc, state, _ = _setup(M=2, production=True)
    before = ckpt.flatten_state(_copy(state))
    pp = _pipeline(state, tc, 2, 2)
    _run_pipeline(pp, _batches(2))
    after = ckpt.flatten_state(state)
    assert before.keys() == after.keys()
    for k, v in before.items():
        assert (torch.equal(v, after[k]) if isinstance(v, torch.Tensor)
                else v == after[k]), k
    assert pp.merged_state().model is not state.model


def test_refusals(monkeypatch):
    """A schedule other than gpipe and 1f1b, ``grad_accum > 1``, ``dp > 1``
    in one process, a world that is not stages x dp, and fewer cards than
    stages raise, the layouts with the launcher's command and the cards
    with the JAX package's message; so do the Trainer's exclusions of a
    data mesh and ``scan_epochs``, and the CLI's ``--data_parallel 2`` in
    one process."""
    tc, state, _ = _setup(M=1)
    with pytest.raises(ValueError, match="pipeline_schedule"):
        _pipeline(state, tc, 2, 2, schedule="interleaved")
    with pytest.raises(ValueError, match="grad_accum"):
        PipelineTrainer(state.model, dataclasses.replace(tc, grad_accum=4),
                        TOTAL_STEPS, STEPS_PER_EPOCH, n_stages=2,
                        devices=["cpu"] * 2, state=state)
    launch = (r"torchrun --nproc_per_node 4 -m nvae_torch.cli --mode train "
              r"\.\.\. --pp_stages 2 --data_parallel 2")
    with pytest.raises(ValueError, match=r"2 stages x dp=2 runs 4 "
                       r"processes, one per device, not one: launch them "
                       r"with " + launch):
        PipelineTrainer(state.model, tc, TOTAL_STEPS, STEPS_PER_EPOCH,
                        n_stages=2, dp=2, devices=["cpu"] * 4, state=state)
    # JAX's default dp, the cards over the stages, in one process.
    with pytest.raises(ValueError, match=launch):
        pipeline_dp(2, 0, world=1, cards=4)
    assert pipeline_dp(2, 0, world=1, cards=1) == 1
    assert pipeline_dp(2, 0, world=4, cards=1) == 2
    # A world that is not stages x dp.
    with pytest.raises(ValueError, match=r"needs 4 ranks, one process per "
                       r"device: launch them with " + launch
                       + r" \(this is a world of 6\)"):
        pipeline_dp(2, 2, world=6, cards=1)
    with pytest.raises(ValueError, match=r"3 stages x dp=1 needs 3 ranks.*"
                       r"--nproc_per_node 3 .*world of 4"):
        check_layout(3, 1, 4)
    with pytest.raises(SystemExit, match="--pp_stages: .*" + launch):
        cli.main(["--mode", "train", "--cpu", "--pp_stages", "2",
                  "--data_parallel", "2"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"pipeline needs 2 devices "
                       r"\(2 stages x dp=1\), have 1"):
        PipelineTrainer(state.model, tc, TOTAL_STEPS, STEPS_PER_EPOCH,
                        n_stages=2, state=state)
    from nvae_torch.parallel.mesh import DataMesh

    cfg = debug_config(use_pallas_kernels=True)
    mesh = DataMesh(rank=0, size=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does its own placement"):
        Trainer(cfg, TrainConfig(pipeline_stages=2), 4, mesh=mesh)
    with pytest.raises(ValueError, match="excludes scan_epochs"):
        Trainer(cfg, TrainConfig(pipeline_stages=2, scan_epochs=True), 4,
                device="cpu")


def test_cli_trains_resumes_and_samples(tmp_path, capsys, monkeypatch,
                                        no_tensorboard):  # noqa: F811
    """``--mode train --cpu --pp_stages 2 --pp_microbatches 2
    --pp_schedule gpipe`` trains 2 epochs with a checkpoint each, resumes
    from the second for a third, and ``--mode sample`` reads its
    checkpoint; the CPU runs the kernels' plain versions."""
    for fn in _kernel_wrappers():
        monkeypatch.setattr(fn, "launches", 0)
    argv = ["--mode", "train", "--pp_stages", "2", "--pp_microbatches", "2",
            "--pp_schedule", "gpipe", "--evaluate_frequency", "1",
            "--sample_frequency", "1", "--model_save_frequency", "1",
            *_cli_argv(tmp_path)]
    cli.main(["--epochs", "2", *argv])
    out = capsys.readouterr().out
    assert "Pipeline: 2 stages x dp=1, gpipe over 2 microbatches" in out
    assert "Training done: best_loss=" in out
    assert ckpt.all_steps(str(tmp_path / "models")) == [4, 8]
    cli.main(["--epochs", "3", *argv])
    assert "Training done: best_loss=" in capsys.readouterr().out
    assert ckpt.all_steps(str(tmp_path / "models")) == [4, 8, 12]
    payload = ckpt.load_payload(str(tmp_path / "models"), 12)
    assert payload["step"] == 12
    counts = [v for k, v in payload.items() if k.endswith("/count")]
    assert counts and all(v == 12 for v in counts)
    lines = _jsonl(tmp_path / "logs" / "metrics.jsonl")
    assert [r["step"] for r in lines if "train/loss" in r] == [0, 1, 2]
    assert all(np.isfinite(r["train/loss"]) for r in lines
               if "train/loss" in r)
    assert sum("test/elbo" in r for r in lines) == 3
    assert [fn.launches for fn in _kernel_wrappers()] == [0] * 5

    cli.main(["--mode", "sample", "--n_samples", "4", "--pp_stages", "2",
              *_cli_argv(tmp_path)])
    assert "(step 12)" in capsys.readouterr().out
    pngs = os.listdir(tmp_path / "results" / "t_1.0")
    assert len([f for f in pngs if f.endswith(".png")]) == 4


def test_bf16_depthwise_against_grad_accum_step():
    """bf16 compute and BatchNorm apply with the depthwise postprocess
    (JAX's ``test_pipeline_best_perf_config_bf16_depthwise``) at 3 stages
    against the ``grad_accum=2`` step, at JAX's bf16 limits: loss within
    2e-2 relative, parameters within 5e-3 after 3 SGD steps."""
    tc, state, tx = _setup(M=2, compute_dtype="bfloat16",
                           bn_apply_dtype="bfloat16",
                           postprocess_5x5_depthwise=True)
    pp = _pipeline(_copy(state), tc, 3, 2, _sgd_chain("projection"))
    batches = _batches(3)
    _, ref = _run_single(_copy(state), tx, tc, batches)
    got = _run_pipeline(pp, batches)
    _assert_losses(ref, got, rtol=2e-2)
    params = [k for k, _ in state.model.named_parameters()]
    assert _max_delta({k: ref[-1][1][k] for k in params},
                      {k: got[-1][1][k] for k in params}) <= 5e-3
