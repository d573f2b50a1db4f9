"""The port's training entry point on the CPU at a tiny size: the Trainer
(fit, artifacts, bitwise resume, early stopping, preemption, the sampling
sweep), checkpoints (round trip, the async writer's snapshot) and the CLI
(train and sample with --cpu, presets, unported flags).  Mirrors
``tests/test_trainer.py``, ``tests/test_data.py``'s checkpoint tests and
``tests/test_cli.py`` of the JAX package."""

import contextlib
import json
import os
import shutil
import signal
import sys

import numpy as np
import pytest
import torch

from nvae_torch import cli
from nvae_torch.config import TrainConfig, debug_config
from nvae_torch.data import make_iterators, synthetic_dataset
from nvae_torch.train import checkpoint as ckpt
from nvae_torch.train.state import create_train_state
from nvae_torch.train.step import make_train_step
from nvae_torch.train.trainer import Trainer
from nvae_torch.utils.logging import MetricsLogger

@contextlib.contextmanager
def single_torch_thread():
    """One intra-op thread inside the block: under the suite's parallel
    workers, PyTorch's default of a thread per core in every worker
    oversubscribes the cores and slows these small CPU steps many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def one_torch_thread():
    with single_torch_thread():
        yield


pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY_ARCH = [
    "--n_encoder_channels", "8", "--n_decoder_channels", "8",
    "--n_groups_per_scale", "1", "1", "--n_latent_per_group", "2",
    "--n_preprocess_blocks", "1", "--n_preprocess_cells", "2",
    "--n_postprocess_blocks", "1", "--n_postprocess_cells", "2",
]


def _tiny_cfg():
    return debug_config(n_groups_per_scale=(1, 1), n_latent_per_group=2,
                        use_pallas_kernels=True)


def _train_cfg(tmp_path, **kw):
    base = dict(batch_size=8, step_based_warmup=True,
                model_save_dir=str(tmp_path / "models"),
                tensorboard_log_dir=str(tmp_path / "logs"))
    base.update(kw)
    return TrainConfig(**base)


def _iters(n_train=32, n_test=16, seed=0):
    bundle = synthetic_dataset(n_train=n_train, n_test=n_test, seed=seed)
    return make_iterators(bundle, 8, seed=seed, device="cpu")


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


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_fit_artifacts_and_bitwise_resume(tmp_path):
    """A 3-epoch run, and the same run resumed from its step-8 checkpoint,
    end in the same state bit for bit: the image and eval hooks change
    nothing, and the checkpoint holds all of the state."""
    tc = _train_cfg(tmp_path, epochs=3, sample_frequency=1,
                    evaluate_frequency=1, model_save_frequency=1)
    train_iter, test_iter = _iters()
    logger = MetricsLogger(tc.tensorboard_log_dir, tensorboard=False)
    trainer = Trainer(_tiny_cfg(), tc, len(train_iter), logger=logger,
                      device="cpu")
    result = trainer.fit(train_iter, test_iter)
    logger.close()
    assert len(result.history) == 3 and trainer.state.step == 12
    assert not result.interrupted and np.isfinite(result.best_loss)
    assert ckpt.all_steps(trainer.ckpt_dir) == [4, 8, 12]
    lines = _jsonl(tmp_path / "logs" / "metrics.jsonl")
    train = [r for r in lines if "train/loss" in r]
    test = [r for r in lines if "test/elbo" in r]
    saves = [r for r in lines if "checkpoint/total_ms" in r]
    assert [r["step"] for r in train] == [r["step"] for r in test] == [0, 1, 2]
    assert all(np.isfinite(v) for r in train + test for v in r.values())
    assert all(r["train/images_per_sec"] > 0 for r in train)
    assert [r["step"] for r in saves] == [4, 8, 12]
    dirs = os.listdir(tmp_path / "logs" / "images")
    for t in ("0.7", "0.8", "0.9", "1.0"):
        assert f"samples_t{t}_step2" in dirs
    assert len(os.listdir(tmp_path / "logs" / "images"
                          / "test_reconstruction_step0")) == 3
    final = _flat(trainer.state)

    # Resume from step 8 in a fresh trainer: epoch 2 again, the same end.
    shutil.rmtree(os.path.join(trainer.ckpt_dir, "12"))
    again = Trainer(_tiny_cfg(), tc, len(train_iter), device="cpu")
    assert again.maybe_resume() == 2 and again.state.step == 8
    _assert_same(_flat(again.state), ckpt.load_payload(trainer.ckpt_dir, 8))
    again.fit(*_iters())
    _assert_same(_flat(again.state), final)


def test_early_stopping_restores_the_best_state(tmp_path):
    # Epoch-based warm-up: beta rises each epoch, and so does the loss on a
    # tiny fixed set after the first epochs.
    tc = _train_cfg(tmp_path, epochs=20, patience=1, sample_frequency=1000,
                    model_save_frequency=1000, evaluate_frequency=0,
                    step_based_warmup=False)
    train_iter, _ = _iters(n_train=16, n_test=8, seed=1)
    trainer = Trainer(_tiny_cfg(), tc, len(train_iter), device="cpu")
    seen = []
    result = trainer.fit(train_iter, on_epoch_end=lambda e, tr, m: seen.append(
        (m["loss"], _flat(tr.state))))
    assert len(result.history) < 20  # stopped early
    best = min(range(len(seen)), key=lambda i: seen[i][0])
    assert best == len(seen) - 2 and result.best_loss == seen[best][0]
    _assert_same(_flat(trainer.state), seen[best][1])


def test_sigterm_preemption_checkpoints_and_resumes(tmp_path):
    tc = _train_cfg(tmp_path, epochs=20, sample_frequency=1000,
                    model_save_frequency=1000, evaluate_frequency=0)
    train_iter, _ = _iters(n_train=16, n_test=8, seed=3)
    trainer = Trainer(_tiny_cfg(), tc, len(train_iter), device="cpu")

    def preempt_at_epoch_1(epoch, tr, means):
        if epoch == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    prev_handler = signal.getsignal(signal.SIGTERM)
    result = trainer.fit(train_iter, on_epoch_end=preempt_at_epoch_1)
    assert result.interrupted and len(result.history) < 20
    assert signal.getsignal(signal.SIGTERM) is prev_handler
    assert ckpt.latest_step(trainer.ckpt_dir) == result.state.step
    fresh = Trainer(_tiny_cfg(), tc, len(train_iter), device="cpu")
    assert fresh.maybe_resume() == result.state.step // len(train_iter)
    _assert_same(_flat(fresh.state), _flat(result.state))


def test_sample_images_sweep_matches_per_temperature_semantics(tmp_path):
    """The sweep returns one n_per_t block per temperature, bitwise the
    per-sample-vector call with the same seed; sampling leaves the model in
    training mode with its buffers untouched."""
    trainer = Trainer(_tiny_cfg(), _train_cfg(tmp_path, epochs=1), 1,
                      device="cpu")
    before = _flat(trainer.state)
    sweep = trainer.sample_images_sweep(2, (0.7, 1.0), seed=3)
    assert set(sweep) == {0.7, 1.0}
    assert all(b.shape == (2, 32, 32, 1) for b in sweep.values())
    direct, *_ = trainer.sample_images(
        4, torch.tensor([0.7, 0.7, 1.0, 1.0]), seed=3)
    assert torch.equal(direct[:2], sweep[0.7])
    assert torch.equal(direct[2:], sweep[1.0])
    assert trainer.model.training
    _assert_same(_flat(trainer.state), before)
    recon = trainer.reconstruct_images(next(iter(_iters()[1])))
    assert recon.shape == (3, 32, 32, 1)
    _assert_same(_flat(trainer.state), before)
    with pytest.raises(ValueError, match="no EMA"):
        trainer.swap_in_ema()


def _stepped_state(tc, steps=1):
    model, state, tx = create_train_state(_tiny_cfg(), tc, 10, device="cpu")
    step = make_train_step(model, tx, tc, 10, 5)
    batch = (np.random.RandomState(0).rand(8, 32, 32, 1) > 0.5).astype(
        np.float32)
    for _ in range(steps):
        state, _ = step(state, batch)
    return state, step, batch


def test_checkpoint_round_trip(tmp_path):
    tc = TrainConfig(batch_size=8, step_based_warmup=True, ema_decay=0.9)
    state, _, _ = _stepped_state(tc)
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 5, state)
    assert ckpt.latest_step(d) == 5 and ckpt.all_steps(d) == [5]
    # No pickled class: the file loads with weights_only.
    raw = torch.load(os.path.join(d, "5", ckpt.FILE), weights_only=True)
    assert raw["step"] == 1 and any(k.startswith("opt/") for k in raw)
    template = create_train_state(_tiny_cfg(), tc, 10, device="cpu", seed=9)[1]
    restored = ckpt.restore_checkpoint(d, template)
    _assert_same(_flat(restored), _flat(state))
    assert restored.model is template.model
    # A template without the EMA slot does not fit the checkpoint.
    no_ema = create_train_state(_tiny_cfg(), TrainConfig(), 10,
                                device="cpu")[1]
    with pytest.raises(ValueError, match="optimizer state differs"):
        ckpt.restore_checkpoint(d, no_ema)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(d, template, step=6)
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_async_checkpoint_writer_snapshot_semantics(tmp_path):
    """``save`` snapshots the state before it returns: the next step updates
    the parameters in place while the write may be in flight, and the
    checkpoint still holds the state at the save; a re-save of the same step
    is skipped."""
    tc = TrainConfig(batch_size=8, step_based_warmup=True)
    state, step, batch = _stepped_state(tc)
    snapshot = _flat(state)
    d = str(tmp_path / "ckpt")
    with ckpt.AsyncCheckpointWriter(d) as w:
        assert w.save(1, state)
        state, _ = step(state, batch)  # writes the parameters in place
        assert not w.save(1, state)  # same step: skipped, not clobbered
        w.wait()
        assert [t[0] for t in w.timings] == [1]
        assert 0.0 <= w.timings[0][1] <= w.timings[0][2]
    _assert_same(ckpt.load_payload(d, 1), snapshot)
    assert not _flat(state)["model/decoder.h"].equal(snapshot["model/decoder.h"])
    # A new writer knows the steps on disk.
    with ckpt.AsyncCheckpointWriter(d) as w:
        assert not w.save(1, state) and w.save(2, state)
    assert ckpt.all_steps(d) == [1, 2]


def _cli_argv(tmp_path, *extra):
    return [
        "--dataset", "synthetic", "--debug", "--cpu", "--batch_size", "4",
        "--seed", "0", *TINY_ARCH, "--use_pallas", "--step_based_warmup",
        "--model_save_dir", str(tmp_path / "models"),
        "--sample_dir", str(tmp_path / "results"),
        "--tensorboard_log_dir", str(tmp_path / "logs"), *extra,
    ]


@pytest.fixture
def no_tensorboard(monkeypatch):
    """Keep the logger's optional TensorBoard mirror out of the CLI tests."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _kernel_wrappers():
    from nvae_torch.kernels import depthwise
    from nvae_torch.kernels.se_gate import se_gate

    return [getattr(depthwise, name) for name in (
        "fused_swish_depthwise5x5", "depthwise_conv5x5",
        "fused_swish_depthwise5x5_dx", "fused_swish_depthwise5x5_dw")] + [
        se_gate]


def test_cli_train_then_sample_on_the_cpu(tmp_path, capsys, monkeypatch,
                                          no_tensorboard):
    for fn in _kernel_wrappers():
        monkeypatch.setattr(fn, "launches", 0)
    cli.main(["--mode", "train", "--epochs", "1", "--evaluate_frequency", "1",
              "--sample_frequency", "1", "--model_save_frequency", "1",
              *_cli_argv(tmp_path)[:]])
    out = capsys.readouterr().out
    assert "Training done: best_loss=" in out and "img/s" in out
    assert ckpt.all_steps(str(tmp_path / "models")) == [4]
    lines = _jsonl(tmp_path / "logs" / "metrics.jsonl")
    assert sum("train/loss" in r for r in lines) == 1
    assert sum("test/elbo" in r for r in lines) == 1
    # The CPU runs the kernels' plain versions: no launch is counted.
    assert [fn.launches for fn in _kernel_wrappers()] == [0] * 5

    cli.main(["--mode", "sample", "--n_samples", "8",
              "--scale_temperatures", "0.6", "0.9", *_cli_argv(tmp_path)])
    out = capsys.readouterr().out
    assert "(step 4)" in out
    for t in ("t_0.7", "t_0.8", "t_0.9", "t_1.0", "t_annealed"):
        pngs = [(tmp_path / "results" / t / f).read_bytes()
                for f in os.listdir(tmp_path / "results" / t)
                if f.endswith(".png")]
        assert len(pngs) == 8, t
        assert pngs[0][:8] == b"\x89PNG\r\n\x1a\n"
        # As in the JAX CLI, every batch index draws from the step's
        # sampling key: the second batch of 4 repeats the first.
        assert len(set(pngs)) <= 4, t
    with pytest.raises(SystemExit, match="one value per decoder scale"):
        cli.main(["--mode", "sample", "--scale_temperatures", "1", "1", "1",
                  *_cli_argv(tmp_path)])


def _configs_seen_by_cli(pkg, argv, monkeypatch, fast_preset):
    """Run ``pkg``'s CLI (``"nvae_torch"`` or ``"nvae_tpu"``) on ``argv``
    up to its Trainer; returns the model and training configs it builds
    and the settings it hands ``make_iterators``, as plain dicts."""
    import dataclasses
    import importlib

    cli_mod = importlib.import_module(f"{pkg}.cli")
    presets = importlib.import_module(f"{pkg}.presets")
    data = importlib.import_module(f"{pkg}.data")
    trainer_mod = importlib.import_module(f"{pkg}.train.trainer")
    logging_mod = importlib.import_module(f"{pkg}.utils.logging")
    if fast_preset:
        # A preset that turns a switch on, which unset flags must keep.
        base_model, base_train = presets.get_preset("mnist_step_sn")
        fast = dataclasses.replace(base_model, postprocess_5x5_depthwise=True)
        monkeypatch.setattr(presets, "get_preset",
                            lambda name: (fast, base_train))
    seen = {}

    class _StopEarly(Exception):
        pass

    class _CapturingTrainer:
        def __init__(self, model_cfg, train_cfg, **kw):
            seen.update(model=dataclasses.asdict(model_cfg),
                        train=dataclasses.asdict(train_cfg))
            raise _StopEarly

    class _NoLogger:
        def __init__(self, *a, **kw):
            pass

        def close(self):
            pass

    def capture_iterators(bundle, batch_size, **kw):
        seen["iterators"] = {"batch_size": batch_size, **{
            k: kw[k] for k in ("target_size", "binarize",
                               "parity_binarize_255", "seed", "debug")}}
        return [None] * 4, [None] * 4

    monkeypatch.setattr(trainer_mod, "Trainer", _CapturingTrainer)
    monkeypatch.setattr(data, "make_iterators", capture_iterators)
    monkeypatch.setattr(logging_mod, "MetricsLogger", _NoLogger)
    if pkg == "nvae_tpu":
        from nvae_tpu.utils import compile_cache

        monkeypatch.setattr(compile_cache, "enable_compile_cache",
                            lambda *a, **kw: None)
    with pytest.raises(_StopEarly):
        cli_mod.main(list(argv))
    return seen


@pytest.mark.parametrize("extra,fast_preset", [
    # A preset's switches survive unset flags; explicit switches turn
    # features on; the preset's batch size, warm-up and parity settings win
    # over the flags, and the data pipeline takes --parity_binarize_255.
    (["--preset", "mnist_step_sn_parity", "--batch_size", "16",
      "--use_pallas", "--parity_frozen_norm"], False),
    (["--preset", "mnist_step_sn", "--parity_binarize_255",
      "--ema_decay", "0.99", "--step_based_warmup"], True),
    (["--preset", "mnist_epoch_sn", "--mode", "sample", "--binary_eval",
      "--use_ema", "--n_samples", "7"], False),
    (["--batch_size", "8", *TINY_ARCH, "--parity_binarize_255",
      "--ema_decay", "0.5", "--spectral_mode", "forward"], False),
    (["--batch_size", "8", *TINY_ARCH, "--scan_epochs"], False),
    # The RGB presets on their synthetic stand-ins: DML, no binarization,
    # celeba64's remat and 64x64 target kept, the preset's batch size.
    (["--preset", "cifar10_dml", "--dataset", "synthetic_rgb",
      "--use_pallas", "--batch_size", "16"], False),
    (["--preset", "celeba64", "--dataset", "synthetic_rgb64",
      "--use_pallas", "--scan_epochs"], False),
    (["--batch_size", "8", *TINY_ARCH, "--dataset", "synthetic_rgb",
      "--remat"], False),
])
def test_preset_flags_not_clobbered(tmp_path, monkeypatch, extra,
                                    fast_preset):
    """The port's CLI builds the same model and training configs, and
    hands the data pipeline the same settings, as the JAX CLI does for the
    same command line, with and without a preset."""
    monkeypatch.setenv("JAX_PLATFORMS", os.environ.get("JAX_PLATFORMS",
                                                       "cpu"))
    argv = ["--mode", "train", "--dataset", "synthetic", "--debug", "--cpu",
            "--epochs", "3", "--seed", "5",
            "--model_save_dir", str(tmp_path / "m"),
            "--sample_dir", str(tmp_path / "s"),
            "--tensorboard_log_dir", str(tmp_path / "l"), *extra]
    port = _configs_seen_by_cli("nvae_torch", argv, monkeypatch, fast_preset)
    ref = _configs_seen_by_cli("nvae_tpu", argv, monkeypatch, fast_preset)
    assert port == ref
    if fast_preset:
        assert port["model"]["postprocess_5x5_depthwise"]


# Parameters of the RGB presets (use_pallas_kernels=True, as the chip run
# drives them), as the JAX model's jax.eval_shape counts them.
PRESET_PARAMS = {"cifar10_dml": 202_707_746, "celeba64": 710_515_186}


@pytest.mark.parametrize("name", [
    "mnist_step_sn", "mnist_step_sn_parity", "mnist_step_sr",
    "mnist_epoch_sn", "omniglot_deep", "fashion_mnist_deep", "cifar10_dml",
    "celeba64"])
def test_every_preset_builds_and_equals_jax_config(name):
    """Each preset returns the JAX package's configs field for field and
    builds (on the meta device: no weights); the RGB presets' parameter
    counts are the JAX model's."""
    import dataclasses

    from nvae_torch.models.nvae import NVAE
    from nvae_torch.presets import PRESETS, get_preset
    from nvae_tpu.presets import get_preset as jax_preset

    assert name in PRESETS
    model_cfg, train_cfg = get_preset(name)
    want_model, want_train = jax_preset(name)
    assert dataclasses.asdict(model_cfg) == dataclasses.asdict(want_model)
    assert dataclasses.asdict(train_cfg) == dataclasses.asdict(want_train)
    cfg = dataclasses.replace(model_cfg, use_pallas_kernels=True)
    model = NVAE(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n > 0 and model_cfg.shapes().base_size >= 1
    if name in PRESET_PARAMS:
        import jax
        import jax.numpy as jnp

        from nvae_tpu.models import NVAE as JaxNVAE

        jm = JaxNVAE(dataclasses.replace(want_model, use_pallas_kernels=True))
        s = cfg.image_size
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0),
             "sample": jax.random.PRNGKey(1)},
            jnp.zeros((1, s, s, cfg.in_channels)), True))
        assert n == PRESET_PARAMS[name] == sum(
            x.size for x in jax.tree_util.tree_leaves(shapes["params"]))
        assert model.postprocess.head.weight.shape[0] == 70


@pytest.mark.parametrize("extra,match", [
    # --data_parallel N > 1 in a world of 1 names the launcher it needs.
    (["--mode", "test", "--data_parallel", "2"], "torchrun --nproc_per_node 2"),
    (["--mode", "serve", "--data_parallel", "2"],
     "torchrun --nproc_per_node 2"),
    # --fsdp trains (tests/test_torch_parallel.py), and so does
    # --pp_stages (tests/test_torch_pipeline.py); the pair stops with JAX's
    # refusal.  The pipeline's data-parallel stages (ROADMAP.md Queue 1
    # #14, the case's id) are S*N processes: in a world of 1 they stop
    # with the launcher's line (tests/test_torch_pipeline_dp.py trains
    # them in a world of 4).
    (["--fsdp", "--pp_stages", "2"], "excludes --fsdp/--scan_epochs"),
    pytest.param(["--pp_stages", "2", "--data_parallel", "2"],
                 "torchrun --nproc_per_node 4 -m nvae_torch.cli --mode train "
                 r"\.\.\. --pp_stages 2 --data_parallel 2",
                 id="extra3-Queue 1 #14"),
    (["--data_parallel", "2"], "torchrun --nproc_per_node 2"),
])
def test_unported_modes_and_flags_stop_the_run(tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["--mode", "train", *_cli_argv(tmp_path), *extra])


def test_cli_scan_epochs_trains_and_resumes_on_the_cpu(tmp_path, capsys,
                                                       no_tensorboard):
    """``--mode train --scan_epochs --cpu`` at debug size trains 2 epochs
    through the epoch runner (no graph on the CPU), with a checkpoint per
    epoch, then resumes for a third."""
    argv = ["--mode", "train", "--scan_epochs", "--evaluate_frequency", "1",
            "--sample_frequency", "1", "--model_save_frequency", "1",
            *_cli_argv(tmp_path)]
    cli.main(["--epochs", "2", *argv])
    assert "Training done: best_loss=" in capsys.readouterr().out
    assert ckpt.all_steps(str(tmp_path / "models")) == [4, 8]
    cli.main(["--epochs", "3", *argv])
    assert "Training done: best_loss=" in capsys.readouterr().out
    assert ckpt.all_steps(str(tmp_path / "models")) == [4, 8, 12]
    payload = ckpt.load_payload(str(tmp_path / "models"), 12)
    counts = [v for k, v in payload.items() if k.endswith("/count")]
    assert counts and all(v == 12 for v in counts)  # written as integers
    lines = _jsonl(tmp_path / "logs" / "metrics.jsonl")
    assert [r["step"] for r in lines if "train/loss" in r] == [0, 1, 2]
    assert sum("test/elbo" in r for r in lines) == 3
    assert [fn.launches for fn in _kernel_wrappers()] == [0] * 5


@pytest.mark.parametrize("extra", [
    ["--pp_microbatches", "2"], ["--pp_schedule", "gpipe"],
])
def test_flags_of_unported_paths_are_unknown(tmp_path, monkeypatch, extra):
    """The JAX CLI's pipeline-schedule flags, which the port declares now
    that the pipeline runs, parse into the same ``TrainConfig`` as the JAX
    CLI builds from the same command line."""
    argv = ["--mode", "train", "--dataset", "synthetic", "--debug", "--cpu",
            "--batch_size", "8", *TINY_ARCH, "--pp_stages", "2",
            "--model_save_dir", str(tmp_path / "m"),
            "--tensorboard_log_dir", str(tmp_path / "l"), *extra]
    port = _configs_seen_by_cli("nvae_torch", argv, monkeypatch, False)
    ref = _configs_seen_by_cli("nvae_tpu", argv, monkeypatch, False)
    assert port == ref
    train = port["train"]
    assert train["pipeline_stages"] == 2
    assert (train["pipeline_microbatches"], train["pipeline_schedule"]) == (
        (2, "1f1b") if "--pp_microbatches" in extra else (0, "gpipe"))


def _serve_captured(tmp_path, monkeypatch, *extra):
    """``--mode serve`` with the HTTP server replaced by a recorder of what
    the CLI hands it."""
    from nvae_torch import serving_http

    captured = {}

    def fake_serve(call_fn, batch_size, **kw):
        captured.update(call_fn=call_fn, batch_size=batch_size, **kw)

    monkeypatch.setattr(serving_http, "serve", fake_serve)
    cli.main(["--mode", "serve", *_cli_argv(tmp_path), *extra])
    return captured


def test_serve_mode_wiring(tmp_path, monkeypatch, no_tensorboard):
    """--mode serve hands the HTTP layer a warmed (seed, f32[B]) -> images
    sampler with the CLI's batch, host, port and delay, and a reloader
    (after ``tests/test_cli.py::test_serve_mode_wiring``)."""
    captured = _serve_captured(
        tmp_path, monkeypatch, "--data_parallel", "1", "--serve_port", "8123",
        "--serve_max_delay_ms", "3", "--serve_batches", "2")
    assert captured["batch_size"] == [2, 4]  # --batch_size 4 and 2
    assert captured["port"] == 8123 and captured["host"] == "127.0.0.1"
    assert captured["max_delay_ms"] == 3.0 and captured["drain_signals"]
    call = captured["call_fn"]
    t = torch.full((4,), 0.8)
    imgs = call(2, t)
    assert imgs.shape == (4, 32, 32, 1)
    assert torch.equal(imgs, call(2, t))  # the server's replay guarantee
    assert captured["reloader_factory"] is not None
    assert call.info["step"] == 0  # no checkpoint yet: fresh weights
    assert call.info["serve_dtype"] == "float32"


def test_serve_dtype_reaches_the_sampler(tmp_path, monkeypatch,
                                         no_tensorboard):
    call = _serve_captured(tmp_path, monkeypatch, "--serve_dtype", "int8",
                           "--serve_output", "uint8")["call_fn"]
    assert call.info["serve_dtype"] == "int8"
    assert call.info["output_dtype"] == "uint8"
    assert call(2, torch.full((4,), 0.8)).dtype == torch.uint8


def test_png_writer_and_tiles_match_the_jax_package(tmp_path):
    """The stdlib PNG encoder's files decode (PIL) to the bytes written;
    ``tile_images`` and ``to_uint8`` equal the JAX package's."""
    from PIL import Image

    from nvae_torch.utils import images as timg
    from nvae_tpu.utils import images as jimg

    rng = np.random.RandomState(0)
    x = rng.rand(5, 6, 7, 1).astype(np.float32)
    np.testing.assert_array_equal(timg.tile_images(x), jimg.tile_images(x))
    np.testing.assert_array_equal(timg.to_uint8(x), jimg.to_uint8(x))
    for c in (1, 3):
        img = rng.randint(0, 256, size=(6, 7, c)).astype(np.uint8)
        path = tmp_path / f"rgb{c}.png"
        path.write_bytes(timg.encode_png(img))
        back = np.asarray(Image.open(path))
        np.testing.assert_array_equal(back.reshape(6, 7, c), img)
    timg.save_images_to_dir(x, str(tmp_path / "dir"))
    files = sorted(os.listdir(tmp_path / "dir"))
    decoded = sorted(np.asarray(Image.open(tmp_path / "dir" / f)).tobytes()
                     for f in files)
    assert decoded == sorted(a[..., 0].tobytes() for a in timg.to_uint8(x))
    with pytest.raises(ValueError, match="uint8"):
        timg.encode_png(x[0])
