"""The port's CLI on the RGB and rematerialized paths, on the CPU at a tiny
size: ``--mode train`` for one epoch, a resumed second epoch, then ``--mode
sample``, with the DML head (picked by an RGB dataset, or asked for with
``--likelihood dml``), with ``--remat``, and at 64x64 on the scan path.
The presets themselves are full width: ``tests/test_torch_trainer.py``
holds their configs to the JAX CLI's, and ``chip_smoke.py`` runs them on
the card."""

import os

import pytest

from nvae_torch import cli
from nvae_torch.train import checkpoint as ckpt
from nvae_torch.utils.images import decode_png
from tests.test_torch_trainer import (  # noqa: F401  (fixtures)
    _cli_argv,
    _jsonl,
    _kernel_wrappers,
    no_tensorboard,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("extra,channels,size", [
    (["--dataset", "synthetic_rgb"], 3, 32),
    (["--dataset", "synthetic_rgb", "--likelihood", "dml", "--remat"], 3, 32),
    (["--remat"], 1, 32),
    (["--dataset", "synthetic_rgb64", "--remat", "--scan_epochs"], 3, 64),
])
def test_cli_rgb_and_remat_train_resume_and_sample(tmp_path, capsys,
                                                   no_tensorboard, extra,
                                                   channels, size):
    argv = [*_cli_argv(tmp_path), "--evaluate_frequency", "1",
            "--sample_frequency", "1", "--model_save_frequency", "1", *extra]
    cli.main(["--mode", "train", "--epochs", "1", *argv])
    out = capsys.readouterr().out
    assert "Training done: best_loss=" in out
    likelihood = "dml" if channels == 3 else "bernoulli"
    cli.main(["--mode", "train", "--epochs", "2", *argv])
    assert "Training done: best_loss=" in capsys.readouterr().out
    assert ckpt.all_steps(str(tmp_path / "models")) == [4, 8]
    lines = _jsonl(tmp_path / "logs" / "metrics.jsonl")
    train = [r for r in lines if "train/loss" in r]
    assert [r["step"] for r in train] == [0, 1]
    assert all(abs(v) < float("inf") for r in lines for v in r.values())
    # A DML model's loss is over 256 levels of each channel, in nats.
    if likelihood == "dml":
        assert train[0]["train/reconstruction_loss"] > 1000.0
    images = os.listdir(tmp_path / "logs" / "images")
    assert "test_reconstruction_step1" in images

    cli.main(["--mode", "sample", "--n_samples", "4", *argv])
    assert "(step 8)" in capsys.readouterr().out
    d = tmp_path / "results" / "t_0.7"
    pngs = sorted(f for f in os.listdir(d) if f.endswith(".png"))
    assert len(pngs) == 4
    img = decode_png((d / pngs[0]).read_bytes())
    assert img.shape == (size, size, channels)
    # The CPU runs the kernels' plain versions: no launch is counted.
    assert [fn.launches for fn in _kernel_wrappers()] == [0] * 5
