"""The port stands alone: nothing in ``nvae_torch``, ``chip_smoke.py`` or
``chip_ring_probe.py`` imports JAX or the JAX package, importing the port
loads no JAX, and no entry point runs on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from nvae_torch import debug_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nvae_tpu")


def _port_files():
    files = [os.path.join(ROOT, n)
             for n in ("chip_smoke.py", "chip_ring_probe.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "nvae_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    rel = {os.path.relpath(f, ROOT) for f in files}
    for mod in ("losses", "optim", "state", "step", "checkpoint", "trainer"):
        assert os.path.join("nvae_torch", "train", f"{mod}.py") in rel
    for path in (("data", "datasets.py"), ("data", "pipeline.py"),
                 ("eval", "nll.py"), ("eval", "evaluate.py"),
                 ("eval", "features.py"), ("eval", "inception.py"),
                 ("eval", "frechet.py"), ("eval", "fid.py"),
                 ("eval", "ppl.py"), ("eval", "precision_recall.py"),
                 ("utils", "images.py"),
                 ("utils", "logging.py"), ("utils", "seeds.py"),
                 ("kernels", "se_gate.py"), ("kernels", "ops.py"),
                 ("utils", "native_png.py"), ("cli.py",), ("presets.py",),
                 ("serving.py",), ("serving_program.py",),
                 ("serving_http.py",),
                 ("export_serving.py",), ("parallel", "__init__.py"),
                 ("parallel", "mesh.py"), ("parallel", "multihost.py"),
                 ("tools", "profile_step.py"), ("tools", "memory_report.py"),
                 ("tools", "bench_serving_http.py")):
        assert os.path.join("nvae_torch", *path) in rel
    bad = [
        (os.path.relpath(f, ROOT), mod)
        for f in files for mod in _imported_roots(f) if mod in FORBIDDEN
    ]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import nvae_torch, nvae_torch.convert, nvae_torch.serving, "
        "nvae_torch.serving_runtime, nvae_torch.kernels._build, "
        "nvae_torch.train.losses, nvae_torch.train.optim, "
        "nvae_torch.train.state, nvae_torch.train.step, "
        "nvae_torch.train.checkpoint, nvae_torch.train.trainer, "
        "nvae_torch.data, nvae_torch.eval.nll, nvae_torch.utils.images, "
        "nvae_torch.eval, nvae_torch.eval.fid, "
        "nvae_torch.utils.logging, nvae_torch.kernels.se_gate, "
        "nvae_torch.kernels.ops, nvae_torch.serving_program, "
        "nvae_torch.utils.native_png, "
        "nvae_torch.cli, nvae_torch.presets, nvae_torch.serving_http, "
        "nvae_torch.export_serving, nvae_torch.tools, "
        "nvae_torch.tools.common, nvae_torch.tools.profile_step, "
        "nvae_torch.tools.memory_report, nvae_torch.tools.parity_run, "
        "nvae_torch.tools.bench_eval_protocol, "
        "nvae_torch.tools.reproduce_baseline, "
        "nvae_torch.tools.bench_serving_runtime, "
        "nvae_torch.tools.bench_serving_http, "
        "nvae_torch.tools.bench_async_ckpt, "
        "nvae_torch.tools.bench_serving_artifact\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card(monkeypatch):
    from nvae_torch import TrainConfig
    from nvae_torch.models.nvae import NVAE
    from nvae_torch.serving import Sampler
    from nvae_torch.train.state import create_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sampler(debug_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NVAE(debug_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(debug_config(), TrainConfig(), 10)
    # Asked for, the CPU works.
    assert Sampler(debug_config(), device="cpu").info["device"] == "cpu"
    model, state, _ = create_train_state(debug_config(), TrainConfig(), 10,
                                         device="cpu")
    assert model.training and state.step == 0
    assert model.decoder.h.device.type == "cpu"


def test_trainer_and_cli_default_to_the_card(monkeypatch, tmp_path):
    from nvae_torch import TrainConfig, cli
    from nvae_torch.data import make_iterators, synthetic_dataset
    from nvae_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(debug_config(), TrainConfig(epochs=1), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_iterators(synthetic_dataset(n_train=8, n_test=8), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--mode", "train", "--dataset", "synthetic", "--debug",
                  "--model_save_dir", str(tmp_path / "m"),
                  "--tensorboard_log_dir", str(tmp_path / "l")])
    assert not (tmp_path / "l").exists()  # it stopped before writing
    trainer = Trainer(debug_config(), TrainConfig(epochs=1), 4, device="cpu")
    assert trainer.device.type == "cpu" and trainer.model.training
