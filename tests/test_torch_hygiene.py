"""The port stands alone: nothing in ``nvae_torch`` or ``chip_smoke.py``
imports JAX or the JAX package, importing the port loads no JAX, and no entry
point runs on the CPU unless asked to."""

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
    files = [os.path.join(ROOT, "chip_smoke.py")]
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
    bad = [
        (os.path.relpath(f, ROOT), mod)
        for f in files for mod in _imported_roots(f) if mod in FORBIDDEN
    ]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import nvae_torch, nvae_torch.convert, nvae_torch.serving, "
        "nvae_torch.serving_runtime, nvae_torch.kernels._build\n"
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
    from nvae_torch.models.nvae import NVAE
    from nvae_torch.serving import Sampler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sampler(debug_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NVAE(debug_config())
    # Asked for, the CPU works.
    assert Sampler(debug_config(), device="cpu").info["device"] == "cpu"
