"""The program form of the port's serving artifact (``torch.export``),
against the JAX package's ``jax.export`` artifact where it has a case
(``tests/test_export.py``), on the CPU at debug size.

- On JAX's recorded normals the program's images equal JAX's
  ``NVAE.sample`` on the same converted weights at atol 1e-4 (``ATOL``,
  fp32 compute on both sides, other summation orders), with fp32, bf16 and
  int8 weights.
- For one seed the program's images equal the weights-file ``Sampler``'s
  bitwise: scalar and per-sample temperatures, uint8 output.
- The graph records the fused depthwise forward as the op
  ``nvae_torch::fused_swish_dw5x5`` once per eager call of it, and holds no
  grouped convolution in its place.
- A process that imports only torch and ``nvae_torch.kernels`` runs the
  file; the export tool's ``--load --run`` and the HTTP server take it.
"""

import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nvae_torch import config as tcfg
from nvae_torch import export_serving, serving_http
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.serving import (
    PROGRAM_FORMAT,
    Sampler,
    export_program,
    export_sampler,
    load_artifact,
)
from nvae_torch.serving_http import serve
from nvae_torch.serving_program import ProgramSampler, read_meta
from nvae_tpu import serving as jserving
from nvae_tpu.models import NVAE as JaxNVAE
from tests.test_torch_sampler import _models, _record
from tests.test_torch_serving_http import _get, _post
from tests.test_torch_trainer import single_torch_thread


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_module():
    """One intra-op thread for the module's tests and its module-scoped
    fixtures (``tests/test_torch_trainer.py``'s ``single_torch_thread``)."""
    with single_torch_thread():
        yield


ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
TINY = dict(n_encoder_channels=8, n_decoder_channels=8,
            n_groups_per_scale=(1, 1), n_latent_per_group=2,
            use_pallas_kernels=True)
OP = torch.ops.nvae_torch.fused_swish_dw5x5.default


@pytest.fixture(scope="module")
def tiny():
    cfg = tcfg.debug_config(**TINY)
    return cfg, TorchNVAE(cfg, device="cpu", seed=0).state_dict()


class _CountOp(TorchDispatchMode):
    """Counts the eager calls of #2's op."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is OP:
            self.calls += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("serve_dtype", ["", "bfloat16", "int8"])
def test_program_matches_jax_sample(monkeypatch, tmp_path, serve_dtype):
    jm, variables, tm = _models("default")
    params = variables["params"]
    if serve_dtype == "int8":
        params = jserving.dequantize_params(
            jserving.quantize_params_int8(params))
    elif serve_dtype == "bfloat16":
        params = jserving.cast_params(params, jnp.bfloat16)
    t = np.array([0.6, 0.9, 1.2], np.float32)
    (want, *_), normals, _ = _record(monkeypatch, lambda: jm.apply(
        {**variables, "params": params}, 3, t, True, None,
        method=JaxNVAE.sample, rngs={"sample": jax.random.PRNGKey(5)}))
    path = str(tmp_path / "p.pt2")
    export_program(path, tm.cfg, tm.state_dict(), 3,
                   per_sample_temperature=True, serve_dtype=serve_dtype,
                   device="cpu")
    program = load_artifact(path, "cpu")
    assert isinstance(program, ProgramSampler)
    assert program.noise_shapes == [n.shape for n in normals]
    got = program.run(torch.from_numpy(t), normals)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("serve_dtype,per_sample,output_dtype", [
    ("", False, ""), ("", True, ""), ("bfloat16", True, "uint8"),
    ("int8", False, "uint8"), ("int8", True, ""),
])
def test_program_equals_the_weights_sampler_bitwise(tiny, tmp_path,
                                                    serve_dtype, per_sample,
                                                    output_dtype):
    cfg, sd = tiny
    path = str(tmp_path / "p.pt2")
    export_program(path, cfg, sd, B, per_sample_temperature=per_sample,
                   output_dtype=output_dtype, serve_dtype=serve_dtype,
                   step=7, device="cpu")
    program = load_artifact(path, "cpu")
    live = Sampler(cfg, sd, B, output_dtype=output_dtype, device="cpu",
                   serve_dtype=serve_dtype)
    t = torch.linspace(0.6, 1.0, B) if per_sample else 0.8
    got = program(3, t)
    assert got.dtype == (torch.uint8 if output_dtype else torch.float32)
    assert torch.equal(got, live(3, t))
    assert not torch.equal(got, program(4, t))  # the seed is an input
    a = program.artifact
    assert (a["form"], a["batch"], a["step"], program.step) == (
        "program", B, 7, 7)
    assert a["per_sample_temperature"] == per_sample
    assert a["serve_dtype"] == (serve_dtype or "float32")
    assert program.info["output_dtype"] == (output_dtype or "float32")
    assert read_meta(path)["format"] == PROGRAM_FORMAT
    if per_sample:
        # A uniform vector is the scalar's draw; a mixed one moves only
        # its own rows (JAX's test_export_per_sample_temperature).
        mixed = torch.tensor([0.8, 0.8, 5.0, 5.0])
        uniform, hot = program(11, 0.8), program(11, mixed)
        assert torch.equal(uniform[:2], hot[:2])
        assert not torch.equal(uniform[2:], hot[2:])
    else:
        with pytest.raises(ValueError, match="temperature of shape"):
            program(3, torch.full((B,), 0.8))


@pytest.mark.parametrize("overrides", [
    {}, {"postprocess_5x5_depthwise": True}, {"compute_dtype": "bfloat16"},
])
def test_graph_records_the_op_once_per_eager_call(tmp_path, overrides):
    cfg = tcfg.debug_config(**{**TINY, **overrides})
    sd = TorchNVAE(cfg, device="cpu", seed=0).state_dict()
    path = str(tmp_path / "p.pt2")
    export_program(path, cfg, sd, B, device="cpu")
    program = load_artifact(path, "cpu")
    live = Sampler(cfg, sd, B, device="cpu")
    with _CountOp() as eager:
        want = live(5, 0.9)
    nodes = [n for n in program.program.graph.nodes
             if n.op == "call_function"]
    in_graph = sum(n.target is OP for n in nodes)
    assert eager.calls >= 1
    assert in_graph == eager.calls == program.artifact["op_nodes"]
    with _CountOp() as served:
        assert torch.equal(program(5, 0.9), want)
    assert served.calls == eager.calls
    grouped = [n for n in nodes if "conv" in str(n.target)
               and len(n.args) > 6 and n.args[6] != 1]
    assert not grouped, grouped
    # No run-time dtype checks: a host dispatch each, on fixed dtypes.
    assert not any("_assert_tensor_metadata" in str(n.target) for n in nodes)


def test_fake_output_has_the_real_layout():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 8, 8, 6).astype(np.float32))
    k = torch.from_numpy(rng.randn(6, 1, 5, 5).astype(np.float32))
    taps = k.permute(2, 3, 1, 0)  # the model's (5, 5, 1, C) view
    b = torch.zeros(6)
    for xx, bias in ((x, b), (x.to(torch.bfloat16), b), (x, None)):
        kk = taps.to(xx.dtype)
        real = OP(xx, kk, bias, True)
        fake = OP(xx.to("meta"), kk.to("meta"),
                  None if bias is None else bias.to("meta"), True)
        assert (real.shape, real.dtype, real.stride()) == (
            fake.shape, fake.dtype, fake.stride())


def test_bf16_and_int8_programs_smaller_and_finite(tiny, tmp_path, capsys):
    """JAX's test_export_bf16_weights_smaller_and_finite and
    test_export_int8_weights_quality_and_size, through the tool."""
    sizes, weights = {}, {}
    for dtype in ("", "bfloat16", "int8"):
        out = str(tmp_path / f"p{dtype}.pt2")
        meta = export_serving.main(
            ["--out", out, "--debug", "--batch", "2", "--cpu",
             "--use_pallas", "--weights_dtype", dtype,
             *(["--check"] if dtype == "int8" else [])])
        assert meta["format"] == "program"
        sizes[dtype] = os.path.getsize(out)
        program = load_artifact(out, "cpu")
        weights[dtype] = program.weights_bytes
        assert np.isfinite(program(3, 1.0).numpy()).all()
    assert sizes["bfloat16"] < sizes[""] and sizes["int8"] < sizes[""]
    assert weights["bfloat16"] < 0.6 * weights[""]
    assert weights["int8"] < weights["bfloat16"]
    lines = capsys.readouterr().out.splitlines()
    assert any(l.startswith("check OK: program artifact") for l in lines)
    quality = [json.loads(l) for l in lines if "int8_vs_fp_mean_abs" in l]
    assert len(quality) == 1
    assert np.isfinite(quality[0]["int8_vs_fp_max_abs"])
    assert quality[0]["int8_vs_fp_mean_abs"] < 0.05


def test_program_runs_without_the_model_code(tiny, tmp_path):
    """Only torch, ``nvae_torch.kernels`` and the file (JAX's artifact needs
    only jax and the file)."""
    cfg, sd = tiny
    path = str(tmp_path / "p.pt2")
    export_program(path, cfg, sd, B, per_sample_temperature=True,
                   serve_dtype="int8", device="cpu")
    want = load_artifact(path, "cpu")(9, torch.full((B,), 0.7))
    out = str(tmp_path / "images.pt")
    code = f"""
import json, sys, torch
import nvae_torch.kernels
torch.set_num_threads(1)
extra = {{"nvae_torch_sampler.json": ""}}
ep = torch.export.load({path!r}, extra_files=extra)
meta = json.loads(extra["nvae_torch_sampler.json"])
gen = torch.Generator().manual_seed(9)
eps = [torch.randn(s, generator=gen) for s in meta["noise_shapes"]]
with torch.inference_mode():
    images = ep.module()(torch.full(({B},), 0.7), eps)
torch.save(images, {out!r})
loaded = sorted(m for m in sys.modules if m.startswith("nvae_torch."))
assert "nvae_torch.models" not in sys.modules, loaded
assert "nvae_torch.serving" not in sys.modules, loaded
print(json.dumps(loaded))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not any(m.startswith(("nvae_torch.models", "nvae_torch.nn"))
                   for m in loaded), loaded
    assert torch.equal(torch.load(out), want)


def test_export_tool_load_and_run(tmp_path, capsys):
    """JAX's test_export_load_and_run_cli: ``--load --run`` on the
    program, with PNGs."""
    out = str(tmp_path / "p.pt2")
    export_serving.main(["--out", out, "--debug", "--batch", "2", "--cpu",
                         "--per_sample_temperature", "--check"])
    assert "check OK: program artifact" in capsys.readouterr().out
    images = export_serving.main(["--load", out, "--run", "--cpu",
                                  "--temperature", "0.9",
                                  "--save_png", str(tmp_path / "png")])
    assert images.shape == (2, 32, 32, 1) and np.isfinite(images).all()
    assert len(os.listdir(tmp_path / "png")) == 2
    with open(out + ".json") as f:
        assert json.load(f)["format"] == "program"


def test_load_artifact_names_the_form(tiny, tmp_path):
    cfg, sd = tiny
    weights, program = str(tmp_path / "w.pt"), str(tmp_path / "p.pt2")
    export_sampler(weights, cfg, sd, B, serve_dtype="bfloat16")
    export_program(program, cfg, sd, B, serve_dtype="bfloat16", device="cpu")
    w, p = load_artifact(weights, "cpu"), load_artifact(program, "cpu")
    assert (w.artifact["form"], p.artifact["form"]) == ("weights", "program")
    assert torch.equal(w(1, 0.8), p(1, 0.8))
    assert not hasattr(p, "swap")  # a program reloads from its file


def test_http_server_serves_programs_by_batch_and_reloads(tiny, tmp_path):
    cfg, sd = tiny
    paths = {}
    for b in (2, 6):
        paths[b] = str(tmp_path / f"p{b}.pt2")
        export_program(paths[b], cfg, sd, b, per_sample_temperature=True,
                       serve_dtype="int8", device="cpu")
    call, batches = serving_http._build_calls_from_artifacts(
        [paths[6], paths[2]], "cpu")
    assert batches == [2, 6]
    live = Sampler(cfg, sd, 2, serve_dtype="int8", device="cpu")
    t = torch.tensor([0.6, 1.0])
    assert torch.equal(call(3, t), live(3, t))
    factory = serving_http._artifact_reloader_factory(
        [paths[6], paths[2]], "cpu")
    httpd = serve(call, batches, port=0, max_delay_ms=5.0, block=False,
                  reloader_factory=factory)
    try:
        status, _, body = _post(httpd, {"n": 5, "temperature": 0.8})
        assert status == 200
        assert np.load(io.BytesIO(body)).shape == (5, 32, 32, 1)
        weights = _get(httpd, "/stats")["weights"]
        assert (weights["form"], weights["serve_dtype"]) == ("program",
                                                             "int8")
        skipped = _post(httpd, {"if_newer": True}, path="/reload")
        assert json.loads(skipped[2])["skipped"]
        os.utime(paths[2], (os.path.getmtime(paths[2]) + 5,) * 2)
        status, _, body = _post(httpd, {"if_newer": True}, path="/reload")
        assert status == 200 and json.loads(body)["batch"] == [2, 6]
    finally:
        httpd.shutdown_and_close()
    scalar = str(tmp_path / "scalar.pt2")
    export_program(scalar, cfg, sd, 2, device="cpu")
    with pytest.raises(SystemExit, match="per_sample_temperature"):
        serving_http._build_call_from_artifact(scalar, "cpu")
