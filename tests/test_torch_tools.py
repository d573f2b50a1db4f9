"""The port's measurement tools (``nvae_torch.tools``) in their ``--quick
--cpu`` forms: each runs end to end on the debug model and prints the JSON
line of its JAX twin in ``tools/`` (every key of the JAX tool's report,
read from that tool's source), as ``tests/test_bench_tools.py`` drives the
JAX tools.  Beside them: ``profile_step``'s analyzer on a hand-made Chrome
trace (categories, busy time as a union of spans, idle gaps, the
depthwise kernels by wrapper, the step's parts); ``memory_report``'s state
bytes against the JAX tool's own byte counts (8 virtual devices) in the
``single``, ``replicated`` and ``fsdp`` layouts; ``reproduce_baseline``
driven whole in a subprocess on a fabricated ``mnist.npz``, as
``tests/test_reproduce_baseline.py`` drives JAX's.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_trainer import single_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_module():
    with single_torch_thread():
        yield


def _jax_keys(tool: str, var: str) -> list:
    """The string keys of every dict literal assigned to ``var`` in the
    JAX tool ``tools/<tool>.py``, in order, one list per assignment."""
    with open(os.path.join(REPO, "tools", f"{tool}.py")) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == var
                        for t in node.targets)):
            out.append([k.value for k in node.value.keys
                        if isinstance(k, ast.Constant)])
    assert out, (tool, var)
    return out


def _json_lines(out: str) -> list:
    return [json.loads(ln) for ln in out.strip().splitlines()
            if ln.startswith("{")]


def _has_keys(report: dict, keys) -> None:
    missing = [k for k in keys if k not in report]
    assert not missing, missing


# ---- profile_step ------------------------------------------------------------


def _trace() -> dict:
    """A Chrome trace as ``torch.profiler`` writes it: kernels (two that
    overlap), a copy, the window and a step part on the host and its span
    on the device, a pipeline stage's range on both (no kernel, no part),
    and host operators the analysis ignores."""
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 0, "tid": 0}

    k = "kernel"
    return {"traceEvents": [
        x("user_annotation", "profile_step.window", 0.0, 1000.0),
        x("user_annotation", "train_step.forward", 10.0, 300.0),
        x("gpu_user_annotation", "train_step.forward", 100.0, 400.0),
        x("user_annotation", "pipeline.stage0.forward", 5.0, 900.0),
        x("gpu_user_annotation", "pipeline.stage0.forward", 90.0, 800.0),
        x("cpu_op", "aten::conv2d", 20.0, 50.0),
        x(k, "void dw5x5_ring<(Kind)0, 4, 8>(float const*)", 100.0, 50.0),
        x(k, "void dw5x5_ring<(Kind)0, 4, 8>(float const*)", 150.0, 50.0),
        x(k, "void dw5x5_bf16<(Kind)1, 2>(bf16 const*)", 200.0, 100.0),
        x(k, "void dw5x5_dw_reduce(float*)", 300.0, 10.0),
        # Overlaps the previous kernel: counted once in the busy time.
        x(k, "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc",
          305.0, 45.0),
        x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 400.0, 20.0),
        x(k, "ampere_sgemm_128x64_nn", 500.0, 30.0),
        x(k, "void at::native::batch_norm_collect_statistics_kernel", 530.0,
          10.0),
        x(k, "void at::native::multi_tensor_apply_kernel<Adamax>", 540.0,
          10.0),
        x(k, "void at::native::vectorized_elementwise_kernel<4>", 800.0,
          5.0),
        x(k, "void at::native::reduce_kernel<512, 1>", 805.0, 5.0),
        x(k, "void se_gate_cluster<2>(float const*)", 810.0, 10.0),
        x(k, "some_other_kernel", 820.0, 10.0),
    ]}


def test_profile_step_analyzer_on_a_trace():
    from nvae_torch.tools.profile_step import analyze_events, events_from_trace

    r = analyze_events(events_from_trace(_trace()), steps=2)
    # The window's host span is the wall time; the busy time is the union
    # of the kernels' spans: 100-350, 400-420, 500-550, 800-830 us.
    assert r["wall_ms"] == pytest.approx(1.0)
    assert r["device_busy_ms"] == pytest.approx(0.35)
    assert r["busy_share"] == pytest.approx(0.35)
    assert r["device_kernels"] == 13
    assert r["per_step"]["device_busy_ms"] == pytest.approx(0.175)
    cats = r["by_category"]
    assert cats["depthwise (hand-written #1-#4)"]["count"] == 4
    assert cats["depthwise (hand-written #1-#4)"]["ms"] == pytest.approx(0.21)
    for cat in ("se_gate (hand-written #5)", "copies", "BatchNorm",
                "cuDNN convolutions", "GEMMs", "optimizer (foreach)",
                "reductions", "elementwise", "other"):
        assert cats[cat]["count"] == 1, cat
    assert sum(c["share"] for c in cats.values()) == pytest.approx(1.0)
    assert r["depthwise"]["fused_swish_depthwise5x5"] == 2
    assert r["depthwise"]["fused_swish_depthwise5x5_dx_bf16"] == 1
    assert sum(r["depthwise"].values()) == 3  # the reduction is not #4 again
    assert r["parts"] == {"train_step.forward": {
        "host_ms": pytest.approx(0.3), "device_span_ms": pytest.approx(0.4),
        "count": 1}}
    gaps = r["idle_gaps"]
    assert [g["ms"] for g in gaps] == pytest.approx([0.25, 0.08, 0.05])
    assert gaps[0]["after"].startswith("void at::native::multi_tensor")
    assert gaps[0]["before"].startswith("void at::native::vectorized")
    assert r["kernels"][0][2].startswith("void dw5x5_ring")


class _KinetoEvent:
    """A raw profiler event as ``torch.profiler`` gives it, from a span of
    a Chrome trace: on the card where its ``cat`` says so, a
    ``record_function`` range (the user scope) where it is a host
    annotation."""

    def __init__(self, ev):
        self.ev = ev

    def name(self):
        return self.ev["name"]

    def device_type(self):
        cat = self.ev["cat"]
        on_card = cat.startswith("gpu_") or cat == "kernel"
        return torch.autograd.DeviceType.CUDA if on_card else (
            torch.autograd.DeviceType.CPU)

    def scope(self):
        from torch._C._profiler import RecordScope

        return int(RecordScope.USER_SCOPE) if (
            self.ev["cat"] == "user_annotation") else 0

    def start_ns(self):
        return int(self.ev["ts"] * 1e3)

    def duration_ns(self):
        return int(self.ev["dur"] * 1e3)


def test_profile_step_readers_agree_on_annotations():
    """The raw profiler events and the Chrome trace of one window give the
    same spans: an annotation on the device, a pipeline stage's range too,
    is no kernel, whatever its name."""
    from types import SimpleNamespace

    from nvae_torch.tools.profile_step import (
        analyze_events,
        events_from_profiler,
        events_from_trace,
    )

    trace = _trace()
    raw = [_KinetoEvent(ev) for ev in trace["traceEvents"]]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: raw)))
    events = events_from_profiler(prof)
    assert events == events_from_trace(trace)
    kinds = {(e.name, e.kind) for e in events}
    assert ("pipeline.stage0.forward", "device_annotation") in kinds
    assert ("pipeline.stage0.forward", "kernel") not in kinds
    r = analyze_events(events)
    assert r["device_kernels"] == 13
    assert r["device_busy_ms"] == pytest.approx(0.35)


def test_profile_call_reads_the_profilers_events():
    """``profile_call`` (what ``chip_smoke.py``'s profile phase runs) on
    the CPU: the wall time on the host's clock, a step part's host span
    from the profiler's raw events, and no device kernels."""
    from torch.profiler import record_function

    from nvae_torch.tools.profile_step import profile_call

    x = torch.ones(8, 8)

    def fn():
        with record_function("train_step.forward"):
            for _ in range(10):
                x.mul(2.0).sum()

    r = profile_call("cpu", fn, device="cpu")
    assert r["wall_ms"] > 0 and r["device_kernels"] == 0 and r["rows"] == []
    part = r["parts"]["train_step.forward"]
    assert part["count"] == 1 and 0 < part["host_ms"] <= r["wall_ms"]


@pytest.mark.parametrize("scan", [False, True])
def test_profile_step_capture_and_analyze_quick(tmp_path, capsys, scan):
    from nvae_torch.tools import profile_step

    out = str(tmp_path / "prof")
    profile_step.main(["capture", "--quick", "--cpu", "--outdir", out]
                      + (["--scan_epochs"] if scan else []))
    assert os.path.exists(os.path.join(out, "trace.json"))
    capsys.readouterr()
    profile_step.main(["analyze", "--outdir", out, "--top", "5"])
    text = capsys.readouterr().out
    report = _json_lines(text)[-1]
    _has_keys(report, ("metric", "wall_ms", "device_busy_ms", "busy_share",
                       "by_category", "depthwise", "parts", "idle_gaps",
                       "top_kernels", "per_step", "capture"))
    assert report["metric"] == "profile_step"
    assert report["capture"]["steps"] == 2
    assert report["capture"]["scan_epochs"] is scan
    assert report["wall_ms"] > 0
    # The CPU has no device kernels; the step's parts are on the host.
    assert report["device_kernels"] == 0
    parts = report["parts"]
    assert {"train_step.forward", "train_step.backward",
            "train_step.update"} <= set(parts)
    assert all(p["host_ms"] > 0 for p in parts.values())
    assert "train_step.forward: host" in text


# ---- memory_report -----------------------------------------------------------


def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KINDS = ("params", "opt_state", "batch_stats", "spectral")


def _same_bytes(port: dict, jax_bytes: dict, counters: int) -> None:
    """The port's bytes equal JAX's, but that the port's update counts are
    int64 (8 bytes) where optax's are int32."""
    for k in KINDS:
        extra = 4 * counters if k == "opt_state" else 0
        assert port[k] == jax_bytes[k] + extra, (k, port[k], jax_bytes[k])


@pytest.mark.parametrize("layout", ["single", "replicated"])
def test_memory_report_matches_jax_tool(capsys, layout):
    """The debug model's state bytes, total and on a rank, as the JAX tool
    reports them for its 8 virtual CPU devices."""
    import jax

    from nvae_torch.tools import memory_report

    jax_tool = _load_jax_tool("memory_report")
    want = jax_tool.main(["--debug", "--no_compile", "--layout", layout])
    n = len(jax.devices())
    got = memory_report.main(["--debug", "--cpu", "--no_compile", "--layout",
                              layout, "--data_parallel", str(n)])
    report = _json_lines(capsys.readouterr().out)[-1]
    _has_keys(report, _jax_keys("memory_report", "report")[0])
    assert report == json.loads(json.dumps(got))
    assert got["layout"] == want["layout"] == layout
    assert got["n_devices"] == want["n_devices"] == n
    assert got["int64_counters"] == 2
    for key in ("state_bytes_total", "state_bytes_device0"):
        _same_bytes(got[key], want[key], got["int64_counters"])


def test_memory_report_fsdp_matches_jax():
    """FSDP at the default min_size (65,536 elements) over 8 ranks, on a
    debug model wide enough that some kernels shard: the bytes on a rank
    equal those the JAX tool counts on device 0 of JAX's FSDP layout."""
    import jax

    from nvae_torch import config as tcfg
    from nvae_torch.tools.memory_report import (
        int64_counters,
        state_bytes_by_kind,
    )
    from nvae_torch.train.state import create_train_state
    from nvae_tpu import config as jcfg
    from nvae_tpu.parallel import make_mesh, shard_state_fsdp
    from nvae_tpu.train.state import create_train_state as jax_state

    assert len(jax.devices()) == 8
    arch = dict(n_encoder_channels=64, n_decoder_channels=64,
                n_groups_per_scale=(1, 1), n_latent_per_group=2)
    jax_tool = _load_jax_tool("memory_report")
    _, js, _ = jax_state(jcfg.debug_config(**arch),
                         jcfg.TrainConfig(batch_size=16,
                                          step_based_warmup=True), 100)
    js = shard_state_fsdp(js, make_mesh(n_data=8, n_model=1), 65536)
    want = {k: jax_tool._device0_bytes(getattr(js, k)) for k in KINDS}
    total = {k: jax_tool._tree_bytes(getattr(js, k)) for k in KINDS}
    _, state, _ = create_train_state(
        tcfg.debug_config(**arch),
        tcfg.TrainConfig(batch_size=16, step_based_warmup=True), 100,
        device="cpu")
    got = state_bytes_by_kind(state, 8, 65536)
    n = int64_counters(state)
    _same_bytes(got, want, n)
    _same_bytes(state_bytes_by_kind(state), total, n)
    assert got["params"] < total["params"] / 2  # most bytes sharded


def test_memory_report_tp_matches_jax():
    """TP at the default min_features (512) over JAX's tool's grid of 8
    ranks (4 x 2), on the debug model wide enough that its widest
    expansion kernels split: JAX's placement in the port's count equals
    the bytes the JAX tool counts on device 0 of JAX's TP layout (the
    kernels split, the optimizer state replicated), and the port's layout
    splits the kernels' Adamax moments too."""
    import jax

    from nvae_torch import config as tcfg
    from nvae_torch.tools.memory_report import (
        int64_counters,
        state_bytes_by_kind,
    )
    from nvae_torch.train.state import create_train_state
    from nvae_tpu import config as jcfg
    from nvae_tpu.parallel import make_mesh, shard_state_tp
    from nvae_tpu.train.state import create_train_state as jax_state

    assert len(jax.devices()) == 8
    arch = dict(n_encoder_channels=64, n_decoder_channels=64,
                n_groups_per_scale=(1, 1), n_latent_per_group=2)
    jax_tool = _load_jax_tool("memory_report")
    _, js, _ = jax_state(jcfg.debug_config(**arch),
                         jcfg.TrainConfig(batch_size=16,
                                          step_based_warmup=True), 100)
    js = shard_state_tp(js, make_mesh(n_data=4, n_model=2))
    want = {k: jax_tool._device0_bytes(getattr(js, k)) for k in KINDS}
    _, state, _ = create_train_state(
        tcfg.debug_config(**arch),
        tcfg.TrainConfig(batch_size=16, step_based_warmup=True), 100,
        device="cpu")
    n = int64_counters(state)
    jaxs = state_bytes_by_kind(state, 2, 512, tp=True, opt_sharded=False)
    _same_bytes(jaxs, want, n)
    port = state_bytes_by_kind(state, 2, 512, tp=True)
    total = state_bytes_by_kind(state)
    assert jaxs["params"] < total["params"]  # some kernels split
    assert total["opt_state"] - port["opt_state"] == 2 * (
        total["params"] - port["params"])


def test_memory_report_refuses_tp_and_measures_no_cpu_step(capsys):
    """(The tool used to refuse ``--layout tp``.)  ``--layout tp`` over 2
    and 8 ranks lays them out as the JAX tool's grid, 1 x 2 and 4 x 2; at
    debug size no kernel reaches 512 output channels, so a rank holds the
    whole state in both placements (the split bytes:
    ``test_memory_report_tp_matches_jax``); no step reading on the CPU."""
    from nvae_torch.tools import memory_report

    for n, grid in ((2, (1, 2)), (8, (4, 2))):
        r = memory_report.main(["--debug", "--cpu", "--layout", "tp",
                                "--data_parallel", str(n)])
        assert (r["layout"], r["n_data"], r["n_model"]) == ("tp", *grid)
        assert (r["state_bytes_device0"] == r["state_bytes_total"]
                == r["state_bytes_device0_jax_placement"])
        assert r["step_memory_analysis"] is None  # no card: no reading
    r = memory_report.main(["--debug", "--cpu", "--layout", "single"])
    assert r["step_memory_analysis"] is None


# ---- the training-run tools --------------------------------------------------


@pytest.mark.parametrize("perf", [False, True])
def test_parity_run_quick(tmp_path, capsys, perf):
    from nvae_torch.tools import parity_run

    out = tmp_path / "run"
    r = parity_run.main(["--quick", "--cpu", "--out", str(out)]
                        + (["--perf"] if perf else []))
    text = capsys.readouterr().out
    assert "| epoch | train loss |" in text
    with open(out / "curves.json") as f:
        curves = json.load(f)
    assert curves["config"] == ("mnist_step_sn+perf" if perf
                                else "mnist_step_sn_parity")
    assert [c["epoch"] for c in curves["curves"]] == [0, 1]
    for c in curves["curves"]:
        _has_keys(c, ("nll", "nll_std", "elbo", "reconstruction_loss",
                      "kl_loss"))
        assert np.isfinite(c["nll"]) and c["nll"] > 0
    assert len(r["history"]) == 2


def test_bench_eval_protocol_quick(capsys):
    from nvae_torch.tools import bench_eval_protocol

    bench_eval_protocol.main(["--quick", "--cpu", "--ckpt", "/nonexistent"])
    report = _json_lines(capsys.readouterr().out)[-1]
    _has_keys(report, _jax_keys("bench_eval_protocol", "result")[0])
    assert report["metric"] == "full_eval_protocol_wall"
    assert report["value"] > 0 and report["checkpoint_epoch"] == 0
    assert {"sampling", "nll", "fid"} <= set(report["stage_seconds"])


def test_reproduce_baseline_end_to_end_on_fabricated_mnist(tmp_path):
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    rng = np.random.RandomState(0)
    np.savez(data_dir / "mnist.npz",
             x_train=(rng.rand(128, 28, 28) * 255).astype(np.uint8),
             y_train=rng.randint(0, 10, 128).astype(np.uint8),
             x_test=(rng.rand(64, 28, 28) * 255).astype(np.uint8),
             y_test=rng.randint(0, 10, 64).astype(np.uint8))
    out = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if k != "NVAE_TPU_WEIGHTS"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "nvae_torch.tools.reproduce_baseline",
         "--debug", "--tiny_model", "--dataset", "mnist", "--data_dir",
         str(data_dir), "--batch_size", "16", "--out", str(out), "--cpu"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "vs reference" in proc.stdout
    assert "NOT comparable" in proc.stdout
    with open(out / "comparison.json") as f:
        comparison = json.load(f)
    assert comparison["comparable"] is False
    assert comparison["variant"] == "step_sn"
    assert len(comparison["rows"]) == 6
    for name in ("corrected", "parity"):
        with open(out / f"evaluation_{name}.json") as f:
            ev = json.load(f)
        assert ev["feature_backbone_weights"] == "fixed-seed"
        assert ev["sample_metrics"]
        assert np.isfinite(ev["nll"]["mean"]) and ev["nll"]["mean"] > 0


# ---- serving and checkpoint tools -------------------------------------------


def test_bench_serving_runtime_quick(capsys):
    from nvae_torch.tools import bench_serving_runtime

    results = bench_serving_runtime.main(["--quick", "--cpu"])
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 2 and len(results) == 2
    closed_keys, poisson_keys = _jax_keys("bench_serving_runtime", "result")
    closed, poisson = lines
    _has_keys(closed, closed_keys)
    _has_keys(poisson, poisson_keys)
    assert closed["metric"] == "serving_runtime_closed_loop"
    assert 0 < closed["occupancy"] <= 1
    assert closed["dispatches"] * 8 >= closed["rows"]
    assert poisson["metric"] == "serving_runtime_poisson"
    assert poisson["p50_ms"] <= poisson["p95_ms"] <= poisson["value"]
    assert poisson["throughput_images_per_sec"] > 0


def test_bench_serving_http_quick_two_shapes(capsys):
    from nvae_torch.tools import bench_serving_http

    bench_serving_http.main(["--quick", "--cpu", "--batch", "4", "16",
                             "--max_delay_ms", "5", "--seconds", "2"])
    report = _json_lines(capsys.readouterr().out)[-1]
    _has_keys(report, _jax_keys("bench_serving_http", "report")[0])
    assert report["metric"] == "serving_http"
    assert report["batch"] == [4, 16]
    assert report["requests"] > 0 and report["img_per_s"] > 0
    assert 0.0 < report["occupancy"] <= 1.0
    shapes = report["dispatch_shapes"]
    assert sum(shapes.values()) == report["dispatches"] > 0
    by_shape = report["occupancy_by_shape"]
    assert set(by_shape) == set(shapes)
    assert all(0.0 < v <= 1.0 for v in by_shape.values())
    # The shapes' occupancies weighted by their rows give the whole one.
    rows = {int(b): int(b) * n for b, n in shapes.items()}
    whole = sum(by_shape[str(b)] * r for b, r in rows.items()) / sum(
        rows.values())
    assert whole == pytest.approx(report["occupancy"], abs=2e-3)


def test_bench_async_ckpt_quick(capsys):
    from nvae_torch.tools import bench_async_ckpt

    bench_async_ckpt.main(["--quick", "--cpu", "--epochs", "2"])
    report = _json_lines(capsys.readouterr().out)[-1]
    _has_keys(report, _jax_keys("bench_async_ckpt", "report")[0])
    assert report["metric"] == "async_ckpt_overlap"
    for k in ("baseline_epoch_s", "sync_epoch_s", "async_epoch_s",
              "sync_total_s", "async_total_s", "state_mb"):
        assert report[k] > 0, k
    assert len(report["sync_blocked_ms"]) == 2
    assert len(report["async_blocked_ms"]) == 2


def test_bench_serving_artifact_quick(capsys):
    from nvae_torch.tools import bench_serving_artifact

    bench_serving_artifact.main(["--quick", "--cpu"])
    report = _json_lines(capsys.readouterr().out)[-1]
    _has_keys(report, _jax_keys("bench_serving_artifact", "report")[0])
    assert report["metric"] == "serving_artifact_int8_vs_bf16"
    assert report["bf16"]["img_per_s"] > 0 and report["int8"]["img_per_s"] > 0
    assert report["int8"]["mb"] < report["bf16"]["mb"]
    assert report["mean_abs_pixel_delta"] < 0.25


def test_tools_raise_without_a_card(monkeypatch):
    """Without ``--cpu`` a tool runs on the card, and raises where there is
    none."""
    from nvae_torch.tools import bench_serving_artifact, memory_report

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        memory_report.main(["--debug", "--no_compile"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_serving_artifact.main(["--quick"])
