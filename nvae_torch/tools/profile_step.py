"""Capture and analyze a ``torch.profiler`` trace of the port's training
step (twin of ``tools/profile_step.py``).

Usage::

    python -m nvae_torch.tools.profile_step capture [--outdir DIR] \\
        [--steps 8] [--compute_dtype float32] [--bn_apply_dtype float32] \\
        [--postprocess_depthwise] [--scan_epochs] [--cpu] [--quick]
    python -m nvae_torch.tools.profile_step analyze [--outdir DIR] [--top 40]

``capture`` runs ``--steps`` training steps of the default 40.1M-parameter
MNIST config (``ModelConfig()`` with the hand-written kernels) at batch 144
under ``torch.profiler`` and writes the Chrome trace ``trace.json`` and
``meta.json`` (the run's settings and wall time) to ``--outdir``; with
``--scan_epochs`` it profiles one CUDA graph replay of the epoch runner's
step instead (``--steps`` replays).  ``analyze`` reads that trace back with
``json`` alone and prints the device time per kernel and per category (the
hand-written depthwise kernels by name, #5, cuDNN convolutions, GEMMs,
BatchNorm, optimizer, reductions, elementwise work, copies), the device's
busy time against the window's wall time, the ``train_step.*`` parts of
``nvae_torch/train/step.py`` (host time and the span of their kernels on
the device), and the longest idle gaps between kernels; then one JSON line.
The JAX tool's ``--depth`` (model regions cut from XLA's op scope paths)
has no counterpart: a CUDA kernel carries no module path, and the
``train_step.*`` parts stand in for the regions.

:func:`profile_call` profiles one call of a function in process and runs
the same analysis on the profiler's events (``chip_smoke.py``'s profile
phase uses it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional

from nvae_torch.tools.common import (
    add_cpu_flag,
    device_info,
    log,
    sync,
    tool_device,
)

WINDOW = "profile_step.window"
PART_PREFIX = "train_step."
IDLE_GAPS = 5  # the longest idle stretches a report lists
# The wrappers of the depthwise kernels by the kind in the kernel's name:
# the row ring ``dw5x5_ring<kind, ...>`` (fp32) and the sliding-row kernel
# ``dw5x5_bf16<kind, ...>`` (bf16), kind 0 forward, 1 dx, 2 dW/db (whose
# reduction kernel ``dw5x5_dw_reduce`` is not counted again).
DW_WRAPPERS = {"0": "fused_swish_depthwise5x5",
               "1": "fused_swish_depthwise5x5_dx",
               "2": "fused_swish_depthwise5x5_dw"}
DW_KERNEL_NAMES = ("fused_swish_depthwise5x5", "depthwise_conv5x5",
                   "fused_swish_depthwise5x5_dx", "fused_swish_depthwise5x5_dw",
                   "fused_swish_depthwise5x5_bf16",
                   "fused_swish_depthwise5x5_dx_bf16",
                   "fused_swish_depthwise5x5_dw_bf16")
_DW_RE = re.compile(r"dw5x5_(ring|bf16)<\s*\(?\w*\)?\s*(\d)")
# (category, pattern over the kernel's name): the first match wins.
CATEGORIES = (
    ("depthwise (hand-written #1-#4)", r"dw5x5_"),
    ("se_gate (hand-written #5)", r"se_gate"),
    ("copies", r"^Memcpy|^Memset|copy_kernel|CatArrayBatchedCopy|"
               r"direct_copy"),
    ("BatchNorm", r"batch_norm|batchnorm|bn_fw|bn_bw|welford"),
    ("cuDNN convolutions", r"conv|fprop|dgrad|wgrad|fft|winograd|cudnn|"
                           r"implicit_gemm|nchwToNhwc|nhwcToNchw|"
                           r"pointwise_mult_and_sum_complex"),
    ("GEMMs", r"gemm|gemv|cublas|cutlass|Kernel2"),
    ("optimizer (foreach)", r"multi_tensor_apply|foreach"),
    ("reductions", r"reduce_kernel|[Rr]educe"),
    ("elementwise", r"elementwise"),
)


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


@dataclasses.dataclass
class Event:
    """One span of a trace: ``kind`` is ``kernel`` (a device kernel, copy
    or fill), ``device_annotation`` (a ``record_function`` range's span on
    the device) or ``host_annotation`` (the same range on the host)."""
    name: str
    kind: str
    start_us: float
    dur_us: float


# A Chrome trace span's kind by its activity type (its ``cat``).
KINDS = {"kernel": "kernel", "gpu_memcpy": "kernel", "gpu_memset": "kernel",
         "gpu_user_annotation": "device_annotation",
         "user_annotation": "host_annotation"}


def events_from_trace(trace: dict) -> List[Event]:
    """The spans of a Chrome trace (``torch.profiler``'s
    ``export_chrome_trace``)."""
    out = []
    for ev in trace.get("traceEvents", []):
        kind = KINDS.get(ev.get("cat"))
        if kind is None or ev.get("ph") != "X":
            continue
        out.append(Event(ev["name"], kind, float(ev["ts"]),
                         float(ev.get("dur", 0.0))))
    return out


def events_from_profiler(prof) -> List[Event]:
    """The same spans from a finished ``torch.profiler.profile``, read from
    its raw profiler events (building its ``events()`` tree costs seconds
    for a training step's ~20,000 kernels and their host operators): on
    the host the ``record_function`` ranges (the profiler's user scope);
    on the card each range's span (an event named as one of those
    ranges), else a kernel, copy or fill.  (PyTorch 2.11's events carry
    no activity type.)"""
    import torch
    from torch._C._profiler import RecordScope

    cuda = torch.autograd.DeviceType.CUDA
    user = int(RecordScope.USER_SCOPE)
    events = list(prof.profiler.kineto_results.events())
    ranges = {ev.name() for ev in events
              if ev.device_type() != cuda and ev.scope() == user}
    out = []
    for ev in events:
        if ev.device_type() == cuda:
            kind = ("device_annotation" if ev.name() in ranges
                    else "kernel")
        elif ev.scope() == user:
            kind = "host_annotation"
        else:
            continue
        out.append(Event(ev.name(), kind, ev.start_ns() / 1e3,
                         ev.duration_ns() / 1e3))
    return out


def _merged(spans: Iterable[tuple]) -> List[list]:
    """Sorted ``(start, end, first name, last name)`` spans merged where
    they overlap."""
    out: List[list] = []
    for s, e, name in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1], out[-1][3] = e, name
        else:
            out.append([s, e, name, name])
    return out


def depthwise_launches(rows) -> Dict[str, int]:
    """Launches of the depthwise kernels in ``(ms, count, name)`` rows, by
    their wrapper's name (``DW_WRAPPERS``; the dW/db reduction is not
    counted again)."""
    out = dict.fromkeys(DW_KERNEL_NAMES, 0)
    for _, n, name in rows:
        m = _DW_RE.search(name)
        if m:
            out[DW_WRAPPERS[m.group(2)]
                + ("_bf16" if m.group(1) == "bf16" else "")] += n
    return out


def analyze_events(events: List[Event], wall_ms: Optional[float] = None,
                   steps: int = 1, top: int = 40) -> dict:
    """Where the time of a profiled window goes.

    - ``device_busy_ms``: the union of the kernels' spans (overlapping
      kernels count once); ``wall_ms`` the window's (the caller's clock, or
      the ``profile_step.window`` range's host span, or the spans' extent);
    - ``by_category``: ms, launches and share of the kernels' summed time;
      ``kernels``: the ``top`` kernels by summed time, ``[ms, count,
      name]``; ``depthwise``: launches of each depthwise wrapper's kernel;
    - ``parts``: each ``train_step.*`` range's host ms and the span of its
      kernels on the device; ``idle_gaps``: the ``IDLE_GAPS`` longest
      stretches with no kernel running, between the first and the last
      kernel, with the kernels on either side.

    Times are totals over the window; ``per_step`` divides the busy and
    wall times by ``steps``."""
    kernels = [e for e in events if e.kind == "kernel"]
    by_name: Dict[str, list] = {}
    for e in kernels:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.dur_us / 1e3
        row[1] += 1
    rows = sorted(([ms, n, name] for name, (ms, n) in by_name.items()),
                  reverse=True)
    total_ms = sum(r[0] for r in rows)
    by_cat: Dict[str, dict] = {}
    for ms, n, name in rows:
        c = by_cat.setdefault(category(name), {"ms": 0.0, "count": 0})
        c["ms"] += ms
        c["count"] += n
    for c in by_cat.values():
        c["share"] = c["ms"] / total_ms if total_ms else 0.0
    depthwise = depthwise_launches(rows)
    merged = _merged((e.start_us, e.start_us + e.dur_us, e.name)
                     for e in kernels)
    busy_ms = sum(e - s for s, e, _, _ in merged) / 1e3
    idle = sorted(((b[0] - a[1]) / 1e3, a[3], b[2])
                  for a, b in zip(merged[:-1], merged[1:]))[::-1]
    parts: Dict[str, dict] = {}
    window = [e for e in events
              if e.kind == "host_annotation" and e.name == WINDOW]
    for e in events:
        if e.name.startswith(PART_PREFIX) and e.kind != "kernel":
            part = parts.setdefault(e.name, {"host_ms": 0.0,
                                             "device_span_ms": 0.0,
                                             "count": 0})
            if e.kind == "host_annotation":
                part["host_ms"] += e.dur_us / 1e3
                part["count"] += 1
            else:
                part["device_span_ms"] += e.dur_us / 1e3
    if wall_ms is None:
        if window:
            wall_ms = sum(e.dur_us for e in window) / 1e3
        elif events:
            wall_ms = (max(e.start_us + e.dur_us for e in events)
                       - min(e.start_us for e in events)) / 1e3
        else:
            wall_ms = 0.0
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "busy_share": busy_ms / wall_ms if wall_ms else None,
        "device_kernels": len(kernels),
        "kernel_ms_sum": total_ms,
        "steps": steps,
        "per_step": {"wall_ms": wall_ms / steps,
                     "device_busy_ms": busy_ms / steps,
                     "device_kernels": len(kernels) / steps},
        "by_category": dict(sorted(by_cat.items(),
                                   key=lambda kv: -kv[1]["ms"])),
        "depthwise": depthwise,
        "parts": dict(sorted(parts.items())),
        "idle_gaps": [{"ms": ms, "after": a, "before": b}
                      for ms, a, b in idle[:IDLE_GAPS]],
        "kernels": rows[:top],
    }


def print_report(label: str, r: dict, top: int = 10, out=None) -> None:
    """The report as text lines (to ``out``, default standard error)."""
    def say(s):
        if out is None:
            log(s)
        else:
            print(s, file=out, flush=True)

    share = r["busy_share"]
    say(f"profile {label}: wall {r['wall_ms']:.2f} ms, device busy "
        f"{r['device_busy_ms']:.2f} ms"
        + (f" ({100 * share:.0f}%)" if share is not None else "")
        + f", {r['device_kernels']} device kernels over {r['steps']} "
        f"step(s)")
    for cat, c in r["by_category"].items():
        say(f"  {c['ms'] / r['steps']:9.3f} ms/step {100 * c['share']:5.1f}%"
            f"  x{c['count']:<6d} {cat}")
    for name, part in r["parts"].items():
        say(f"  {name}: host {part['host_ms']:.1f} ms, device span "
            f"{part['device_span_ms']:.1f} ms")
    for g in r["idle_gaps"]:
        say(f"  idle {g['ms']:.3f} ms after {g['after'][:50]} before "
            f"{g['before'][:50]}")
    for ms, count, key in r["kernels"][:top]:
        say(f"  {ms:8.3f} ms  x{count:<5d} {key[:90]}")


def profile_call(label: str, fn: Callable[[], object], device=None,
                 warm: bool = True) -> dict:
    """``fn()`` once more under ``torch.profiler`` (after one warm call
    unless ``warm`` is False), synced on ``device`` (default the current
    card): :func:`analyze_events` of its events, the wall time on the
    host's clock, printed to standard error.  The report's ``rows`` are
    every kernel's ``(ms, count, name)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if cuda
        else torch.device("cpu"))
    if warm:
        fn()
        sync(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        fn()
        sync(dev)
        wall_ms = 1e3 * (time.monotonic() - t0)
    r = analyze_events(events_from_profiler(prof), wall_ms=wall_ms,
                       top=10 ** 9)
    r["rows"] = [tuple(row) for row in r["kernels"]]
    r["top"] = r["rows"][:10]
    print_report(label, r)
    return r


# ---- capture --------------------------------------------------------------


def _model_config(args):
    from nvae_torch.config import ModelConfig, debug_config

    kw = dict(compute_dtype=args.compute_dtype,
              bn_apply_dtype=args.bn_apply_dtype,
              postprocess_5x5_depthwise=args.postprocess_depthwise,
              use_pallas_kernels=args.use_pallas)
    return debug_config(**kw) if args.quick else ModelConfig(**kw)


def capture(args) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from nvae_torch.config import TrainConfig
    from nvae_torch.train.state import create_train_state

    device = tool_device(args)
    cfg = _model_config(args)
    bs = args.batch_size
    tc = TrainConfig(batch_size=bs, step_based_warmup=True)
    total_steps = 400 * (60000 // bs)
    t0 = time.time()
    model, state, tx = create_train_state(cfg, tc, total_steps, device=device)
    log(f"device {device}: init {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M params")
    rng = np.random.RandomState(0)
    if args.scan_epochs:
        from nvae_torch.train.epoch_runner import (
            make_epoch_runner,
            stage_dataset,
        )

        runner = make_epoch_runner(model, tx, tc, total_steps, 2,
                                   target_size=cfg.image_size)
        data = stage_dataset(rng.randint(0, 256, (2 * bs, 28, 28, 1))
                             .astype(np.uint8), device)
        t0 = time.time()
        state, _ = runner(state, data, 0)  # eager step, then the capture
        log(f"warm-up epoch (eager step, capture): {time.time() - t0:.1f} s")
        if runner.graph is not None:
            run_once = runner.graph.replay
        else:  # the CPU: no graph; one eager step of the runner
            def run_once():
                runner(state, data, 1)
    else:
        from nvae_torch.train.step import make_train_step

        step = make_train_step(model, tx, tc, total_steps, 60000 // bs)
        batch = torch.from_numpy(
            (rng.rand(bs, 32, 32, 1) > 0.7).astype(np.float32)).to(device)
        box = [state]

        def run_once():
            box[0], _ = step(box[0], batch)

        t0 = time.time()
        for _ in range(3):
            run_once()
        sync(device)
        log(f"warm-up: {time.time() - t0:.1f} s")
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        with record_function(WINDOW):
            for _ in range(args.steps):
                run_once()
            sync(device)
        wall = time.monotonic() - t0
    log(f"traced {args.steps} {'replays' if args.scan_epochs else 'steps'} "
        f"in {wall:.2f} s ({wall / args.steps * 1e3:.1f} ms each incl. "
        "host)")
    os.makedirs(args.outdir, exist_ok=True)
    path = os.path.join(args.outdir, "trace.json")
    prof.export_chrome_trace(path)
    meta = {"steps": args.steps, "scan_epochs": bool(args.scan_epochs),
            "batch_size": bs, "wall_ms": 1e3 * wall,
            "config": {"compute_dtype": cfg.compute_dtype,
                       "bn_apply_dtype": cfg.bn_apply_dtype,
                       "postprocess_depthwise": cfg.postprocess_5x5_depthwise,
                       "use_pallas_kernels": cfg.use_pallas_kernels,
                       "quick": bool(args.quick)},
            "device": device_info(device)}
    with open(os.path.join(args.outdir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    log(f"trace: {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
    return meta


def analyze(args) -> dict:
    path = os.path.join(args.outdir, "trace.json")
    if not os.path.exists(path):
        raise SystemExit(f"no trace.json under {args.outdir}")
    meta = {}
    meta_path = os.path.join(args.outdir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    with open(path) as f:
        trace = json.load(f)
    r = analyze_events(events_from_trace(trace), steps=meta.get("steps", 1),
                       top=args.top)
    print_report(os.path.basename(os.path.abspath(args.outdir)), r,
                 top=args.top, out=sys.stdout)
    report = {"metric": "profile_step", **{k: v for k, v in r.items()
                                            if k != "kernels"},
              "top_kernels": r["kernels"][:args.top],
              "capture": meta}
    print(json.dumps(report))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cmd", choices=["capture", "analyze"])
    ap.add_argument("--outdir", default="profile_step")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=144)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--compute_dtype", default="float32")
    ap.add_argument("--bn_apply_dtype", default="float32")
    ap.add_argument("--postprocess_depthwise", action="store_true")
    ap.add_argument("--use_pallas", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="The hand-written kernels (the JAX tool's flag; "
                         "on by default here)")
    ap.add_argument("--scan_epochs", action="store_true",
                    help="Profile graph replays of the epoch runner's step")
    ap.add_argument("--quick", action="store_true",
                    help="Debug-size model (for tests)")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    if args.quick:
        args.batch_size, args.steps = min(args.batch_size, 8), min(
            args.steps, 2)
    return capture(args) if args.cmd == "capture" else analyze(args)


if __name__ == "__main__":
    main()
