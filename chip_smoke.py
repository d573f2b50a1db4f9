#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nvae_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card, the CUDA toolkit (``nvcc``) and the repository's
``nvae_torch`` package, and imports nothing of JAX or ``nvae_tpu``.  Phases,
each raising on failure (nothing is caught):

1. build: compiles every CUDA source of the port with ``nvcc`` (one process
   per source, started together) into ``nvae_torch/kernels/_build/``;
2. kernels: each kernel against its plain PyTorch version at every shape of
   the sampling path, batch 144, fp32 (atol 2e-5);
3. sampler: the full-width MNIST sampler (``ModelConfig()``, 24.08M sampling
   weights, seeded Flax-style init with random BatchNorm running statistics)
   in the default and the depthwise-postprocess configuration: the fused
   kernel's launches per ``sample`` call (14 and 20), and the card's logits
   and images against the same port on the CPU at batch 4 with injected
   noise;
4. server (the main path): a ``BatchingSampler`` over the ``Sampler`` answers
   three requests of different size and temperature in each configuration,
   with every launch counter set to 0 just before and read just after; one
   dispatch is replayed bitwise;
5. timing: images per second at batch 144 by direct calls and through the
   server, and each kernel's time at each
   path shape beside its bound, its plain version and the library call
   ``F.conv2d(groups=C)``;
6. profile: ``torch.profiler`` over one ``sample`` call per configuration:
   device busy time against wall time, and the costliest kernels.

The last three lines of standard output are the card's name and power limit
(``nvidia-smi``), one JSON object ``{"kernels": [...]}``, and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 144
# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
KERNEL_ATOL = 2e-5
# Card against CPU through the whole 40-layer chain: fp32 on both, other
# summation orders (cuDNN vs the CPU's convolutions).
PROB_ATOL = 1e-3
LOGIT_RTOL = 1e-3  # of the largest |logit|
# (H, C, bias, calls per sample: default config, depthwise config)
PATH_SHAPES = [
    (4, 1536, True, 9, 9),
    (8, 768, True, 5, 5),
    (16, 384, False, 0, 3),
    (32, 192, False, 0, 3),
]


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def configs():
    from nvae_torch.config import ModelConfig

    return {
        "default": ModelConfig(use_pallas_kernels=True),
        "depthwise": ModelConfig(use_pallas_kernels=True,
                                 postprocess_5x5_depthwise=True),
    }


def expected_launches(cfg) -> int:
    """Fused-kernel launches of one ``sample`` call: one per generative
    cell, plus one per postprocess node in the depthwise form."""
    cells = (cfg.n_total_groups - 1) * cfg.res_cells_per_group
    post = cfg.n_postprocess_blocks * cfg.n_postprocess_cells
    return cells + (post if cfg.postprocess_5x5_depthwise else 0)


def reset_counts():
    from nvae_torch.kernels import depthwise as dw

    dw.fused_swish_depthwise5x5.launches = 0
    dw.depthwise_conv5x5.launches = 0


def read_counts() -> dict:
    from nvae_torch.kernels import depthwise as dw

    return {
        "fused_swish_depthwise5x5": dw.fused_swish_depthwise5x5.launches,
        "depthwise_conv5x5": dw.depthwise_conv5x5.launches,
    }


# ---- phase 1 ----------------------------------------------------------------


def phase_build():
    from nvae_torch.kernels import _build

    t0 = time.monotonic()
    logs = _build.build()
    log(f"build: {sorted(logs)} in {time.monotonic() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")


# ---- phase 2 ----------------------------------------------------------------


def path_inputs(h, c, bias, device, seed=0):
    """x (B, H, H, C), taps as DepthwiseConv passes them (a (5, 5, 1, C)
    view of a channels_last (C, 1, 5, 5) weight), bias or None."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(BATCH, h, h, c, generator=gen, device=device)
    w = 0.2 * torch.randn(c, 1, 5, 5, generator=gen, device=device)
    k = w.contiguous(memory_format=torch.channels_last).permute(2, 3, 1, 0)
    b = torch.randn(c, generator=gen, device=device) * 0.1 if bias else None
    return x, k, b


def phase_kernels(device) -> dict:
    """Max abs error of each kernel against its plain version, per shape."""
    from nvae_torch.kernels import depthwise as dw

    errs = {"fused_swish_depthwise5x5": {}, "depthwise_conv5x5": {}}
    for h, c, bias, _, _ in PATH_SHAPES:
        x, k, b = path_inputs(h, c, bias, device)
        got = dw.fused_swish_depthwise5x5(x, k, b, fuse_swish=True)
        want = dw.fused_swish_depthwise5x5_plain(x, k, b, fuse_swish=True)
        thin = dw.depthwise_conv5x5(x, k.contiguous())
        thin_want = dw.fused_swish_depthwise5x5_plain(x, k, None,
                                                      fuse_swish=False)
        torch.cuda.synchronize(device)
        for name, a, r in (("fused_swish_depthwise5x5", got, want),
                           ("depthwise_conv5x5", thin, thin_want)):
            err = float((a - r).abs().max())
            errs[name][(h, c)] = err
            log(f"kernel {name} {BATCH}x{h}x{h}x{c}: max abs err {err:.3g} "
                f"(atol {KERNEL_ATOL})")
    return errs


# ---- phase 3 ----------------------------------------------------------------


def random_bn_stats_(model, seed: int) -> None:
    from nvae_torch.nn.blocks import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(
                    0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.uniform_(0.5, 1.5, generator=gen)


def phase_sampler(cfg, device):
    """The full-width sampler on the card: launches per sample call, and the
    card against the CPU with injected noise.  Returns (sampler, record)."""
    from nvae_torch.kernels import depthwise as dw
    from nvae_torch.models.nvae import NVAE, decoder_noise_shapes
    from nvae_torch.serving import Sampler, fp32_convolutions

    cpu_model = NVAE(cfg, device="cpu", seed=0)
    random_bn_stats_(cpu_model, seed=1)
    sampler = Sampler(cfg, cpu_model.state_dict(), n_samples=BATCH,
                      device=device)

    before = dw.fused_swish_depthwise5x5.launches
    images = sampler(1, torch.ones(BATCH))
    torch.cuda.synchronize(device)
    per_call = dw.fused_swish_depthwise5x5.launches - before
    check_images(images.cpu().numpy(), BATCH)

    rng = np.random.RandomState(2)
    eps = [rng.randn(*s).astype(np.float32)
           for s in decoder_noise_shapes(cfg, 4)]
    t = torch.tensor([0.6, 0.8, 1.0, 1.2])
    with torch.inference_mode():
        with fp32_convolutions():
            feats, *_ = sampler.model.decoder.generate(4, t.to(device), eps=eps)
            gpu = sampler.model.postprocess(feats).cpu()
        feats, *_ = cpu_model.decoder.generate(4, t, eps=eps)
        cpu = cpu_model.postprocess(feats)
    scale = float(cpu.abs().max())
    logit_err = float((gpu - cpu).abs().max())
    prob_err = float((torch.sigmoid(gpu) - torch.sigmoid(cpu)).abs().max())
    return sampler, {
        "launches_per_sample": per_call,
        "logit_max_abs": scale,
        "logit_err": logit_err,
        "prob_err": prob_err,
        "finite": bool(torch.isfinite(gpu).all()),
    }


def check_images(a: np.ndarray, n: int) -> None:
    if a.shape != (n, 32, 32, 1):
        raise AssertionError(f"images shape {a.shape}")
    if not np.isfinite(a).all() or a.min() < 0.0 or a.max() > 1.0:
        raise AssertionError("images not finite probabilities")


# ---- phase 4: the main path -------------------------------------------------


def phase_server(sampler) -> dict:
    """Three requests through the batching server; counts read around it."""
    from nvae_torch.serving_runtime import BatchingSampler, dispatch_seed

    requests = [(100, 0.8), (60, 1.0), (20, 0.6)]
    reset_counts()
    t0 = time.monotonic()
    with BatchingSampler(sampler, BATCH, max_delay_ms=0, seed=3) as srv:
        futs = [srv.submit(n, t) for n, t in requests]
        srv.flush()
        outs = [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    counts = read_counts()
    for (n, _), out in zip(requests, outs):
        check_images(out, n)
    # Dispatch 0 packed the first BATCH rows of the requests, in order.
    temps = [t for n, t in requests for _ in range(n)]
    direct = sampler(dispatch_seed(3, 0), torch.tensor(temps[:BATCH]))
    replay = np.array_equal(np.concatenate(outs)[:BATCH],
                            direct.cpu().numpy())
    return {
        "counts": counts,
        "dispatches": srv.stats.dispatches,
        "rows_served": srv.stats.rows_served,
        "seconds": seconds,
        "replay_bitwise": replay,
    }


# ---- phase 5 ----------------------------------------------------------------


def time_ms(fn, arg_sets, iters=40):
    """Mean time of one call over ``iters`` calls that cycle through
    ``arg_sets`` (enough sets to exceed the 50 MB L2), by CUDA events.
    Returns (device ms, eager ms): the first replays the calls captured in a
    CUDA graph, so it holds device time alone; the second issues them from
    Python, host overhead included."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    device = start.elapsed_time(end) / iters
    del graph
    return device, eager


def bound(h, c, bias, swish):
    """Least time for one call: each input read once, each output written
    once, over HBM; 50 FLOP per output for the taps, 4 for swish, 1 for the
    bias, over the fp32 rate.  Returns (bytes ms, operations ms)."""
    n = BATCH * h * h * c
    nbytes = 4 * (2 * n + 25 * c + (c if bias else 0))
    flops = n * (50 + (4 if swish else 0) + (1 if bias else 0))
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOP_PER_S


def phase_timing(device, samplers) -> dict:
    from nvae_torch.kernels import depthwise as dw
    from nvae_torch.serving import fp32_convolutions
    from nvae_torch.serving_runtime import BatchingSampler

    out = {"img_per_s": {}, "shapes": []}
    for name, sampler in samplers.items():
        t = torch.ones(BATCH)
        for i in range(2):
            sampler(100 + i, t)
        torch.cuda.synchronize()
        n_calls = 5
        t0 = time.monotonic()
        for i in range(n_calls):
            sampler(200 + i, t)
        torch.cuda.synchronize()
        out["img_per_s"][name] = n_calls * BATCH / (time.monotonic() - t0)
        # The same work through the server, whose worker enqueues the next
        # dispatch while the card runs the last one.
        with BatchingSampler(sampler, BATCH, max_delay_ms=0, seed=5) as srv:
            srv.submit(BATCH, 1.0).result(timeout=600)
            t0 = time.monotonic()
            futs = [srv.submit(BATCH, 0.6 + 0.1 * i) for i in range(8)]
            for f in futs:
                f.result(timeout=600)
            server = 8 * BATCH / (time.monotonic() - t0)
        log(f"timing {name}: {out['img_per_s'][name]:.1f} img/s at batch "
            f"{BATCH} by direct calls, {server:.1f} img/s through the server")

    with fp32_convolutions():
        for h, c, bias, _, _ in PATH_SHAPES:
            n_sets = max(2, min(8, math.ceil(200e6 / (8 * BATCH * h * h * c))))
            sets = [path_inputs(h, c, bias, device, seed=s)
                    for s in range(n_sets)]
            nchw = [(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), b)
                    for x, k, b in sets]
            plain_sets = [(x, k, None) for x, k, _ in sets]
            row = {"shape": [BATCH, h, h, c], "bias": bias}
            calls = {
                "fused": (
                    lambda x, k, b: dw.fused_swish_depthwise5x5(
                        x, k, b, fuse_swish=True),
                    lambda x, k, b: dw.fused_swish_depthwise5x5_plain(
                        x, k, b, fuse_swish=True),
                    # The library call convolves without the swish.
                    lambda x, w, b: F.conv2d(x, w, b, padding=2, groups=c),
                    sets, bound(h, c, bias, True),
                ),
                "thin": (
                    lambda x, k, b: dw.depthwise_conv5x5(x, k),
                    lambda x, k, b: dw.fused_swish_depthwise5x5_plain(
                        x, k, None, fuse_swish=False),
                    lambda x, w, b: F.conv2d(x, w, None, padding=2, groups=c),
                    plain_sets, bound(h, c, False, False),
                ),
            }
            for kind, (kern, plain, lib, args, bnd) in calls.items():
                ms, eager = time_ms(kern, args)
                row[kind] = {
                    "ms": ms, "eager_ms": eager,
                    "plain_ms": time_ms(plain, args)[0],
                    "library_ms": time_ms(lib, nchw)[0],
                    "bound": bnd,
                }
            for kind in ("fused", "thin"):
                r = row[kind]
                log(f"timing {kind} {BATCH}x{h}x{h}x{c}: kernel "
                    f"{r['ms'] * 1e3:.1f} us (eager {r['eager_ms'] * 1e3:.1f}"
                    f" us), bound {max(r['bound']) * 1e3:.1f} us, plain "
                    f"{r['plain_ms'] * 1e3:.1f} us, conv2d(groups=C) "
                    f"{r['library_ms'] * 1e3:.1f} us")
            out["shapes"].append(row)
            del sets, nchw, plain_sets
    return out


def phase_profile(samplers) -> dict:
    """Where one ``sample`` call's time goes: ``torch.profiler`` over one
    warm call per configuration; device busy time (sum of kernel times)
    against the call's wall time, and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, sampler in samplers.items():
        t = torch.ones(BATCH)
        sampler(300, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            sampler(301, t)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.monotonic() - t0)
        rows = []
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue  # an operator: its kernels are listed themselves
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
            if dev_us > 0:
                rows.append((dev_us / 1e3, ev.count, ev.key))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows)
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "top": rows[:8]}
        log(f"profile {name}: wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.0f}%)")
        for ms, count, key in rows[:8]:
            log(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    return out


def kernel_records(errs, launches, timing) -> list:
    """One record per kernel.  Times and bounds are per depthwise-config
    ``sample`` call: each shape weighted by its calls (9, 5, 3, 3)."""
    entries = [
        ("fused_swish_depthwise5x5", "fused",
         "nvae_tpu/kernels/depthwise.py:239"),
        ("depthwise_conv5x5", "thin", "nvae_tpu/kernels/depthwise.py:105"),
    ]
    records = []
    for name, kind, replaces in entries:
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        t_bytes = t_ops = 0.0
        shapes = []
        for (h, c, _, _, calls), row in zip(PATH_SHAPES, timing["shapes"]):
            r = row[kind]
            b_bytes, b_ops = r["bound"]
            for key in ("ms", "plain_ms", "library_ms"):
                tot[key] += calls * r[key]
            tot["bound_ms"] += calls * max(b_bytes, b_ops)
            t_bytes += calls * b_bytes
            t_ops += calls * b_ops
            shapes.append({
                "shape": row["shape"], "calls_per_sample": calls,
                "ms": r["ms"], "eager_ms": r["eager_ms"],
                "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                "bound_ms": max(b_bytes, b_ops),
                "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                "max_abs_err": errs[name][(h, c)],
            })
        records.append({
            "name": name, "route": "cuda",
            "source": "nvae_torch/kernels/csrc/depthwise5x5.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs[name].values()),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": tot["library_ms"],
            "per": f"depthwise-config sample call at batch {BATCH}",
            "shapes": shapes,
        })
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import nvae_torch  # noqa: F401  (fails outside the repository)

    t_start = time.monotonic()
    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    phase_build()

    errs = phase_kernels(device)
    for name, per_shape in errs.items():
        worst = max(per_shape.values())
        if not worst <= KERNEL_ATOL:
            raise AssertionError(f"{name}: max abs err {worst} > {KERNEL_ATOL}")

    samplers = {}
    for name, cfg in configs().items():
        sampler, rec = phase_sampler(cfg, device)
        want = expected_launches(cfg)
        log(f"sampler {name}: {rec}")
        if rec["launches_per_sample"] != want:
            raise AssertionError(
                f"{name}: {rec['launches_per_sample']} fused launches per "
                f"sample call, expected {want}")
        if not rec["finite"]:
            raise AssertionError(f"{name}: non-finite logits")
        if rec["logit_err"] > LOGIT_RTOL * max(rec["logit_max_abs"], 1.0):
            raise AssertionError(f"{name}: card vs CPU logits {rec}")
        if rec["prob_err"] > PROB_ATOL:
            raise AssertionError(f"{name}: card vs CPU probabilities {rec}")
        samplers[name] = sampler

    # The main path: counts set to 0 just before each run, read just after.
    launches = {"fused_swish_depthwise5x5": 0, "depthwise_conv5x5": 0}
    for name, sampler in samplers.items():
        rec = phase_server(sampler)
        log(f"server {name}: {rec}")
        want = expected_launches(configs()[name]) * rec["dispatches"]
        if rec["counts"]["fused_swish_depthwise5x5"] != want:
            raise AssertionError(f"{name}: launches {rec['counts']} != {want}")
        if rec["rows_served"] != 180 or not rec["replay_bitwise"]:
            raise AssertionError(f"{name}: server check failed {rec}")
        for k, v in rec["counts"].items():
            launches[k] += v
    if launches["fused_swish_depthwise5x5"] == 0:
        raise AssertionError("the main path never launched the fused kernel")

    timing = phase_timing(device, samplers)
    phase_profile(samplers)
    records = kernel_records(errs, launches, timing)
    log(f"total {time.monotonic() - t_start:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
