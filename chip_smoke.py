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
   the sampling and training paths, batch 144, fp32: the forward and dx
   (with swish' and in the form without it) at atol 2e-5, dW/db (with and
   without bias) at 1e-4 of the largest |dW| and bitwise across two runs;
   and the fused op's gradients on the card against the CPU Function;
3. sampler: the full-width MNIST sampler (``ModelConfig()``, seeded
   Flax-style init with random BatchNorm running statistics) in the default
   and the depthwise-postprocess configuration: the fused kernel's launches
   per ``sample`` call (14 and 20), and the card's logits and images against
   the same port on the CPU at batch 4 with injected noise;
4. server (a main path): a ``BatchingSampler`` over the ``Sampler`` answers
   three requests of different size and temperature in each configuration,
   with every launch counter set to 0 just before and read just after; one
   dispatch is replayed bitwise;
5. training (a main path): in each configuration, 5 full-width training
   steps (``make_train_step``, Adamax + spectral projection, batch 144,
   synthetic binarized images from a numpy seed) with every counter set to
   0 just before and read just after: finite metrics, and exactly 14
   (default) or 20 (depthwise) launches per step of each of the forward,
   dx and dW/db kernels; then one step at batch 4 on the card against the
   same step on the CPU in float32 and in float64, with injected noise
   (loss, gradients, BatchNorm running statistics);
6. timing: images per second at batch 144 by direct calls and through the
   server, ms per training step and images per second, and each kernel's
   time at each path shape beside its bound, its plain version and the
   library call (``F.conv2d(groups=C)``, ``torch.nn.grad.conv2d_input`` and
   ``conv2d_weight``);
7. profile: ``torch.profiler`` over one ``sample`` call and one training
   step per configuration: device busy time against wall time, and the
   costliest kernels.

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
DW_RTOL = 1e-4  # of the largest |dW|: sums of up to 147k products
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
TRAIN_STEPS = 5
# One full-width training step at batch 4, card against CPU: fp32 on both
# sides, other summation orders through ~100 layers forward and back.  A
# float64 step on the CPU is the reference: at this width each fp32 step is
# about 1e-3 (relative L2) from it in its gradient, and up to 8e-4 in its
# BatchNorm variances (E[x^2] - E[x]^2 cancels), on the CPU as on the card,
# so the two fp32 steps lie up to the sum of their errors apart.
TRAIN_LOSS_RTOL = 1e-4
GRAD_REL_L2 = 3e-3  # card vs CPU fp32, of the whole gradient
CARD_VS_CPU_ROUNDING = 1.5  # card's error vs float64 over the CPU fp32's
LEAF_REL_L2 = 1e-2  # card vs float64, of each parameter's nonzero gradient
BN_STATS_ATOL = 2e-3  # card vs CPU fp32, of max(1, |value|)
BN_STATS_F64_ATOL = 1e-3  # card vs float64, of max(1, |value|)
KERNEL_NAMES = ("fused_swish_depthwise5x5", "depthwise_conv5x5",
                "fused_swish_depthwise5x5_dx", "fused_swish_depthwise5x5_dw")


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

    for name in KERNEL_NAMES:
        getattr(dw, name).launches = 0


def read_counts() -> dict:
    from nvae_torch.kernels import depthwise as dw

    return {name: getattr(dw, name).launches for name in KERNEL_NAMES}


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


def phase_backward_kernels(device) -> dict:
    """dx (with swish' and without) and dW/db (with and without bias)
    against their plain versions at every path shape; dW/db twice, for
    bitwise repeatability.  Returns the errors per kernel and shape."""
    from nvae_torch.kernels import depthwise as dw

    errs = {"fused_swish_depthwise5x5_dx": {},
            "fused_swish_depthwise5x5_dw": {}}
    for h, c, _, _, _ in PATH_SHAPES:
        x, k, _ = path_inputs(h, c, False, device)
        g = path_inputs(h, c, False, device, seed=1)[0]
        dx_err = 0.0
        for fuse in (True, False):
            got = dw.fused_swish_depthwise5x5_dx(g, k, x if fuse else None,
                                                 fuse_swish=fuse)
            want = dw.fused_swish_depthwise5x5_dx_plain(g, k, x,
                                                        fuse_swish=fuse)
            dx_err = max(dx_err, float((got - want).abs().max()))
        errs["fused_swish_depthwise5x5_dx"][(h, c)] = dx_err
        log(f"kernel dx {BATCH}x{h}x{h}x{c}: max abs err {dx_err:.3g} "
            f"(atol {KERNEL_ATOL}, with and without swish')")
        worst = 0.0
        for fuse, bias in ((True, True), (True, False), (False, True)):
            a = dw.fused_swish_depthwise5x5_dw(x, g, fuse_swish=fuse,
                                               with_bias=bias)
            b = dw.fused_swish_depthwise5x5_dw(x, g, fuse_swish=fuse,
                                               with_bias=bias)
            dk_want, db_want = dw.fused_swish_depthwise5x5_dw_plain(
                x, g, fuse_swish=fuse)
            torch.cuda.synchronize(device)
            same = torch.equal(a[0], b[0]) and (
                not bias or torch.equal(a[1], b[1]))
            if not same:
                raise AssertionError(f"dW/db {h}x{c}: two runs differ")
            scale = float(dk_want.abs().max())
            err = float((a[0] - dk_want).abs().max())
            if bias:
                err = max(err, float((a[1] - db_want).abs().max()))
                scale = max(scale, float(db_want.abs().max()))
            log(f"kernel dW/db {BATCH}x{h}x{h}x{c} swish={fuse} bias={bias}: "
                f"max abs err {err:.3g}, max |dW| {scale:.4g} "
                f"(limit {DW_RTOL * scale:.3g}), bitwise repeatable")
            if not err <= DW_RTOL * scale:
                raise AssertionError(f"dW/db {h}x{c}: err {err} > "
                                     f"{DW_RTOL} x {scale}")
            worst = max(worst, err)
        errs["fused_swish_depthwise5x5_dw"][(h, c)] = worst
    return errs


def phase_function_grads(device) -> float:
    """The fused op's gradients (x, the taps as DepthwiseConv passes them,
    the bias) on the card against the CPU Function.  Returns the largest
    error over max(1, |gradient|)."""
    from nvae_torch.kernels import depthwise as dw

    gen = torch.Generator().manual_seed(7)
    shape = (8, 8, 8, 192)
    x0 = torch.randn(shape, generator=gen)
    w0 = 0.2 * torch.randn(192, 1, 5, 5, generator=gen)
    b0 = 0.1 * torch.randn(192, generator=gen)
    g0 = torch.randn(shape, generator=gen)
    grads = {}
    for dev in ("cpu", device):
        # Fresh leaves on each device: ``.to("cpu")`` of a CPU tensor is the
        # tensor itself, so marking it would make the card's copies non-leaf.
        x = x0.to(dev).detach().requires_grad_()
        w = w0.to(dev).contiguous(memory_format=torch.channels_last).detach()
        w.requires_grad_()
        b = b0.to(dev).detach().requires_grad_()
        y = dw.fused_swish_depthwise5x5(x, w.permute(2, 3, 1, 0), b)
        (y * g0.to(dev)).sum().backward()
        grads[str(dev)] = (x.grad, w.grad, b.grad)
    worst = 0.0
    for got, want in zip(grads[str(device)], grads["cpu"]):
        if got is None:
            raise AssertionError("the fused op on the card gave no gradient")
        scale = max(1.0, float(want.abs().max()))
        worst = max(worst, float((got.cpu() - want).abs().max()) / scale)
    log(f"fused op gradients, card vs CPU Function: max err {worst:.3g} of "
        f"max(1, |grad|)")
    if not worst <= 1e-4:
        raise AssertionError(f"card gradients differ from the CPU: {worst}")
    return worst


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
    from nvae_torch.device import fp32_math
    from nvae_torch.serving import Sampler

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
        with fp32_math(deterministic=True):
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


# ---- phase 5: the training path --------------------------------------------


def train_batch(n: int, seed: int) -> torch.Tensor:
    """Synthetic binarized images (n, 32, 32, 1) from a numpy seed."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.rand(n, 32, 32, 1) > 0.5).astype(np.float32))


def train_setup(cfg, device, batch: int):
    from nvae_torch.config import TrainConfig
    from nvae_torch.train.state import create_train_state
    from nvae_torch.train.step import make_train_step

    tc = TrainConfig(batch_size=batch, step_based_warmup=True)
    model, state, tx = create_train_state(cfg, tc, total_steps=1000,
                                          device=device, seed=0)
    return state, make_train_step(model, tx, tc, 1000, 100)


def phase_train(cfg, device) -> dict:
    """The training path: TRAIN_STEPS full-width steps at batch BATCH, with
    the counts set to 0 just before and read just after.  Returns the
    counts, the metrics of every step, ms per step and peak memory."""
    state, step = train_setup(cfg, device, BATCH)
    batches = [train_batch(BATCH, 10 + i).to(device)
               for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    stamps, metrics = [], []
    t0 = time.monotonic()
    for b in batches:
        state, m = step(state, b)
        torch.cuda.synchronize(device)
        stamps.append(time.monotonic())
        metrics.append(m)
    counts = read_counts()
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    finite = all(math.isfinite(v) for m in metrics for v in m.values())
    # The first step pays cuDNN's algorithm search and the allocator's
    # first requests; the rest are the steady state.
    steady = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    return {
        "counts": counts, "steps": state.step, "finite": finite,
        "metrics": metrics,
        "first_step_ms": 1e3 * (stamps[0] - t0),
        "ms_per_step": 1e3 * sum(steady) / len(steady),
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "state": state, "step": step,
    }


def one_step_grads(cfg, device, batch, eps, float64=False):
    """One training step at batch 4 from seed-0 weights with injected noise;
    the optimizer records the gradients and leaves the parameters alone.
    Returns (metrics, gradients, BatchNorm running statistics), on the CPU
    in float64.  ``float64`` runs a float64 copy of the model (CPU only)."""
    from nvae_torch.config import TrainConfig
    from nvae_torch.models.nvae import NVAE
    from nvae_torch.train import optim
    from nvae_torch.train.state import TrainState
    from nvae_torch.train.step import make_train_step

    tc = TrainConfig(batch_size=4, step_based_warmup=True)
    grads = {}

    def record(updates, state, params=None):
        grads.update({k: g.detach().cpu().double() for k, g in updates.items()})
        return {k: torch.zeros_like(g) for k, g in updates.items()}, state

    tx = optim.GradientTransformation(lambda params: None, record)
    # The same seed gives the same weights on every device: they are drawn
    # on the CPU.
    model = NVAE(cfg, device=device, seed=0)
    if float64:
        model.double()
    model.train()
    step = make_train_step(model, tx, tc, 1000, 100)
    _, m = step(TrainState(0, 0, model, None, 0), batch.to(device), eps=eps)
    stats = {k: v.detach().cpu().double() for k, v in model.state_dict().items()
             if "running" in k}
    return {k: float(v) for k, v in m.items()}, grads, stats


def grad_errors(got, want) -> dict:
    """How far one step's results ``got`` lie from ``want``: the loss
    (relative), the whole gradient (relative L2), the worst parameter's
    gradient (relative L2, over the parameters whose gradient in ``want``
    is not 0 at 1e-12 of the whole: the biases that feed a training-mode
    BatchNorm have a true gradient of 0, and hold rounding noise alone) and
    the BatchNorm running statistics (|error| over max(1, |value|))."""
    (m_a, g_a, s_a), (m_b, g_b, s_b) = got, want
    norm = math.sqrt(sum(float((g ** 2).sum()) for g in g_b.values()))
    num = math.sqrt(sum(float(((g_a[k] - g_b[k]) ** 2).sum()) for k in g_b))
    leaf = max((float((g_a[k] - g_b[k]).norm() / g_b[k].norm()), k)
               for k in g_b if float(g_b[k].norm()) > 1e-12 * norm)
    bn = max(float(((s_a[k] - s_b[k]).abs() / s_b[k].abs().clamp(min=1.0))
                   .max()) for k in s_b)
    return {
        "loss_rel": abs(m_a["loss"] - m_b["loss"]) / abs(m_b["loss"]),
        "grad_rel_l2": num / norm,
        "worst_leaf_rel_l2": leaf[0], "worst_leaf": leaf[1],
        "bn_stats_err": bn,
    }


def phase_train_vs_cpu(cfg, device) -> dict:
    """One full-width training step at batch 4 on the card, on the CPU in
    float32, and on the CPU in float64 (the reference that tells rounding
    from fault), from the same weights and injected noise."""
    from nvae_torch.models.nvae import posterior_noise_shapes

    batch = train_batch(4, 3)
    rng = np.random.RandomState(4)
    eps = [[rng.randn(*s).astype(np.float32)
            for s in posterior_noise_shapes(cfg, 4)]]
    card = one_step_grads(cfg, device, batch, eps)
    cpu = one_step_grads(cfg, "cpu", batch, eps)
    ref = one_step_grads(cfg, "cpu", batch, eps, float64=True)
    return {"card_vs_cpu": grad_errors(card, cpu),
            "card_vs_f64": grad_errors(card, ref),
            "cpu_vs_f64": grad_errors(cpu, ref)}


# ---- phases 6 and 7 --------------------------------------------------------


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


def bwd_bound(h, c, kind, bias):
    """Least time of one dx (``kind`` "dx": reads dy and x, writes dx; 50
    FLOP per output for the taps and 9 for the swish' epilogue) or dW/db
    call ("dw": reads x and dy, writes (25 + 1) x C sums; 50 FLOP per
    element for the taps, 4 for swish, 1 for the bias sum).  Returns
    (bytes ms, operations ms)."""
    n = BATCH * h * h * c
    if kind == "dx":
        nbytes, flops = 4 * (3 * n + 25 * c), n * 59
    else:
        nbytes = 4 * (2 * n + (26 if bias else 25) * c)
        flops = n * (54 + (1 if bias else 0))
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOP_PER_S


def phase_backward_timing(device) -> list:
    """Each backward kernel's time at each path shape (the forms the
    training path runs: dx with swish', dW/db with swish and the shape's
    bias) beside its bound, its plain version and the library call that
    computes the same function without the swish parts."""
    from torch.nn.grad import conv2d_input, conv2d_weight

    from nvae_torch.kernels import depthwise as dw
    from nvae_torch.device import fp32_math

    rows = []
    with fp32_math(deterministic=True):
        for h, c, bias, _, _ in PATH_SHAPES:
            n_sets = max(2, min(8, math.ceil(200e6 / (8 * BATCH * h * h * c))))
            sets = []
            for s in range(n_sets):
                x, k, _ = path_inputs(h, c, False, device, seed=s)
                g = path_inputs(h, c, False, device, seed=100 + s)[0]
                sets.append((x, k, g))
            nchw = [(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                     g.permute(0, 3, 1, 2)) for x, k, g in sets]
            size_x = (BATCH, c, h, h)
            size_w = (c, 1, 5, 5)
            calls = {
                "dx": (
                    lambda x, k, g: dw.fused_swish_depthwise5x5_dx(g, k, x),
                    lambda x, k, g: dw.fused_swish_depthwise5x5_dx_plain(
                        g, k, x),
                    lambda x, w, g: conv2d_input(size_x, w, g, padding=2,
                                                 groups=c),
                ),
                "dw": (
                    lambda x, k, g: dw.fused_swish_depthwise5x5_dw(
                        x, g, with_bias=bias),
                    lambda x, k, g: dw.fused_swish_depthwise5x5_dw_plain(x, g),
                    lambda x, w, g: conv2d_weight(x, size_w, g, padding=2,
                                                  groups=c),
                ),
            }
            row = {"shape": [BATCH, h, h, c], "bias": bias}
            for kind, (kern, plain, lib) in calls.items():
                ms, eager = time_ms(kern, sets)
                row[kind] = {
                    "ms": ms, "eager_ms": eager,
                    "plain_ms": time_ms(plain, sets)[0],
                    "library_ms": time_ms(lib, nchw)[0],
                    "bound": bwd_bound(h, c, kind, bias),
                }
                r = row[kind]
                log(f"timing {kind} {BATCH}x{h}x{h}x{c}: kernel "
                    f"{r['ms'] * 1e3:.1f} us (eager {r['eager_ms'] * 1e3:.1f}"
                    f" us), bound {max(r['bound']) * 1e3:.1f} us, plain "
                    f"{r['plain_ms'] * 1e3:.1f} us, library "
                    f"{r['library_ms'] * 1e3:.1f} us")
            rows.append(row)
            del sets, nchw
    return rows


def phase_timing(device, samplers) -> dict:
    from nvae_torch.kernels import depthwise as dw
    from nvae_torch.device import fp32_math
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

    with fp32_math(deterministic=True):
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


def profile_call(label: str, fn) -> dict:
    """Where one warm call's time goes: ``torch.profiler`` over ``fn()``;
    device busy time (sum of kernel times) against the call's wall time,
    and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # an operator: its kernels are listed themselves
        if ev.key.startswith("train_step."):
            continue  # a step part's span on the device, not a kernel
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    n_kernels = sum(r[1] for r in rows)
    # The step's parts (its record_function ranges): time on the host's
    # clock, and the span of their kernels on the device's.
    parts: dict = {}
    for ev in prof.events():
        if ev.name.startswith("train_step."):
            side = ("host_ms" if ev.device_type == torch.autograd.DeviceType.CPU
                    else "device_span_ms")
            part = parts.setdefault(ev.name, {"host_ms": 0.0,
                                              "device_span_ms": 0.0})
            part[side] += ev.time_range.elapsed_us() / 1e3
    log(f"profile {label}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.0f}%), {n_kernels} "
        "device kernels")
    for name, part in sorted(parts.items()):
        log(f"  {name}: host {part['host_ms']:.1f} ms, device span "
            f"{part['device_span_ms']:.1f} ms")
    for ms, count, key in rows[:10]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_kernels": n_kernels, "parts": parts, "top": rows[:10]}


def phase_profile(samplers, trainers) -> dict:
    """One ``sample`` call and one training step per configuration."""
    out = {}
    t = torch.ones(BATCH)
    for name, sampler in samplers.items():
        out[f"sample {name}"] = profile_call(
            f"sample {name}", lambda: sampler(301, t))
    for name, rec in trainers.items():
        batch = train_batch(BATCH, 99).to(rec["state"].model.decoder.h.device)

        def one_step(rec=rec, batch=batch):
            rec["state"], _ = rec["step"](rec["state"], batch)

        out[f"train {name}"] = profile_call(f"train step {name}", one_step)
    return out


def kernel_records(errs, launches, timing, bwd_timing) -> list:
    """One record per kernel.  Times and bounds are per depthwise-config
    call of the path that runs the kernel (a ``sample`` call for the
    forwards, a training step for dx and dW/db): each shape weighted by its
    calls there (9, 5, 3, 3).  ``launches`` sums the main paths' counts."""
    entries = [
        ("fused_swish_depthwise5x5", timing["shapes"], "fused",
         "nvae_tpu/kernels/depthwise.py:239", "sample call"),
        ("depthwise_conv5x5", timing["shapes"], "thin",
         "nvae_tpu/kernels/depthwise.py:105", "sample call"),
        ("fused_swish_depthwise5x5_dx", bwd_timing, "dx",
         "nvae_tpu/kernels/depthwise.py:274", "training step"),
        ("fused_swish_depthwise5x5_dw", bwd_timing, "dw",
         "nvae_tpu/kernels/depthwise.py:288", "training step"),
    ]
    records = []
    for name, rows, kind, replaces, per in entries:
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        t_bytes = t_ops = 0.0
        shapes = []
        for (h, c, _, _, calls), row in zip(PATH_SHAPES, rows):
            r = row[kind]
            b_bytes, b_ops = r["bound"]
            for key in ("ms", "plain_ms", "library_ms"):
                tot[key] += calls * r[key]
            tot["bound_ms"] += calls * max(b_bytes, b_ops)
            t_bytes += calls * b_bytes
            t_ops += calls * b_ops
            shapes.append({
                "shape": row["shape"], "calls": calls,
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
            "per": f"depthwise-config {per} at batch {BATCH}",
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
    bwd_errs = phase_backward_kernels(device)
    worst = max(bwd_errs["fused_swish_depthwise5x5_dx"].values())
    if not worst <= KERNEL_ATOL:
        raise AssertionError(f"dx: max abs err {worst} > {KERNEL_ATOL}")
    errs.update(bwd_errs)
    phase_function_grads(device)

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

    # The main paths: counts set to 0 just before each run, read just after.
    launches = dict.fromkeys(KERNEL_NAMES, 0)
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
    trainers = {}
    for name, cfg in configs().items():
        rec = phase_train(cfg, device)
        want = expected_launches(cfg) * TRAIN_STEPS
        log(f"train {name}: {TRAIN_STEPS} steps, counts {rec['counts']}, "
            f"first step {rec['first_step_ms']:.1f} ms, then "
            f"{rec['ms_per_step']:.2f} ms/step "
            f"({1e3 * BATCH / rec['ms_per_step']:.1f} img/s), peak memory "
            f"{rec['peak_mem_gb']:.2f} GB")
        for i, m in enumerate(rec["metrics"]):
            log(f"  step {i}: " + ", ".join(
                f"{k} {v:.6g}" for k, v in sorted(m.items())))
        if not rec["finite"] or rec["steps"] != TRAIN_STEPS:
            raise AssertionError(f"train {name}: non-finite metrics")
        for k in ("fused_swish_depthwise5x5", "fused_swish_depthwise5x5_dx",
                  "fused_swish_depthwise5x5_dw"):
            if rec["counts"][k] != want:
                raise AssertionError(
                    f"train {name}: {k} launched {rec['counts'][k]} times in "
                    f"{TRAIN_STEPS} steps, expected {want}")
        for k, v in rec["counts"].items():
            launches[k] += v
        trainers[name] = rec
    for k in ("fused_swish_depthwise5x5", "fused_swish_depthwise5x5_dx",
              "fused_swish_depthwise5x5_dw"):
        if launches[k] == 0:
            raise AssertionError(f"the main paths never launched {k}")

    for name, cfg in configs().items():
        rec = phase_train_vs_cpu(cfg, device)
        for pair, r in rec.items():
            log(f"train step {name} {pair}: {r}")
        vs_cpu, vs_f64 = rec["card_vs_cpu"], rec["card_vs_f64"]
        cpu_rounding = rec["cpu_vs_f64"]["grad_rel_l2"]
        if (vs_cpu["loss_rel"] > TRAIN_LOSS_RTOL
                or vs_cpu["grad_rel_l2"] > GRAD_REL_L2
                or vs_f64["grad_rel_l2"] > CARD_VS_CPU_ROUNDING * cpu_rounding
                or vs_f64["worst_leaf_rel_l2"] > LEAF_REL_L2
                or vs_cpu["bn_stats_err"] > BN_STATS_ATOL
                or vs_f64["bn_stats_err"] > BN_STATS_F64_ATOL):
            raise AssertionError(f"train {name}: card vs CPU {rec}")

    timing = phase_timing(device, samplers)
    bwd_timing = phase_backward_timing(device)
    phase_profile(samplers, trainers)
    records = kernel_records(errs, launches, timing, bwd_timing)
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
