#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nvae_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card, the CUDA toolkit (``nvcc``) and the repository's
``nvae_torch`` package, and imports nothing of JAX or ``nvae_tpu``.  Phases,
each raising on failure (nothing is caught):

1. build: compiles every CUDA source of the port with ``nvcc`` (one process
   per source, started together) into ``nvae_torch/kernels/_build/``, and
   logs each kernel's registers, spills and static shared bytes (``ptxas
   -v``), the depthwise ring's launch geometry at each path shape, and the
   gate's clusters at each SE shape beside the clusters the card holds at
   once (``cudaOccupancyMaxActiveClusters``);
2. kernels: each kernel against its plain PyTorch version at every shape of
   the sampling and training paths, fp32, at every batch the paths give it
   (the forwards at 144, 576, 72, 12, 4 and 3; dx and dW/db at 144, 72 and
   4; 72 is a rank's share of phase 12's data-parallel batch): the
   forward and dx (with swish' and in the form without it) at atol 2e-5,
   dW/db (with and without bias) at 1e-4 of the largest |dW| and bitwise
   across two runs;
   the fused op's gradients on the card against the CPU Function; and the
   squeeze-excitation gate (#5) at the model's four SE shapes, the extra
   shapes (ragged pixel counts, C % 4 != 0, batch 1, the most channels a
   block takes) and with x off 16-byte alignment, at atol 1e-5, bitwise
   across two runs, refusing an input that requires grad and one channel
   too many;
   and kernel #2's bf16 instance at every path shape and at batches 144,
   576 and 8 (the serving paths'): within one bf16 ulp of its plain
   version's result plus 32 fp32 ulps of its products' sum, at least
   99.9% of outputs bitwise equal to it, and bitwise across two runs;
   and the bf16 instances of #3 and #4 at every path shape and batches
   144, 72 and 4 (the training paths'): dx (with swish' and without) within one
   bf16 ulp plus 32 fp32 ulps of |swish'(x)| sum |dy w|, at least 99.9%
   bitwise equal, bitwise across two runs; dW/db's fp32 sums at 1e-4 of
   the largest |dW|, bitwise across two runs;
   and #1-#4 in fp32 and the bf16 instances of #2-#4 at the shapes phase
   14's tensor-parallel step gives them (72 rows, 4x4x768 and 8x8x384: the
   generative cells' halves of their hidden channels), at the same limits;
3. sampler: the full-width MNIST sampler (``ModelConfig()``, seeded
   Flax-style init with random BatchNorm running statistics) in the default
   and the depthwise-postprocess configuration: the fused kernel's launches
   per ``sample`` call (14 and 20), and the card's logits and images against
   the same port on the CPU at batch 4 with injected noise;
4. server (a main path): a ``BatchingSampler`` over the ``Sampler`` answers
   three requests of different size and temperature in each configuration,
   with every launch counter set to 0 just before and read just after; one
   dispatch is replayed bitwise;
   then the sampler matrix (a main path): in each configuration, weights in
   fp32, bf16 and int8 at fp32 compute and bf16 and int8 at bf16 compute
   (compute and BatchNorm apply), batch 144: exact launches of #2 per call
   (fp32 or bf16 as the compute dtype says), ms per call, weights bytes on
   the card, a call's peak memory, the host ms of int8 dequantization, and
   the card against the CPU at batch 8 with injected noise;
5. training (a main path): in each configuration, 5 full-width training
   steps (``make_train_step``, Adamax + spectral projection, batch 144,
   synthetic binarized images from a numpy seed) with every counter set to
   0 just before and read just after: finite metrics, and exactly 14
   (default) or 20 (depthwise) launches per step of each of the forward,
   dx and dW/db kernels; then the same in bf16 (compute and BatchNorm
   apply bf16 in both configurations, and bf16 compute with fp32 BatchNorm
   apply in the default one): a falling reconstruction loss (every
   configuration), exactly 14 or 20 launches per step of each bf16 kernel
   (#2, #3, #4) and none of the fp32 ones;
   then one step at batch 4 on the card against the same step on the CPU
   in float32 and in float64, with injected noise (loss, gradients,
   BatchNorm running statistics), and in the depthwise configuration the
   bf16 step on the card and on the CPU (the plain versions), the card's
   gradient no further from float64 than 1.5 times the CPU's (the CPU's
   steps come from a helper process, ``chip_smoke.py --host-refs DIR``,
   started here: held once phase 5b is done);
   then the device-resident epoch (a main path, ``--scan_epochs``): in
   the default and depthwise configurations in fp32 and the depthwise one
   in bf16, 60,000 synthetic uint8 rows staged on the card and 2 epochs of
   5 full-width steps at batch 144 through the epoch runner, as CUDA
   graph replays (the first step eager on a side stream, the second
   captured) and eagerly from the same seed: the two runs' parameters,
   statistics, optimizer state and mean metrics bit for bit equal, exactly
   14 / 20 launches of each of #2, #3 and #4 per replay (and per eager
   step) in the config's dtype and none of the other, ms per step of the
   second epoch and peak memory of both;
6. the gate's own entry point (a main path; the model does not call it, as
   in the JAX package): one call at each of the model's SE shapes, counted;
7. the training entry point (a main path): ``python -m nvae_torch.cli`` as
   subprocesses at full width (``--preset mnist_step_sn --use_pallas``,
   batch 144, synthetic data, ``--debug``): train 2 epochs with eval, image
   hooks and a checkpoint per epoch, then resume for a third and at the
   same time ``--mode sample`` over a copy of the second epoch's
   checkpoint; exit codes, metrics, image directories, checkpoints, 144 PNGs
   per temperature, and exact launch counts (14 of #2, #3 and #4 per step,
   14 of #2 per eval, sampling and reconstruction forward); then, in
   process, the state a Trainer restores equals the step-8 checkpoint;
   and the CLI in bf16 (``--compute_dtype bfloat16 --bn_apply_dtype
   bfloat16 --postprocess_depthwise``): train 1 epoch, then ``--mode
   sample`` on its checkpoint, with exact launch counts of the bf16
   kernels and none of fp32; and the CLI on the scan path (``--scan_epochs``):
   train 2 epochs with eval, image hooks and a checkpoint per epoch, then
   resume for a third, with exact launch counts through the wrappers (each
   run's eager first step, its capture and the forwards of the hooks) and
   as replays (the other steps), and the optimizer's counts in the last
   checkpoint; the three (per step, bf16, scan) run at the same time, each
   in its own directory, so their seconds are no measurement;
8. IWAE NLL on that model: K=10 over 2 test batches of 144 (seconds per
   batch), and one B=4 NLL card against CPU (rtol 1e-4), each side also
   held to a float64 CPU run, then the serving artifact (below), in this
   process while ``--mode serve`` runs (so the seconds of both are no
   measurement);
   ``--mode serve`` (a main path) as a subprocess over the CLI's
   checkpoint, int8 weights, bf16 compute, batches 144 and 576: concurrent
   npy and PNG requests, /healthz, /stats answering while a dispatch is in
   flight, /reload to step 8 and to the latest, the load of
   ``tools/bench_serving_http.py`` (32 clients, n in [1, 16], a 10 ms
   window) for 5 s after 1 s of warm-up (img/s, req/s, p50 and p99
   latency, occupancy), SIGTERM drain with exit 0 and exact launch counts;
   and the serving artifact: fp32, bf16 and int8 exports (bytes), the int8
   one checked bitwise against the live sampler, served by ``python -m
   nvae_torch.serving_http --artifact`` for one request, SIGTERM, exact
   launch counts;
   8b. the metric suite (a main path) over phase 7's checkpoint: ``python
   -m nvae_torch.cli --mode test`` as a subprocess at the default
   temperatures and backbones (VGG16 at 224, InceptionV3 at 299,
   random-init), reduced to ``--debug`` (4 test batches of 144), 1
   attempt and 1,008 FID samples; then ``--eval_parity`` (the
   nearest-299 path) at T=1.0, 1 attempt and 1,440 FID samples: exit
   codes, evaluation.json (its keys, finite values, P&R in [0, 1] or [0,
   2], random-init provenance), each stage's seconds, and exact launches
   of fp32 #2 (per sample call, NLL posterior pass and ``sample_with_z``
   postprocess),
   none of any other kernel; then, in process, each backbone card vs
   CPU
   (relative L2 1e-4) and its ms per image, P&R at 10,000 x 10,000 x 512
   full against streamed at 2,500 (radii, no membership flip, ms) and card
   vs CPU at 2,000, the fp32 device FID against the fp64 host FID on
   10,000 x 2,048 features (and with TF32 allowed, a control that must
   fail that limit); ``python -m nvae_torch.eval.fid --save_stats`` over
   phase 7's t_0.7 PNGs and scoring them against 144 PNGs of noise
   (``random_conv``), the printed FID against ``scipy.linalg.sqrtm``'s
   (the two ``--mode test`` runs and the FID command line at once: their
   seconds are no measurement);
9. timing: images per second at batch 144 by direct calls and through the
   server, and each kernel's time at each path shape beside its bound (and
   the bound's share of the kernel's time), its plain version and the
   library call (and the kernel's time over the library's;
   ``F.conv2d(groups=C)``,
   ``torch.nn.grad.conv2d_input`` and ``conv2d_weight``; for the gate, which
   no single call computes, the eager ``SqueezeExcitation`` module), the
   bf16 instances of #2, #3 and #4 beside their bounds and the library
   calls in bf16 (input sets holding more than twice the L2), and #2 at
   the shapes of ``tools/bench_dw_kernel.py``;
10. profile: ``torch.profiler`` over one ``sample`` call (fp32, and bf16
    weights with bf16 compute), one training step per configuration
    (fp32, and the depthwise one in bf16) and one graph replay of each
    scan configuration's step, analyzed by the package's
    ``nvae_torch.tools.profile_step``: device busy time against wall time,
    time by kernel category, the step's parts, the longest idle gaps and
    the costliest kernels; the replay's depthwise kernels by name must
    number what its capture counted;
11. the RGB presets (main paths; run after 10, on a card freed of the
    earlier phases' models and graphs):
    ``cifar10_dml`` (batch 128) and ``celeba64`` (batch 64, rematerialized
    cells) at full width: #1-#4 in fp32 against their plain versions at
    every shape of their paths (4x4x2304 to 64x64x288) and every batch the
    paths give them, as phase 2 holds them, each shape's ring geometry
    logged; the bf16 instances of #2, #3 and #4 at every such shape at 4
    rows, with and without swish (#3: swish') and bias, at phase 2's bf16
    limits, bitwise across two runs, each shape's sliding-row geometry
    logged (a few seconds); in each postprocess form 2 training steps with exact launches
    (cifar10_dml 46 / 52 of each of #2-#4 a step; celeba64 54 / 60 of #3
    and #4 and twice that of #2, which the backward pass's recompute runs
    again), one more step profiled, and a sampler at batch 144 (launches,
    ms a call); for cifar10_dml a B=4 step and B=4 head output and images
    card vs CPU in fp32 and float64 with injected noise, and the B=4 IWAE
    NLL card vs CPU (the CPU's side from phase 5's helper, which starts
    on it at phase 9; the B=4 steps held after the preset's scan forms);
    for cifar10_dml in bf16 (compute and BatchNorm apply) the B=4 step card
    vs CPU from 30 Adamax steps under deterministic cuDNN (loss within
    5e-3, gradient and BatchNorm statistics no further from float64 than
    1.5 times the CPU's) and the B=4 IWAE NLL card vs CPU, 2 training steps
    at batch 128 with exact launches of the bf16 kernels and none of fp32,
    and one bf16 sample call at batch 144; for
    celeba64 one step with remat against one without at batch 4 under
    deterministic cuDNN (loss, gradients, BatchNorm statistics within
    1e-6); each
    preset's scan path (2 epochs of 3 steps, the second captured, replays
    counted, one replay profiled), and its depthwise form's: 2 steps
    eagerly and as replays under deterministic cuDNN, bit for bit, with
    exact launches (the postprocess's too); then the
    CLI as subprocesses with exact
    counts, three at a time: cifar10_dml trains 1 epoch and scores
    (``--mode test --debug --eval_attempts 1``, 1,008 FID samples as phase
    8b), sampling (RGB PNGs) beside the scoring, while cifar10_dml and
    celeba64 train 1 epoch each on the scan path (a CUDA graph of the
    remat'd step); one request through a ``BatchingSampler`` over the
    cifar10_dml checkpoint; and #2-#4 timed
    at each RGB shape at the preset's batch beside their bounds, plain
    versions and library calls (the fp32 records' ``rgb_shapes``);
12. data parallelism (main paths; states its seconds): 12a, two ranks on
    the one card over gloo (NCCL refuses two ranks on one device), spawned
    as ``chip_smoke.py --dp-rank DIR``: from a state warmed by 30 Adamax
    steps, 2 full-width default fp32 SGD steps (lr 1e-6) at global batch
    144 (72 rows a rank) under deterministic cuDNN against 2
    single-process steps on the same weights, batches and noise: every
    step's loss and grad_norm at JAX's lockstep limits (rtol 1e-5 / 1e-4)
    and every parameter within 1e-5; the single run with each batch's
    halves swapped within those limits too, and each of two planted faults
    (BatchNorm statistics, KL balancing coefficients left per rank) outside
    them; both ranks' states bit for bit equal, exactly 14 launches of each
    of #2, #3 and #4 a step on each rank, ms per step and the gloo
    all-reduce of the 160 MB gradient;
    12b, NCCL at world size 1 in this process while 12a's ranks step (its
    ms are no measurement): the scan runner with the
    mesh (its all-reduces captured in the step's graph) against the runner
    without, phase 5b's epochs and steps under deterministic cuDNN: states
    and means bit for bit equal, replays and replayed launches equal, ms
    per step of each; 12c, ``python -m torch.distributed.run
    --nproc_per_node 2`` over the CLI at full width (gloo): ``--mode train
    --data_parallel 2`` for an epoch with eval and image hooks (one
    checkpoint), a resume for a second, then ``--mode serve
    --data_parallel 2`` answering two requests of 144 rows at two
    temperatures, held against the single-rank ``Sampler`` for the same
    dispatch seeds (bitwise, or within 1e-3 where cuDNN picks another
    algorithm for 72 rows than for 144), SIGTERM to rank 0 (it drains and
    stops the other rank); exact launch counts on each rank.  Neither
    two ranks sharing a card nor NCCL over one rank measures scaling.
    12d, FSDP (``--fsdp``), beside them: 12d-1 on 12a's ranks, the state
    re-sharded at min_size 64 (every conv kernel a shard, the depthwise
    taps too): 2 SGD steps with the spectral projection from 12a's warm
    start, replicated and FSDP, against the single process's, at 12a's
    limits, with the halves-swapped control within them and the planted
    fault (sigma from each rank's own block of a kernel) outside them,
    exactly 14 launches of each of #2-#4 a step on each rank, ms per step
    of both layouts, the gloo all-gather and reduce-scatter ms, peak and
    at-rest MB per rank; 12d-2 in 12b's NCCL group: the scan runner over
    the FSDP state (its all-gathers and reduce-scatters captured) bit for
    bit equal to the runner without a mesh; 12d-3 at the same time as 12c:
    ``torchrun ... --data_parallel 2 --fsdp`` trains an epoch and resumes
    for a second, beside the resume a world-1 ``--mode sample`` from the
    first epoch's checkpoint writes PNGs bit for bit equal to this
    process's from the same checkpoint restored in the replicated layout;
13. the pipeline (a main path; states its seconds): ``PipelineTrainer``
    at full width (the default MNIST config, ``use_pallas_kernels``, batch
    144), every stage on this one card (``devices=[cuda:0] * S``), from
    seed-0 weights, SGD at lr 1e-5 with the spectral projection, under
    deterministic cuDNN without TF32: (a) fp32 S=2 M=2 and S=4 M=4 under
    1f1b, 2 steps each, against the ``grad_accum=M`` step on the same
    batches and noise, at JAX's pipeline limits (loss within 1e-4
    relative, parameters and BatchNorm statistics within 2e-6 after each
    step); (b) S=4 M=4 under gpipe equal to (a)'s 1f1b run bit for bit,
    stashing 4 microbatch inputs a stage against at most 2; (c) bf16
    compute and BatchNorm apply with the depthwise postprocess at S=3 M=2
    against the ``grad_accum=2`` step at JAX's bf16 limits (loss 2e-2
    relative, parameters 5e-3); (d) exactly the launches of #2-#4 the
    stage split gives (14 M of each a step where the decoder is the last
    stage, else 28 M of #2 with its recompute and 14 M of #3 and #4; 6 M
    more of each with the depthwise postprocess), in the config's dtype and
    none of the other; (e) the Trainer with ``pipeline_stages=2`` on one
    card stops with JAX's ``pipeline needs 2 devices`` message.  Each
    configuration's ms a step (its second) beside the ``grad_accum=M``
    step's.  (f) the data-parallel stages: four gloo ranks on the card
    (``chip_smoke.py --pp-rank DIR``, started with the phase) as 2 stages
    x 2 ranks, 36 rows a rank a microbatch: beside (a)-(e) they build
    their stages and take one step from (a)'s seeded start (its loss and
    grad_norm logged beside (a)'s, unchecked: the seeded fp32 step is
    chaotic under reordered sums), while ``torchrun --nproc_per_node 4 -m
    nvae_torch.cli --mode train --pp_stages 2 --data_parallel 2`` trains
    an epoch with eval and image hooks and resumes for a second (exact
    launches on each rank, checkpoints, metrics, the layout printed by
    rank 0 alone) and this process makes the warm start (phase 12a's: 30
    Adamax steps), its ``grad_accum=2`` reference, and that step with each
    microbatch's halves and noise swapped (a sound reordering); then,
    alone on the card, the one-process S=2 M=2 pipeline from the warm
    start at (a)'s limits against that reference, and the ranks' 2 1f1b
    steps from it, the loss and parameters at (a)'s limits and the
    BatchNorm statistics within 1e-5 of ``max(1, |value|)``
    (``PP_DP_BN_RTOL``, which the swapped control must pass too): a
    stage's ranks bit for bit equal after each step, every rank's metrics
    equal, exactly its stage's launches on each rank (the first stage's
    none), the ms a step of both and the peak MB a rank.
14. the tensor-parallel layout (a main path; states its seconds): four
    gloo ranks on the card (``chip_smoke.py --tp-rank DIR``) as
    ``make_mesh(0, 2)``'s 2 data x 2 model grid, started with phase 13:
    once this process has made 13f's warm start (and from it the
    one-process steps below, under deterministic cuDNN), the ranks build
    the default configuration at full width from it in
    ``shard_state_tp``'s layout (the 14 generative cells' expansion
    kernels and depthwise taps split: #2-#4 on each rank's half of their
    hidden channels, the projection summed over the model axis), with SGD
    at lr 1e-3 and the spectral projection, and take one step beside 13f's
    CLI: its loss within 1e-4 relative, grad_norm 1e-4, the parameters
    (gathered whole) within 2e-6, the BatchNorm statistics within 1e-5 of
    ``max(1, |value|)``, and its control, the one-process step with the
    split kernels' gradient dropped, at least 2e-5 from the one-process
    step.  Then they build it in fp32 and in bf16 (compute and BatchNorm
    apply) with the production optimizer (Adamax and the spectral
    projection) at lr 1e-5; once 13f is done, alone on the card, they take
    2 fp32 steps and 1 bf16 step: the fp32 loss and grad_norm as above,
    the parameters within 3 lr a step, the statistics after the first
    step; the bf16 step no farther from the one-process fp32 step than 2x
    the one-process bf16 step.  Each step on 72 rows a data index of 13f's
    batches under deterministic cuDNN, against the one-process step from
    the same start; every rank's metrics equal, no tensor differing across
    the ranks that hold it alike, exactly 14 of each of #2-#4 a step on
    each rank in the run's dtype; the ms a step beside phase 5's
    one-process steps, at-rest and peak MB a rank.

The last three lines of standard output are the card's name and power limit
(``nvidia-smi``), one JSON object ``{"kernels": [...]}``, and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.

``python3 chip_smoke.py --kernel-times ROOT`` only builds and times kernels
#1-#5 (and the bf16 instances, where the tree has them) of the tree at ROOT
(phase 9's kernel timing), printing one JSON line; run it on two trees in
one call to compare two versions on one card.
"""

from __future__ import annotations

import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 144
# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
L2_BYTES = 50e6
SMS = 132
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
# Other batch sizes the main paths give the forward kernel (#2): the CLI's
# sample mode draws its 4-temperature sweep of BATCH in one call of 4 x
# BATCH rows, the trainer's sample hook 4 x 3 rows and its reconstruction 3;
# --mode test draws each precision/recall half of a test batch in one call
# of BATCH // 2 rows; the B=4 training step and NLL set against the CPU.
# The backward kernels run at BATCH, in that step at 4, and at BATCH // 2 on
# each of the two ranks of phase 12's data-parallel steps (whose forwards
# and sample calls also run BATCH // 2 rows).
FWD_BATCHES = (BATCH, 4 * BATCH, BATCH // 2, 12, 4, 3)
BWD_BATCHES = (BATCH, BATCH // 2, 4)
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
DW_KERNEL_NAMES = ("fused_swish_depthwise5x5", "depthwise_conv5x5",
                   "fused_swish_depthwise5x5_dx", "fused_swish_depthwise5x5_dw",
                   "fused_swish_depthwise5x5_bf16",
                   "fused_swish_depthwise5x5_dx_bf16",
                   "fused_swish_depthwise5x5_dw_bf16")
# The training path's kernels (#2, #3, #4), fp32 and bf16 instances.
TRAIN_KERNELS = {
    "float32": ("fused_swish_depthwise5x5", "fused_swish_depthwise5x5_dx",
                "fused_swish_depthwise5x5_dw"),
    "bfloat16": ("fused_swish_depthwise5x5_bf16",
                 "fused_swish_depthwise5x5_dx_bf16",
                 "fused_swish_depthwise5x5_dw_bf16"),
}
KERNEL_NAMES = DW_KERNEL_NAMES + ("se_gate",)
# The C entries' kernel kinds (``nvae_dw5x5_bf16_blocks_per_sm``).
BF16_KIND_INDEX = {"fwd": 0, "dx": 1, "dw": 2}
# (H = W, C, hidden) of the model's squeeze-excitation blocks (kernel #5),
# at batch BATCH; then (B, H, W, C, hidden): JAX's test shape; H * W = 63
# and 25, not multiples of the cluster size; C % 4 != 0 at 32x32 (the
# 4-byte copies); batch 1; and the most channels a block takes at 8x8 with
# hidden 4 (SE_MAX_C + 1 is refused).
SE_SHAPES = [(4, 256, 16), (8, 128, 8), (16, 64, 4), (32, 32, 4)]
SE_MAX_C = 2896
SE_EXTRA_SHAPES = [(4, 8, 8, 128, 8), (3, 7, 9, 40, 4), (2, 5, 5, 64, 4),
                   (2, 32, 32, 5, 4), (1, 16, 16, 64, 4),
                   (1, 8, 8, SE_MAX_C, 4)]
SE_ATOL = 1e-5  # tests/test_kernels.py's limit
# The shapes tools/bench_dw_kernel.py times kernel #2 at (no bias).
TOOL_SHAPES = [(32, 192), (16, 192), (4, 1536)]
# The training entry point: --debug truncates to 4 train and 4 test batches.
CLI_EPOCHS = 2
CLI_BATCHES = 4
# The scan path (phase 5b): MNIST's training set of uint8 rows staged on the
# card, two epochs of 5 steps (the first step eager, the second captured).
SCAN_ROWS = 60_000
SCAN_STEPS_PER_EPOCH = 5
SCAN_EPOCHS = 2
SCAN_CHECK_STEPS = 3  # graph vs eager: one eager, one captured, one more
SAMPLE_TEMPERATURES = ("0.7", "0.8", "0.9", "1.0")
# IWAE NLL: K attempts over NLL_BATCHES test batches at full width; one B=4
# NLL card vs CPU at rtol 1e-4, each side also held to a float64 CPU run.
NLL_ATTEMPTS = 10
NLL_BATCHES = 2
NLL_RTOL = 1e-4
# Kernel #2's bf16 instance: the batches the serving paths give it (the
# server's --serve_batches 144 576; the sampler matrix's CPU check at 8).
# Its limits against the plain version are BF16_SUM_ULPS and
# BF16_MIN_EQUAL_SHARE in nvae_torch/kernels/depthwise.py.
BF16_BATCHES = (BATCH, 4 * BATCH, 8)
BF16_FLOP_PER_S = 989e12  # tensor cores, dense: the library call's rate
# The sampler matrix: (serve_dtype, compute dtype) at full width, B=BATCH.
# "bfloat16" compute sets compute_dtype and bn_apply_dtype.  Card against
# CPU at MATRIX_CPU_BATCH rows: a full-width model on the host's cores takes
# seconds a call in fp32 and more in bf16, so 8 rows, with injected noise.
MATRIX = (("float32", "float32"), ("bfloat16", "float32"),
          ("int8", "float32"), ("bfloat16", "bfloat16"),
          ("int8", "bfloat16"))
MATRIX_CPU_BATCH = 8
MATRIX_CALLS = 10  # timed calls per row, each ending in a sync
BF16_PROB_ATOL = 3e-2
# The HTTP phase: --mode serve over the CLI's checkpoint, under the load of
# the repo's serving benchmark (tools/bench_serving_http.py, its defaults):
# SERVE_CLIENTS clients, each on one persistent connection sending requests
# back to back, n drawn uniformly from [1, SERVE_MAX_N] and the temperature
# from SERVE_TEMPERATURES, a SERVE_MAX_DELAY_MS batching window, one second
# of warm-up, then a timed window of SERVE_SECONDS (the benchmark's 20 s
# cut to a quarter to hold this script's run time).
SERVE_BATCHES = (BATCH, 4 * BATCH)
SERVE_CLIENTS = 32
SERVE_MAX_N = 16
SERVE_TEMPERATURES = (0.6, 0.7, 0.8, 0.9, 1.0)
SERVE_MAX_DELAY_MS = 10
SERVE_WARMUP_S = 1.0
SERVE_SECONDS = 5.0
SERVER_FLAGS = []  # further flags of the artifact server
# The metric suite (phase 8b): --mode test over the CLI phase's checkpoint,
# reduced to --debug (4 test batches of BATCH), EVAL_ATTEMPTS attempts and
# EVAL_FID_SAMPLES (7 sample calls a temperature at 144 and at phase
# 11's 128; the default is 10,000)
# at the default temperatures and backbones; then the
# reference's protocol (--eval_parity) at one temperature, one attempt and
# PARITY_FID_SAMPLES.  In process: the backbones card vs CPU on
# FEATURE_IMAGES images (relative L2 FEATURE_RTOL), P&R at PR_ROWS x PR_ROWS
# x PR_DIM full against streamed (PR_ROW_BATCH; the same products on the
# same card, so no membership may flip) and card against CPU at PR_CPU_ROWS
# (within PR_CPU_FLIPS memberships: cuBLAS and the CPU's BLAS sum the
# distances in other orders), the fp32 device FID against the fp64 host FID
# on FID_ROWS x FID_DIM features.  FID_DEVICE_RTOL lies between two
# readings on an H100 (80GB HBM3, 700 W): the fp32 path 5.1e-7 from the
# host, the same path with TF32 allowed 2.3e-4; each run repeats that
# control and fails unless it lands outside the limit.
EVAL_ATTEMPTS = 1  # one: the whole run must end within 1200 s
EVAL_FID_SAMPLES = 1008  # cut from 2,016: the whole run must end in 1200 s
PARITY_FID_SAMPLES = 1440
EVAL_TEMPERATURES = 3
FEATURE_IMAGES = 4
FEATURE_RTOL = 1e-4
PR_ROWS = 10_000
PR_DIM = 512
PR_ROW_BATCH = 2_500
PR_CPU_ROWS = 2_000
PR_CPU_FLIPS = 3
PR_STREAM_FLIPS = 0
PR_TIMED = 3
FID_ROWS = 10_000
FID_DIM = 2048
FID_DEVICE_RTOL = 1e-5
FP32_FLOP_PER_S = 67e12  # outside the tensor cores: the P&R products
FID_NOISE_PNGS = 144
FID_CLI_RTOL = 1e-4  # printed to 6 digits; sqrtm against two eigh in fp64
FID_CLI_FLAGS = []  # further flags of python -m nvae_torch.eval.fid

# The RGB presets (phase 11): (H, C, bias, calls per forward in the
# preset's own postprocess form, in the depthwise one) of kernels #2-#4 on
# each one's path, the decoder's generative cells (a bias each) and the
# depthwise postprocess (none).  Their training batch is the preset's (128,
# 64); RGB_STEPS steps per form; samplers and the server at
# RGB_SAMPLE_BATCH; remat against no remat at REMAT_BATCH on the card
# under deterministic cuDNN, within REMAT_RTOL (loss, gradient's relative
# L2, BatchNorm statistics); the scan path 2 epochs of RGB_SCAN_STEPS;
# kernel timing over RGB_TIMING_ITERS calls.
RGB_SHAPES = {
    "cifar10_dml": [(4, 2304, True, 30, 30), (8, 1152, True, 16, 16),
                    (16, 576, False, 0, 3), (32, 288, False, 0, 3)],
    "celeba64": [(4, 4608, True, 30, 30), (8, 2304, True, 16, 16),
                 (16, 1152, True, 8, 8), (32, 576, False, 0, 3),
                 (64, 288, False, 0, 3)],
}
RGB_STEPS = 2  # two a form: the whole run must end within 1200 s
RGB_SAMPLE_BATCH = BATCH
# The B=4 step and NLL card vs CPU (phase 5's and 8's limits) run at the
# preset's full width with its depth cut to these groups per scale.  At
# its own depth, (8, 16), the first step from seeded weights is
# ill-conditioned (the steps' logged grad_norm is ~1e13): the CPU's own
# fp32 step lies as far from the float64 step as the card's does, so no
# fp32 limit can hold there.
RGB_CPU_GROUPS = (2, 4)
# There phase 5's limits hold but one: the card's fp32 gradient lies 1.6
# times as far from float64 as the CPU's (2.4e-4 against 1.5e-4 relative
# L2, both 12 times inside GRAD_REL_L2; cuDNN's convolution algorithms at
# these widths, TF32 off), against phase 5's 1.5.
RGB_CARD_VS_CPU_ROUNDING = 2.0
REMAT_BATCH = 4
REMAT_RTOL = 1e-6
RGB_SCAN_STEPS = 3
# The depthwise forms on the scan path: RGB_DW_SCAN_STEPS steps eagerly and
# as graph replays (the first step eager, the second captured) under
# deterministic cuDNN, bit for bit.
RGB_DW_SCAN_STEPS = 2
# The bf16 form of cifar10_dml (compute and BatchNorm apply bf16): the B=4
# step card vs CPU at RGB_CPU_GROUPS from DML_WARM_STEPS Adamax steps at
# the preset's batch holds the loss within BF16_LOSS_RTOL, the gradient
# and the BatchNorm statistics no further from float64 than
# CARD_VS_CPU_ROUNDING times the CPU's (``check_bf16_dml_step``); the B=4
# IWAE NLL card vs CPU in bf16 within BF16_NLL_RTOL, or the card no
# further from float64 than RGB_CARD_VS_CPU_ROUNDING times the CPU.  Both
# relative limits are the CPU tests' bf16 loss limit against JAX
# (``tests/test_torch_bf16_train.py``'s LOSS_RTOL).  From the seeded
# weights the bf16 gradient is chaotic: the CPU's lies 1.0 (relative L2)
# from float64 and the card's 2.76, 3.3 apart (the median leaf as far);
# after 10, 30 and 60 warm-up steps the card's lies 0.0218, 0.0209 and
# 0.0148 from float64 and the CPU's 0.0229, 0.0223 and 0.0144
# (``chip_dml_probe.py`` on an NVIDIA H100 80GB HBM3 at 700 W).  The warm
# start runs under deterministic cuDNN, the same state every run: from it
# the card's gradient lies 0.01285 and the CPU's 0.01279 from float64, the
# largest BatchNorm error 0.0172 and 0.0179 (``chip_dml_probe.py
# --warm-steps 30 30``, same card); with cuDNN's defaults the latter ratio
# moved between 0.89 and 1.74 from run to run.
DML_WARM_STEPS = 30
BF16_LOSS_RTOL = 5e-3
BF16_NLL_RTOL = 5e-3
RGB_BF16_BATCH = 4  # bf16 #2-#4 against their plain versions
BF16 = dict(compute_dtype="bfloat16", bn_apply_dtype="bfloat16")
RGB_TIMING_ITERS = 20


T_IMPORT = time.monotonic()


def log(msg: str) -> None:
    """One line of the run's log, with its seconds since the start."""
    print(f"[chip_smoke {time.monotonic() - T_IMPORT:7.1f} s] {msg}",
          flush=True)


def configs():
    from nvae_torch.config import ModelConfig

    return {
        "default": ModelConfig(use_pallas_kernels=True),
        "depthwise": ModelConfig(use_pallas_kernels=True,
                                 postprocess_5x5_depthwise=True),
    }


def bf16_configs():
    """The bf16 training configurations: bf16 compute with bf16 BatchNorm
    apply (default and depthwise; bench.py's ladder rung 2 is the depthwise
    one), and bf16 compute with fp32 BatchNorm apply (default)."""
    import dataclasses

    bf = dict(compute_dtype="bfloat16", bn_apply_dtype="bfloat16")
    cfgs = configs()
    return {
        "default bf16": dataclasses.replace(cfgs["default"], **bf),
        "depthwise bf16": dataclasses.replace(cfgs["depthwise"], **bf),
        "default bf16 fp32-BN": dataclasses.replace(
            cfgs["default"], compute_dtype="bfloat16"),
    }


def expected_launches(cfg) -> int:
    """Fused-kernel launches of one ``sample`` call: one per generative
    cell, plus one per postprocess node in the depthwise form."""
    cells = (cfg.n_total_groups - 1) * cfg.res_cells_per_group
    post = cfg.n_postprocess_blocks * cfg.n_postprocess_cells
    return cells + (post if cfg.postprocess_5x5_depthwise else 0)


def counters() -> dict:
    """Each kernel's wrapper, which counts its launches in ``launches``."""
    from nvae_torch.kernels import depthwise as dw
    from nvae_torch.kernels.se_gate import se_gate

    return {**{name: getattr(dw, name) for name in DW_KERNEL_NAMES},
            "se_gate": se_gate}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


# ---- phase 1 ----------------------------------------------------------------


def ptxas_entries(text: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes, static
    shared bytes) of each entry in ``nvcc -Xptxas -v`` output."""
    entries = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entries.append([m.group(1), 0, 0, 0, 0])
        elif entries and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            entries[-1][2:4] = [int(m.group(1)), int(m.group(2))]
        elif entries and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            entries[-1][1] = int(regs.group(1))
            entries[-1][4] = int(smem.group(1)) if smem else 0
    if shutil.which("c++filt") and entries:
        names = subprocess.run(["c++filt"], input="\n".join(
            e[0] for e in entries), capture_output=True, text=True,
            check=True, timeout=60).stdout.splitlines()
        for e, name in zip(entries, names):
            e[0] = name.replace("(anonymous namespace)::", "")
    return entries


def phase_build():
    from nvae_torch.kernels import _build
    from nvae_torch.kernels import depthwise as dw
    from nvae_torch.kernels import se_gate as se

    t0 = time.monotonic()
    logs = _build.build()
    log(f"build: {sorted(logs)} in {time.monotonic() - t0:.1f} s")
    for name, text in logs.items():
        for kernel, regs, st, ld, smem in ptxas_entries(text):
            log(f"  {name}: {kernel}: {regs} registers, spills {st} B "
                f"stored / {ld} B loaded, {smem} B static shared")
    # The depthwise kernels' dynamic shared memory and schedule at each path
    # shape: the row ring (fp32 #1-#4) and the sliding-row kernel (bf16 #2,
    # #3 and #4), with its blocks an SM as the card reports them.
    for h, c, _, _, _ in PATH_SHAPES:
        for kind, dtype in ((k, d) for d in ("float32", "bfloat16")
                            for k in ("fwd", "dx", "dw")):
            g = dw.geometry(kind, (BATCH, h, h, c), dtype)
            sliding = dtype == "bfloat16"
            extra = ""
            if sliding:
                per_sm = dw._lib().nvae_dw5x5_bf16_blocks_per_sm(
                    BF16_KIND_INDEX[kind], g.threads, g.smem_bytes, 0)
                extra = (f", {g.threads} threads ({g.chunks_per_block} "
                         f"chunks) a block, {per_sm} blocks an SM")
            log(f"  {'sliding' if sliding else 'ring'} {kind} {dtype} "
                f"{BATCH}x{h}x{h}x{c}: {g.smem_bytes} B dynamic shared, "
                f"{g.blocks} blocks ({g.blocks_per_chunk} per chunk group), "
                f"{g.slots_per_pass} rows per pass, {g.ahead} passes "
                f"ahead{extra}")
    # The gate's clusters at each SE shape, and how many the card holds at
    # once against the rows that need one each.
    for h, c, hd in SE_SHAPES:
        g = se.geometry(BATCH, h * h, c, hd)
        log(f"  se_gate {BATCH}x{h}x{h}x{c} (hidden {hd}): clusters of "
            f"{g.cluster} blocks of {g.threads} threads, {g.blocks} blocks "
            f"({g.blocks / SMS:.2f} per SM), {g.smem_bytes} B dynamic shared, "
            f"pixels per block {len(g.pixels(0))}-{len(g.pixels(g.cluster - 1))}"
            f"; resident clusters {se.max_active_clusters(g)} for {BATCH} rows")


# ---- phase 2 ----------------------------------------------------------------


def path_inputs(h, c, bias, device, seed=0, batch=BATCH):
    """x (B, H, H, C), taps as DepthwiseConv passes them (a (5, 5, 1, C)
    view of a channels_last (C, 1, 5, 5) weight), bias or None."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(batch, h, h, c, generator=gen, device=device)
    w = 0.2 * torch.randn(c, 1, 5, 5, generator=gen, device=device)
    k = w.contiguous(memory_format=torch.channels_last).permute(2, 3, 1, 0)
    b = torch.randn(c, generator=gen, device=device) * 0.1 if bias else None
    return x, k, b


def phase_kernels(device, shapes=PATH_SHAPES, batches=FWD_BATCHES) -> dict:
    """Max abs error of each forward kernel against its plain version at
    every path shape and every batch in ``batches``; per shape, the worst
    over the batches."""
    from nvae_torch.kernels import depthwise as dw

    errs = {"fused_swish_depthwise5x5": {}, "depthwise_conv5x5": {}}
    for h, c, bias, _, _ in shapes:
        for n in batches:
            x, k, b = path_inputs(h, c, bias, device, batch=n)
            got = dw.fused_swish_depthwise5x5(x, k, b, fuse_swish=True)
            want = dw.fused_swish_depthwise5x5_plain(x, k, b, fuse_swish=True)
            thin = dw.depthwise_conv5x5(x, k.contiguous())
            thin_want = dw.fused_swish_depthwise5x5_plain(x, k, None,
                                                          fuse_swish=False)
            torch.cuda.synchronize(device)
            for name, a, r in (("fused_swish_depthwise5x5", got, want),
                               ("depthwise_conv5x5", thin, thin_want)):
                err = float((a - r).abs().max())
                errs[name][(h, c)] = max(err, errs[name].get((h, c), 0.0))
                log(f"kernel {name} {n}x{h}x{h}x{c}: max abs err {err:.3g} "
                    f"(atol {KERNEL_ATOL})")
    return errs


def phase_backward_kernels(device, shapes=PATH_SHAPES,
                           batches=BWD_BATCHES) -> dict:
    """dx (with swish' and without) and dW/db (with and without bias)
    against their plain versions at every path shape and every batch in
    ``batches``; dW/db twice, for bitwise repeatability.  Returns the
    errors per kernel and shape, the worst over the batches."""
    from nvae_torch.kernels import depthwise as dw

    errs = {"fused_swish_depthwise5x5_dx": {},
            "fused_swish_depthwise5x5_dw": {}}
    for (h, c, _, _, _), n in ((s, n) for s in shapes for n in batches):
        x, k, _ = path_inputs(h, c, False, device, batch=n)
        g = path_inputs(h, c, False, device, seed=1, batch=n)[0]
        dx_err = 0.0
        for fuse in (True, False):
            got = dw.fused_swish_depthwise5x5_dx(g, k, x if fuse else None,
                                                 fuse_swish=fuse)
            want = dw.fused_swish_depthwise5x5_dx_plain(g, k, x,
                                                        fuse_swish=fuse)
            dx_err = max(dx_err, float((got - want).abs().max()))
        errs["fused_swish_depthwise5x5_dx"][(h, c)] = max(
            dx_err, errs["fused_swish_depthwise5x5_dx"].get((h, c), 0.0))
        log(f"kernel dx {n}x{h}x{h}x{c}: max abs err {dx_err:.3g} "
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
            log(f"kernel dW/db {n}x{h}x{h}x{c} swish={fuse} bias={bias}: "
                f"max abs err {err:.3g}, max |dW| {scale:.4g} "
                f"(limit {DW_RTOL * scale:.3g}), bitwise repeatable")
            if not err <= DW_RTOL * scale:
                raise AssertionError(f"dW/db {h}x{c}: err {err} > "
                                     f"{DW_RTOL} x {scale}")
            worst = max(worst, err)
        errs["fused_swish_depthwise5x5_dw"][(h, c)] = max(
            worst, errs["fused_swish_depthwise5x5_dw"].get((h, c), 0.0))
    return errs


def phase_bf16_backward_kernels(device) -> dict:
    """The bf16 instances of #3 and #4 against their plain versions at every
    path shape and every batch in BWD_BATCHES.  dx (with swish' and without)
    within one bf16 ulp of the result plus ``BF16_SUM_ULPS`` fp32 ulps of
    ``|swish'(x)| * sum |dy * w|`` (``bf16_dx_scale``), at least
    ``BF16_MIN_EQUAL_SHARE`` bitwise equal, and bitwise across two runs;
    dW/db (with and without bias) within DW_RTOL of the largest |dW| on the
    fp32 sums, bitwise across two runs.  Returns per shape the worst of
    each, over the batches."""
    from nvae_torch.kernels import depthwise as dw

    out = {}
    for (h, c, _, _, _), n in ((s, n) for s in PATH_SHAPES
                               for n in BWD_BATCHES):
        x, k, _ = bf16_inputs(h, c, False, device, batch=n)
        g = bf16_inputs(h, c, False, device, seed=1, batch=n)[0]
        r = out.setdefault((h, c), {"err": 0.0, "sum_ulps": 0.0,
                                    "equal": 1.0, "dw_err": 0.0})
        for fuse in (True, False):
            got = dw.fused_swish_depthwise5x5_dx(g, k, x if fuse else None,
                                                 fuse_swish=fuse)
            again = dw.fused_swish_depthwise5x5_dx(
                g, k, x if fuse else None, fuse_swish=fuse)
            want = dw.fused_swish_depthwise5x5_dx_plain(g, k, x,
                                                        fuse_swish=fuse)
            torch.cuda.synchronize(device)
            if got.dtype != torch.bfloat16 or not torch.equal(got, again):
                raise AssertionError(f"bf16 #3 {n}x{h}x{c}: two runs differ")
            sum_ulps = float(dw.bf16_sum_ulps(got, want, dw.bf16_dx_scale(
                g, k, x, fuse_swish=fuse)).max())
            equal = float((bf16_ulps(got, want) == 0).float().mean())
            err = float((got.float() - want.float()).abs().max())
            log(f"kernel dx bf16 {n}x{h}x{h}x{c} swish'={fuse}: max abs err "
                f"{err:.3g}, {sum_ulps:.3g} fp32 ulps of |swish'(x)| sum "
                f"|dy w| past one bf16 ulp (limit {dw.BF16_SUM_ULPS}); "
                f"{100 * equal:.4f}% bitwise equal (limit "
                f"{100 * dw.BF16_MIN_EQUAL_SHARE}%); bitwise repeatable")
            if not (sum_ulps <= dw.BF16_SUM_ULPS
                    and equal >= dw.BF16_MIN_EQUAL_SHARE):
                raise AssertionError(f"bf16 #3 {n}x{h}x{c}: {sum_ulps} fp32 "
                                     f"ulps, {equal} equal")
            r["err"] = max(r["err"], err)
            r["sum_ulps"] = max(r["sum_ulps"], sum_ulps)
            r["equal"] = min(r["equal"], equal)
        for fuse, bias in ((True, True), (True, False), (False, True)):
            a = dw.fused_swish_depthwise5x5_dw(x, g, fuse_swish=fuse,
                                               with_bias=bias)
            b = dw.fused_swish_depthwise5x5_dw(x, g, fuse_swish=fuse,
                                               with_bias=bias)
            dk_want, db_want = dw.fused_swish_depthwise5x5_dw_plain(
                x, g, fuse_swish=fuse)
            torch.cuda.synchronize(device)
            if a[0].dtype != torch.float32 or not (torch.equal(a[0], b[0])
                                                   and (not bias or torch.equal(
                                                       a[1], b[1]))):
                raise AssertionError(f"bf16 #4 {h}x{c}: two runs differ")
            scale = float(dk_want.abs().max())
            err = float((a[0] - dk_want).abs().max())
            if bias:
                err = max(err, float((a[1] - db_want).abs().max()))
                scale = max(scale, float(db_want.abs().max()))
            log(f"kernel dW/db bf16 {n}x{h}x{h}x{c} swish={fuse} bias={bias}"
                f": max abs err {err:.3g}, max |dW| {scale:.4g} (limit "
                f"{DW_RTOL * scale:.3g}), bitwise repeatable")
            if not err <= DW_RTOL * scale:
                raise AssertionError(f"bf16 #4 {h}x{c}: err {err} > "
                                     f"{DW_RTOL} x {scale}")
            r["dw_err"] = max(r["dw_err"], err)
    return out


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
    gpu = sampler.apply(lambda m: logits(m, 4, t.to(device), eps)).cpu()
    with torch.inference_mode():
        cpu = logits(cpu_model, 4, t, eps)
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


def logits(model, n, t, eps):
    """The likelihood head's logits of a prior pass with injected noise."""
    feats, *_ = model.decoder.generate(n, t, eps=eps)
    return model.postprocess(feats)


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


def train_batch(n: int, seed: int, cfg=None) -> torch.Tensor:
    """Synthetic images from a numpy seed: binarized (n, 32, 32, 1), or for
    an RGB ``cfg`` each channel on its 256 levels at the config's size."""
    rng = np.random.RandomState(seed)
    if cfg is None or cfg.in_channels == 1:
        return torch.from_numpy(
            (rng.rand(n, 32, 32, 1) > 0.5).astype(np.float32))
    s = cfg.image_size
    return torch.from_numpy(
        (rng.randint(0, 256, (n, s, s, 3)) / 255.0).astype(np.float32))


def train_setup(cfg, device, batch: int, mesh=None):
    """Seed-0 weights, Adamax + spectral projection, and the train step;
    over a data ``mesh`` the state replicated from rank 0 and the
    data-parallel step (``batch`` is then the global batch)."""
    from nvae_torch.config import TrainConfig
    from nvae_torch.parallel import shard_state
    from nvae_torch.train.state import create_train_state
    from nvae_torch.train.step import make_train_step

    tc = TrainConfig(batch_size=batch, step_based_warmup=True)
    model, state, tx = create_train_state(cfg, tc, total_steps=1000,
                                          device=device, seed=0)
    if mesh is not None:
        state = shard_state(state, mesh)
    return state, make_train_step(model, tx, tc, 1000, 100, mesh=mesh)


def phase_train(cfg, device, batch=BATCH, steps=TRAIN_STEPS) -> dict:
    """The training path: ``steps`` full-width steps at ``batch``, with the
    counts set to 0 just before and read just after.  Returns the counts,
    the metrics of every step, ms per step and peak memory."""
    state, step = train_setup(cfg, device, batch)
    batches = [train_batch(batch, 10 + i, cfg).to(device)
               for i in range(steps)]
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


def one_step_grads(cfg, device, batch, eps, float64=False, weights=None):
    """One training step at batch 4 from seed-0 weights (or the state dict
    ``weights``) with injected noise; the optimizer records the gradients
    and leaves the parameters alone.  Returns (metrics, gradients,
    BatchNorm running statistics), on the CPU in float64.  ``float64`` runs
    a float64 copy of the model (CPU only)."""
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
    if weights is not None:
        model.load_state_dict(weights)
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
    the BatchNorm running statistics (|error| over max(1, |value|), and
    all of them together in relative L2); and the median parameter's
    gradient (relative L2), the typical leaf."""
    (m_a, g_a, s_a), (m_b, g_b, s_b) = got, want
    norm = math.sqrt(sum(float((g ** 2).sum()) for g in g_b.values()))
    num = math.sqrt(sum(float(((g_a[k] - g_b[k]) ** 2).sum()) for k in g_b))
    leaves = sorted((float((g_a[k] - g_b[k]).norm() / g_b[k].norm()), k)
                    for k in g_b if float(g_b[k].norm()) > 1e-12 * norm)
    leaf = leaves[-1]
    bn = max(float(((s_a[k] - s_b[k]).abs() / s_b[k].abs().clamp(min=1.0))
                   .max()) for k in s_b)
    bn_l2 = math.sqrt(sum(float(((s_a[k] - s_b[k]) ** 2).sum()) for k in s_b)
                      / sum(float((s_b[k] ** 2).sum()) for k in s_b))
    return {
        "loss_rel": abs(m_a["loss"] - m_b["loss"]) / abs(m_b["loss"]),
        "grad_rel_l2": num / norm,
        "worst_leaf_rel_l2": leaf[0], "worst_leaf": leaf[1],
        "median_leaf_rel_l2": leaves[len(leaves) // 2][0],
        "bn_stats_err": bn, "bn_stats_rel_l2": bn_l2,
    }


def check_train_vs_cpu(name: str, rec: dict,
                       rounding: float = CARD_VS_CPU_ROUNDING) -> None:
    """The B=4 step's card vs CPU fp32 and float64 limits (fp32 part); the
    card's gradient no further from float64 than ``rounding`` times the
    CPU's."""
    for pair, r in rec.items():
        log(f"train step {name} {pair}: {r}")
    vs_cpu, vs_f64 = rec["card_vs_cpu"], rec["card_vs_f64"]
    cpu_rounding = rec["cpu_vs_f64"]["grad_rel_l2"]
    if (vs_cpu["loss_rel"] > TRAIN_LOSS_RTOL
            or vs_cpu["grad_rel_l2"] > GRAD_REL_L2
            or vs_f64["grad_rel_l2"] > rounding * cpu_rounding
            or vs_f64["worst_leaf_rel_l2"] > LEAF_REL_L2
            or vs_cpu["bn_stats_err"] > BN_STATS_ATOL
            or vs_f64["bn_stats_err"] > BN_STATS_F64_ATOL):
        raise AssertionError(f"train {name}: card vs CPU {rec}")


def checked_kernel_errors(device, shapes, fwd_batches, bwd_batches) -> dict:
    """#1 and #2 (phase_kernels) and #3 and #4 (phase_backward_kernels)
    at ``shapes``, each forward and dx held to KERNEL_ATOL (dW/db is held
    inside); the worst error per kernel and (H, C)."""
    errs = phase_kernels(device, shapes, fwd_batches)
    for name, per_shape in errs.items():
        worst = max(per_shape.values())
        if not worst <= KERNEL_ATOL:
            raise AssertionError(
                f"{name}: max abs err {worst} > {KERNEL_ATOL}")
    bwd_errs = phase_backward_kernels(device, shapes, bwd_batches)
    worst = max(bwd_errs["fused_swish_depthwise5x5_dx"].values())
    if not worst <= KERNEL_ATOL:
        raise AssertionError(f"dx: max abs err {worst} > {KERNEL_ATOL}")
    errs.update(bwd_errs)
    return errs


def train_vs_cpu_inputs(cfg) -> tuple:
    """The B=4 step's batch and injected noise (``phase_train_vs_cpu``)."""
    from nvae_torch.models.nvae import posterior_noise_shapes

    batch = train_batch(4, 3, cfg)
    rng = np.random.RandomState(4)
    eps = [[rng.randn(*s).astype(np.float32)
            for s in posterior_noise_shapes(cfg, 4)]]
    return batch, eps


def cpu_step_refs(cfg, bf16_cfg=None, start=None) -> dict:
    """The CPU side of ``phase_train_vs_cpu``: the B=4 step on the CPU in
    float32 (``cpu``) and in float64 (``f64``) from seed-0 weights; with
    ``bf16_cfg`` also that step on the CPU (``cpu16``, the kernels' plain
    versions) and, from the state dict ``start`` if given (or from the file
    it names, once it is there), the float64 step from there
    (``f64_start``)."""
    batch, eps = train_vs_cpu_inputs(cfg)
    out = {"cpu": one_step_grads(cfg, "cpu", batch, eps),
           "f64": one_step_grads(cfg, "cpu", batch, eps, float64=True)}
    if bf16_cfg is None:
        return out
    if isinstance(start, str):
        start = HostRefs.wait_load(start)
    if start is not None:
        out["f64_start"] = one_step_grads(cfg, "cpu", batch, eps,
                                          float64=True, weights=start)
    t0 = time.monotonic()
    out["cpu16"] = one_step_grads(bf16_cfg, "cpu", batch, eps,
                                  weights=start)
    out["cpu16_seconds"] = time.monotonic() - t0
    return out


def train_vs_cpu_card(cfg, device, bf16_cfg=None, bf16_start=None) -> tuple:
    """The card's side of ``phase_train_vs_cpu``: the fp32 step from seed-0
    weights and, with ``bf16_cfg``, the bf16 step (from ``bf16_start`` if
    given) with its exact launches."""
    batch, eps = train_vs_cpu_inputs(cfg)
    card = one_step_grads(cfg, device, batch, eps)
    card16 = None
    if bf16_cfg is not None:
        reset_counts()
        card16 = one_step_grads(bf16_cfg, device, batch, eps,
                                weights=bf16_start)
        counts = read_counts()
        want = expected_launches(bf16_cfg)
        for k in KERNEL_NAMES:
            if counts[k] != (want if k in TRAIN_KERNELS["bfloat16"] else 0):
                raise AssertionError(f"bf16 B=4 step: launches {counts}")
    return card, card16


def train_vs_cpu_record(card, card16, host: dict) -> dict:
    """``phase_train_vs_cpu``'s distances from the card's steps and the
    CPU's (``cpu_step_refs``' record)."""
    cpu, ref = host["cpu"], host["f64"]
    out = {"card_vs_cpu": grad_errors(card, cpu),
           "card_vs_f64": grad_errors(card, ref),
           "cpu_vs_f64": grad_errors(cpu, ref)}
    if card16 is not None:
        ref = host.get("f64_start", ref)
        cpu16 = host["cpu16"]
        out["bf16_cpu_seconds"] = host["cpu16_seconds"]
        out.update({"bf16_card_vs_cpu": grad_errors(card16, cpu16),
                    "bf16_card_vs_f64": grad_errors(card16, ref),
                    "bf16_cpu_vs_f64": grad_errors(cpu16, ref)})
    return out


def phase_train_vs_cpu(cfg, device, refs, bf16_cfg=None,
                       bf16_start=None) -> dict:
    """One full-width training step at batch 4 on the card, on the CPU in
    float32, and on the CPU in float64 (the reference that tells rounding
    from fault), from the same weights and injected noise.  With
    ``bf16_cfg`` (``cfg`` in bf16 compute) also that step on the card and
    on the CPU (the kernels' plain versions), each held to the same float64
    step; from the state dict ``bf16_start`` if given (and then the float64
    step from there too).  ``refs()`` returns the CPU side
    (``cpu_step_refs``' record, from the helper process)."""
    card, card16 = train_vs_cpu_card(cfg, device, bf16_cfg, bf16_start)
    return train_vs_cpu_record(card, card16, refs())


class HostRefs:
    """The CPU references of the card-vs-CPU checks, computed by a helper
    process (``chip_smoke.py --host-refs DIR``) while this one goes on with
    the card: seconds of float32 and float64 work on the host each, off
    the run's critical path.  ``add`` names a job (a function of this
    module and its keyword arguments), ``start`` starts the helper, which
    runs the jobs in order and writes each result to ``DIR/<name>.pt``;
    ``put`` hands it an input made later (a job waits for its file);
    ``ref(name)`` returns a function that waits for a result."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="nvae_chip_smoke_host_")
        self.jobs, self.proc, self.log = [], None, None

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name.replace(" ", "_") + ".pt")

    def add(self, name: str, fn, **kwargs) -> None:
        self.jobs.append((name, fn.__name__, kwargs))

    def gate(self, name: str) -> None:
        """The later jobs wait until ``open_gate(name)``."""
        self.jobs.append((name, "host_gate",
                          {"path": self.path(f"{name} open")}))

    def open_gate(self, name: str) -> None:
        self.put(f"{name} open", True)

    def start(self) -> None:
        torch.save(self.jobs, os.path.join(self.dir, "jobs.pt"))
        self.log = open(os.path.join(self.dir, "host_refs.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--host-refs", self.dir], cwd=self.dir, env=port_env(),
            stdout=self.log, stderr=subprocess.STDOUT)

    def put(self, name: str, obj) -> None:
        path = self.path(name)
        torch.save(obj, path + ".tmp")
        os.replace(path + ".tmp", path)

    @staticmethod
    def wait_load(path: str, proc=None, timeout: float = 1200.0):
        t0 = time.monotonic()
        while not os.path.exists(path):
            if proc is not None and proc.poll() is not None:
                raise AssertionError(f"host references: the helper exited "
                                     f"{proc.returncode} before {path}")
            if time.monotonic() - t0 > timeout:
                raise AssertionError(f"host references: no {path} in "
                                     f"{timeout} s")
            time.sleep(0.1)
        return torch.load(path, weights_only=False)

    def ref(self, name: str):
        def wait():
            t0 = time.monotonic()
            try:
                out = self.wait_load(self.path(name), self.proc)
            except AssertionError:
                self.log.flush()
                with open(self.log.name) as f:
                    raise AssertionError(f"host references: {name}:\n"
                                         f"{f.read()[-4000:]}")
            log(f"host reference {name}: waited "
                f"{time.monotonic() - t0:.1f} s")
            return out
        return wait

    def close(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self.log is not None:
            # To standard error: the run's result lines end its output.
            self.log.close()
            with open(self.log.name) as f:
                for line in f.read().splitlines()[-40:]:
                    print(f"[chip_smoke] host references: {line}",
                          file=sys.stderr, flush=True)
        shutil.rmtree(self.dir, ignore_errors=True)


def host_gate(path: str) -> bool:
    """A helper's job that waits for ``HostRefs.open``."""
    return HostRefs.wait_load(path)


def host_refs(workdir: str) -> int:
    """The helper of ``HostRefs`` (``chip_smoke.py --host-refs DIR``): runs
    DIR's jobs in order on the CPU, each result to its file, at a lower
    priority than the run's own processes (``os.nice``: the host's cores
    drive the card first)."""
    os.nice(10)
    sys.path.insert(0, ROOT)
    jobs = torch.load(os.path.join(workdir, "jobs.pt"), weights_only=False)
    for name, fn, kwargs in jobs:
        t0 = time.monotonic()
        out = globals()[fn](**kwargs)
        path = os.path.join(workdir, name.replace(" ", "_") + ".pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
        print(f"{name}: {time.monotonic() - t0:.1f} s, done at "
              f"{time.monotonic() - T_IMPORT:.1f} s", flush=True)
    return 0


# ---- phase 5b: the device-resident epoch (--scan_epochs) --------------------


def scan_configs():
    """The scan path's configurations: fp32 default and depthwise, and the
    depthwise one in bf16 (the JAX package's flagship ``--scan_epochs``
    dtypes)."""
    return {**configs(),
            "depthwise bf16": bf16_configs()["depthwise bf16"]}


def scan_data(device) -> torch.Tensor:
    """SCAN_ROWS uint8 28x28 rows (MNIST's 47 MB) on the card: synthetic
    digits (``nvae_torch.data.synthetic_dataset``, 2,048 of them) drawn
    with a numpy seed."""
    from nvae_torch.data import synthetic_dataset
    from nvae_torch.train.epoch_runner import stage_dataset

    digits = synthetic_dataset(n_train=2048, n_test=16, seed=5).train_x
    rows = np.random.RandomState(6).randint(0, len(digits), SCAN_ROWS)
    return stage_dataset(digits[rows], device)


def replayed_counts() -> dict:
    """Each depthwise wrapper's ``replayed``: the launches graph replays
    made (captured launches x replays)."""
    from nvae_torch.kernels import depthwise as dw

    return {fn.__name__: fn.replayed for fn in dw.COUNTED}


def scan_train_config(cfg, batch: int):
    from nvae_torch.config import TrainConfig

    return TrainConfig(batch_size=batch, step_based_warmup=True,
                       binary=cfg.likelihood == "bernoulli")


def scan_start(cfg, device, batch: int):
    """The scan path's seed-0 ``(model, state, tx)`` (Adamax + spectral
    projection)."""
    from nvae_torch.train.state import create_train_state

    return create_train_state(cfg, scan_train_config(cfg, batch),
                              total_steps=1000, device=device, seed=0)


def scan_run(cfg, device, data, graph: bool, steps_per_epoch: int,
             epochs: int, batch: int = BATCH, mesh=None,
             fsdp: bool = False, start=None) -> dict:
    """``epochs`` epochs of ``steps_per_epoch`` full-width steps at
    ``batch`` through the epoch runner (Adamax + spectral projection,
    seed-0 weights; with ``fsdp`` its state in the FSDP layout over
    ``mesh``), as graph replays or eagerly, with the counts set to 0
    just before and read just after.  Returns the counts, each epoch's means
    and seconds, ms per step of the last epoch, the run's peak memory
    (over what was allocated before it began: its model, state, graph and
    activations), the final state on the host and the runner.  ``start``
    (``scan_start``'s ``(model, state, tx)``) replaces the seed-0 state."""
    from nvae_torch.train import checkpoint as ckpt
    from nvae_torch.train.epoch_runner import make_epoch_runner

    base = torch.cuda.memory_allocated(device)
    tc = scan_train_config(cfg, batch)
    model, state, tx = start or scan_start(cfg, device, batch)
    if fsdp:
        from nvae_torch.parallel import shard_state_fsdp

        state = shard_state_fsdp(state, mesh)
    run = make_epoch_runner(model, tx, tc, 1000, steps_per_epoch,
                            target_size=cfg.image_size, graph=graph,
                            mesh=mesh)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    before = replayed_counts()
    means, seconds = [], []
    for e in range(epochs):
        t0 = time.monotonic()
        state, m = run(state, data, e)  # ends in the epoch's fetch
        seconds.append(time.monotonic() - t0)
        means.append(m)
    counts = read_counts()
    replayed = {k: v - before[k] for k, v in replayed_counts().items()}
    flat = {k: v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v
            for k, v in ckpt.flatten_state(state).items()}
    return {"counts": counts, "replayed": replayed, "means": means,
            "epoch_seconds": seconds,
            "ms_per_step": 1e3 * seconds[-1] / steps_per_epoch,
            "peak_mem_gb": (torch.cuda.max_memory_allocated(device) - base)
            / 1e9, "steps": state.step, "flat": flat, "runner": run}


def state_diff(a: dict, b: dict) -> dict:
    """How two flat states differ: bitwise or not, and the largest
    difference over max(1, |value|) with its leaf."""
    worst, where, equal = 0.0, None, True
    for k, v in a.items():
        if not isinstance(v, torch.Tensor):
            equal &= v == b[k]
            continue
        if torch.equal(v, b[k]):
            continue
        equal = False
        d = float(((v.double() - b[k].double()).abs()
                   / v.double().abs().clamp(min=1.0)).max())
        if d > worst:
            worst, where = d, k
    return {"bitwise": bool(equal), "max_rel_diff": worst, "leaf": where}


class deterministic_cudnn:
    """``torch.backends.cudnn.deterministic`` on inside the block: cuDNN's
    default fp32 convolution backward algorithms sum with atomics, so two
    eager fp32 steps on the same inputs differ in their last bits."""

    def __enter__(self):
        self.was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.was


def phase_scan(cfg, device, data, repeat: bool) -> dict:
    """The scan path (a main path) in one configuration:

    - timed: SCAN_EPOCHS epochs of SCAN_STEPS_PER_EPOCH steps as graph
      replays (cuDNN's default algorithms): launch counts (the eager first
      step and the capture through the wrappers, the rest as replays), ms
      per step of the last epoch, peak memory;
    - check: SCAN_CHECK_STEPS steps as replays and the same steps eagerly,
      from the same seed, under ``deterministic_cudnn``: the two states
      and mean metrics compared;
    - repeat (with ``repeat``; run for the default configuration alone,
      to hold the run time): those steps eagerly
      twice with cuDNN's defaults, compared: whether the eager step itself
      is reproducible."""
    timed = scan_run(cfg, device, data, True, SCAN_STEPS_PER_EPOCH,
                     SCAN_EPOCHS)
    run = timed.pop("runner")
    del timed["flat"]
    out = {"timed": timed, "runner": run, "eager_steps": run.eager_steps,
           "replays": run.replays,
           "launches_per_replay": run.launches_per_replay}
    with deterministic_cudnn():
        eager = scan_run(cfg, device, data, False, SCAN_CHECK_STEPS, 1)
        graphed = scan_run(cfg, device, data, True, SCAN_CHECK_STEPS, 1)
    out["check"] = {"state": state_diff(graphed["flat"], eager["flat"]),
                    "means_equal": graphed["means"] == eager["means"],
                    "eager_peak_mem_gb": eager["peak_mem_gb"],
                    "graph_peak_mem_gb": graphed["peak_mem_gb"],
                    "eager_counts": eager["counts"],
                    "launches_per_replay":
                        graphed["runner"].launches_per_replay}
    del eager, graphed
    if repeat:
        a = scan_run(cfg, device, data, False, SCAN_CHECK_STEPS, 1)
        b = scan_run(cfg, device, data, False, SCAN_CHECK_STEPS, 1)
        out["repeat"] = {"state": state_diff(a["flat"], b["flat"]),
                         "means_equal": a["means"] == b["means"]}
    out["counts"] = {k: timed["counts"][k] + out["check"]["eager_counts"][k]
                     for k in KERNEL_NAMES}
    return out


def check_scan(name, cfg, rec) -> None:
    """The timed run: every step but the first (eager, on a side stream)
    replayed the graph captured at the second; a replay launches exactly
    14 / 20 of each of #2, #3 and #4 in the config's dtype and none of the
    other, and so does each eager step; finite means.  The check: graph
    and eager bit for bit equal."""
    n = expected_launches(cfg)
    steps = SCAN_EPOCHS * SCAN_STEPS_PER_EPOCH
    if (rec["eager_steps"], rec["replays"]) != (1, steps - 1):
        raise AssertionError(f"scan {name}: {rec['eager_steps']} eager "
                             f"steps, {rec['replays']} replays")
    timed, check = rec["timed"], rec["check"]
    for dtype, names in TRAIN_KERNELS.items():
        per = n if dtype == cfg.compute_dtype else 0
        for k in names:
            got = (rec["launches_per_replay"][k],
                   check["launches_per_replay"][k], timed["counts"][k],
                   timed["replayed"][k], check["eager_counts"][k])
            want = (per, per, 2 * per, per * (steps - 1),
                    per * SCAN_CHECK_STEPS)
            if got != want:
                raise AssertionError(
                    f"scan {name}: {k} per replay (timed, check) / timed "
                    f"run / replayed / eager check run {got}, expected "
                    f"{want}")
    if timed["steps"] != steps or not all(
            math.isfinite(v) for e in timed["means"] for v in e.values()):
        raise AssertionError(f"scan {name}: {timed['means']}")
    if not (check["state"]["bitwise"] and check["means_equal"]):
        raise AssertionError(f"scan {name}: graph vs eager {check}")


# ---- kernel #5: the squeeze-excitation gate ---------------------------------


def se_inputs(b, h, w, c, hd, device, seed=0):
    """x (B, H, W, C) and the gate's w1 (C, Hd), b1, w2 (Hd, C), b2."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=gen, device=device)
    weights = [0.1 * torch.randn(s, generator=gen, device=device)
               for s in ((c, hd), (hd,), (hd, c), (c,))]
    return (x, *weights)


def offset_copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied into a buffer one float longer, starting at its second
    float: contiguous, but 4 bytes off the 16-byte alignment."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    out = buf[1:].view_as(x)
    out.copy_(x)
    return out


def phase_se_gate(device) -> dict:
    """Kernel #5 against its plain version at the model's SE shapes (batch
    BATCH), then the SE_EXTRA_SHAPES, then the model's 8x8 shape with x 4
    bytes off alignment (the 4-byte copy path): atol SE_ATOL, bitwise
    across two runs.  An input that requires grad raises, and so does one
    channel more than SE_MAX_C.  Returns the errors per case."""
    from nvae_torch.device import fp32_math
    from nvae_torch.kernels.se_gate import se_gate, se_gate_reference

    errs = {}
    cases = [((BATCH, h, h, c, hd), False) for h, c, hd in SE_SHAPES]
    cases += [(shape, False) for shape in SE_EXTRA_SHAPES]
    cases.append(((BATCH, 8, 8, 128, 8), True))
    for shape, offset in cases:
        args = se_inputs(*shape, device)
        if offset:
            args = (offset_copy(args[0]), *args[1:])
        got, again = se_gate(*args), se_gate(*args)
        with fp32_math():
            want = se_gate_reference(*args)
        torch.cuda.synchronize(device)
        err = float((got - want).abs().max())
        label = f"{shape}{' x 4 bytes off alignment' if offset else ''}"
        log(f"kernel se_gate {label}: max abs err {err:.3g} (atol {SE_ATOL})"
            f", bitwise repeatable {torch.equal(got, again)}")
        if not torch.equal(got, again):
            raise AssertionError(f"se_gate {label}: two runs differ")
        if not err <= SE_ATOL:
            raise AssertionError(f"se_gate {label}: err {err} > {SE_ATOL}")
        errs[(*shape, offset)] = err
    x = args[0].clone().requires_grad_()
    try:
        se_gate(x, *args[1:])
    except RuntimeError as e:
        log(f"kernel se_gate: an input that requires grad raises ({e})")
    else:
        raise AssertionError("se_gate took an input that requires grad")
    try:
        se_gate(*se_inputs(1, 8, 8, SE_MAX_C + 1, 4, device))
    except ValueError as e:
        log(f"kernel se_gate: {SE_MAX_C + 1} channels at 8x8 raise ({e})")
    else:
        raise AssertionError(f"se_gate took {SE_MAX_C + 1} channels at 8x8")
    return errs


def phase_se_entry(device) -> dict:
    """Kernel #5's own entry point (the model does not call it, as in the
    JAX package): one ``se_gate`` call at each of the model's SE shapes,
    with every count set to 0 just before and read just after."""
    from nvae_torch.kernels.se_gate import se_gate

    sets = [se_inputs(BATCH, h, h, c, hd, device, seed=9)
            for h, c, hd in SE_SHAPES]
    torch.cuda.synchronize(device)
    reset_counts()
    outs = [se_gate(*args) for args in sets]
    torch.cuda.synchronize(device)
    counts = read_counts()
    if counts["se_gate"] != len(SE_SHAPES):
        raise AssertionError(f"se_gate entry: counts {counts}")
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError("se_gate entry: non-finite output")
    log(f"se_gate entry: {len(SE_SHAPES)} calls, counts {counts}")
    return counts


# ---- the training entry point ----------------------------------------------


# A module of the port (``python -m <module>``) run by ``runpy`` (the same
# module run the same way), after which the process writes this script's
# ``read_counts()`` and ``replayed_counts()`` to the file named by its first
# argument; the module is the second.
RUN_WITH_COUNTS = """
import json, runpy, sys
import os
path = sys.argv.pop(1).replace("{rank}", os.environ.get("RANK", "0"))
module = sys.argv.pop(1)
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
finally:
    import chip_smoke
    with open(path, "w") as f:
        json.dump({"launches": chip_smoke.read_counts(),
                   "replayed": chip_smoke.replayed_counts()}, f)
"""


def module_command(module: str, counts_path: str, argv) -> list:
    return [sys.executable, "-c", RUN_WITH_COUNTS, counts_path, module, *argv]


def port_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def run_cli(label: str, argv, workdir: str,
            module: str = "nvae_torch.cli") -> dict:
    """``python -m nvae_torch.cli`` (or another ``module``) as a user runs
    it, in a subprocess that writes its kernel launch counts to a file;
    fails on a non-zero exit."""
    counts_path = os.path.join(workdir,
                               f"{label.replace(' ', '_')}_counts.json")
    t0 = time.monotonic()
    proc = subprocess.run(
        module_command(module, counts_path, argv),
        cwd=workdir, env=port_env(), capture_output=True, text=True,
        timeout=900)
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli {label} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    with open(counts_path) as f:
        written = json.load(f)
    counts = written["launches"]
    replayed = {k: written["replayed"].get(k, 0) for k in KERNEL_NAMES}
    last = proc.stdout.strip().splitlines()[-1]
    shown = {k: v for k, v in replayed.items() if v}
    log(f"cli {label}: exit 0 in {seconds:.1f} s, launches {counts}"
        f"{f', replayed {shown}' if shown else ''}; {last}")
    return {"seconds": seconds, "counts": counts, "replayed": replayed,
            "stdout": proc.stdout}


# Held by a chain of ``run_concurrently`` around its work on the card in
# this process where another chain may have such work at the same time:
# ``nvae_torch.device.fp32_math`` sets and restores process-wide flags.
IN_PROCESS = threading.Lock()


def run_concurrently(*chains) -> list:
    """Each of ``chains`` (functions of no argument, whose work is the
    entry points' subprocesses) in a thread of its own, all at once;
    returns their results in order and raises the first failure once all
    have ended.  The runs share the host's cores and the card, so the
    seconds they log are no measurement."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(chains)) as pool:
        futures = [pool.submit(c) for c in chains]
        return [f.result() for f in futures]


def check_cli_counts(label, counts, per_forward, steps, forwards,
                     dtype="float32", remat=False):
    """#3 and #4 ``per_forward`` times per step; #2 that often per step
    (twice under ``remat``: the backward pass runs each cell again) and
    per eval, sampling and reconstruction forward, all in the instance of
    the compute ``dtype``; no other kernel."""
    fwd, dx, dwk = TRAIN_KERNELS[dtype]
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want.update({fwd: per_forward * ((2 if remat else 1) * steps + forwards),
                 dx: per_forward * steps, dwk: per_forward * steps})
    if counts != want:
        raise AssertionError(f"cli {label}: launches {counts}, expected {want}")


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def cli_args(workdir: str) -> list:
    return ["--preset", "mnist_step_sn", "--dataset", "synthetic",
            "--use_pallas", "--batch_size", str(BATCH), "--debug",
            "--evaluate_frequency", "1", "--sample_frequency", "1",
            "--model_save_frequency", "1",
            "--model_save_dir", os.path.join(workdir, "models"),
            "--sample_dir", os.path.join(workdir, "results"),
            "--tensorboard_log_dir", os.path.join(workdir, "logs")]


def phase_cli(workdir: str) -> dict:
    """The training entry point at full width (the ``mnist_step_sn``
    preset, batch 144, synthetic data, ``--debug``): train 2 epochs, then
    resume for a third and, at the same time, ``--mode sample`` over a copy
    of the second epoch's checkpoint, each a subprocess whose exit code,
    artifacts and exact kernel launch counts are checked."""
    from nvae_torch.config import ModelConfig
    from nvae_torch.train import checkpoint as ckpt

    per_fwd = expected_launches(ModelConfig(use_pallas_kernels=True))
    args = cli_args(workdir)
    models = os.path.join(workdir, "models")
    logs = os.path.join(workdir, "logs")
    steps = CLI_EPOCHS * CLI_BATCHES

    train = run_cli("train", ["--mode", "train", "--epochs", str(CLI_EPOCHS),
                              *args], workdir)
    # Per epoch: 4 eval forwards, one sampling call, one reconstruction.
    check_cli_counts("train", train["counts"], per_fwd, steps,
                     CLI_EPOCHS * (CLI_BATCHES + 2))
    lines = read_jsonl(os.path.join(logs, "metrics.jsonl"))
    tr = [r for r in lines if "train/loss" in r]
    te = [r for r in lines if "test/elbo" in r]
    if (len(tr) != CLI_EPOCHS or len(te) != CLI_EPOCHS or not all(
            math.isfinite(v) for r in tr + te for v in r.values())):
        raise AssertionError(f"cli train: metrics {tr} {te}")
    images = os.listdir(os.path.join(logs, "images"))
    for e in range(CLI_EPOCHS):
        want = [f"samples_t{t}_step{e}" for t in SAMPLE_TEMPERATURES]
        want.append(f"test_reconstruction_step{e}")
        if not set(want) <= set(images):
            raise AssertionError(f"cli train: image dirs {sorted(images)}")
    if ckpt.all_steps(models) != [CLI_BATCHES, steps]:
        raise AssertionError(f"cli train: checkpoints {ckpt.all_steps(models)}")
    if "Training done: best_loss=" not in train["stdout"]:
        raise AssertionError("cli train: no 'Training done' line")

    # The sample reads a copy of these checkpoints while the resume
    # writes the next one beside them.
    copy = os.path.join(workdir, "sample_models")
    shutil.copytree(models, copy)
    resume, sample = run_concurrently(
        lambda: run_cli("resume", ["--mode", "train",
                                   "--epochs", str(CLI_EPOCHS + 1), *args],
                        workdir),
        lambda: run_cli("sample", ["--mode", "sample", "--n_samples",
                                   str(BATCH), *args, "--model_save_dir",
                                   copy, "--tensorboard_log_dir",
                                   copy + "_logs"], workdir))
    shutil.rmtree(copy, ignore_errors=True)
    check_cli_counts("resume", resume["counts"], per_fwd, CLI_BATCHES,
                     CLI_BATCHES + 2)
    new = read_jsonl(os.path.join(logs, "metrics.jsonl"))[len(lines):]
    epochs = [r["step"] for r in new if "train/loss" in r]
    if epochs != [CLI_EPOCHS] or ckpt.all_steps(models) != [
            CLI_BATCHES, steps, steps + CLI_BATCHES]:
        raise AssertionError(f"cli resume: epochs {epochs}, checkpoints "
                             f"{ckpt.all_steps(models)}")
    check_cli_counts("sample", sample["counts"], per_fwd, 0, 1)
    for t in SAMPLE_TEMPERATURES:
        d = os.path.join(workdir, "results", f"t_{t}")
        pngs = [f for f in os.listdir(d) if f.endswith(".png")]
        if len(pngs) != BATCH:
            raise AssertionError(f"cli sample: {len(pngs)} PNGs in {d}")
        # The native batch writer wrote them (nvae_torch/utils/native_png.py).
        if not all(png_written_natively(os.path.join(d, f)) for f in pngs):
            raise AssertionError(f"cli sample: PNGs in {d} not written by "
                                 "the native writer")
    counts = {k: train["counts"][k] + resume["counts"][k] + sample["counts"][k]
              for k in KERNEL_NAMES}
    return {"train": train, "resume": resume, "sample": sample,
            "metrics": lines + new, "counts": counts}


def phase_cli_bf16(workdir: str) -> dict:
    """The training entry point in bf16 at full width: ``--preset
    mnist_step_sn --use_pallas --compute_dtype bfloat16 --bn_apply_dtype
    bfloat16 --postprocess_depthwise`` (bench.py's ladder rung 2 with the
    kernels), batch 144, synthetic data, ``--debug``: train 1 epoch with
    eval, image hooks and a checkpoint, then ``--mode sample`` on that
    checkpoint; exact launch counts of the bf16 kernels, none of fp32."""
    from nvae_torch.config import ModelConfig
    from nvae_torch.train import checkpoint as ckpt

    workdir = os.path.join(workdir, "bf16")
    os.makedirs(workdir)
    per_fwd = expected_launches(ModelConfig(use_pallas_kernels=True,
                                            postprocess_5x5_depthwise=True))
    args = [*cli_args(workdir), "--compute_dtype", "bfloat16",
            "--bn_apply_dtype", "bfloat16", "--postprocess_depthwise"]
    train = run_cli("train bf16", ["--mode", "train", "--epochs", "1",
                                   *args], workdir)
    check_cli_counts("train bf16", train["counts"], per_fwd, CLI_BATCHES,
                     CLI_BATCHES + 2, "bfloat16")
    lines = read_jsonl(os.path.join(workdir, "logs", "metrics.jsonl"))
    tr = [r for r in lines if "train/loss" in r]
    if (len(tr) != 1 or not any("test/elbo" in r for r in lines) or not all(
            math.isfinite(v) for r in lines for v in r.values())):
        raise AssertionError(f"cli train bf16: metrics {lines}")
    models = os.path.join(workdir, "models")
    if ckpt.all_steps(models) != [CLI_BATCHES]:
        raise AssertionError(f"cli train bf16: checkpoints "
                             f"{ckpt.all_steps(models)}")
    payload = ckpt.load_payload(models, CLI_BATCHES)
    if not all(v.dtype == torch.float32 for v in payload.values()
               if isinstance(v, torch.Tensor) and v.is_floating_point()):
        raise AssertionError("cli train bf16: a checkpoint tensor is not fp32")
    sample = run_cli("sample bf16", ["--mode", "sample", "--n_samples",
                                     str(BATCH), *args], workdir)
    check_cli_counts("sample bf16", sample["counts"], per_fwd, 0, 1,
                     "bfloat16")
    for t in SAMPLE_TEMPERATURES:
        d = os.path.join(workdir, "results", f"t_{t}")
        if len([f for f in os.listdir(d) if f.endswith(".png")]) != BATCH:
            raise AssertionError(f"cli sample bf16: PNGs in {d}")
    counts = {k: train["counts"][k] + sample["counts"][k]
              for k in KERNEL_NAMES}
    return {"train": train, "sample": sample, "metrics": lines,
            "counts": counts}


def phase_cli_scan(workdir: str) -> dict:
    """The training entry point on the scan path at full width: ``--preset
    mnist_step_sn --use_pallas --scan_epochs``, batch 144, synthetic data,
    ``--debug``: train 2 epochs with eval, image hooks and a checkpoint per
    epoch, then resume for a third.  Exact launches: through the wrappers
    each run's first step (eager), its capture and every eval, sampling and
    reconstruction forward; as replays every other step (the captured one
    runs as the first replay)."""
    from nvae_torch.config import ModelConfig
    from nvae_torch.train import checkpoint as ckpt

    workdir = os.path.join(workdir, "scan")
    os.makedirs(workdir)
    per_fwd = expected_launches(ModelConfig(use_pallas_kernels=True))
    args = [*cli_args(workdir), "--scan_epochs"]
    logs = os.path.join(workdir, "logs")
    models = os.path.join(workdir, "models")
    steps = CLI_EPOCHS * CLI_BATCHES
    train = run_cli("train scan", ["--mode", "train", "--epochs",
                                   str(CLI_EPOCHS), *args], workdir)
    check_cli_counts("train scan", train["counts"], per_fwd, 2,
                     CLI_EPOCHS * (CLI_BATCHES + 2))
    check_cli_counts("train scan replays", train["replayed"], per_fwd,
                     steps - 1, 0)
    lines = read_jsonl(os.path.join(logs, "metrics.jsonl"))
    tr = [r for r in lines if "train/loss" in r]
    te = [r for r in lines if "test/elbo" in r]
    if (len(tr) != CLI_EPOCHS or len(te) != CLI_EPOCHS or not all(
            math.isfinite(v) for r in tr + te for v in r.values())):
        raise AssertionError(f"cli train scan: metrics {tr} {te}")
    images = os.listdir(os.path.join(logs, "images"))
    if f"test_reconstruction_step{CLI_EPOCHS - 1}" not in images:
        raise AssertionError(f"cli train scan: image dirs {sorted(images)}")
    if ckpt.all_steps(models) != [CLI_BATCHES, steps]:
        raise AssertionError(f"cli train scan: checkpoints "
                             f"{ckpt.all_steps(models)}")
    resume = run_cli("resume scan", ["--mode", "train", "--epochs",
                                     str(CLI_EPOCHS + 1), *args], workdir)
    check_cli_counts("resume scan", resume["counts"], per_fwd, 2,
                     CLI_BATCHES + 2)
    check_cli_counts("resume scan replays", resume["replayed"], per_fwd,
                     CLI_BATCHES - 1, 0)
    new = read_jsonl(os.path.join(logs, "metrics.jsonl"))[len(lines):]
    epochs = [r["step"] for r in new if "train/loss" in r]
    if epochs != [CLI_EPOCHS] or ckpt.all_steps(models) != [
            CLI_BATCHES, steps, steps + CLI_BATCHES]:
        raise AssertionError(f"cli resume scan: epochs {epochs}, "
                             f"checkpoints {ckpt.all_steps(models)}")
    payload = ckpt.load_payload(models, steps + CLI_BATCHES)
    counts = [v for k, v in payload.items() if k.endswith("/count")]
    if not counts or any(v != steps + CLI_BATCHES for v in counts):
        raise AssertionError(f"cli resume scan: optimizer counts {counts}")
    return {"train": train, "resume": resume, "metrics": lines + new,
            "counts": {k: train["counts"][k] + resume["counts"][k]
                       for k in KERNEL_NAMES},
            "replayed": {k: train["replayed"][k] + resume["replayed"][k]
                         for k in train["replayed"]}}


def report_cli(rec: dict, batch: int = BATCH) -> None:
    """The training entry point's own numbers, from its metrics.jsonl."""
    for r in rec["metrics"]:
        if "train/loss" in r:
            log(f"cli epoch {r['step']}: {r['train/epoch_seconds']:.3f} s, "
                f"{r['train/images_per_sec']:.1f} img/s, loss "
                f"{r['train/loss']:.3f}, peak memory "
                f"{r.get('train/peak_memory_gb', math.nan):.2f} GB")
        elif "test/elbo" in r:
            log(f"cli eval epoch {r['step']}: elbo {r['test/elbo']:.3f}, "
                f"{r['test/eval_ms_per_batch']:.2f} ms per batch of {batch}")
        elif "checkpoint/total_ms" in r:
            log(f"cli checkpoint step {r['step']}: blocking "
                f"{r['checkpoint/blocking_ms']:.1f} ms, total "
                f"{r['checkpoint/total_ms']:.1f} ms")


def phase_restored_state(workdir: str, device):
    """In-process: a Trainer built from the same flags restores epoch 2
    (``--resume_from 2``, the resume run's path) and holds exactly the
    step-8 checkpoint's tensors.  Returns the trainer."""
    from nvae_torch import cli
    from nvae_torch.train import checkpoint as ckpt
    from nvae_torch.train.trainer import Trainer

    args = cli.parse_args(["--mode", "train", "--epochs", str(CLI_EPOCHS + 1),
                           "--resume_from", str(CLI_EPOCHS),
                           *cli_args(workdir)])
    model_cfg, train_cfg, _ = cli.configs_from_args(args)
    trainer = Trainer(model_cfg, train_cfg, CLI_BATCHES, device=device)
    start = trainer.maybe_resume()
    step = CLI_EPOCHS * CLI_BATCHES
    want = ckpt.load_payload(train_cfg.model_save_dir, step)
    got = ckpt.flatten_state(trainer.state)
    same = set(got) == set(want) and all(
        torch.equal(v.cpu(), want[k]) if isinstance(v, torch.Tensor)
        else v == want[k] for k, v in got.items())
    log(f"restore: epoch {start}, step {trainer.state.step}, {len(got)} "
        f"entries, equal to the step-{step} checkpoint: {same}")
    if start != CLI_EPOCHS or trainer.state.step != step or not same:
        raise AssertionError("the restored state differs from the checkpoint")
    return trainer


def nll_errors(card: float, cpu: float, f64: float) -> dict:
    return {"card_vs_cpu": abs(card - cpu) / abs(cpu),
            "card_vs_f64": abs(card - f64) / abs(f64),
            "cpu_vs_f64": abs(cpu - f64) / abs(f64)}


def phase_nll(trainer, device) -> dict:
    """IWAE NLL on the restored full-width model: K=NLL_ATTEMPTS over
    NLL_BATCHES test batches of BATCH (seconds per batch); then one B=4 NLL
    (K=3) with injected noise on the card, on the CPU in float32 and in
    float64."""
    from nvae_torch.data import make_iterators, synthetic_dataset
    from nvae_torch.eval.nll import make_nll_fn

    model = trainer.model
    bundle = synthetic_dataset(n_train=BATCH, n_test=NLL_BATCHES * BATCH,
                               seed=0)
    _, test_iter = make_iterators(bundle, BATCH, seed=0, device=device)
    nll_fn = make_nll_fn(model, NLL_ATTEMPTS, crop=2)
    values, seconds = [], []
    batches = list(test_iter.epoch(0))
    for i, batch in enumerate(batches):
        gen = torch.Generator(device=device).manual_seed(i)
        torch.cuda.synchronize(device)
        t0 = time.monotonic()
        values.append(float(nll_fn(batch, generator=gen)))
        seconds.append(time.monotonic() - t0)
    log(f"nll: K={NLL_ATTEMPTS}, batch {BATCH}: {values} nats, "
        f"{seconds} s per batch")
    if len(values) != NLL_BATCHES or not all(map(math.isfinite, values)):
        raise AssertionError(f"nll: {values}")

    errs = nll_card_vs_cpu("nll", model, batches[0][:4].cpu(), device)
    return {"values": values, "seconds": seconds, "b4": errs}


def nll_noise(cfg) -> list:
    """The B=4 IWAE NLL's injected noise (K=3) of ``nll_card_vs_cpu``."""
    from nvae_torch.models.nvae import posterior_noise_shapes

    rng = np.random.RandomState(6)
    return [[rng.randn(*s).astype(np.float32)
             for s in posterior_noise_shapes(cfg, 4)] for _ in range(3)]


def cpu_nll_refs(cfg, x: torch.Tensor, float64: bool = True,
                 weights=None) -> tuple:
    """The CPU side of ``nll_card_vs_cpu`` (``nll_bf16_card_vs_cpu``): the
    B=4 IWAE NLL of ``cfg`` from seed-0 weights (or the state dict
    ``weights``) on the CPU in float32 and, with ``float64``, in float64
    (else None)."""
    from nvae_torch.eval.nll import make_nll_fn
    from nvae_torch.models.nvae import NVAE

    eps = nll_noise(cfg)
    host = NVAE(cfg, device="cpu", seed=0)
    if weights is not None:
        host.load_state_dict(weights)
    cpu = float(make_nll_fn(host, 3)(x, eps=eps))
    if not float64:
        return cpu, None
    host.double()
    return cpu, float(make_nll_fn(host, 3)(x.double(), eps=eps))


def nll_card_vs_cpu(label: str, model, x: torch.Tensor, device,
                    refs=None) -> dict:
    """One B=4 IWAE NLL (K=3, JAX's crop 2) with injected noise on the
    card, on the CPU in float32 and in float64, held to NLL_RTOL.
    ``refs()``, if given, returns the CPU's (``cpu_nll_refs``' record over
    the model's weights, from the helper process)."""
    from nvae_torch.eval.nll import make_nll_fn

    card = float(make_nll_fn(model, 3)(x.to(device), eps=nll_noise(model.cfg)))
    if refs is not None:
        cpu, f64 = refs()
    else:
        cpu, f64 = cpu_nll_refs(model.cfg, x, weights={
            k: v.cpu() for k, v in model.state_dict().items()})
    errs = nll_errors(card, cpu, f64)
    log(f"{label} B=4 card {card!r}, CPU fp32 {cpu!r}, CPU fp64 {f64!r}: "
        f"{errs}")
    errs["f64"] = f64
    if not (errs["card_vs_f64"] <= NLL_RTOL and (
            errs["card_vs_cpu"] <= NLL_RTOL
            or errs["card_vs_f64"] <= CARD_VS_CPU_ROUNDING
            * errs["cpu_vs_f64"])):
        raise AssertionError(f"{label}: card vs CPU {errs}")
    return errs


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


def bound(h, c, bias, swish, batch=BATCH):
    """Least time for one call: each input read once, each output written
    once, over HBM; 50 FLOP per output for the taps, 4 for swish, 1 for the
    bias, over the fp32 rate.  Returns (bytes ms, operations ms)."""
    n = batch * h * h * c
    nbytes = 4 * (2 * n + 25 * c + (c if bias else 0))
    flops = n * (50 + (4 if swish else 0) + (1 if bias else 0))
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOP_PER_S


def bwd_bound(h, c, kind, bias, batch=BATCH):
    """Least time of one dx (``kind`` "dx": reads dy and x, writes dx; 50
    FLOP per output for the taps and 9 for the swish' epilogue) or dW/db
    call ("dw": reads x and dy, writes (25 + 1) x C sums; 50 FLOP per
    element for the taps, 4 for swish, 1 for the bias sum).  Returns
    (bytes ms, operations ms)."""
    n = batch * h * h * c
    if kind == "dx":
        nbytes, flops = 4 * (3 * n + 25 * c), n * 59
    else:
        nbytes = 4 * (2 * n + (26 if bias else 25) * c)
        flops = n * (54 + (1 if bias else 0))
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOP_PER_S


def log_timing(label: str, r: dict, library: str) -> None:
    """One kernel timing line: card, bound, plain and library times, the
    bound's share of the card time and the card time over the library's."""
    log(f"timing {label}: kernel {r['ms'] * 1e3:.1f} us (eager "
        f"{r['eager_ms'] * 1e3:.1f} us), bound {max(r['bound']) * 1e3:.1f} us"
        f" (share {max(r['bound']) / r['ms']:.2f}), plain "
        f"{r['plain_ms'] * 1e3:.1f} us, {library} "
        f"{r['library_ms'] * 1e3:.1f} us (kernel / library "
        f"{r['ms'] / r['library_ms']:.2f})")


def phase_backward_timing(device, shapes=PATH_SHAPES, batch=BATCH,
                          iters=40) -> list:
    """Each backward kernel's time at each path shape (the forms the
    training path runs: dx with swish', dW/db with swish and the shape's
    bias) beside its bound, its plain version and the library call that
    computes the same function without the swish parts, over ``iters``
    calls."""
    from torch.nn.grad import conv2d_input, conv2d_weight

    from nvae_torch.kernels import depthwise as dw
    from nvae_torch.device import fp32_math

    rows = []
    with fp32_math(deterministic=True):
        for h, c, bias, _, _ in shapes:
            n_sets = max(2, min(8, math.ceil(200e6 / (8 * batch * h * h * c))))
            sets = []
            for s in range(n_sets):
                x, k, _ = path_inputs(h, c, False, device, seed=s,
                                      batch=batch)
                g = path_inputs(h, c, False, device, seed=100 + s,
                                batch=batch)[0]
                sets.append((x, k, g))
            nchw = [(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                     g.permute(0, 3, 1, 2)) for x, k, g in sets]
            size_x = (batch, c, h, h)
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
            row = {"shape": [batch, h, h, c], "bias": bias}
            for kind, (kern, plain, lib) in calls.items():
                ms, eager = time_ms(kern, sets, iters)
                row[kind] = {
                    "ms": ms, "eager_ms": eager,
                    "plain_ms": time_ms(plain, sets, iters)[0],
                    "library_ms": time_ms(lib, nchw, iters)[0],
                    "bound": bwd_bound(h, c, kind, bias, batch),
                }
                log_timing(f"{kind} {batch}x{h}x{h}x{c}", row[kind], "library")
            rows.append(row)
            del sets, nchw
    return rows


def phase_timing(device, samplers) -> dict:
    from nvae_torch.serving_runtime import BatchingSampler

    out = {"img_per_s": {}}
    for name, sampler in samplers.items():
        if name.endswith("bf16"):
            continue  # the matrix timed it
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
    out["shapes"] = phase_forward_timing(device)
    return out


def phase_forward_timing(device, shapes=PATH_SHAPES, batch=BATCH,
                         iters=40) -> list:
    """Each forward kernel (#2 with swish and the shape's bias, #1) at each
    path shape beside its bound, its plain version and
    ``F.conv2d(groups=C)``, over ``iters`` calls."""
    from nvae_torch.kernels import depthwise as dw
    from nvae_torch.device import fp32_math

    rows = []
    with fp32_math(deterministic=True):
        for h, c, bias, _, _ in shapes:
            n_sets = max(2, min(8, math.ceil(200e6 / (8 * batch * h * h * c))))
            sets = [path_inputs(h, c, bias, device, seed=s, batch=batch)
                    for s in range(n_sets)]
            nchw = [(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), b)
                    for x, k, b in sets]
            plain_sets = [(x, k, None) for x, k, _ in sets]
            row = {"shape": [batch, h, h, c], "bias": bias}
            calls = {
                "fused": (
                    lambda x, k, b: dw.fused_swish_depthwise5x5(
                        x, k, b, fuse_swish=True),
                    lambda x, k, b: dw.fused_swish_depthwise5x5_plain(
                        x, k, b, fuse_swish=True),
                    # The library call convolves without the swish.
                    lambda x, w, b: F.conv2d(x, w, b, padding=2, groups=c),
                    sets, bound(h, c, bias, True, batch),
                ),
                "thin": (
                    lambda x, k, b: dw.depthwise_conv5x5(x, k),
                    lambda x, k, b: dw.fused_swish_depthwise5x5_plain(
                        x, k, None, fuse_swish=False),
                    lambda x, w, b: F.conv2d(x, w, None, padding=2, groups=c),
                    plain_sets, bound(h, c, False, False, batch),
                ),
            }
            for kind, (kern, plain, lib, args, bnd) in calls.items():
                ms, eager = time_ms(kern, args, iters)
                row[kind] = {
                    "ms": ms, "eager_ms": eager,
                    "plain_ms": time_ms(plain, args, iters)[0],
                    "library_ms": time_ms(lib, nchw, iters)[0],
                    "bound": bnd,
                }
            for kind in ("fused", "thin"):
                log_timing(f"{kind} {batch}x{h}x{h}x{c}", row[kind],
                           "conv2d(groups=C)")
            rows.append(row)
            del sets, nchw, plain_sets
    return rows


def phase_se_timing(device) -> list:
    """Kernel #5 at the model's SE shapes beside its bound (x read and y
    written once, the weights read once; the pool's adds, the gate's
    multiplies and the dense layers' 4 C Hd per row, over the fp32 rate),
    its plain version and the port's eager ``SqueezeExcitation`` module on
    the same map.  No single PyTorch call computes the gate.  The input
    sets hold more than twice the L2 cache of x, and every set is called
    once per cycle, so each call reads its x from HBM."""
    from nvae_torch.kernels.se_gate import se_gate, se_gate_reference
    from nvae_torch.nn.blocks import SqueezeExcitation

    rows = []
    with torch.no_grad():
        for h, c, hd in SE_SHAPES:
            n = BATCH * h * h * c
            n_sets = int(2 * L2_BYTES // (4 * n)) + 1
            iters = max(40, n_sets)
            sets = [se_inputs(BATCH, h, h, c, hd, device, seed=s)
                    for s in range(n_sets)]
            module = SqueezeExcitation(c).to(device)
            nchw = [(x.permute(0, 3, 1, 2),) for x, *_ in sets]
            ms, eager = time_ms(se_gate, sets, iters)
            nbytes = 4 * (2 * n + 2 * c * hd + hd + c)
            flops = 2 * n + BATCH * (4 * c * hd + hd + 5 * c)
            row = {"shape": [BATCH, h, h, c, hd], "ms": ms, "eager_ms": eager,
                   "sets": n_sets, "x_mb_in_sets": 4 * n * n_sets / 1e6,
                   "plain_ms": time_ms(se_gate_reference, sets, iters)[0],
                   "module_ms": time_ms(module, nchw, iters)[0],
                   "bound": (1e3 * nbytes / HBM_BYTES_PER_S,
                             1e3 * flops / FP32_FLOP_PER_S)}
            log(f"timing se_gate {BATCH}x{h}x{h}x{c} (hidden {hd}), {n_sets} "
                f"sets ({row['x_mb_in_sets']:.1f} MB of x): kernel "
                f"{ms * 1e3:.2f} us (eager {eager * 1e3:.2f} us), bound "
                f"{max(row['bound']) * 1e3:.2f} us (share "
                f"{max(row['bound']) / ms:.2f}), plain "
                f"{row['plain_ms'] * 1e3:.2f} us, SqueezeExcitation "
                f"{row['module_ms'] * 1e3:.2f} us")
            rows.append(row)
            del sets, nchw
    return rows


def phase_tool_timing(device) -> list:
    """Kernel #2 (swish, no bias) at the shapes ``tools/bench_dw_kernel.py``
    times its TPU tuning variants at, beside its bound, its plain version
    and ``F.conv2d(groups=C)``."""
    from nvae_torch.device import fp32_math
    from nvae_torch.kernels import depthwise as dw

    rows = []
    with fp32_math(deterministic=True):
        for h, c in TOOL_SHAPES:
            n_sets = max(2, min(8, math.ceil(200e6 / (8 * BATCH * h * h * c))))
            sets = [path_inputs(h, c, False, device, seed=s)
                    for s in range(n_sets)]
            nchw = [(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), None)
                    for x, k, _ in sets]
            row = {"shape": [BATCH, h, h, c],
                   "ms": time_ms(lambda x, k, b: dw.fused_swish_depthwise5x5(
                       x, k, None), sets)[0],
                   "plain_ms": time_ms(
                       lambda x, k, b: dw.fused_swish_depthwise5x5_plain(
                           x, k, None), sets)[0],
                   "library_ms": time_ms(lambda x, w, b: F.conv2d(
                       x, w, None, padding=2, groups=c), nchw)[0],
                   "bound": bound(h, c, False, True)}
            log(f"timing fused (tool shape) {BATCH}x{h}x{h}x{c}: kernel "
                f"{row['ms'] * 1e3:.1f} us, bound {max(row['bound']) * 1e3:.1f}"
                f" us, plain {row['plain_ms'] * 1e3:.1f} us, conv2d(groups=C)"
                f" {row['library_ms'] * 1e3:.1f} us")
            rows.append(row)
            del sets, nchw
    return rows


def phase_profile(samplers, trainers, scans) -> dict:
    """One ``sample`` call and one training step per configuration, and
    one graph replay of each scan configuration's step (an extra step on
    that runner's state): its device kernels by name hold the replay's
    launch counts."""
    from nvae_torch.tools.profile_step import profile_call

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
    for name, rec in scans.items():
        graph = rec["runner"].graph
        prof = profile_call(f"scan replay {name}", graph.replay)
        ring = prof["depthwise"]
        want = {k: rec["launches_per_replay"].get(k, 0)
                for k in DW_KERNEL_NAMES}
        if ring != want:
            raise AssertionError(f"scan replay {name}: ring kernels in the "
                                 f"profile {ring}, the capture counted "
                                 f"{rec['launches_per_replay']}")
        out[f"scan {name}"] = prof
    return out


def se_geometry(shape) -> dict:
    """The gate's launch geometry at a (B, H, W, C, hidden) shape."""
    from nvae_torch.kernels.se_gate import geometry

    b, h, w, c, hd = shape
    g = geometry(b, h * w, c, hd)
    return {"cluster": g.cluster, "blocks": g.blocks, "threads": g.threads,
            "smem_bytes": g.smem_bytes}


def se_record(se_errs, launches, se_timing) -> dict:
    """Kernel #5's record: times and bounds summed over one call at each of
    the model's four SE shapes."""
    b_bytes = sum(r["bound"][0] for r in se_timing)
    b_ops = sum(r["bound"][1] for r in se_timing)
    return {
        "name": "se_gate", "route": "cuda",
        "source": "nvae_torch/kernels/csrc/se_gate.cu",
        "replaces": "nvae_tpu/kernels/se_gate.py:53",
        "launches": launches["se_gate"],
        "max_abs_err": max(se_errs.values()),
        "ms": sum(r["ms"] for r in se_timing),
        "plain_ms": sum(r["plain_ms"] for r in se_timing),
        "bound_ms": sum(max(r["bound"]) for r in se_timing),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None,
        "per": f"one call at each of the model's SE shapes at batch {BATCH}",
        "module_ms": sum(r["module_ms"] for r in se_timing),
        "shapes": [{"shape": r["shape"], "ms": r["ms"],
                    "eager_ms": r["eager_ms"], "plain_ms": r["plain_ms"],
                    "module_ms": r["module_ms"],
                    "bound_ms": max(r["bound"]), "sets": r["sets"],
                    "geometry": se_geometry(r["shape"])} for r in se_timing],
    }


# ---- bf16: kernel #2's bf16 instance, the sampler matrix, serving ---------


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 steps between two bf16 tensors, element by element (their bit
    patterns mapped to integers in value order)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(i >= 0x8000, 0x8000 - (i & 0x7FFF), i + 0x8000)
    return (ordered(a) - ordered(b)).abs()


def bf16_inputs(h, c, bias, device, seed=0, batch=BATCH):
    """path_inputs with x and the taps in bf16 (the bias stays fp32)."""
    x, k, b = path_inputs(h, c, bias, device, seed, batch)
    return x.to(torch.bfloat16), k.to(torch.bfloat16), b


def phase_bf16_kernel(device) -> dict:
    """Kernel #2's bf16 instance against its plain version at every path
    shape and every batch in BF16_BATCHES, bitwise across two runs: no
    output more than ``BF16_SUM_ULPS`` fp32 ulps of its products' sum
    (``bf16_sum_ulps``) past one bf16 ulp of the result, and at least
    ``BF16_MIN_EQUAL_SHARE`` of them bitwise equal.  Logs both, and the
    distance in bf16 steps of the results themselves.  Returns per shape
    the worst of each."""
    from nvae_torch.kernels import depthwise as dw

    out = {}
    for h, c, bias, _, _ in PATH_SHAPES:
        for n in BF16_BATCHES:
            x, k, b = bf16_inputs(h, c, bias, device, batch=n)
            got = dw.fused_swish_depthwise5x5(x, k, b)
            again = dw.fused_swish_depthwise5x5(x, k, b)
            want = dw.fused_swish_depthwise5x5_plain(x, k, b)
            torch.cuda.synchronize(device)
            if got.dtype != torch.bfloat16 or not torch.equal(got, again):
                raise AssertionError(f"bf16 #2 {n}x{h}x{c}: two runs differ")
            ulps = bf16_ulps(got, want)
            worst, equal = int(ulps.max()), float((ulps == 0).float().mean())
            err = float((got.float() - want.float()).abs().max())
            sum_ulps = float(dw.bf16_sum_ulps(
                got, want, dw.bf16_sum_scale(x, k, b)).max())
            log(f"kernel fused bf16 {n}x{h}x{h}x{c}: max abs err {err:.3g}, "
                f"{sum_ulps:.3g} fp32 ulps of the products' sum past one "
                f"bf16 ulp (limit {dw.BF16_SUM_ULPS}); {100 * equal:.4f}% "
                f"bitwise equal (limit {100 * dw.BF16_MIN_EQUAL_SHARE}%); "
                f"results {worst} bf16 steps apart at most; bitwise "
                f"repeatable")
            if not (sum_ulps <= dw.BF16_SUM_ULPS
                    and equal >= dw.BF16_MIN_EQUAL_SHARE):
                raise AssertionError(f"bf16 #2 {n}x{h}x{c}: {sum_ulps} fp32 "
                                     f"ulps of the sum, {equal} equal")
            r = out.setdefault((h, c), {"ulps": 0, "err": 0.0, "equal": 1.0,
                                        "sum_ulps": 0.0})
            r["ulps"] = max(r["ulps"], worst)
            r["err"] = max(r["err"], err)
            r["equal"] = min(r["equal"], equal)
            r["sum_ulps"] = max(r["sum_ulps"], sum_ulps)
    return out


def phase_bf16_timing(device) -> list:
    """Kernel #2's bf16 instance at each path shape (B=BATCH) beside its
    bound (x read and y written once in bf16, the taps in bf16 and the fp32
    bias read once; 55 fp32 operations per output), its plain version and
    ``F.conv2d(groups=C)`` in bf16 without the swish."""
    from nvae_torch.kernels import depthwise as dw

    rows = []
    for h, c, bias, _, _ in PATH_SHAPES:
        n = BATCH * h * h * c
        # More than twice the L2 of bf16 x, each set called once a cycle.
        n_sets = int(2 * L2_BYTES // (2 * n)) + 1
        iters = max(40, n_sets)
        sets = [bf16_inputs(h, c, bias, device, seed=s) for s in range(n_sets)]
        nchw = [(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                 None if b is None else b.to(torch.bfloat16))
                for x, k, b in sets]
        nbytes = 2 * (2 * n + 25 * c) + (4 * c if bias else 0)
        flops = n * (50 + 4 + (1 if bias else 0))
        ms, eager = time_ms(lambda x, k, b: dw.fused_swish_depthwise5x5(
            x, k, b), sets, iters)
        row = {"shape": [BATCH, h, h, c], "bias": bias, "ms": ms,
               "eager_ms": eager, "sets": n_sets,
               "x_mb_in_sets": 2 * n * n_sets / 1e6,
               "plain_ms": time_ms(
                   lambda x, k, b: dw.fused_swish_depthwise5x5_plain(
                       x, k, b), sets, iters)[0],
               "library_ms": time_ms(lambda x, w, b: F.conv2d(
                   x, w, b, padding=2, groups=c), nchw, iters)[0],
               "bound": (1e3 * nbytes / HBM_BYTES_PER_S,
                         1e3 * flops / FP32_FLOP_PER_S)}
        log_timing(f"fused bf16 {BATCH}x{h}x{h}x{c} ({n_sets} sets, "
                   f"{row['x_mb_in_sets']:.1f} MB of x)", row, "conv2d bf16")
        rows.append(row)
        del sets, nchw
    return rows


def phase_bf16_backward_timing(device) -> list:
    """The bf16 instances of #3 (with swish') and #4 (with swish and the
    shape's bias) at each path shape (B=BATCH) beside their bounds, their
    plain versions and ``conv2d_input`` / ``conv2d_weight`` (groups=C) in
    bf16 without the swish parts and db.  Bounds: dx reads dy and x and
    writes dx in bf16 (6 bytes an element) and the bf16 taps, 59 fp32
    operations an element; dW/db reads x and dy in bf16 (4 bytes an
    element) and writes the fp32 sums, 54 (55 with db) operations an
    element.  The input sets hold more than twice the L2 of bf16 x, and
    every set is called once a cycle."""
    from torch.nn.grad import conv2d_input, conv2d_weight

    from nvae_torch.kernels import depthwise as dw

    rows = []
    for h, c, bias, _, _ in PATH_SHAPES:
        n = BATCH * h * h * c
        n_sets = int(2 * L2_BYTES // (2 * n)) + 1
        iters = max(40, n_sets)
        sets = []
        for s in range(n_sets):
            x, k, _ = bf16_inputs(h, c, False, device, seed=s)
            g = bf16_inputs(h, c, False, device, seed=100 + s)[0]
            sets.append((x, k, g))
        nchw = [(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                 g.permute(0, 3, 1, 2)) for x, k, g in sets]
        size_x, size_w = (BATCH, c, h, h), (c, 1, 5, 5)
        calls = {
            "dx": (lambda x, k, g: dw.fused_swish_depthwise5x5_dx(g, k, x),
                   lambda x, k, g: dw.fused_swish_depthwise5x5_dx_plain(
                       g, k, x),
                   lambda x, w, g: conv2d_input(size_x, w, g, padding=2,
                                                groups=c),
                   (2 * (3 * n + 25 * c), 59 * n)),
            "dw": (lambda x, k, g: dw.fused_swish_depthwise5x5_dw(
                       x, g, with_bias=bias),
                   lambda x, k, g: dw.fused_swish_depthwise5x5_dw_plain(x, g),
                   lambda x, w, g: conv2d_weight(x, size_w, g, padding=2,
                                                 groups=c),
                   (2 * 2 * n + 4 * (26 if bias else 25) * c,
                    (55 if bias else 54) * n)),
        }
        row = {"shape": [BATCH, h, h, c], "bias": bias, "sets": n_sets,
               "x_mb_in_sets": 2 * n * n_sets / 1e6}
        for kind, (kern, plain, lib, (nbytes, flops)) in calls.items():
            ms, eager = time_ms(kern, sets, iters)
            row[kind] = {
                "ms": ms, "eager_ms": eager,
                "plain_ms": time_ms(plain, sets, iters)[0],
                "library_ms": time_ms(lib, nchw, iters)[0],
                "bound": (1e3 * nbytes / HBM_BYTES_PER_S,
                          1e3 * flops / FP32_FLOP_PER_S),
            }
            log_timing(f"{kind} bf16 {BATCH}x{h}x{h}x{c} ({n_sets} sets, "
                       f"{row['x_mb_in_sets']:.1f} MB of x)", row[kind],
                       f"conv2d_{'input' if kind == 'dx' else 'weight'} bf16")
        rows.append(row)
        del sets, nchw
    return rows


def bf16_record(bf16_errs, launches, rows) -> dict:
    """Kernel #2's bf16 instance's record, per depthwise-config bf16 sample
    call (the shapes weighted by their calls, 9, 5, 3, 3)."""
    from nvae_torch.kernels import depthwise as dw

    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
    t_bytes = t_ops = 0.0
    shapes = []
    for (h, c, _, _, calls), r in zip(PATH_SHAPES, rows):
        b_bytes, b_ops = r["bound"]
        for key in ("ms", "plain_ms", "library_ms"):
            tot[key] += calls * r[key]
        tot["bound_ms"] += calls * max(b_bytes, b_ops)
        t_bytes += calls * b_bytes
        t_ops += calls * b_ops
        e = bf16_errs[(h, c)]
        shapes.append({
            "shape": r["shape"], "calls": calls, "ms": r["ms"],
            "sets": r["sets"], "x_mb_in_sets": r["x_mb_in_sets"],
            "eager_ms": r["eager_ms"], "plain_ms": r["plain_ms"],
            "library_ms": r["library_ms"], "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations",
            "bound_share": max(b_bytes, b_ops) / r["ms"],
            "vs_library": r["ms"] / r["library_ms"],
            "max_abs_err": e["err"], "max_sum_ulps": e["sum_ulps"],
            "max_steps_apart": e["ulps"], "bitwise_share": e["equal"]})
    return {
        "name": "fused_swish_depthwise5x5_bf16", "route": "cuda",
        "source": "nvae_torch/kernels/csrc/depthwise5x5.cu",
        "replaces": "nvae_tpu/kernels/depthwise.py:239",
        "launches": launches["fused_swish_depthwise5x5_bf16"],
        "max_abs_err": max(e["err"] for e in bf16_errs.values()),
        "max_sum_ulps": max(e["sum_ulps"] for e in bf16_errs.values()),
        "sum_ulps_limit": dw.BF16_SUM_ULPS,
        "bitwise_share": min(e["equal"] for e in bf16_errs.values()),
        "bitwise_share_limit": dw.BF16_MIN_EQUAL_SHARE,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": tot["library_ms"],
        "per": f"depthwise-config bf16 sample call at batch {BATCH}",
        "shapes": shapes,
    }


def bf16_backward_records(errs, launches, rows) -> list:
    """The records of #3's and #4's bf16 instances (``kernel_records`` per
    depthwise-config bf16 training step), with dx's ulps and bitwise share
    beside their limits and dW/db's limit."""
    from nvae_torch.kernels import depthwise as dw

    dx, dwk = TRAIN_KERNELS["bfloat16"][1:]
    rec_dx, rec_dw = kernel_records(
        {dx: {s: e["err"] for s, e in errs.items()},
         dwk: {s: e["dw_err"] for s, e in errs.items()}}, launches,
        [(dx, rows, "dx", "nvae_tpu/kernels/depthwise.py:274",
          "bf16 training step"),
         (dwk, rows, "dw", "nvae_tpu/kernels/depthwise.py:288",
          "bf16 training step")])
    for (h, c, _, _, _), shape in zip(PATH_SHAPES, rec_dx["shapes"]):
        shape.update(max_sum_ulps=errs[(h, c)]["sum_ulps"],
                     bitwise_share=errs[(h, c)]["equal"])
    rec_dx.update(max_sum_ulps=max(e["sum_ulps"] for e in errs.values()),
                  sum_ulps_limit=dw.BF16_SUM_ULPS,
                  bitwise_share=min(e["equal"] for e in errs.values()),
                  bitwise_share_limit=dw.BF16_MIN_EQUAL_SHARE)
    rec_dw.update(rtol_of_max_dw=DW_RTOL, bitwise_across_runs=True)
    return [rec_dx, rec_dw]


def matrix_cfg(cfg, compute: str):
    import dataclasses

    return dataclasses.replace(cfg, compute_dtype=compute,
                               bn_apply_dtype=compute)


def phase_matrix(name, cfg, device) -> dict:
    """The full-width sampler at every (serve_dtype, compute dtype) of
    MATRIX at batch BATCH: exact launches of #2 (fp32 or bf16 as the
    compute dtype says) per call, ms per call (the median of MATRIX_CALLS
    synced calls), weights bytes on the card, peak memory of a call, the
    host ms that int8 dequantization adds; and
    the card's probabilities against the CPU's at MATRIX_CPU_BATCH rows
    with injected noise (fp32 compute: atol PROB_ATOL; bf16 compute: atol
    BF16_PROB_ATOL, and no further from the CPU's fp32-compute run on the
    same weights than CARD_VS_CPU_ROUNDING times the CPU's bf16 run is).
    Returns the rows and the main path's launch counts."""
    from nvae_torch.models.nvae import NVAE, decoder_noise_shapes
    from nvae_torch.serving import Sampler, dequantize_params

    host = NVAE(cfg, device="cpu", seed=0)
    random_bn_stats_(host, seed=1)
    sd = host.state_dict()
    del host
    rng = np.random.RandomState(3)
    n_cpu = MATRIX_CPU_BATCH
    eps = [rng.randn(*s).astype(np.float32)
           for s in decoder_noise_shapes(cfg, n_cpu)]
    t_cpu = torch.linspace(0.6, 1.2, n_cpu)
    t = torch.ones(BATCH)
    cpu_probs, rows = {}, []
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    for serve, compute in MATRIX:
        label = f"{name} weights {serve} compute {compute}"
        rcfg = matrix_cfg(cfg, compute)
        sampler = Sampler(rcfg, sd, BATCH, device=device,
                          serve_dtype="" if serve == "float32" else serve)
        sampler(1, t)
        torch.cuda.synchronize(device)
        reset_counts()
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        images = sampler(2, t)
        torch.cuda.synchronize(device)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(device) - before
        check_images(images.cpu().numpy(), BATCH)
        # The batching server's replay: the same seed, the same bits.
        if not torch.equal(images, sampler(2, t)):
            raise AssertionError(f"{label}: two calls with one seed differ")
        for k, v in counts.items():
            launches[k] += v
        kern = ("fused_swish_depthwise5x5_bf16" if compute == "bfloat16"
                else "fused_swish_depthwise5x5")
        want = {k: 0 for k in KERNEL_NAMES}
        want[kern] = expected_launches(cfg)
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, want {want}")
        # Host clock around each call and its sync: the host's spread shows
        # between calls, so the median of MATRIX_CALLS, with the range.
        per_call = []
        for i in range(MATRIX_CALLS):
            t0 = time.monotonic()
            sampler(3 + i, t)
            torch.cuda.synchronize(device)
            per_call.append(1e3 * (time.monotonic() - t0))
        ms = float(np.median(per_call))
        dequant_ms = 0.0
        if serve == "int8":
            t0 = time.perf_counter()
            for _ in range(10):
                dequantize_params(sampler._weights)
            dequant_ms = 1e3 * (time.perf_counter() - t0) / 10
            torch.cuda.synchronize(device)
        # Card against CPU, same weights, same noise.
        card = torch.sigmoid(sampler.apply(
            lambda m: logits(m, n_cpu, t_cpu.to(device), eps)).float().cpu())
        t0 = time.monotonic()
        cpu_sampler = Sampler(rcfg, sd, n_cpu, device="cpu",
                              serve_dtype=sampler.serve_dtype)
        cpu = torch.sigmoid(cpu_sampler.apply(
            lambda m: logits(m, n_cpu, t_cpu, eps)).float())
        cpu_s = time.monotonic() - t0
        cpu_probs[(serve, compute)] = cpu
        err = float((card - cpu).abs().max())
        row = {"config": name, "serve_dtype": serve, "compute": compute,
               "launches": counts[kern], "ms_per_call": ms,
               "ms_min": min(per_call), "ms_max": max(per_call),
               "img_per_s": 1e3 * BATCH / ms,
               "weights_mb": sampler.weights_bytes / 1e6,
               "peak_call_mb": peak / 1e6, "dequant_host_ms": dequant_ms,
               "card_vs_cpu": err, "cpu_seconds": cpu_s}
        if compute == "bfloat16":
            ref = cpu_probs[(serve, "float32")]
            row["card_vs_cpu_fp32"] = float((card - ref).abs().max())
            row["cpu_bf16_vs_fp32"] = float((cpu - ref).abs().max())
            ok = (err <= BF16_PROB_ATOL and row["card_vs_cpu_fp32"]
                  <= CARD_VS_CPU_ROUNDING * row["cpu_bf16_vs_fp32"])
        else:
            ok = err <= PROB_ATOL
        log(f"matrix {label}: {counts[kern]} launches of {kern} per call, "
            f"{ms:.2f} ms per call (median of {MATRIX_CALLS}, "
            f"{row['ms_min']:.2f}-{row['ms_max']:.2f}; "
            f"{row['img_per_s']:.1f} img/s), weights "
            f"{row['weights_mb']:.2f} MB, call peak {row['peak_call_mb']:.1f} "
            f"MB, dequant host {dequant_ms:.3f} ms; card vs CPU at "
            f"B={n_cpu}: {err:.3g}"
            + (f", vs CPU fp32 compute {row['card_vs_cpu_fp32']:.3g} (CPU "
               f"bf16 vs fp32 {row['cpu_bf16_vs_fp32']:.3g})"
               if compute == "bfloat16" else "")
            + f"; CPU run {cpu_s:.1f} s")
        if not ok:
            raise AssertionError(f"{label}: card vs CPU {row}")
        rows.append(row)
        if (serve, compute) == ("bfloat16", "bfloat16"):
            kept = sampler  # profiled in phase 10
        del sampler, cpu_sampler
    return {"rows": rows, "launches": launches, "bf16_sampler": kept}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http(port: int, path: str, body=None, timeout=600.0):
    """(status, headers, bytes) of one request to the local server."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def http_json(port: int, path: str, body=None):
    return json.loads(http(port, path, body)[2])


class Server:
    """A port module serving HTTP in a subprocess that writes its launch
    counts at exit: started, waited for, stopped by SIGTERM."""

    def __init__(self, label, module, argv, workdir, port):
        self.label, self.port, self.workdir = label, port, workdir
        self.counts_path = os.path.join(workdir, f"{label}_counts.json")
        self.log_path = os.path.join(workdir, f"{label}.log")
        self.log = open(self.log_path, "w")
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            module_command(module, self.counts_path, argv), cwd=workdir,
            env=port_env(), stdout=self.log, stderr=subprocess.STDOUT)

    def output(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def wait_ready(self, timeout=600.0) -> float:
        while time.monotonic() - self.t0 < timeout:
            if self.proc.poll() is not None:
                raise AssertionError(f"{self.label} exited {self.proc.returncode}"
                                     f":\n{self.output()[-4000:]}")
            try:
                http_json(self.port, "/healthz")
                return time.monotonic() - self.t0
            except OSError:
                time.sleep(0.25)
        self.kill()
        raise AssertionError(f"{self.label}: not up in {timeout} s")

    def stop(self) -> dict:
        """SIGTERM: the server drains and exits; returns its launch counts
        and exit code."""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError(f"{self.label}: no exit after SIGTERM")
        self.log.close()
        if rc != 0:
            raise AssertionError(f"{self.label} exited {rc} after SIGTERM:\n"
                                 f"{self.output()[-4000:]}")
        with open(self.counts_path) as f:
            return {"rc": rc, "counts": json.load(f)["launches"]}

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def png_size(data: bytes):
    import struct

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    return struct.unpack(">II", data[16:24])


def serve_clients(port: int, seconds: float, seed0: int, lat: list,
                  rows: list, errors: list) -> None:
    """SERVE_CLIENTS threads, each on one HTTP/1.1 connection, sending npy
    requests back to back for ``seconds`` (the load of
    ``tools/bench_serving_http.py``); every answer checked for its shape
    and finite values, each request's latency and rows appended."""
    import http.client
    import threading

    deadline = time.monotonic() + seconds

    def client(i):
        rng = np.random.default_rng(seed0 + i)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            while time.monotonic() < deadline and not errors:
                n = int(rng.integers(1, SERVE_MAX_N + 1))
                t = SERVE_TEMPERATURES[int(rng.integers(
                    len(SERVE_TEMPERATURES)))]
                t0 = time.monotonic()
                conn.request("POST", "/sample", body=json.dumps(
                    {"n": n, "temperature": t}).encode())
                r = conn.getresponse()
                body = r.read()
                lat.append(time.monotonic() - t0)
                if r.status != 200:
                    raise AssertionError(f"HTTP {r.status}: {body[:120]!r}")
                arr = np.load(io.BytesIO(body))
                if arr.shape != (n, 32, 32, 1) or not np.isfinite(arr).all():
                    raise AssertionError(f"{arr.shape}, finite "
                                         f"{np.isfinite(arr).all()}")
                rows.append(n)
        except Exception as e:  # reported by the caller
            errors.append(e)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()


def serve_load(port: int) -> dict:
    """The serving benchmark's load: SERVE_WARMUP_S of warm-up, then
    SERVE_SECONDS timed.  Images and requests per second, request latency
    percentiles, and the dispatches and their occupancy in the window."""
    errors = []
    serve_clients(port, SERVE_WARMUP_S, 99, [], [], errors)
    before = http_json(port, "/stats")
    lat, rows = [], []
    t0 = time.monotonic()
    serve_clients(port, SERVE_SECONDS, 1000, lat, rows, errors)
    wall = time.monotonic() - t0
    after = http_json(port, "/stats")
    if errors:
        raise AssertionError(f"serve load: {errors[:3]}")
    lat_ms = np.sort(1e3 * np.asarray(lat))
    served = after["rows_served"] - before["rows_served"]
    padded = after["rows_padded"] - before["rows_padded"]
    return {"clients": SERVE_CLIENTS, "max_n": SERVE_MAX_N,
            "max_delay_ms": SERVE_MAX_DELAY_MS, "requests": len(rows),
            "rows": sum(rows), "seconds": wall,
            "img_per_s": sum(rows) / wall, "req_per_s": len(rows) / wall,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "max_ms": float(lat_ms[-1]),
            "dispatches": after["dispatches"] - before["dispatches"],
            "occupancy": served / max(1, served + padded)}


def stats_during_dispatch(port: int) -> dict:
    """F1 on the wire: one request of the largest batch, and ``GET /stats``
    polled while it is in flight.  Every poll must answer before the
    request does, and well inside its time."""
    import threading

    before = http_json(port, "/stats")
    done = {}

    def big():
        t0 = time.monotonic()
        http(port, "/sample", {"n": SERVE_BATCHES[-1], "temperature": 0.9})
        done["at"] = time.monotonic()
        done["ms"] = 1e3 * (done["at"] - t0)

    th = threading.Thread(target=big)
    th.start()
    polls = []
    while "at" not in done:
        t0 = time.monotonic()
        st = http_json(port, "/stats")
        t1 = time.monotonic()
        if "at" in done and done["at"] < t1:
            break
        polls.append((1e3 * (t1 - t0), st["dispatches"] - before["dispatches"],
                      st["requests"] - before["requests"]))
        time.sleep(0.002)
    th.join()
    in_flight = [p for p in polls if p[2] == 1]
    rec = {"request_ms": done["ms"], "polls": len(polls),
           "polls_in_flight": len(in_flight),
           "max_stats_ms": max((p[0] for p in in_flight), default=math.nan),
           "weights": st.get("weights")}
    log(f"serve /stats while a {SERVE_BATCHES[-1]}-row dispatch is in flight:"
        f" {rec['polls_in_flight']} answers, slowest "
        f"{rec['max_stats_ms']:.2f} ms, the request {rec['request_ms']:.1f} ms")
    if not in_flight or rec["max_stats_ms"] > 0.5 * rec["request_ms"]:
        raise AssertionError(f"/stats waited on the dispatch: {rec}")
    return rec


def phase_serve(workdir: str) -> dict:
    """``--mode serve`` as a user runs it, at full width over the CLI
    phase's checkpoint: int8 weights, bf16 compute, batches 144 and 576.
    Concurrent npy and PNG requests, /healthz, /stats while a dispatch is
    in flight, /reload to step 8 and to the latest, a timed load, then
    SIGTERM: it drains and exits 0, with exact launch counts of bf16 #2."""
    import threading

    from nvae_torch.config import ModelConfig

    per_call = expected_launches(ModelConfig(use_pallas_kernels=True))
    port = free_port()
    argv = ["--mode", "serve", *cli_args(workdir), "--serve_dtype", "int8",
            "--compute_dtype", "bfloat16", "--serve_batches",
            *map(str, SERVE_BATCHES), "--serve_port", str(port),
            "--serve_max_delay_ms", str(SERVE_MAX_DELAY_MS)]
    server = Server("serve", "nvae_torch.cli", argv, workdir, port)
    try:
        up = server.wait_ready()
        health = http_json(port, "/healthz")
        if health.get("batch_sizes") != list(SERVE_BATCHES):
            raise AssertionError(f"serve /healthz {health}")
        info = http_json(port, "/stats")["weights"]
        last = CLI_EPOCHS * CLI_BATCHES + CLI_BATCHES  # the resumed step
        if (info["step"], info["generation"], info["serve_dtype"]) != (
                last, 0, "int8"):
            raise AssertionError(f"serve weights {info}")
        # Concurrent npy and PNG requests.
        out = {}

        def ask(key, body):
            out[key] = http(port, "/sample", body)

        asks = [threading.Thread(target=ask, args=(
            i, {"n": 16 + 8 * i, "temperature": 0.7,
                "format": "png" if i % 2 else "npy"})) for i in range(6)]
        for th in asks:
            th.start()
        for th in asks:
            th.join()
        for i, (status, headers, body) in sorted(out.items()):
            if i % 2:
                side = int(math.isqrt(16 + 8 * i)) * 32
                if png_size(body) != (side, side):
                    raise AssertionError(f"serve png {png_size(body)}")
            elif np.load(io.BytesIO(body)).shape != (
                    16 + 8 * i, 32, 32, 1):
                raise AssertionError("serve npy shape")
        f1 = stats_during_dispatch(port)
        reloads = [http_json(port, "/reload", {"step": CLI_EPOCHS
                                               * CLI_BATCHES}),
                   http_json(port, "/reload", {})]
        if [(r["step"], r["generation"]) for r in reloads] != [
                (CLI_EPOCHS * CLI_BATCHES, 1), (last, 2)]:
            raise AssertionError(f"serve reloads {reloads}")
        load = serve_load(port)
        stats = http_json(port, "/stats")
        end = server.stop()
    finally:
        server.kill()
    want = dict.fromkeys(KERNEL_NAMES, 0)
    # One warm-up call per served batch, then one call per dispatch.
    want["fused_swish_depthwise5x5_bf16"] = per_call * (
        len(SERVE_BATCHES) + stats["dispatches"])
    if end["counts"] != want:
        raise AssertionError(f"serve launches {end['counts']}, want {want}")
    log(f"serve: up in {up:.1f} s, reloads {reloads}; load of "
        f"tools/bench_serving_http.py ({SERVE_CLIENTS} clients, n in [1, "
        f"{SERVE_MAX_N}], {SERVE_MAX_DELAY_MS} ms window) for "
        f"{load['seconds']:.2f} s: {load['requests']} requests, "
        f"{load['rows']} images, {load['img_per_s']:.1f} img/s, "
        f"{load['req_per_s']:.1f} req/s, latency p50 {load['p50_ms']:.1f} "
        f"ms, p99 {load['p99_ms']:.1f} ms, max {load['max_ms']:.1f} ms, "
        f"{load['dispatches']} dispatches at occupancy "
        f"{load['occupancy']:.4f}; stats {stats}; SIGTERM: exit "
        f"{end['rc']}, launches {end['counts']}")
    return {"up_s": up, "load": load, "f1": f1, "stats": stats,
            "counts": end["counts"]}


def phase_serving(workdir: str, device, programs: "ProgramHelper") -> dict:
    """Phases 8 and 8's NLL over the CLI phase's checkpoints: the restored
    state (``phase_restored_state``); ``--mode serve`` over HTTP (its own
    process) and the program artifacts' checks (``phase_programs``) while
    this process runs the IWAE NLL, then the weights-file artifact.
    Returns the launches of these paths."""
    t0 = time.monotonic()
    trainer = phase_restored_state(workdir, device)

    def nll_then_artifact():
        phase_nll(trainer, device)
        log("nll done")
        return phase_artifact(workdir, trainer)

    serve, _, program = run_concurrently(
        lambda: phase_serve(workdir), nll_then_artifact,
        lambda: phase_programs(programs))
    log(f"serving phase {time.monotonic() - t0:.1f} s")
    return {k: serve["counts"][k] + program["counts"][k]
            for k in KERNEL_NAMES}


PROGRAM_RUNNER = """
import json, sys, torch
import nvae_torch.kernels
from nvae_torch.kernels import depthwise as dw
path, seed, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
extra = {"nvae_torch_sampler.json": ""}
ep = torch.export.load(path, extra_files=extra)
meta = json.loads(extra["nvae_torch_sampler.json"])
dev = torch.device("cuda", 0)
if not meta["device"].startswith("cuda"):
    from torch.export.passes import move_to_device_pass
    ep = move_to_device_pass(ep, dev)
gen = torch.Generator(dev).manual_seed(seed)
eps = [torch.randn(s, generator=gen, device=dev) for s in meta["noise_shapes"]]
t = torch.full((meta["batch"],), 0.8, device=dev)
cudnn = torch.backends.cudnn
cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
cudnn.deterministic, cudnn.benchmark = True, False
with torch.inference_mode():
    images = ep.module()(t, eps)
torch.save(images.cpu(), out)
print(json.dumps({"launches": dw.launch_counts(), "modules": sorted(
    m for m in sys.modules if m.split(".")[0] == "nvae_torch")}))
"""


def png_written_natively(path: str) -> bool:
    """Whether a PNG's image data is stored deflate blocks (zlib header
    78 01), as the port's native writer writes them; the stdlib encoder
    compresses (78 9c)."""
    with open(path, "rb") as f:
        data = f.read()
    i = data.index(b"IDAT")
    return data[i + 4:i + 6] == b"\x78\x01"


def program_exports() -> list:
    """(label, export_serving flags, counted wrapper, calls) of the program
    artifacts at B=144, seeded weights, each a per-sample-temperature
    program checked with ``--check``: the default model in fp32 (traced on
    the CPU, run on the card), bf16 and int8 with bf16 compute, and the
    depthwise model in bf16 (bf16 BatchNorm apply).  ``--check`` calls the
    program and the live sampler once each (int8: and the full-precision
    sampler, for the quality line)."""
    bf16 = ["--compute_dtype", "bfloat16"]
    return [
        ("fp32", ["--export_on_cpu"], "fused_swish_depthwise5x5", 2),
        ("bf16", [*bf16, "--weights_dtype", "bfloat16"],
         "fused_swish_depthwise5x5_bf16", 2),
        ("int8", [*bf16, "--weights_dtype", "int8"],
         "fused_swish_depthwise5x5_bf16", 3),
        ("bf16 depthwise", ["--postprocess_depthwise", *bf16,
                            "--bn_apply_dtype", "bfloat16",
                            "--weights_dtype", "bfloat16"],
         "fused_swish_depthwise5x5_bf16", 2),
    ]


def program_path(workdir: str, label: str) -> str:
    return os.path.join(workdir, f"program_{label.replace(' ', '_')}.pt2")


def program_helper(workdir: str) -> int:
    """The helper process of ``ProgramHelper`` (``chip_smoke.py --programs
    DIR``): ``python -m nvae_torch.export_serving``'s ``main`` for each of
    ``program_exports`` (exported, saved, loaded on the card, held bitwise
    against the live sampler by ``--check``), for an int8 weights file at
    batch 72, and ``--load --run --save_png`` of the int8 program, each
    with its stdout and launch counts, written to ``DIR/programs.json``."""
    os.nice(10)  # the run's own phases go first
    sys.path.insert(0, ROOT)
    import contextlib

    from nvae_torch import export_serving

    common = ["--batch", str(BATCH), "--per_sample_temperature", "--check",
              "--use_pallas", "--seed", "0"]
    runs = [(label, ["--out", program_path(workdir, label), *common, *flags])
            for label, flags, _, _ in program_exports()]
    runs.append(("weights int8", [
        "--out", os.path.join(workdir, "weights_int8.pt"), "--format",
        "weights", *common[2:], "--batch", str(BATCH // 2),
        "--compute_dtype", "bfloat16", "--weights_dtype", "int8"]))
    runs.append(("load --run", [
        "--load", program_path(workdir, "int8"), "--run", "--seed", "42",
        "--temperature", "0.8", "--save_png",
        os.path.join(workdir, "program_png")]))
    recs = {}
    for label, argv in runs:
        reset_counts()
        out = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            result = export_serving.main(argv)
        torch.cuda.synchronize()
        recs[label] = {"stdout": out.getvalue(), "counts": read_counts(),
                       "seconds": time.monotonic() - t0}
        print(f"{label}: {recs[label]}", flush=True)
        if label == "load --run":
            np.save(os.path.join(workdir, "load_run.npy"), result)
    with open(os.path.join(workdir, "programs.json.tmp"), "w") as f:
        json.dump(recs, f)
    os.replace(os.path.join(workdir, "programs.json.tmp"),
               os.path.join(workdir, "programs.json"))
    return 0


class ProgramHelper:
    """The program artifacts, made by a helper process started after the
    build (``program_helper``) while this one goes on with the card: its
    work is mostly the host's (tracing, saving, loading), niced, and it
    counts its own launches.  ``records`` waits for it."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="nvae_chip_smoke_programs_")
        self.log = open(os.path.join(self.dir, "programs.log"), "w")
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--programs", self.dir], cwd=self.dir, env=port_env(),
            stdout=self.log, stderr=subprocess.STDOUT)

    def records(self, timeout: float = 900.0) -> dict:
        t0 = time.monotonic()
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = None
        self.log.flush()
        if rc != 0:
            with open(self.log.name) as f:
                raise AssertionError(f"program helper: exit {rc}:\n"
                                     f"{f.read()[-4000:]}")
        with open(os.path.join(self.dir, "programs.json")) as f:
            recs = json.load(f)
        log(f"program helper: done {time.monotonic() - self.t0:.1f} s after "
            f"its start, waited {time.monotonic() - t0:.1f} s")
        return recs

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def check_programs(recs: dict) -> dict:
    """The helper's tool runs: each program's ``--check`` passed with #2's
    launches exact by instance (14 a call, 20 in the depthwise config) and
    as many op nodes in its graph; the weights file's too; ``--load
    --run`` one call.  Returns the launches and a record per program."""
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    out = {}
    runs = [(label, name, calls, "--postprocess_depthwise" in flags)
            for label, flags, name, calls in program_exports()]
    runs += [("weights int8", "fused_swish_depthwise5x5_bf16", 3, False),
             ("load --run", "fused_swish_depthwise5x5_bf16", 1, False)]
    for label, name, calls, depthwise in runs:
        rec = recs[label]
        per_call = expected_launches(configs()["depthwise" if depthwise
                                               else "default"])
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want[name] = calls * per_call
        lines = rec["stdout"].splitlines()
        meta = next((json.loads(l) for l in lines
                     if l.startswith(('{"exported"', '{"artifact"'))), {})
        quality = [json.loads(l) for l in lines if "int8_vs_fp" in l]
        out[label] = {"seconds": rec["seconds"],
                      **{k: meta[k] for k in ("bytes", "op_nodes")
                         if k in meta}, **(quality[0] if quality else {})}
        checked = label == "load --run" or any(
            l.startswith("check OK: ") for l in lines)
        if (rec["counts"] != want or not checked
                or ("op_nodes" in meta and meta["op_nodes"] != per_call)
                or label.endswith("int8") != bool(quality)):
            raise AssertionError(f"program helper {label}: {out[label]}, "
                                 f"launches {rec['counts']}, want {want}")
        for k, v in rec["counts"].items():
            launches[k] += v
    log(f"program artifacts (the helper's tool runs): {out}")
    return {"counts": launches, "records": out}


def phase_program_runner(workdir: str) -> dict:
    """The int8 program run by a process that imports only torch and
    ``nvae_torch.kernels`` (``PROGRAM_RUNNER``): bitwise the images of the
    tool's ``--load --run`` on the same seed and temperature, whose PNGs
    (the native writer's, stored deflate) decode to their pixels."""
    from nvae_torch.utils.images import load_images_from_dir, to_uint8

    t0 = time.monotonic()
    out = os.path.join(workdir, "program_images.pt")
    proc = subprocess.run(
        [sys.executable, "-c", PROGRAM_RUNNER,
         program_path(workdir, "int8"), "42", out],
        cwd=workdir, env=port_env(), capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"program runner exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    ran = json.loads(proc.stdout.strip().splitlines()[-1])
    images = np.load(os.path.join(workdir, "load_run.npy"))
    bitwise = np.array_equal(torch.load(out).numpy(), images)
    png_dir = os.path.join(workdir, "program_png")
    files = sorted(os.listdir(png_dir))
    native = all(png_written_natively(os.path.join(png_dir, f))
                 for f in files)
    # Files are uuid-named: compare the sets of images.
    same_pixels = sorted(map(bytes, load_images_from_dir(png_dir))) == sorted(
        map(bytes, to_uint8(images)))
    counts = {k: v for k, v in ran["launches"].items() if v}
    rec = {"seconds": time.monotonic() - t0, "modules": ran["modules"],
           "launches": counts, "bitwise": bitwise, "pngs": len(files),
           "pngs_native": native, "png_pixels_equal": same_pixels}
    log(f"program runner (torch and nvae_torch.kernels only): {rec}")
    if (not bitwise or counts != {"fused_swish_depthwise5x5_bf16":
                                  expected_launches(configs()["default"])}
            or any(m.startswith(("nvae_torch.models", "nvae_torch.nn"))
                   for m in ran["modules"])
            or len(files) != BATCH or not native or not same_pixels):
        raise AssertionError(f"program runner: {rec}")
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    launches.update(ran["launches"])
    return {"counts": launches, **rec}


def phase_artifact(workdir: str, trainer) -> dict:
    """The weights-file artifact of the CLI's checkpoint with bf16 compute:
    fp32, bf16 and int8 exports and their bytes, the int8 one loaded on the
    card and checked bitwise against the live sampler (weights and
    samples)."""
    import dataclasses

    from nvae_torch.serving import (
        Sampler,
        export_sampler,
        load_artifact,
        variables_from_state,
    )

    sizes = {}
    sd = variables_from_state(trainer.state)
    cfg = dataclasses.replace(trainer.model_cfg, compute_dtype="bfloat16")
    for dtype in ("float32", "bfloat16"):
        sizes[dtype] = export_sampler(
            os.path.join(workdir, f"sampler_{dtype}.pt"), cfg, sd, BATCH,
            per_sample_temperature=True,
            serve_dtype="" if dtype == "float32" else dtype)
    path = os.path.join(workdir, "sampler_int8.pt")
    sizes["int8"] = export_sampler(path, cfg, sd, BATCH,
                                   per_sample_temperature=True,
                                   serve_dtype="int8",
                                   step=int(trainer.state.step))
    # The file serves the live sampler's weights and samples, bitwise.
    served = load_artifact(path, trainer.device)
    live = Sampler(cfg, sd, BATCH, device=trainer.device, serve_dtype="int8")
    for k, v in live._weights.items():
        w = served._weights[k]
        if not (torch.equal(v.q, w.q) and torch.equal(v.scale, w.scale)
                if hasattr(v, "q") else torch.equal(v, w)):
            raise AssertionError(f"artifact: {k} differs from the live one")
    t = torch.full((BATCH,), 0.8)
    if not torch.equal(served(42, t), live(42, t)):
        raise AssertionError("artifact: samples differ from the live ones")
    log(f"artifact: weights-file bytes {sizes} (fp32 / bf16 / int8 "
        "weights), the int8 file checked bitwise against the live sampler")
    return {"bytes": sizes}


def phase_artifact_server(workdir: str) -> dict:
    """``python -m nvae_torch.serving_http`` over the helper's int8
    program at batch 144 and int8 weights file at 72, routed by batch: one
    request on each, then SIGTERM drains it to exit 0, with exact launch
    counts."""
    port = free_port()
    server = Server("artifact", "nvae_torch.serving_http",
                    ["--artifact", program_path(workdir, "int8"),
                     "--artifact", os.path.join(workdir, "weights_int8.pt"),
                     "--port", str(port), "--max_delay_ms", "5",
                     *SERVER_FLAGS], workdir, port)
    try:
        up = server.wait_ready()
        # 100 rows: the program's batch (144); 50: the weights file's (72).
        for n in (100, 50):
            status, _, body = http(port, "/sample",
                                   {"n": n, "temperature": 0.8})
            arr = np.load(io.BytesIO(body))
            if status != 200 or arr.shape != (n, 32, 32, 1):
                raise AssertionError(f"artifact server: {status} {arr.shape}")
        stats = http_json(port, "/stats")
        end = server.stop()
    finally:
        server.kill()
    per_call = expected_launches(configs()["default"])
    want = dict.fromkeys(KERNEL_NAMES, 0)
    # A warm-up call per artifact, then one dispatch on each.
    want["fused_swish_depthwise5x5_bf16"] = 4 * per_call
    shapes = {str(BATCH // 2): 1, str(BATCH): 1}
    if (end["counts"] != want or stats["weights"]["serve_dtype"] != "int8"
            or stats["weights"].get("form") != "program"
            or stats.get("dispatch_shapes") != shapes):
        raise AssertionError(f"artifact server: {end} {stats}")
    log(f"artifact server over the int8 program (b{BATCH}) and weights "
        f"file (b{BATCH // 2}): up in {up:.1f} s, one request on each, "
        f"dispatch shapes {stats['dispatch_shapes']}; SIGTERM exit "
        f"{end['rc']}, launches {end['counts']}")
    return {"counts": end["counts"]}


def phase_programs(programs: "ProgramHelper") -> dict:
    """The program form: the helper's records (``check_programs``), then
    the bare runner and the artifact server side by side."""
    t0 = time.monotonic()
    checked = check_programs(programs.records())
    runner, server = run_concurrently(
        lambda: phase_program_runner(programs.dir),
        lambda: phase_artifact_server(programs.dir))
    launches = {k: checked["counts"][k] + runner["counts"][k]
                + server["counts"][k] for k in KERNEL_NAMES}
    log(f"program artifact checks in {time.monotonic() - t0:.1f} s")
    return {"counts": launches}


# ---- phase 8b: the metric suite (--mode test) -------------------------------


def eval_launches(cfg, attempts: int, temperatures: int,
                  fid_samples: int, batch: int = BATCH) -> int:
    """Kernel #2's launches in one ``--mode test`` run over CLI_BATCHES
    test batches of ``batch``: per temperature, each attempt's sample
    call, one sample call per test-batch half and two ``sample_with_z``
    calls (the postprocess's launches alone), and the FID batches; then
    one NLL posterior pass per test batch and attempt."""
    per_call = expected_launches(cfg)
    post = per_call - (cfg.n_total_groups - 1) * cfg.res_cells_per_group
    calls = temperatures * (attempts * (1 + 2 * CLI_BATCHES)
                            + max(fid_samples // batch, 1))
    return (per_call * (calls + CLI_BATCHES * attempts)
            + post * 2 * temperatures * attempts)


def check_evaluation(label: str, d: dict, temperatures: int,
                     pr_max: float) -> None:
    """``evaluation.json`` with the protocol's keys, every value finite,
    P&R in [0, pr_max], random-init provenance (not comparable)."""
    from nvae_torch.eval.evaluate import Metric, Metrics, ModelEvaluation

    m = Metric(0.0, 0.0)
    ref = ModelEvaluation(m, [Metrics(1.0, 0.0, m, m, m)]).to_dict()

    def shape(x):
        if isinstance(x, dict):
            return {k: shape(v) for k, v in x.items()}
        return [shape(v) for v in x[:1]] if isinstance(x, list) else None

    values = [d["nll"]["mean"], d["nll"]["stddev"]] + [
        v for r in d["sample_metrics"] for v in (
            r["fid"], *(r[k][s] for k in ("ppl", "precision", "recall")
                        for s in ("mean", "stddev")))]
    pr = [r[k]["mean"] for r in d["sample_metrics"]
          for k in ("precision", "recall")]
    if (shape(d) != shape(ref) or len(d["sample_metrics"]) != temperatures
            or not all(map(math.isfinite, values))
            or not all(0.0 <= v <= pr_max for v in pr)
            or d["feature_backbone_weights"] != "random-init"
            or d["fid_backbone_weights"] != "random-init"
            or d["feature_backbone"] != "vgg16"
            or d["fid_backbone"] != "inception"):
        raise AssertionError(f"{label}: evaluation.json {d}")


def timed_sync(fn, device):
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def phase_eval_features(device) -> dict:
    """Each backbone at its native size on the card against the CPU, on
    the same images, and the card's ms per image at a batch of 256."""
    from nvae_torch.eval.features import extract_features, get_extractor

    rng = np.random.RandomState(7)
    images = rng.rand(FEATURE_IMAGES, 32, 32, 1).astype(np.float32)
    batch = torch.from_numpy(rng.rand(256, 32, 32, 1).astype(np.float32)
                             ).to(device)
    out = {}
    for name in ("vgg16", "inception", "random_conv"):
        card_fn = get_extractor(name, device=device)
        card = extract_features(images, card_fn)
        cpu = extract_features(images, get_extractor(name, device="cpu"))
        err = float(np.linalg.norm(card - cpu) / np.linalg.norm(cpu))
        extract_features(batch, card_fn)  # warm-up
        _, secs = timed_sync(lambda: extract_features(batch, card_fn), device)
        out[name] = {"rel_l2": err, "dim": card.shape[1],
                     "ms_per_image": 1e3 * secs / 256}
        log(f"eval features {name}: card vs CPU rel L2 {err:.3g}, "
            f"{out[name]['ms_per_image']:.4f} ms per image at batch 256")
        if not err <= FEATURE_RTOL:
            raise AssertionError(f"eval features {name}: {out[name]}")
    return out


def phase_eval_pr(device) -> dict:
    """P&R at PR_ROWS x PR_ROWS x PR_DIM on the card: the full-matrix path
    against the streamed one (radii, membership flips, values), each
    timed; then card against CPU at PR_CPU_ROWS."""
    from nvae_torch.eval.precision_recall import (
        ManifoldEstimator,
        knn_precision_recall_features,
    )

    rng = np.random.RandomState(11)
    real = torch.from_numpy(rng.randn(PR_ROWS, PR_DIM).astype(np.float32))
    gen = torch.from_numpy(
        (rng.randn(PR_ROWS, PR_DIM) * 0.9 + 0.1).astype(np.float32))
    real, gen = real.to(device), gen.to(device)
    rec = {}
    members = {}
    for label, rows in (("full", PR_ROWS), ("streamed", PR_ROW_BATCH)):
        ref_m = ManifoldEstimator(real, row_batch_size=rows, device=device)
        ev_m = ManifoldEstimator(gen, row_batch_size=rows, device=device)
        members[label] = (ref_m.radii[3], ev_m.radii[3],
                          ref_m.membership(gen, 3), ev_m.membership(real, 3))
        knn_precision_recall_features(real, gen, row_batch_size=rows,
                                      device=device)  # warm-up
        secs = []
        for _ in range(PR_TIMED):
            pr, s_ = timed_sync(lambda: knn_precision_recall_features(
                real, gen, row_batch_size=rows, device=device), device)
            secs.append(s_)
        rec[label] = {"precision": pr["precision"], "recall": pr["recall"],
                      "ms": [1e3 * v for v in secs]}
    full, streamed = members["full"], members["streamed"]
    radii_err = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                    for a, b in zip(full[:2], streamed[:2]))
    flips = [int((a != b).sum()) for a, b in zip(full[2:], streamed[2:])]
    # The four fp32 products of one P&R call over the card's fp32 rate.
    bound_ms = 1e3 * 4 * 2.0 * PR_ROWS * PR_ROWS * PR_DIM / FP32_FLOP_PER_S
    rec.update({"radii_rel_err": radii_err, "membership_flips": flips,
                "bound_ms": bound_ms})
    log(f"eval P&R {PR_ROWS}x{PR_ROWS}x{PR_DIM}: full {rec['full']}, "
        f"streamed ({PR_ROW_BATCH}) {rec['streamed']}; radii rel err "
        f"{radii_err:.3g}, membership flips (precision, recall side) "
        f"{flips}; bound of the products {bound_ms:.2f} ms")
    if radii_err > 1e-5 or max(flips) > PR_STREAM_FLIPS:
        raise AssertionError(f"eval P&R: full vs streamed {rec}")

    n = PR_CPU_ROWS
    kw = dict(return_realism=True, return_neighbors=True)
    card = knn_precision_recall_features(real[:n], gen[:n], device=device,
                                         **kw)
    cpu = knn_precision_recall_features(real[:n].cpu(), gen[:n].cpu(),
                                        device="cpu", **kw)
    diff = {k: abs(card[k] - cpu[k]) * n for k in ("precision", "recall")}
    realism = float(np.max(np.abs(card["realism"] - cpu["realism"])
                           / np.abs(cpu["realism"])))
    same_nn = float(np.mean(card["nearest_neighbors"]
                            == cpu["nearest_neighbors"]))
    rec["card_vs_cpu"] = {"flips": diff, "realism_rel": realism,
                          "same_neighbors": same_nn,
                          "precision": card["precision"],
                          "recall": card["recall"]}
    log(f"eval P&R card vs CPU at {n}: {rec['card_vs_cpu']}")
    if (max(diff.values()) > PR_CPU_FLIPS or realism > 1e-4
            or same_nn < 0.999):
        raise AssertionError(f"eval P&R card vs CPU: {rec['card_vs_cpu']}")
    return rec


def phase_eval_fid(device) -> dict:
    """The fp32 device FID (two ``eigh`` on the card) against the fp64
    host FID on FID_ROWS x FID_DIM features, each timed; then the same
    device path with TF32 allowed, a control that must land outside
    FID_DEVICE_RTOL, so that the limit is shown to see a precision leak."""
    import contextlib

    from nvae_torch.eval import frechet

    rng = np.random.RandomState(13)
    mix = rng.randn(FID_DIM, FID_DIM).astype(np.float32) / FID_DIM ** 0.5
    a = rng.randn(FID_ROWS, FID_DIM).astype(np.float32)
    b = (rng.randn(FID_ROWS, FID_DIM).astype(np.float32) @ (
        np.eye(FID_DIM, dtype=np.float32) + 0.1 * mix) + 0.02)
    frechet.fid_from_features(a[:256, :64], b[:256, :64], precise=False,
                              device=device)  # warm-up of the solver
    card, card_s = timed_sync(lambda: frechet.fid_from_features(
        a, b, precise=False, device=device), device)
    t0 = time.perf_counter()
    host = frechet.fid_from_features(a, b)
    host_s = time.perf_counter() - t0

    @contextlib.contextmanager
    def tf32_math():
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        saved = cudnn.allow_tf32, matmul.allow_tf32
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        try:
            yield
        finally:
            cudnn.allow_tf32, matmul.allow_tf32 = saved

    fp32_math = frechet.fp32_math
    frechet.fp32_math = tf32_math
    try:
        control = frechet.fid_from_features(a, b, precise=False,
                                            device=device)
    finally:
        frechet.fp32_math = fp32_math
    rec = {"device": card, "host_fp64": host, "rel": abs(card - host) / host,
           "tf32_control": control,
           "tf32_control_rel": abs(control - host) / host,
           "limit_rel": FID_DEVICE_RTOL, "device_s": card_s,
           "host_s": host_s}
    log(f"eval FID {FID_ROWS}x{FID_DIM}: {rec}")
    if not rec["rel"] <= FID_DEVICE_RTOL < rec["tf32_control_rel"]:
        raise AssertionError(f"eval FID device vs host: {rec}")
    return rec


def phase_eval_fid_cli(workdir: str, device) -> dict:
    """``python -m nvae_torch.eval.fid --save_stats`` over the CLI phase's
    t_0.7 PNGs, then scoring those statistics against FID_NOISE_PNGS
    PNGs of uniform noise, with ``random_conv`` features on the card: a
    pair whose FID is far from 0 and whose covariances, unlike random-init
    VGG16's (variances below the 1e-6 jitter), carry a visible share of it.
    The printed FID is held against one computed here from the same
    statistics with ``scipy.linalg.sqrtm``, independent of the port's
    ``fid_from_stats``, at relative FID_CLI_RTOL."""
    import scipy.linalg

    from nvae_torch.eval.fid import compute_statistics_of_path
    from nvae_torch.utils.images import save_images_to_dir

    samples = os.path.join(workdir, "results", "t_0.7")
    noise = os.path.join(workdir, "noise_pngs")
    save_images_to_dir(np.random.RandomState(17).rand(
        FID_NOISE_PNGS, 32, 32, 1).astype(np.float32), noise)
    stats = os.path.join(workdir, "t07_stats.npz")
    out = {}
    for label, argv in (("save", ["--save_stats", samples, stats]),
                        ("score", [stats, noise])):
        argv += ["--backbone", "random_conv"]
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "nvae_torch.eval.fid", *argv,
             *FID_CLI_FLAGS],
            cwd=workdir, env=port_env(), capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"eval.fid {label} exited {proc.returncode}"
                                 f":\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        out[label] = {"seconds": time.monotonic() - t0,
                      "last": proc.stdout.strip().splitlines()[-1]}
    printed = float(out["score"]["last"].split()[1])
    mu1, s1 = compute_statistics_of_path(samples, "random_conv",
                                         device=device)
    mu2, s2 = compute_statistics_of_path(noise, "random_conv", device=device)
    with np.load(stats) as saved:
        stats_err = max(
            float(np.max(np.abs(saved[k] - v)) / np.max(np.abs(v)))
            for k, v in (("mu", mu1), ("sigma", s1)))
    # The reference's formula, with the port's 1e-6 jitter on each side.
    jitter = 1e-6 * np.eye(s1.shape[0])
    s1, s2 = s1.astype(np.float64) + jitter, s2.astype(np.float64) + jitter
    diff = mu1.astype(np.float64) - mu2
    reference = float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * np.trace(
        scipy.linalg.sqrtm(s1 @ s2).real))
    out.update({"printed": printed, "sqrtm_reference": reference,
                "trace_share": float(np.trace(s1) + np.trace(s2)) / reference,
                "rel": abs(printed - reference) / reference,
                "stats_err": stats_err})
    log(f"eval.fid: {out}")
    if (not out["save"]["last"].endswith("(D=512)") or stats_err > 1e-4
            or not reference > 0 or out["rel"] > FID_CLI_RTOL):
        raise AssertionError(f"eval.fid: {out}")
    return out


def phase_eval(workdir: str, device) -> dict:
    """The metric suite at full width (phase 8b): ``--mode test`` over the
    CLI phase's checkpoint, as subprocesses with exact launch counts (#2 in
    fp32 only, no #3 or #4), its evaluation.json and its stage seconds,
    the two runs and the FID command line at once (``run_concurrently``:
    the seconds they log are no measurement); then the metric functions in
    process."""
    from nvae_torch.config import ModelConfig

    cfg = ModelConfig(use_pallas_kernels=True)
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    runs = {}

    def test_run(label, extra, attempts, temps, fid_n, pr_max):
        # Each run its own evaluation.json: the two run at once.
        logs = os.path.join(workdir, label.replace(" ", "_") + "_logs")
        os.makedirs(logs)
        rec = run_cli(label, ["--mode", "test", *extra, *cli_args(workdir),
                              "--tensorboard_log_dir", logs], workdir)
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want["fused_swish_depthwise5x5"] = eval_launches(cfg, attempts, temps,
                                                         fid_n)
        if rec["counts"] != want:
            raise AssertionError(f"{label}: launches {rec['counts']}, "
                                 f"expected {want}")
        with open(os.path.join(logs, "evaluation.json")) as f:
            evaluation = json.load(f)
        check_evaluation(label, evaluation, temps, pr_max)
        stages = json.loads(
            rec["stdout"].split("Stage seconds: ")[1].splitlines()[0])
        log(f"{label}: stage seconds {stages}")
        log(f"{label}: evaluation {json.dumps(evaluation)}")
        return rec, {"seconds": rec["seconds"], "stages": stages,
                     "evaluation": evaluation}

    tests = (
        ("test", ["--eval_attempts", str(EVAL_ATTEMPTS),
                  "--fid_sample_size", str(EVAL_FID_SAMPLES)],
         EVAL_ATTEMPTS, EVAL_TEMPERATURES, EVAL_FID_SAMPLES, 1.0),
        ("test parity", ["--eval_parity", "--eval_attempts", "1",
                         "--eval_temperatures", "1.0",
                         "--fid_sample_size", str(PARITY_FID_SAMPLES)],
         1, 1, PARITY_FID_SAMPLES, 2.0))
    # The two runs side by side with the FID command line (its in-process
    # part is small), then the backbones at batch 256 here: the card holds
    # the two runs beside this process's models, not a third large one.
    torch.cuda.empty_cache()
    log(f"card memory here before the runs: "
        f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved(device) / 2**30:.2f} GiB reserved")
    *done, fid_cli = run_concurrently(
        *[functools.partial(test_run, *t) for t in tests],
        lambda: phase_eval_fid_cli(workdir, device))
    for (label, *_), (rec, run) in zip(tests, done):
        runs[label] = run
        for k, v in rec["counts"].items():
            counts[k] += v
    features = phase_eval_features(device)
    pr = phase_eval_pr(device)
    fid = phase_eval_fid(device)
    return {"runs": runs, "features": features, "pr": pr, "fid": fid,
            "fid_cli": fid_cli, "counts": counts}


# ---- phase 11: the RGB presets (the DML head, rematerialization) ------------


def rgb_configs(name: str):
    """``({label: model config}, training batch)`` of an RGB preset with
    the kernels on, in its own postprocess form and the depthwise one."""
    import dataclasses

    from nvae_torch.presets import get_preset

    cfg, tc = get_preset(name)
    cfg = dataclasses.replace(cfg, use_pallas_kernels=True)
    return {name: cfg, f"{name} depthwise": dataclasses.replace(
        cfg, postprocess_5x5_depthwise=True)}, tc.batch_size


def step_launches(cfg) -> int:
    """#2's launches in one training step: one per depthwise layer, and
    under ``remat`` one more in the backward pass, which runs each cell
    again (#3 and #4: one per layer)."""
    return expected_launches(cfg) * (2 if cfg.remat else 1)


def check_step_counts(label: str, cfg, counts: dict, steps: int) -> None:
    """``steps`` training steps' exact launches of the kernels of the
    config's compute dtype, none of any other."""
    fwd, dx, dwk = TRAIN_KERNELS[cfg.compute_dtype]
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want.update({fwd: step_launches(cfg) * steps,
                 dx: expected_launches(cfg) * steps,
                 dwk: expected_launches(cfg) * steps})
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def phase_rgb_kernels(device) -> dict:
    """#2-#4 (and #1) in fp32 against their plain versions at every shape
    of the RGB presets' paths and every batch those paths give them; each
    shape's ring geometry logged.  The worst error per kernel and (H, C)."""
    from nvae_torch.kernels import depthwise as dw

    errs: dict = {}
    for name, shapes in RGB_SHAPES.items():
        batch = rgb_configs(name)[1]
        for h, c, _, _, _ in shapes:
            for kind in ("fwd", "dx", "dw"):
                g = dw.geometry(kind, (batch, h, h, c))
                log(f"  ring {kind} float32 {batch}x{h}x{h}x{c}: "
                    f"{g.smem_bytes} B dynamic shared, {g.blocks} blocks "
                    f"({g.blocks_per_chunk} per chunk), {g.slots_per_pass} "
                    f"rows per pass, {g.ahead} passes ahead")
        fwd_batches = sorted({batch, RGB_SAMPLE_BATCH, 4 * batch, batch // 2,
                              12, 4, 3}, reverse=True)
        for k, v in checked_kernel_errors(device, shapes, fwd_batches,
                                          (batch, REMAT_BATCH)).items():
            errs.setdefault(k, {}).update(v)
    return errs


def phase_rgb_bf16_kernels(device) -> dict:
    """:func:`bf16_kernel_check` at every shape of the RGB presets' paths,
    at RGB_BF16_BATCH rows."""
    shapes = sorted({(h, c) for v in RGB_SHAPES.values()
                     for h, c, _, _, _ in v})
    return bf16_kernel_check(device, shapes, RGB_BF16_BATCH,
                             "the RGB shapes")


def phase_tp_kernels(device) -> tuple:
    """#1-#4 in fp32 (:func:`checked_kernel_errors`) and the bf16
    instances of #2-#4 (:func:`bf16_kernel_check`) against their plain
    versions at the shapes phase 14's TP step gives them: TP_ROWS rows, the
    generative cells' halves of their hidden channels.  Returns the fp32
    errors per kernel and (H, C), and the bf16 check's record."""
    errs = checked_kernel_errors(device, TP_SHAPES, (TP_ROWS,), (TP_ROWS,))
    bf16 = bf16_kernel_check(device, [(h, c) for h, c, _, _, _ in TP_SHAPES],
                             TP_ROWS, "TP's hidden slices")
    return errs, bf16


def bf16_kernel_check(device, shapes, n: int, what: str) -> dict:
    """The bf16 instances of #2, #3 and #4 against their plain versions at
    each (H, C) of ``shapes``, at ``n`` rows, with and
    without swish (swish') and bias, at the path shapes' limits: #2 and #3
    within ``BF16_SUM_ULPS`` (#3 of ``bf16_dx_scale``), at least
    ``BF16_MIN_EQUAL_SHARE`` bitwise equal where a shape has 10,000 outputs
    or more, bitwise across two runs; #4 within DW_RTOL of the largest |dW|
    (and |db|), bitwise across two runs.  Each shape's geometry logged.
    Returns the worst of each over the shapes."""
    from nvae_torch.kernels import depthwise as dw

    t0 = time.monotonic()
    out = {"fwd_err": 0.0, "fwd_sum_ulps": 0.0, "fwd_equal": 1.0,
           "dx_err": 0.0, "dx_sum_ulps": 0.0, "dx_equal": 1.0,
           "dw_err": 0.0, "shapes": []}
    for h, c in shapes:
        out["shapes"].append([n, h, h, c])
        for kind in ("fwd", "dx", "dw"):
            g = dw.geometry(kind, (n, h, h, c), "bfloat16")
            log(f"  sliding {kind} bfloat16 {n}x{h}x{h}x{c}: {g.smem_bytes} "
                f"B dynamic shared, {g.threads} threads, {g.blocks} blocks "
                f"({g.chunks_per_block} chunks each), {g.slots_per_pass} "
                f"slots per pass, {g.ahead} passes ahead")
        x, k, b = bf16_inputs(h, c, True, device, batch=n)
        g = bf16_inputs(h, c, False, device, seed=1, batch=n)[0]
        for fuse, bias in ((True, True), (True, False), (False, True),
                           (False, False)):
            bb = b if bias else None
            got = dw.fused_swish_depthwise5x5(x, k, bb, fuse_swish=fuse)
            again = dw.fused_swish_depthwise5x5(x, k, bb, fuse_swish=fuse)
            want = dw.fused_swish_depthwise5x5_plain(x, k, bb,
                                                     fuse_swish=fuse)
            a = dw.fused_swish_depthwise5x5_dw(x, g, fuse_swish=fuse,
                                               with_bias=bias)
            a2 = dw.fused_swish_depthwise5x5_dw(x, g, fuse_swish=fuse,
                                                with_bias=bias)
            dk_want, db_want = dw.fused_swish_depthwise5x5_dw_plain(
                x, g, fuse_swish=fuse)
            torch.cuda.synchronize(device)
            if not (torch.equal(got, again) and torch.equal(a[0], a2[0])
                    and (not bias or torch.equal(a[1], a2[1]))):
                raise AssertionError(f"bf16 #2/#4 {n}x{h}x{h}x{c}: two runs "
                                     "differ")
            sum_ulps = float(dw.bf16_sum_ulps(got, want, dw.bf16_sum_scale(
                x, k, bb, fuse_swish=fuse)).max())
            equal = float((bf16_ulps(got, want) == 0).float().mean())
            err = float((got.float() - want.float()).abs().max())
            scale = float(dk_want.abs().max())
            dw_err = float((a[0] - dk_want).abs().max())
            if bias:
                dw_err = max(dw_err, float((a[1] - db_want).abs().max()))
                scale = max(scale, float(db_want.abs().max()))
            log(f"kernel bf16 {n}x{h}x{h}x{c} swish={fuse} bias={bias}: #2 "
                f"max abs err {err:.3g}, {sum_ulps:.3g} fp32 ulps past one "
                f"bf16 ulp (limit {dw.BF16_SUM_ULPS}), {100 * equal:.4f}% "
                f"bitwise equal; #4 max abs err {dw_err:.3g} (limit "
                f"{DW_RTOL * scale:.3g}); both bitwise repeatable")
            if not (sum_ulps <= dw.BF16_SUM_ULPS and dw_err <= DW_RTOL * scale
                    and (got.numel() < 10_000
                         or equal >= dw.BF16_MIN_EQUAL_SHARE)):
                raise AssertionError(
                    f"bf16 #2/#4 {n}x{h}x{h}x{c}: {sum_ulps} fp32 ulps, "
                    f"{equal} equal, dW err {dw_err} of {scale}")
            out["fwd_err"] = max(out["fwd_err"], err)
            out["fwd_sum_ulps"] = max(out["fwd_sum_ulps"], sum_ulps)
            if got.numel() >= 10_000:
                out["fwd_equal"] = min(out["fwd_equal"], equal)
            out["dw_err"] = max(out["dw_err"], dw_err)
        for fuse in (True, False):
            got = dw.fused_swish_depthwise5x5_dx(g, k, x if fuse else None,
                                                 fuse_swish=fuse)
            again = dw.fused_swish_depthwise5x5_dx(
                g, k, x if fuse else None, fuse_swish=fuse)
            want = dw.fused_swish_depthwise5x5_dx_plain(g, k, x,
                                                        fuse_swish=fuse)
            torch.cuda.synchronize(device)
            if got.dtype != torch.bfloat16 or not torch.equal(got, again):
                raise AssertionError(f"bf16 #3 {n}x{h}x{h}x{c}: two runs "
                                     "differ")
            sum_ulps = float(dw.bf16_sum_ulps(got, want, dw.bf16_dx_scale(
                g, k, x, fuse_swish=fuse)).max())
            equal = float((bf16_ulps(got, want) == 0).float().mean())
            err = float((got.float() - want.float()).abs().max())
            log(f"kernel dx bf16 {n}x{h}x{h}x{c} swish'={fuse}: max abs err "
                f"{err:.3g}, {sum_ulps:.3g} fp32 ulps past one bf16 ulp "
                f"(limit {dw.BF16_SUM_ULPS}), {100 * equal:.4f}% bitwise "
                f"equal; bitwise repeatable")
            if not (sum_ulps <= dw.BF16_SUM_ULPS
                    and (got.numel() < 10_000
                         or equal >= dw.BF16_MIN_EQUAL_SHARE)):
                raise AssertionError(f"bf16 #3 {n}x{h}x{h}x{c}: {sum_ulps} "
                                     f"fp32 ulps, {equal} equal")
            out["dx_err"] = max(out["dx_err"], err)
            out["dx_sum_ulps"] = max(out["dx_sum_ulps"], sum_ulps)
            if got.numel() >= 10_000:
                out["dx_equal"] = min(out["dx_equal"], equal)
    out["seconds"] = time.monotonic() - t0
    log(f"bf16 #2-#4 at {what}: {out['seconds']:.1f} s")
    return out


def rgb_sampler_inputs(cfg) -> tuple:
    """The seeded model on the CPU (random BatchNorm statistics), the
    temperatures and the noise of ``phase_rgb_sampler``'s check."""
    from nvae_torch.models.nvae import NVAE, decoder_noise_shapes

    cpu_model = NVAE(cfg, device="cpu", seed=0)
    random_bn_stats_(cpu_model, seed=1)
    rng = np.random.RandomState(2)
    eps = [rng.randn(*sh).astype(np.float32)
           for sh in decoder_noise_shapes(cfg, 4)]
    return cpu_model, torch.tensor([0.6, 0.8, 1.0, 1.2]), eps


def cpu_sampler_refs(cfg) -> tuple:
    """The CPU side of ``phase_rgb_sampler``'s check: the head's output on
    the CPU in float32 and in float64."""
    cpu_model, t4, eps = rgb_sampler_inputs(cfg)
    with torch.inference_mode():
        cpu = logits(cpu_model, 4, t4, eps)
        f64 = logits(cpu_model.double(), 4, t4.double(), eps)
    return cpu, f64


def phase_rgb_sampler(cfg, device, weights, refs) -> dict:
    """The RGB sampler at full width over ``weights`` (a state dict), or
    over seeded weights with random BatchNorm statistics: #2's launches per
    ``sample`` call at RGB_SAMPLE_BATCH, ms per call, the images (the
    mixture's mean in [0, 1]); over the seeded weights also the card's head
    output and images against the CPU in float32 and float64 at batch 4
    with injected noise (``refs()`` returns the CPU's, ``cpu_sampler_refs``'
    record, from the helper process)."""
    from nvae_torch.kernels import depthwise as dw
    from nvae_torch.ops import dml_mean
    from nvae_torch.serving import Sampler

    cpu_model = None
    if weights is None:
        cpu_model, t4, eps = rgb_sampler_inputs(cfg)
        weights = cpu_model.state_dict()
    sampler = Sampler(cfg, weights, n_samples=RGB_SAMPLE_BATCH, device=device)
    t = torch.ones(RGB_SAMPLE_BATCH)
    before = dw.fused_swish_depthwise5x5.launches
    images = sampler(1, t).cpu().numpy()
    torch.cuda.synchronize(device)
    per_call = dw.fused_swish_depthwise5x5.launches - before
    s = cfg.image_size
    if images.shape != (RGB_SAMPLE_BATCH, s, s, 3) or not (
            np.isfinite(images).all() and images.min() >= 0.0
            and images.max() <= 1.0):
        raise AssertionError(f"rgb sampler: images {images.shape}")
    calls = 5
    torch.cuda.synchronize(device)
    t0 = time.monotonic()
    for i in range(calls):
        sampler(10 + i, t)
    torch.cuda.synchronize(device)
    ms = 1e3 * (time.monotonic() - t0) / calls
    if per_call != expected_launches(cfg):
        raise AssertionError(f"rgb sampler: {per_call} launches per call")
    if cpu_model is None:
        return {"launches_per_sample": per_call, "ms_per_call": ms}

    gpu = sampler.apply(lambda m: logits(m, 4, t4.to(device), eps)).cpu()
    cpu, f64 = refs()

    def mean(x):
        return dml_mean(x.permute(0, 2, 3, 1).double(), cfg.n_mix, 3)

    rec = {"launches_per_sample": per_call, "ms_per_call": ms,
           "logit_max_abs": float(cpu.abs().max()),
           "logit_err_cpu": float((gpu - cpu).abs().max()),
           "logit_err_f64": float((gpu.double() - f64).abs().max()),
           "image_err_cpu": float((mean(gpu) - mean(cpu)).abs().max()),
           "image_err_f64": float((mean(gpu) - mean(f64)).abs().max())}
    lim = LOGIT_RTOL * max(rec["logit_max_abs"], 1.0)
    if (not torch.isfinite(gpu).all()
            or max(rec["logit_err_cpu"], rec["logit_err_f64"]) > lim
            or max(rec["image_err_cpu"], rec["image_err_f64"]) > PROB_ATOL):
        raise AssertionError(f"rgb sampler: {rec}")
    return rec


def rgb_scan_data(cfg, device, rows: int) -> torch.Tensor:
    """``rows`` uint8 RGB rows of the config's size on the card: synthetic
    tinted strokes (``nvae_torch.data.synthetic_dataset``) from a seed."""
    from nvae_torch.data import synthetic_dataset
    from nvae_torch.train.epoch_runner import stage_dataset

    x = synthetic_dataset(n_train=rows, n_test=1, image_size=cfg.image_size,
                          channels=3, seed=5).train_x
    return stage_dataset(x, device)


def phase_rgb_scan(name: str, cfg, batch: int, device) -> dict:
    """The scan path of an RGB preset: 2 epochs of RGB_SCAN_STEPS steps at
    its batch as CUDA graph replays (the first step eager, the second
    captured): exact launches through the wrappers and as replays (a
    replay of a remat step runs #2 in the recompute too), ms per step of
    the second epoch, peak memory."""
    from nvae_torch.tools.profile_step import profile_call

    data = rgb_scan_data(cfg, device, 2 * RGB_SCAN_STEPS * batch)
    rec = scan_run(cfg, device, data, True, RGB_SCAN_STEPS, 2, batch)
    steps = 2 * RGB_SCAN_STEPS
    run = rec.pop("runner")
    del rec["flat"], data
    if (run.eager_steps, run.replays) != (1, steps - 1):
        raise AssertionError(f"scan {name}: {run.eager_steps} eager steps, "
                             f"{run.replays} replays")
    check_step_counts(f"scan {name}", cfg, rec["counts"], 2)
    check_step_counts(f"scan {name} replays", cfg,
                      {k: rec["replayed"].get(k, 0) for k in KERNEL_NAMES},
                      steps - 1)
    if not all(math.isfinite(v) for e in rec["means"] for v in e.values()):
        raise AssertionError(f"scan {name}: {rec['means']}")
    log(f"scan {name}: epochs " + ", ".join(
        f"{t:.3f}" for t in rec["epoch_seconds"])
        + f" s, last epoch {rec['ms_per_step']:.2f} ms/step ("
        f"{1e3 * batch / rec['ms_per_step']:.1f} img/s), peak memory "
        f"{rec['peak_mem_gb']:.2f} GB; per replay "
        f"{ {k: v for k, v in run.launches_per_replay.items() if v} }")
    profile_call(f"scan replay {name}", run.graph.replay)
    return rec


def phase_rgb_dw_scan(name: str, cfg, batch: int, device) -> dict:
    """The scan path of an RGB preset's depthwise form under deterministic
    cuDNN: RGB_DW_SCAN_STEPS steps at the preset's batch eagerly and as
    graph replays (the first step eager, the second captured) from the same
    seed: the two states and mean metrics bit for bit equal, exact launches
    in both runs (the postprocess's depthwise layers included, a remat
    step's recompute running #2 again).  Returns the runs' counts and the
    replayed launches."""
    import copy

    data = rgb_scan_data(cfg, device, RGB_DW_SCAN_STEPS * batch)
    # One seed-0 state (a full-width init is drawn on the host, seconds at
    # this width) and a copy of it on the card for the eager run.
    model, state, tx = scan_start(cfg, device, batch)
    twin = copy.deepcopy(state)
    with deterministic_cudnn():
        eager = scan_run(cfg, device, data, False, RGB_DW_SCAN_STEPS, 1,
                         batch, start=(twin.model, twin, tx))
        eager.pop("runner")
        del twin
        graphed = scan_run(cfg, device, data, True, RGB_DW_SCAN_STEPS, 1,
                           batch, start=(model, state, tx))
    del model, state
    run = graphed.pop("runner")
    del data
    diff = state_diff(graphed.pop("flat"), eager.pop("flat"))
    equal = graphed["means"] == eager["means"]
    log(f"scan {name}: graph vs eager over {RGB_DW_SCAN_STEPS} steps, "
        f"deterministic cuDNN: {diff}, means equal {equal}; epoch "
        f"{graphed['epoch_seconds'][0]:.3f} s (graph) / "
        f"{eager['epoch_seconds'][0]:.3f} s (eager), peak memory "
        f"{graphed['peak_mem_gb']:.2f} / {eager['peak_mem_gb']:.2f} GB; "
        f"per replay "
        f"{ {k: v for k, v in run.launches_per_replay.items() if v} }")
    if (run.eager_steps, run.replays) != (1, RGB_DW_SCAN_STEPS - 1):
        raise AssertionError(f"scan {name}: {run.eager_steps} eager steps, "
                             f"{run.replays} replays")
    check_step_counts(f"scan {name} eager", cfg, eager["counts"],
                      RGB_DW_SCAN_STEPS)
    check_step_counts(f"scan {name}", cfg, graphed["counts"], 2)
    check_step_counts(f"scan {name} replays", cfg,
                      {k: graphed["replayed"].get(k, 0)
                       for k in KERNEL_NAMES}, RGB_DW_SCAN_STEPS - 1)
    if not (diff["bitwise"] and equal) or not all(
            math.isfinite(v) for v in graphed["means"][0].values()):
        raise AssertionError(f"scan {name}: graph vs eager {diff}, "
                             f"{graphed['means']} / {eager['means']}")
    del run
    return {"counts": {k: eager["counts"][k] + graphed["counts"][k]
                       for k in KERNEL_NAMES},
            "replayed": graphed["replayed"]}


def dml_warm_start(cfg, device, batch: int, steps: int) -> dict:
    """The state dict after ``steps`` Adamax steps of ``cfg`` at ``batch``
    from seed-0 weights (``train_setup``), on the CPU; under deterministic
    cuDNN, as 12a warms its start, so every run holds the same state (with
    cuDNN's defaults two runs' states differ in their last bits, and the
    bf16 step's largest BatchNorm error from there moved between 0.89 and
    1.74 times the CPU's)."""
    with deterministic_cudnn():
        state, step = train_setup(cfg, device, batch)
        for i in range(steps):
            state, _ = step(state,
                            train_batch(batch, 2000 + i, cfg).to(device))
    return {k: v.detach().cpu() for k, v in state.model.state_dict().items()}


def check_bf16_dml_step(label: str, rec: dict) -> None:
    """The bf16 B=4 step of a DML config from DML_WARM_STEPS Adamax steps
    card vs CPU (the kernels' plain versions), each held to the fp32 step
    in float64 from there: the loss card vs CPU within BF16_LOSS_RTOL, the
    gradient and the BatchNorm statistics no further from float64 than
    CARD_VS_CPU_ROUNDING times the CPU's (phase 5's bf16 limit)."""
    card_cpu, card, cpu = (rec["bf16_card_vs_cpu"], rec["bf16_card_vs_f64"],
                           rec["bf16_cpu_vs_f64"])
    if not (card_cpu["loss_rel"] <= BF16_LOSS_RTOL
            and card["grad_rel_l2"] <= CARD_VS_CPU_ROUNDING
            * cpu["grad_rel_l2"]
            and card["bn_stats_err"] <= CARD_VS_CPU_ROUNDING
            * cpu["bn_stats_err"]):
        raise AssertionError(f"train {label} bf16: card vs CPU {rec}")


def nll_bf16_card_vs_cpu(label: str, cfg, x: torch.Tensor, device,
                         f64: float, refs) -> dict:
    """One B=4 IWAE NLL (K=3) of a bf16 config from seed-0 weights with
    injected noise on the card and on the CPU (the kernels' plain
    versions), each against ``f64``, the fp32 model's in float64 on the
    CPU on the same weights, batch and noise (``nll_card_vs_cpu``'s): the
    card within BF16_NLL_RTOL of the CPU, or no further from float64 than
    RGB_CARD_VS_CPU_ROUNDING times the CPU.  ``refs()`` returns the CPU's
    (``cpu_nll_refs``' record, from the helper process)."""
    from nvae_torch.eval.nll import make_nll_fn
    from nvae_torch.models.nvae import NVAE

    reset_counts()
    model = NVAE(cfg, device=device, seed=0)
    card = float(make_nll_fn(model, 3)(x.to(device), eps=nll_noise(cfg)))
    counts = read_counts()
    del model
    cpu = refs()[0]
    errs = nll_errors(card, cpu, f64)
    log(f"{label} B=4 card {card!r}, CPU bf16 {cpu!r}, CPU fp64 {f64!r}: "
        f"{errs}; launches {counts}")
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want["fused_swish_depthwise5x5_bf16"] = 3 * expected_launches(cfg)
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    if not (math.isfinite(card) and (
            errs["card_vs_cpu"] <= BF16_NLL_RTOL
            or errs["card_vs_f64"] <= RGB_CARD_VS_CPU_ROUNDING
            * errs["cpu_vs_f64"])):
        raise AssertionError(f"{label}: card vs CPU {errs}")
    return errs


def phase_rgb_bf16_dml(preset: str, cfg, batch: int, device) -> dict:
    """The bf16 form of an RGB preset (compute and BatchNorm apply bf16) at
    full width: RGB_STEPS training steps at its batch with exact launches
    of bf16 #2-#4 and none of fp32 (``phase_rgb_train``), then one bf16
    ``sample`` call at RGB_SAMPLE_BATCH over the trained weights (bf16 #2
    once a generative cell, images of the mixture's mean in [0, 1]).
    Returns the launches."""
    import dataclasses

    from nvae_torch.serving import Sampler

    cfg16 = dataclasses.replace(cfg, **BF16)
    label = f"{preset} bf16"
    counts, weights = phase_rgb_train(label, cfg16, batch, device,
                                      profile=False)
    sampler = Sampler(cfg16, weights, n_samples=RGB_SAMPLE_BATCH,
                      device=device)
    del weights
    reset_counts()
    t0 = time.monotonic()
    images = sampler(1, torch.ones(RGB_SAMPLE_BATCH)).cpu().numpy()
    ms = 1e3 * (time.monotonic() - t0)
    sample_counts = read_counts()
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want["fused_swish_depthwise5x5_bf16"] = expected_launches(cfg16)
    s = cfg16.image_size
    log(f"sampler {label}: {images.shape}, first call {ms:.1f} ms, "
        f"launches { {k: v for k, v in sample_counts.items() if v} }")
    if sample_counts != want or images.shape != (RGB_SAMPLE_BATCH, s, s, 3) \
            or not (np.isfinite(images).all() and images.min() >= 0.0
                    and images.max() <= 1.0):
        raise AssertionError(f"sampler {label}: {images.shape}, "
                             f"{sample_counts}")
    del sampler
    torch.cuda.empty_cache()
    return {k: counts[k] + sample_counts[k] for k in KERNEL_NAMES}


def phase_rgb_train(name: str, cfg, batch: int, device, profile: bool,
                    steps: int = RGB_STEPS) -> tuple:
    """``steps`` full-width training steps at the preset's batch with exact
    launch counts (``phase_train``), finite metrics; then, if ``profile``,
    one more step under ``torch.profiler``.  Returns (counts, the trained
    weights)."""
    rec = phase_train(cfg, device, batch, steps)
    log(f"train {name}: {steps} steps at batch {batch}, counts "
        f"{ {k: v for k, v in rec['counts'].items() if v} }, first step "
        f"{rec['first_step_ms']:.1f} ms, then {rec['ms_per_step']:.2f} "
        f"ms/step ({1e3 * batch / rec['ms_per_step']:.1f} img/s), peak "
        f"memory {rec['peak_mem_gb']:.2f} GB")
    for i, m in enumerate(rec["metrics"]):
        log(f"  step {i}: " + ", ".join(f"{k} {v:.6g}"
                                        for k, v in sorted(m.items())))
    if not rec["finite"] or rec["steps"] != steps:
        raise AssertionError(f"train {name}: non-finite metrics")
    check_step_counts(f"train {name}", cfg, rec["counts"], steps)
    if profile:
        from nvae_torch.tools.profile_step import profile_call

        x = train_batch(batch, 99, cfg).to(device)

        def one_step():
            rec["state"], _ = rec["step"](rec["state"], x)

        profile_call(f"train step {name}", one_step)
    counts, weights = rec["counts"], rec["state"].model.state_dict()
    del rec
    torch.cuda.empty_cache()
    return counts, weights


def set_remat(model, remat: bool) -> None:
    """``model``'s cells rematerialized or not, as in a model built with
    ``remat`` so: the flag its towers' ``run_cell`` calls read (the
    decoder's config, the other towers' ``remat``)."""
    import dataclasses

    model.cfg = model.decoder.cfg = dataclasses.replace(model.cfg,
                                                        remat=remat)
    for tower in (model.preprocess, model.encoder, model.postprocess):
        tower.remat = remat


def phase_remat(cfg, device) -> None:
    """One step with ``remat`` against the same step without, at batch
    REMAT_BATCH from the same weights, batch and noise, under deterministic
    cuDNN: loss, gradients and BatchNorm running statistics within
    REMAT_RTOL (a second statistics update would move them by ~5% of
    their distance to the batch's).  One model takes both steps, its
    remat switched (:func:`set_remat`) and its weights and buffers put
    back between them, and the results stay on the card: celeba64's
    second model and its gradients' host copies cost ~20 s."""
    from nvae_torch.config import TrainConfig
    from nvae_torch.models.nvae import NVAE, posterior_noise_shapes
    from nvae_torch.train import optim
    from nvae_torch.train.state import TrainState
    from nvae_torch.train.step import make_train_step

    batch = train_batch(REMAT_BATCH, 3, cfg).to(device)
    rng = np.random.RandomState(4)
    eps = [[rng.randn(*s).astype(np.float32)
            for s in posterior_noise_shapes(cfg, REMAT_BATCH)]]
    tc = TrainConfig(batch_size=REMAT_BATCH, step_based_warmup=True)
    model = NVAE(cfg, device=device, seed=0)
    model.train()
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def step_with(remat: bool):
        set_remat(model, remat)
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(start[k])
        grads = {}

        def record(updates, state, params=None):
            grads.update({k: g.detach().double()
                          for k, g in updates.items()})
            return {k: torch.zeros_like(g) for k, g in updates.items()}, state

        step = make_train_step(model, optim.GradientTransformation(
            lambda params: None, record), tc, 1000, 100)
        _, m = step(TrainState(0, 0, model, None, 0), batch, eps=eps)
        stats = {k: v.detach().double()
                 for k, v in model.state_dict().items() if "running" in k}
        return {k: float(v) for k, v in m.items()}, grads, stats

    with deterministic_cudnn():
        a = step_with(True)
        b = step_with(False)
    errs = grad_errors(a, b)
    errs["bitwise"] = (a[0] == b[0] and all(
        torch.equal(a[1][k], b[1][k]) for k in b[1]) and all(
        torch.equal(a[2][k], b[2][k]) for k in b[2]))
    log(f"remat vs no remat, one step at batch {REMAT_BATCH}: {errs}")
    if not (errs["loss_rel"] <= REMAT_RTOL
            and errs["grad_rel_l2"] <= REMAT_RTOL
            and errs["bn_stats_err"] <= REMAT_RTOL):
        raise AssertionError(f"remat vs no remat: {errs}")


def rgb_cut_configs(cfg) -> tuple:
    """The B=4 card-vs-CPU configs of a DML preset: its groups cut to
    RGB_CPU_GROUPS, in fp32 and in bf16."""
    import dataclasses

    cut = dataclasses.replace(cfg, n_groups_per_scale=RGB_CPU_GROUPS)
    return cut, dataclasses.replace(cut, **BF16)


def add_host_jobs(host: HostRefs) -> None:
    """The CPU references of phases 5 and 11, in the order they are
    needed: the B=4 steps of the MNIST configs; then, once the run opens
    the gate ``rgb`` (``open_gate``), for each RGB preset without remat
    its sampler's, its B=4 NLLs' and its B=4 steps' (those in bf16 from
    the warm start that phase 11 hands over)."""
    for name, cfg in configs().items():
        host.add(f"train {name}", cpu_step_refs, cfg=cfg,
                 bf16_cfg=bf16_configs()["depthwise bf16"]
                 if name == "depthwise" else None)
    # Not beside the entry points' subprocesses, which need the host's
    # cores: from phase 9 on (the kernels timed by CUDA events).
    host.gate("rgb")
    for preset in RGB_SHAPES:
        cfg = rgb_configs(preset)[0][preset]
        if cfg.remat:
            continue
        cut, cut16 = rgb_cut_configs(cfg)
        x4 = train_batch(4, 7, cut)
        host.add(f"rgb sampler {preset}", cpu_sampler_refs, cfg=cfg)
        host.add(f"rgb nll {preset}", cpu_nll_refs, cfg=cut, x=x4)
        host.add(f"rgb nll bf16 {preset}", cpu_nll_refs, cfg=cut16, x=x4,
                 float64=False)
        host.add(f"rgb step {preset}", cpu_step_refs, cfg=cut,
                 bf16_cfg=cut16, start=host.path(f"rgb warm {preset}"))


def phase_rgb_models(device, host: HostRefs) -> tuple:
    """The RGB presets in process at full width: per postprocess form,
    RGB_STEPS training steps at the preset's batch and a sampler at
    RGB_SAMPLE_BATCH; for ``cifar10_dml`` a B=4 step and the B=4 IWAE NLL
    card vs CPU at RGB_CPU_GROUPS; for ``celeba64`` remat against no remat
    (the preset's batch without remat, 46.6 GB at its peak, is no longer
    stepped: the whole run must end within 1200 s); the scan path of each
    preset's two forms; the CPU's side of the checks comes from ``host``
    (``add_host_jobs``' helper).  Returns the main paths' (launches,
    replayed)."""
    from nvae_torch.models.nvae import NVAE

    launches = dict.fromkeys(KERNEL_NAMES, 0)
    replayed = dict.fromkeys(KERNEL_NAMES, 0)
    t0 = time.monotonic()
    for preset in RGB_SHAPES:
        cfgs, batch = rgb_configs(preset)
        for label, cfg in cfgs.items():
            counts, weights = phase_rgb_train(label, cfg, batch, device,
                                              profile=label == preset)
            for k, v in counts.items():
                launches[k] += v
            # Seeded weights against the CPU once a preset (cifar10_dml's
            # own form), else the weights the steps left.
            seeded = label == preset and not cfg.remat
            reset_counts()
            rec = phase_rgb_sampler(
                cfg, device, None if seeded else weights,
                host.ref(f"rgb sampler {preset}"))
            for k, v in read_counts().items():
                launches[k] += v
            del weights
            log(f"sampler {label}: {rec}")
        cfg = cfgs[preset]
        if cfg.remat:
            phase_remat(cfg, device)
        else:
            cut, cut16 = rgb_cut_configs(cfg)
            label = f"{preset} groups {RGB_CPU_GROUPS}"
            # The warm start first: the helper steps from it on the CPU
            # while the card goes on.
            warm = dml_warm_start(cut, device, batch, DML_WARM_STEPS)
            host.put(f"rgb warm {preset}", warm)
            model = NVAE(cut, device=device, seed=0)
            x4 = train_batch(4, 7, cut)
            f64 = nll_card_vs_cpu(f"nll {label}", model, x4, device,
                                  host.ref(f"rgb nll {preset}"))["f64"]
            del model
            nll_bf16_card_vs_cpu(f"nll {label} bf16", cut16, x4, device, f64,
                                 host.ref(f"rgb nll bf16 {preset}"))
            for k, v in phase_rgb_bf16_dml(preset, cfg, batch,
                                           device).items():
                launches[k] += v
        log(f"{preset} in process at {time.monotonic() - t0:.1f} s")
        rec = phase_rgb_scan(preset, cfg, batch, device)
        for k in KERNEL_NAMES:
            launches[k] += rec["counts"][k]
            replayed[k] += rec["replayed"].get(k, 0)
        torch.cuda.empty_cache()
        rec = phase_rgb_dw_scan(f"{preset} depthwise",
                                cfgs[f"{preset} depthwise"], batch, device)
        for k in KERNEL_NAMES:
            launches[k] += rec["counts"][k]
            replayed[k] += rec["replayed"].get(k, 0)
        torch.cuda.empty_cache()
        log(f"{preset} scan forms at {time.monotonic() - t0:.1f} s")
        if not cfg.remat:  # the B=4 steps once the helper's are ready
            rec = phase_train_vs_cpu(cut, device,
                                     host.ref(f"rgb step {preset}"),
                                     bf16_cfg=cut16, bf16_start=warm)
            del warm
            check_train_vs_cpu(label, rec, RGB_CARD_VS_CPU_ROUNDING)
            check_bf16_dml_step(label, rec)
            log(f"{preset} B=4 steps at {time.monotonic() - t0:.1f} s")
    return launches, replayed


def rgb_cli_args(preset: str, workdir: str) -> list:
    dataset = {"cifar10_dml": "synthetic_rgb",
               "celeba64": "synthetic_rgb64"}[preset]
    return ["--preset", preset, "--dataset", dataset, "--use_pallas",
            "--debug", "--evaluate_frequency", "1", "--sample_frequency", "1",
            "--model_save_dir", os.path.join(workdir, "models"),
            "--sample_dir", os.path.join(workdir, "results"),
            "--tensorboard_log_dir", os.path.join(workdir, "logs")]


def rgb_cli_train(label: str, preset: str, workdir: str, scan: bool) -> dict:
    """``--mode train --epochs 1`` of an RGB preset (its batch, synthetic
    data, ``--debug``), per step or ``--scan_epochs``: exit code, metrics,
    the image hooks, the checkpoint and exact launches (through the
    wrappers: each step, or the scan run's eager first step and capture,
    and 4 eval, 1 sampling and 1 reconstruction forward; as replays the
    scan run's other steps)."""
    from nvae_torch.train import checkpoint as ckpt

    cfgs, _ = rgb_configs(preset)
    cfg = cfgs[preset]
    per_fwd = expected_launches(cfg)
    args = rgb_cli_args(preset, workdir) + (["--scan_epochs"] if scan else [])
    rec = run_cli(label, ["--mode", "train", "--epochs", "1",
                          "--model_save_frequency", "0", *args], workdir)
    steps = 2 if scan else CLI_BATCHES
    check_cli_counts(label, rec["counts"], per_fwd, steps, CLI_BATCHES + 2,
                     remat=cfg.remat)
    check_cli_counts(f"{label} replays", rec["replayed"], per_fwd,
                     CLI_BATCHES - 1 if scan else 0, 0, remat=cfg.remat)
    lines = read_jsonl(os.path.join(workdir, "logs", "metrics.jsonl"))
    tr = [r for r in lines if "train/loss" in r]
    if (len(tr) != 1 or not any("test/elbo" in r for r in lines) or not all(
            math.isfinite(v) for r in lines for v in r.values())):
        raise AssertionError(f"cli {label}: metrics {lines}")
    images = os.listdir(os.path.join(workdir, "logs", "images"))
    if "test_reconstruction_step0" not in images:
        raise AssertionError(f"cli {label}: image dirs {sorted(images)}")
    if ckpt.all_steps(os.path.join(workdir, "models")) != [CLI_BATCHES]:
        raise AssertionError(f"cli {label}: checkpoints")
    rec["metrics"] = lines
    return rec


def phase_rgb_cli(workdir: str, device) -> tuple:
    """The entry points on the RGB presets at full width, as subprocesses
    with exact launch counts, three chains at once (``run_concurrently``):
    ``cifar10_dml`` trains 1 epoch and scores (``--mode test --debug
    --eval_attempts 1``, EVAL_FID_SAMPLES), then in process one request
    goes through a ``BatchingSampler`` over its checkpoint; beside the
    scoring, ``--mode sample`` (RGB PNGs) over the same checkpoint;
    meanwhile ``cifar10_dml`` and ``celeba64`` (remat) train 1 epoch each
    on the scan path (a CUDA graph of the remat'd step).  celeba64's step
    through the CLI is its scan run's: its per-step loop is phase 11's in
    process, and the CLI's per-step loop is cifar10_dml's.  Each run's
    directory is removed after its checks (a celeba64 checkpoint holds
    ~8.5 GB).  Returns the runs' (launches, replayed)."""
    from nvae_torch import cli
    from nvae_torch.serving import Sampler, variables_from_state
    from nvae_torch.serving_runtime import BatchingSampler
    from nvae_torch.train.trainer import Trainer
    from nvae_torch.utils.images import decode_png

    counts = dict.fromkeys(KERNEL_NAMES, 0)
    replayed = dict.fromkeys(KERNEL_NAMES, 0)
    lock = threading.Lock()
    cfgs, batch = rgb_configs("cifar10_dml")
    cfg = cfgs["cifar10_dml"]
    wd = os.path.join(workdir, "cifar10_dml")
    os.makedirs(wd)
    args = rgb_cli_args("cifar10_dml", wd)
    trained = threading.Event()  # cifar10_dml's train run has ended

    def add(rec):
        with lock:
            for k in KERNEL_NAMES:
                counts[k] += rec["counts"][k]
                replayed[k] += rec["replayed"][k]

    def cifar10_dml() -> None:
        try:
            rec = rgb_cli_train("train cifar10_dml", "cifar10_dml", wd, False)
        finally:
            trained.set()
        add(rec)
        report_cli(rec, batch)
        logs = os.path.join(wd, "test_logs")
        os.makedirs(logs)
        rec = run_cli("test cifar10_dml", [
            "--mode", "test", "--eval_attempts", "1", "--fid_sample_size",
            str(EVAL_FID_SAMPLES), *args, "--tensorboard_log_dir", logs], wd)
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want["fused_swish_depthwise5x5"] = eval_launches(
            cfg, 1, EVAL_TEMPERATURES, EVAL_FID_SAMPLES, batch)
        if rec["counts"] != want:
            raise AssertionError(f"cli test cifar10_dml: launches "
                                 f"{rec['counts']}, expected {want}")
        add(rec)
        with open(os.path.join(logs, "evaluation.json")) as f:
            check_evaluation("test cifar10_dml", json.load(f),
                             EVAL_TEMPERATURES, 1.0)
        log(f"test cifar10_dml: {rec['seconds']:.1f} s")

        # One request through the batching server over the checkpoint, in
        # this process (its own counts: the subprocesses have theirs).
        parsed = cli.parse_args(["--mode", "serve", *args])
        model_cfg, train_cfg, _ = cli.configs_from_args(parsed)
        trainer = Trainer(model_cfg, train_cfg, CLI_BATCHES, device=device)
        if trainer.maybe_resume() != 1:
            raise AssertionError("serve cifar10_dml: no checkpoint to "
                                 "restore")
        sampler = Sampler(model_cfg, variables_from_state(trainer.state),
                          RGB_SAMPLE_BATCH, device=device)
        del trainer
        n = 2 * RGB_SAMPLE_BATCH // 3  # a partial batch, padded
        reset_counts()
        with BatchingSampler(sampler, RGB_SAMPLE_BATCH, max_delay_ms=10,
                             seed=7) as srv:
            images = srv.submit(n, 0.8).result(timeout=600)
        served = read_counts()
        if (images.shape != (n, 32, 32, 3) or not np.isfinite(images).all()
                or served["fused_swish_depthwise5x5"]
                != expected_launches(cfg)):
            raise AssertionError(f"serve cifar10_dml: {images.shape}, "
                                 f"{served}")
        add({"counts": served, "replayed": dict.fromkeys(KERNEL_NAMES, 0)})
        log(f"serve cifar10_dml: {n} rows in one dispatch, launches "
            f"{ {k: v for k, v in served.items() if v} }")
        del sampler

    def cifar10_dml_sample() -> None:
        trained.wait()
        rec = run_cli("sample cifar10_dml", [
            "--mode", "sample", "--n_samples", str(batch), *args,
            "--tensorboard_log_dir", os.path.join(wd, "sample_logs")], wd)
        check_cli_counts("sample cifar10_dml", rec["counts"],
                         expected_launches(cfg), 0, 1)
        add(rec)
        for t in SAMPLE_TEMPERATURES:
            d = os.path.join(wd, "results", f"t_{t}")
            files = sorted(f for f in os.listdir(d) if f.endswith(".png"))
            with open(os.path.join(d, files[0]), "rb") as f:
                shape = decode_png(f.read()).shape
            if len(files) != batch or shape != (32, 32, 3):
                raise AssertionError(f"cli sample cifar10_dml: {len(files)} "
                                     f"PNGs of {shape} in {d}")

    def the_scan_trains() -> None:
        for preset in ("cifar10_dml", "celeba64"):
            label = f"train {preset} scan"
            run_wd = os.path.join(workdir, label.replace(" ", "_"))
            os.makedirs(run_wd)
            rec = rgb_cli_train(label, preset, run_wd, True)
            add(rec)
            report_cli(rec, rgb_configs(preset)[1])
            shutil.rmtree(run_wd, ignore_errors=True)

    torch.cuda.empty_cache()  # the subprocesses need the card's memory
    run_concurrently(cifar10_dml, cifar10_dml_sample, the_scan_trains)
    shutil.rmtree(wd, ignore_errors=True)
    return counts, replayed


def phase_rgb_timing(device) -> dict:
    """#2, #3 and #4 (and #1) at each RGB path shape at the preset's
    training batch, timed as phase 9 times them at MNIST's (kernel, plain
    version, library call, bound) over RGB_TIMING_ITERS calls.  Rows by
    kernel, one per shape, with its calls per forward in each form."""
    rows = {k: [] for k in TRAIN_KERNELS["float32"]}
    for preset, shapes in RGB_SHAPES.items():
        batch = rgb_configs(preset)[1]
        fwd = phase_forward_timing(device, shapes, batch, RGB_TIMING_ITERS)
        bwd = phase_backward_timing(device, shapes, batch, RGB_TIMING_ITERS)
        for (_, _, _, calls, dw_calls), f, b in zip(shapes, fwd, bwd):
            for name, r in zip(rows, (f["fused"], b["dx"], b["dw"])):
                b_bytes, b_ops = r["bound"]
                rows[name].append({
                    "preset": preset, "shape": f["shape"],
                    "calls": {"default": calls, "depthwise": dw_calls},
                    **{k: r[k] for k in ("ms", "eager_ms", "plain_ms",
                                         "library_ms")},
                    "bound_ms": max(b_bytes, b_ops),
                    "bound_by": "bytes" if b_bytes >= b_ops
                    else "operations"})
    return rows


# ---- phase 12: data parallelism -------------------------------------------

DP_RANKS = 2
DP_STEPS = 2  # cut from 3: the whole run must end in 1200 s
# 12a holds the data-parallel step against the single one from a state
# warmed by DP_WARM_STEPS Adamax steps, stepping with plain SGD at DP_LR.
# From the seeded init the full-width fp32 step is chaotic: the single run
# on its batches with the halves swapped (the same function summed in
# another order) moves step 0's loss by 1.7e-5 and grad_norm by 1.8e-2,
# and the third step's loss by 2.6x; from the warm state, no step's loss
# by more than 6.3e-8, grad_norm by 2.4e-5, a parameter by 1.2e-7
# (``chip_dp_probe.py`` on an H100 80GB HBM3 at 700 W).  There JAX's
# lockstep limits hold as they are, at every step.
DP_WARM_STEPS = 30
DP_LR = 1e-6
DP_LOSS_RTOL, DP_GRAD_NORM_RTOL, DP_PARAMS_ATOL = 1e-5, 1e-4, 1e-5
# Planted faults, each run for one step on the ranks and each of which must
# fail a limit: the BatchNorm statistics or the KL balancing coefficients
# left per rank (loss 2.5e-2 and 1.3e-2 from the single run there).
DP_FAULTS = ("bn_stats_per_rank", "kl_coeff_per_rank")
DP_ALLREDUCE_ITERS = 3
DP_SERVE_TEMPERATURES = (0.7, 1.0)
DP_SERVE_ATOL = PROB_ATOL  # if not bitwise: another cuDNN plan per batch
# Phase 12d (FSDP).  12d-1 runs on 12a's ranks: SGD with the spectral
# projection (sigma, a property of the whole kernel, on the path) from the
# same warm start, re-sharded at JAX's tests' min_size, so that every conv
# kernel shards, the depthwise taps among them, against the single run
# with the same optimizer, at 12a's limits; the planted fault takes sigma
# (and u) from each rank's own block of a kernel.
FSDP_TEST_MIN = 64
FSDP_FAULT = "sigma_from_local_shard"
FSDP_COLLECTIVE_ITERS = 3


def dp_env(port: int, rank=None, world: int = DP_RANKS) -> dict:
    """``world`` ranks on the one card: gloo (NCCL refuses two ranks on
    one device), the coordinator at ``localhost:port``."""
    env = dict(port_env(), NVAE_TORCH_DIST_BACKEND="gloo")
    if rank is not None:
        env.update(NVAE_TORCH_COORDINATOR=f"localhost:{port}",
                   NVAE_TORCH_NUM_PROCESSES=str(world),
                   NVAE_TORCH_PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
    return env


class SGDSteps:
    """Plain SGD steps (``p -= DP_LR * g``, a linear update, so the
    parameters track the gradients) of the default configuration at
    global batch BATCH from a saved start, on one model reloaded for each
    run; over a ``mesh`` each rank steps on its rows of every batch.
    ``spectral`` chains the default spectral projection after the SGD
    update (sigma of each whole kernel on the path: 12d); ``fsdp_min``
    holds the state in the FSDP layout at that ``min_size``, on a model
    built anew for each run (its parameters become shards)."""

    def __init__(self, device, mesh=None, spectral: bool = False,
                 fsdp_min=None):
        from nvae_torch.config import TrainConfig
        from nvae_torch.models.nvae import NVAE
        from nvae_torch.nn.spectral import sn_kernel_names
        from nvae_torch.train import optim as topt

        self.cfg = configs()["default"]
        self.tc = TrainConfig(batch_size=BATCH, step_based_warmup=True)
        self.tx = topt.GradientTransformation(
            lambda params: None,
            lambda updates, state, params=None: (
                {k: -DP_LR * g for k, g in updates.items()}, None))
        if spectral:
            self.tx = topt.chain(self.tx, topt.spectral_projection(
                sn_kernel_names(NVAE(self.cfg, device="meta"))))
        self.device, self.mesh, self.fsdp_min = device, mesh, fsdp_min
        self.model = self._model()

    def _model(self):
        from nvae_torch.train.state import create_train_state

        model, _, _ = create_train_state(self.cfg, self.tc, 1000,
                                         device=self.device, tx=self.tx)
        return model

    def run(self, start: dict, steps: int, swap: bool = False) -> dict:
        """``steps`` steps from ``start`` (a state dict and a step count)
        on ``train_batch(BATCH, 10 +
        i)``; ``swap`` swaps each batch's halves and the noise's with them.
        Returns each step's metrics, the flat parameters after each step
        (on the host, whole), ms per step, the run's peak allocated MB and
        the state."""
        from nvae_torch.models.nvae import posterior_noise_shapes
        from nvae_torch.parallel import (shard_batch, shard_state,
                                         shard_state_fsdp)
        from nvae_torch.parallel.mesh import whole
        from nvae_torch.train.state import TrainState
        from nvae_torch.train.step import make_train_step, step_seed

        if self.fsdp_min is not None:
            self.model = None
            torch.cuda.empty_cache()
            self.model = self._model()
        self.model.load_state_dict(start["sd"])
        state = TrainState(start["step"], 0, self.model, self.tx.init(
            dict(self.model.named_parameters())), 0)
        if self.fsdp_min is not None:
            state = shard_state_fsdp(state, self.mesh, self.fsdp_min)
        elif self.mesh is not None:
            state = shard_state(state, self.mesh)
        step = make_train_step(self.model, self.tx, self.tc, 1000, 100,
                               mesh=self.mesh)
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        out = {"metrics": [], "params": [], "ms": []}
        for i in range(steps):
            b = train_batch(BATCH, 10 + i).to(self.device)
            eps = None
            if swap:
                gen = torch.Generator(device=self.device).manual_seed(
                    step_seed(state.seed, state.step, 0))
                perm = torch.arange(BATCH).roll(BATCH // 2).to(self.device)
                b = b[perm]
                eps = [[torch.randn(sh, generator=gen,
                                    device=self.device)[perm]
                        for sh in posterior_noise_shapes(self.cfg, BATCH)]]
            if self.mesh is not None:
                b = shard_batch(b, self.mesh)
            out["rows"] = b.shape[0]
            t0 = time.monotonic()
            state, m = step(state, b, eps=eps)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["ms"].append(1e3 * (time.monotonic() - t0))
            with torch.no_grad():
                out["params"].append(torch.cat([
                    p.reshape(-1)
                    for p in whole(list(self.model.parameters()))]).cpu())
        out["peak_mb"] = torch.cuda.max_memory_allocated(self.device) / 1e6
        out["state"] = state
        return out


class dp_fault:
    """A planted fault of the data-parallel step, while the block is open:
    ``bn_stats_per_rank`` leaves the BatchNorm statistics to each rank's
    rows, ``kl_coeff_per_rank`` the KL balancing coefficients."""

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        import contextlib

        import nvae_torch.train.losses as losses
        import nvae_torch.train.step as step

        self.saved = (step.batch_stats_over, losses.balanced_kl_loss)
        if self.kind == "bn_stats_per_rank":
            step.batch_stats_over = lambda m, mesh: contextlib.nullcontext()
        else:
            kl = losses.balanced_kl_loss
            losses.balanced_kl_loss = lambda k, a, mesh=None: kl(k, a)

    def __exit__(self, *exc):
        import nvae_torch.train.losses as losses
        import nvae_torch.train.step as step

        step.batch_stats_over, losses.balanced_kl_loss = self.saved


class fsdp_sigma_fault:
    """The planted fault of the FSDP step, while the block is open: the
    spectral projection takes sigma (and u) from each rank's own block of
    a kernel, a power iteration on its shard with its block of u, not on
    the whole kernel."""

    def __enter__(self):
        import nvae_torch.train.optim as optim

        self.saved = (optim.whole, optim.power_iteration)
        real = optim.power_iteration

        def local(w2d, u):
            n = w2d.shape[1]
            if n == u.shape[0]:
                return real(w2d, u)
            mine = slice(torch.distributed.get_rank() * n,
                         (torch.distributed.get_rank() + 1) * n)
            sigma, u_block = real(w2d, u[mine])
            u = u.clone()
            u[mine] = u_block
            return sigma, u

        optim.whole = lambda tensors, specs=None: list(tensors)
        optim.power_iteration = local

    def __exit__(self, *exc):
        import nvae_torch.train.optim as optim

        optim.whole, optim.power_iteration = self.saved


def fsdp_state_mb(mesh, device) -> dict:
    """MB a rank holds at rest of the default configuration's train state
    (Adamax and the spectral projection, no EMA) in the replicated layout
    and in the FSDP layout at the default min_size: the whole state
    (``parallel.mesh.state_bytes``: buffers, u and counters too) and the
    parameters with their two Adamax moments alone (three tensors of each
    parameter's shape, as the prediction counts them)."""
    from nvae_torch.config import TrainConfig
    from nvae_torch.parallel import shard_state, shard_state_fsdp
    from nvae_torch.parallel.mesh import state_bytes
    from nvae_torch.train.state import create_train_state

    out = {}
    for layout, shard in (("replicated", shard_state),
                          ("fsdp", shard_state_fsdp)):
        _, state, _ = create_train_state(
            configs()["default"], TrainConfig(batch_size=BATCH), 1000,
            device=device, seed=0)
        state = shard(state, mesh)
        params = sum(p.numel() * p.element_size()
                     for p in state.model.parameters())
        out[layout] = {"state_mb": state_bytes(state) / 1e6,
                       "params_moments_mb": 3 * params / 1e6}
        del state
    torch.cuda.empty_cache()
    return out


def fsdp_rank(start: dict, mesh, device, params: dict) -> dict:
    """12d-1 on one of 12a's ranks, under deterministic cuDNN: DP_STEPS
    SGD steps with the spectral projection from 12a's warm start in the
    replicated layout, then in the FSDP layout at FSDP_TEST_MIN (the
    counts set to 0 just before and read just after), then one step with
    the planted fault; the gloo all-gather of the sharded parameters and
    the reduce-scatter of their gradients' bytes timed; the state's MB at
    rest in both layouts at the default min_size.  Puts each run's last
    parameters in ``params``."""
    from nvae_torch.parallel.mesh import replica_mismatches, shard_of, whole

    t0 = time.monotonic()
    rep = SGDSteps(device, mesh, spectral=True).run(start, DP_STEPS)
    out = {"replicated": {"metrics": rep["metrics"], "step_ms": rep["ms"],
                          "peak_mb": rep["peak_mb"]}}
    params["fsdp replicated"] = rep["params"][-1]
    del rep
    runs = SGDSteps(device, mesh, spectral=True, fsdp_min=FSDP_TEST_MIN)
    torch.cuda.synchronize(device)
    reset_counts()
    sound = runs.run(start, DP_STEPS)
    out["counts"] = read_counts()
    out.update(metrics=sound["metrics"], step_ms=sound["ms"],
               peak_mb=sound["peak_mb"], rows=sound["rows"],
               mismatches=replica_mismatches(sound["state"], mesh))
    params["fsdp"] = sound["params"][-1]
    del sound
    ps = list(runs.model.parameters())
    shards = [p for p in ps if shard_of(p) is not None]
    n = sum(p.numel() for p in shards)
    out.update(sharded=len(shards), tensors=len(ps),
               sharded_elements=n * mesh.size,
               elements=sum(p.numel() for p in ps) + n * (mesh.size - 1),
               collective_mb=4 * n * mesh.size / 1e6)
    with torch.no_grad():
        whole(shards)
        torch.cuda.synchronize(device)
        t = time.monotonic()
        for _ in range(FSDP_COLLECTIVE_ITERS):
            whole(shards)
        torch.cuda.synchronize(device)
        out["all_gather_ms"] = 1e3 * (time.monotonic() - t) / \
            FSDP_COLLECTIVE_ITERS
        packed = torch.zeros(n * mesh.size, device=device)
        mine = torch.empty(n, device=device)
        mesh.reduce_scatter_mean_(mine, packed)
        torch.cuda.synchronize(device)
        t = time.monotonic()
        for _ in range(FSDP_COLLECTIVE_ITERS):
            mesh.reduce_scatter_mean_(mine, packed)
        torch.cuda.synchronize(device)
        out["reduce_scatter_ms"] = 1e3 * (time.monotonic() - t) / \
            FSDP_COLLECTIVE_ITERS
    del ps, shards, packed, mine
    with fsdp_sigma_fault():
        bad = runs.run(start, 1)
    out["fault"] = {"metrics": bad["metrics"]}
    params[FSDP_FAULT] = bad["params"][-1]
    del bad
    runs.model = None
    torch.cuda.empty_cache()
    out["state_mb"] = fsdp_state_mb(mesh, device)
    out["seconds"] = time.monotonic() - t0
    return out


def dp_rank(workdir: str) -> int:
    """One rank of phase 12a (``chip_smoke.py --dp-rank DIR``, its rank and
    coordinator in the environment), under deterministic cuDNN: once the
    warm start is in ``workdir`` (the rank starts while the phase makes
    it), DP_STEPS SGD steps over the gloo group from it, its rows of each
    batch, with the counts set to 0 just before and read just after; one
    step with each planted fault; 12d-1 (:func:`fsdp_rank`); then the
    all-reduce of a gradient's bytes timed.  Writes its record (and rank 0
    its parameters) to ``workdir``."""
    sys.path.insert(0, ROOT)
    from nvae_torch.parallel import initialize, make_mesh
    from nvae_torch.parallel.mesh import checksums, replica_mismatches
    from nvae_torch.parallel.mesh import state_tensors_named

    initialize()
    mesh = make_mesh()
    device = mesh.device
    runs = SGDSteps(device, mesh)
    start = wait_for_file(os.path.join(workdir, "dp_start.pt"), torch.load,
                          timeout=600)
    with deterministic_cudnn():
        torch.cuda.synchronize(device)
        reset_counts()
        sound = runs.run(start, DP_STEPS)
        counts = read_counts()
        state = sound["state"]
        rec = {"rank": mesh.rank, "device": str(device),
               "rows": sound["rows"], "counts": counts,
               "metrics": sound["metrics"], "step_ms": sound["ms"],
               "mismatches": replica_mismatches(state, mesh),
               "checksums": checksums(list(state_tensors_named(
                   state).values())).tolist()}
        params = {"sound": sound["params"][-1]}
        del sound, state
        rec["faults"] = {}
        for kind in DP_FAULTS:
            with dp_fault(kind):
                r = runs.run(start, 1)
            rec["faults"][kind] = {
                "metrics": r["metrics"],
                "mismatches": len(replica_mismatches(r["state"], mesh))}
            params[kind] = r["params"][-1]
            del r
        runs.model = None
        torch.cuda.empty_cache()
        rec["fsdp"] = fsdp_rank(start, mesh, device, params)
    grad = torch.ones(params["sound"].numel(), device=device)
    mesh.all_reduce_(grad)
    torch.cuda.synchronize(device)
    t0 = time.monotonic()
    for _ in range(DP_ALLREDUCE_ITERS):
        mesh.all_reduce_(grad)
    torch.cuda.synchronize(device)
    rec["allreduce_bytes"] = 4 * grad.numel()
    rec["allreduce_ms"] = 1e3 * (time.monotonic() - t0) / DP_ALLREDUCE_ITERS
    if mesh.rank == 0:
        torch.save(params, os.path.join(workdir, "dp_rank0_params.pt"))
    with open(os.path.join(workdir, f"dp_rank{mesh.rank}.json"), "w") as f:
        json.dump(rec, f)
    mesh.barrier()
    torch.distributed.destroy_process_group()
    return 0


def dp_readings(metrics: list, params, single: dict) -> dict:
    """How far a run is from the single one: each step's loss and
    grad_norm relative to the single run's, and its parameters after its
    last step (the largest absolute difference)."""
    n = len(metrics)
    return {
        "loss": [abs(m["loss"] - s["loss"]) / abs(s["loss"])
                 for m, s in zip(metrics, single["metrics"])],
        "grad_norm": [abs(m["grad_norm"] - s["grad_norm"]) / s["grad_norm"]
                      for m, s in zip(metrics, single["metrics"])],
        "params": float((params - single["params"][n - 1]).abs().max())}


def dp_over_limits(r: dict) -> list:
    """The limits a run's readings break."""
    return [k for k, bad in (
        ("loss", max(r["loss"]) > DP_LOSS_RTOL),
        ("grad_norm", max(r["grad_norm"]) > DP_GRAD_NORM_RTOL),
        ("params", r["params"] > DP_PARAMS_ATOL)) if bad]


def phase_dp_steps(device, workdir: str, meanwhile=None) -> dict:
    """12a: two ranks on the one card over gloo against DP_STEPS single SGD
    steps here, from the same warm start, on the same batches and noise,
    all under deterministic cuDNN: every step's loss and grad_norm and the
    parameters at JAX's lockstep limits; the single run on its batches with
    the halves swapped (a sound reordering) within them too, and each
    planted fault outside them; both ranks' states equal bit for bit and
    exactly 14 launches of each of #2, #3 and #4 per step on each rank.
    ``meanwhile()``, if given, runs here once the references are done,
    while the ranks step; its result is the record's ``meanwhile``."""
    cfg = configs()["default"]
    # The ranks start up meanwhile, and wait for the start.
    port = free_port()
    logs = [open(os.path.join(workdir, f"dp_rank{r}.log"), "w")
            for r in range(DP_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--dp-rank",
         workdir], cwd=workdir, env=dp_env(port, r), stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(DP_RANKS)]
    try:
        with deterministic_cudnn():
            state, step = train_setup(cfg, device, BATCH)
            for i in range(DP_WARM_STEPS):
                state, _ = step(state,
                                train_batch(BATCH, 1000 + i).to(device))
            start = {"sd": {k: v.detach().cpu() for k, v in
                            state.model.state_dict().items()},
                     "step": state.step}
            del state, step
        path = os.path.join(workdir, "dp_start.pt")
        torch.save(start, path + ".tmp")
        os.replace(path + ".tmp", path)
        # The references while the ranks step.
        with deterministic_cudnn():
            runs = SGDSteps(device)
            single = runs.run(start, DP_STEPS)
            swapped = runs.run(start, DP_STEPS, swap=True)
            del runs, single["state"], swapped["state"]
            # 12d-1's references: the same steps with the projection.
            runs = SGDSteps(device, spectral=True)
            single_sn = runs.run(start, DP_STEPS)
            swapped_sn = runs.run(start, DP_STEPS, swap=True)
        del runs, single_sn["state"], swapped_sn["state"]
        torch.cuda.empty_cache()
        later = meanwhile() if meanwhile is not None else None
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rcs):
        tails = [open(f.name).read()[-3000:] for f in logs]
        raise AssertionError(f"dp ranks exited {rcs}:\n" + "\n".join(tails))
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(workdir, f"dp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    want = dict.fromkeys(KERNEL_NAMES, 0)
    for k in TRAIN_KERNELS["float32"]:
        want[k] = expected_launches(cfg) * DP_STEPS
    for rec in ranks:
        if rec["counts"] != want:
            raise AssertionError(f"dp rank {rec['rank']}: launches "
                                 f"{rec['counts']}, expected {want}")
        if rec["mismatches"] or rec["rows"] != BATCH // DP_RANKS:
            raise AssertionError(f"dp rank {rec['rank']}: {rec}")
    if ranks[0]["checksums"] != ranks[1]["checksums"] or (
            ranks[0]["metrics"] != ranks[1]["metrics"]):
        raise AssertionError("dp: the ranks' states or metrics differ")
    params = torch.load(os.path.join(workdir, "dp_rank0_params.pt"))
    readings = {
        "dp": dp_readings(ranks[0]["metrics"], params["sound"], single),
        "halves swapped": dp_readings(swapped["metrics"],
                                      swapped["params"][-1], single),
        **{kind: dp_readings(ranks[0]["faults"][kind]["metrics"],
                             params[kind], single) for kind in DP_FAULTS}}
    for name, r in readings.items():
        log(f"dp 12a {name} vs single, per step: loss "
            + ", ".join(f"{x:.3g}" for x in r["loss"]) + "; grad_norm "
            + ", ".join(f"{x:.3g}" for x in r["grad_norm"])
            + f"; parameters {r['params']:.3g} (limits {DP_LOSS_RTOL}, "
            f"{DP_GRAD_NORM_RTOL}, {DP_PARAMS_ATOL}): over "
            f"{dp_over_limits(r) or 'none'}")
    for name in ("dp", "halves swapped"):
        if dp_over_limits(readings[name]):
            raise AssertionError(f"dp 12a: {name} vs the single run "
                                 f"{readings[name]}")
    for kind in DP_FAULTS:
        if not dp_over_limits(readings[kind]):
            raise AssertionError(f"dp 12a: the planted fault {kind} passes "
                                 f"the limits {readings[kind]}")
    fsdp = check_fsdp_ranks(ranks, params, single_sn, swapped_sn, want)
    log(f"dp 12a: {DP_RANKS} ranks on {ranks[0]['device']} over gloo, "
        f"{DP_STEPS} SGD steps of {BATCH} rows ({BATCH // DP_RANKS} a rank) "
        f"from {DP_WARM_STEPS} Adamax steps: ms per step "
        f"{[round(x, 2) for x in ranks[0]['step_ms']]} (two ranks sharing "
        f"one card: no scaling measured); gloo all-reduce of "
        f"{ranks[0]['allreduce_bytes'] / 1e6:.1f} MB "
        f"{ranks[0]['allreduce_ms']:.2f} ms; losses "
        + ", ".join(f"{a['loss']:.9g} vs {b['loss']:.9g}" for a, b in
                    zip(ranks[0]["metrics"], single["metrics"]))
        + "; grad_norms "
        + ", ".join(f"{a['grad_norm']:.9g} vs {b['grad_norm']:.9g}" for a, b
                    in zip(ranks[0]["metrics"], single["metrics"]))
        + "; tensors differing across the ranks under each fault "
        + str({k: ranks[0]["faults"][k]["mismatches"] for k in DP_FAULTS})
        + f"; per-rank launches {ranks[0]['counts']}")
    return {"ranks": ranks, "readings": readings, "fsdp": fsdp,
            "counts": {k: sum(r["counts"][k] + r["fsdp"]["counts"][k]
                              for r in ranks) for k in KERNEL_NAMES},
            "meanwhile": later}


def check_fsdp_ranks(ranks: list, params: dict, single: dict,
                     swapped: dict, want: dict) -> dict:
    """12d-1's checks of the ranks' records: each rank launched exactly
    ``want`` in its DP_STEPS FSDP steps and holds the same replicated
    tensors and metrics as the other; the FSDP and the replicated runs and
    the single run with the halves swapped within 12a's limits of the
    single run (all SGD with the projection), the planted fault outside
    them.  Logs the readings and the numbers PERF.md keeps."""
    fs = [r["fsdp"] for r in ranks]
    for r, f in zip(ranks, fs):
        if f["counts"] != want:
            raise AssertionError(f"fsdp rank {r['rank']}: launches "
                                 f"{f['counts']}, expected {want}")
        if f["mismatches"] or f["rows"] != BATCH // DP_RANKS or not (
                0 < f["sharded"] < f["tensors"]):
            raise AssertionError(f"fsdp rank {r['rank']}: {f}")
    if fs[0]["metrics"] != fs[1]["metrics"]:
        raise AssertionError("fsdp: the ranks' metrics differ")
    readings = {
        "fsdp": dp_readings(fs[0]["metrics"], params["fsdp"], single),
        "fsdp replicated": dp_readings(fs[0]["replicated"]["metrics"],
                                       params["fsdp replicated"], single),
        "fsdp halves swapped": dp_readings(swapped["metrics"],
                                           swapped["params"][-1], single),
        FSDP_FAULT: dp_readings(fs[0]["fault"]["metrics"],
                                params[FSDP_FAULT], single)}
    for name, r in readings.items():
        log(f"dp 12d-1 {name} vs single (SGD + projection), per step: loss "
            + ", ".join(f"{x:.3g}" for x in r["loss"]) + "; grad_norm "
            + ", ".join(f"{x:.3g}" for x in r["grad_norm"])
            + f"; parameters {r['params']:.3g}: over "
            f"{dp_over_limits(r) or 'none'}")
    for name in ("fsdp", "fsdp replicated", "fsdp halves swapped"):
        if dp_over_limits(readings[name]):
            raise AssertionError(f"dp 12d-1: {name} vs the single run "
                                 f"{readings[name]}")
    if not dp_over_limits(readings[FSDP_FAULT]):
        raise AssertionError(f"dp 12d-1: the planted fault {FSDP_FAULT} "
                             f"passes the limits {readings[FSDP_FAULT]}")
    f = fs[0]
    mb = f["state_mb"]
    log(f"dp 12d-1: {DP_RANKS} ranks over gloo, FSDP at min_size "
        f"{FSDP_TEST_MIN}: {f['sharded']} of {f['tensors']} parameters "
        f"sharded ({f['sharded_elements']} of {f['elements']} elements); ms "
        f"per step FSDP {[round(x, 2) for x in f['step_ms']]} vs replicated "
        f"{[round(x, 2) for x in f['replicated']['step_ms']]} (two ranks "
        f"sharing one card: no scaling measured); gloo all-gather of "
        f"{f['collective_mb']:.1f} MB {f['all_gather_ms']:.2f} ms, "
        f"reduce-scatter {f['reduce_scatter_ms']:.2f} ms; peak allocated "
        f"MB of the steps FSDP {f['peak_mb']:.1f} vs replicated "
        f"{f['replicated']['peak_mb']:.1f}; at rest per rank at the default "
        f"min_size, MB: params+moments FSDP "
        f"{mb['fsdp']['params_moments_mb']:.1f} vs replicated "
        f"{mb['replicated']['params_moments_mb']:.1f} (predicted 251.6 vs "
        f"481.5), whole state {mb['fsdp']['state_mb']:.1f} vs "
        f"{mb['replicated']['state_mb']:.1f}; per-rank launches "
        f"{f['counts']}; {f['seconds']:.1f} s on the ranks")
    return {"readings": readings, "rank0": f}


def phase_dp_graph(device) -> dict:
    """12b: NCCL at world size 1, in this process: the scan runner with the
    mesh (its collectives captured in the step's graph) against the runner
    without, phase 5b's epochs and steps, under deterministic cuDNN: the
    states bit for bit equal (a sum over one rank is exact), the replays
    and each kernel's replayed launches equal, ms per step of each.  12d-2,
    in the same group: the runner over the state in the FSDP layout (at
    the default min_size every large tensor is a shard, whole at world 1:
    the all-gathers and reduce-scatters are nodes of the graph) against
    the runner without a mesh: the state bit for bit, every mean but
    grad_norm bit for bit (the norm sums the shards' squares apart from the
    replicated ones: another order), grad_norm within 1e-6."""
    import torch.distributed as dist

    from nvae_torch.parallel import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=device)
    try:
        mesh = make_mesh(device=device)
        cfg = configs()["default"]
        data = scan_data(device)
        with deterministic_cudnn():
            runs, seconds = {}, {}
            for name, m in (("plain", None), ("mesh", mesh),
                            ("fsdp", mesh)):
                t0 = time.monotonic()
                r = scan_run(cfg, device, data, True, SCAN_STEPS_PER_EPOCH,
                             SCAN_EPOCHS, mesh=m, fsdp=name == "fsdp")
                # Drop the runner (its graph's memory) before the next.
                r["replays"] = r.pop("runner").replays
                torch.cuda.empty_cache()
                runs[name], seconds[name] = r, time.monotonic() - t0
            fsdp_seconds = seconds["fsdp"]
        del data
    finally:
        dist.destroy_process_group()
    plain, meshed = runs["plain"], runs["mesh"]
    diff = state_diff(meshed["flat"], plain["flat"])
    same = {"state": diff["bitwise"],
            "means": meshed["means"] == plain["means"],
            "replays": meshed["replays"] == plain["replays"],
            "replayed": meshed["replayed"] == plain["replayed"],
            "counts": meshed["counts"] == plain["counts"]}
    log(f"dp 12b: NCCL, world 1, scan runner with the mesh vs without: "
        f"{same}, {meshed['replays']} replays each, replayed "
        f"{ {k: v for k, v in meshed['replayed'].items() if v} }; ms per "
        f"step of the last epoch {meshed['ms_per_step']:.2f} with the mesh "
        f"vs {plain['ms_per_step']:.2f} without")
    if not all(same.values()):
        raise AssertionError(f"dp 12b: {same} {diff}")
    fsdp = runs["fsdp"]
    fdiff = state_diff(fsdp["flat"], plain["flat"])
    norms = [(a.pop("grad_norm"), b.pop("grad_norm"))
             for a, b in zip(fsdp["means"], plain["means"])]
    fsame = {"state": fdiff["bitwise"],
             "means but grad_norm": fsdp["means"] == plain["means"],
             "grad_norm": all(abs(a - b) <= 1e-6 * abs(b) for a, b in norms),
             "replays": fsdp["replays"] == plain["replays"],
             "replayed": fsdp["replayed"] == plain["replayed"],
             "counts": fsdp["counts"] == plain["counts"]}
    log(f"dp 12d-2: NCCL, world 1, scan runner over the FSDP state vs "
        f"without a mesh: {fsame}, grad_norms {norms}; ms per step of the "
        f"last epoch {fsdp['ms_per_step']:.2f} FSDP vs "
        f"{plain['ms_per_step']:.2f} without a mesh and "
        f"{meshed['ms_per_step']:.2f} replicated (12b); peak "
        f"{fsdp['peak_mem_gb']:.2f} GB vs {plain['peak_mem_gb']:.2f}; "
        f"{fsdp_seconds:.1f} s")
    if not all(fsame.values()):
        raise AssertionError(f"dp 12d-2: {fsame} {fdiff}")
    return {"same": same, "ms_per_step": meshed["ms_per_step"],
            "plain_ms_per_step": plain["ms_per_step"],
            "fsdp_ms_per_step": fsdp["ms_per_step"],
            "fsdp_seconds": fsdp_seconds,
            "counts": {k: plain["counts"][k] + meshed["counts"][k]
                       + fsdp["counts"][k] for k in KERNEL_NAMES},
            "replayed": {k: plain["replayed"].get(k, 0)
                         + meshed["replayed"].get(k, 0)
                         + fsdp["replayed"].get(k, 0)
                         for k in KERNEL_NAMES}}


def torchrun_command(counts_path: str, argv, world: int = DP_RANKS) -> list:
    """``python -m torch.distributed.run --nproc_per_node world`` over
    the port's CLI, each rank writing its launch counts to
    ``counts_path`` with ``{rank}`` replaced."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(world), "--no-python",
            sys.executable, "-c", RUN_WITH_COUNTS, counts_path,
            "nvae_torch.cli", *argv]


def dp_counts(workdir: str, label: str, world: int = DP_RANKS) -> list:
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"{label}_counts_{r}.json")) as f:
            out.append(json.load(f)["launches"])
    return out


def run_torchrun(label: str, argv, workdir: str, world: int = DP_RANKS,
                 phase: str = "dp 12c", stdout=None) -> list:
    """The CLI over ``world`` ranks (:func:`torchrun_command`); fails on a
    non-zero exit; returns each rank's launch counts (and appends the
    ranks' standard output to the list ``stdout`` if given)."""
    counts = os.path.join(workdir, f"{label}_counts_{{rank}}.json")
    t0 = time.monotonic()
    proc = subprocess.run(torchrun_command(counts, argv, world), cwd=workdir,
                          env=dp_env(0), capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {label} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    if stdout is not None:
        stdout.append(proc.stdout)
    out = dp_counts(workdir, label, world)
    log(f"{phase} {label}: exit 0 in {time.monotonic() - t0:.1f} s, "
        f"launches per rank {out}")
    return out


def rank_pid(parent: int, rank: int) -> int:
    """The pid of the child of ``parent`` whose environment says RANK."""
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != parent:
                continue
            with open(f"/proc/{d}/environ", "rb") as f:
                env = f.read().split(b"\0")
        except OSError:
            continue
        if f"RANK={rank}".encode() in env:
            return int(d)
    raise AssertionError(f"no rank {rank} under pid {parent}")


def phase_dp_cli(workdir: str, device) -> dict:
    """12c: the entry points over torchrun, two ranks on the one card over
    gloo: ``--mode train --data_parallel 2`` at full width (1 epoch with
    eval and image hooks, one checkpoint); then, at the same time, a resume
    for a second epoch and ``--mode serve --data_parallel 2`` over a copy
    of that checkpoint answering two HTTP requests of BATCH rows at two
    temperatures, whose images are held against the single-rank
    ``Sampler`` for the same dispatch seeds; exact launch counts on each
    rank."""
    from nvae_torch.train import checkpoint as ckpt

    per_fwd = expected_launches(configs()["default"])
    args = [*cli_args(workdir), "--data_parallel", str(DP_RANKS)]
    models = os.path.join(workdir, "models")
    counts = dict.fromkeys(KERNEL_NAMES, 0)

    def train(label: str, epochs: int, hooks: list) -> None:
        per_rank = run_torchrun(label, ["--mode", "train", "--epochs",
                                        str(epochs), *args, *hooks], workdir)
        # Each rank: its rows of 4 steps and 4 eval batches; rank 0 also
        # the sample and reconstruction hooks.
        for r, c in enumerate(per_rank):
            check_cli_counts(f"dp {label} rank {r}", c, per_fwd, CLI_BATCHES,
                             0 if hooks else CLI_BATCHES + (2 if r == 0
                                                            else 0))
            for k, v in c.items():
                counts[k] += v
        if ckpt.all_steps(models) != [CLI_BATCHES * e
                                      for e in range(1, epochs + 1)]:
            raise AssertionError(f"dp {label}: checkpoints "
                                 f"{ckpt.all_steps(models)}")

    train("train", 1, [])
    serve_dir = os.path.join(workdir, "serve")
    shutil.copytree(models, os.path.join(serve_dir, "models"))
    # The resume skips the hooks, which the first run has shown.
    _, served = run_concurrently(
        lambda: train("resume", 2, ["--evaluate_frequency", "0",
                                    "--sample_frequency", "0"]),
        lambda: dp_serve(serve_dir, device, per_fwd))
    lines = read_jsonl(os.path.join(workdir, "logs", "metrics.jsonl"))
    if [r["step"] for r in lines if "train/loss" in r] != [0, 1] or [
            r["step"] for r in lines if "test/elbo" in r] != [0]:
        raise AssertionError(f"dp train: metrics lines {lines}")
    for k, v in served["counts"].items():
        counts[k] += v
    return {**served, "counts": counts}


def dp_serve(workdir: str, device, per_fwd: int) -> dict:
    """``--mode serve --data_parallel 2`` over the checkpoint in
    ``workdir``: two requests of BATCH rows at DP_SERVE_TEMPERATURES, held
    against the single-rank ``Sampler`` for the same dispatch seeds, then
    SIGTERM to rank 0 (it drains and stops the other rank); exact launch
    counts on each rank."""
    import dataclasses
    import signal

    from nvae_torch.presets import get_preset
    from nvae_torch.serving import Sampler
    from nvae_torch.serving_runtime import dispatch_seed
    from nvae_torch.train import checkpoint as ckpt

    args = [*cli_args(workdir), "--data_parallel", str(DP_RANKS)]
    port = free_port()
    seed = 1  # the CLI's --seed default: the server's dispatch seeds
    counts_path = os.path.join(workdir, "serve_counts_{rank}.json")
    log_path = os.path.join(workdir, "dp_serve.log")
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(
            torchrun_command(counts_path, [
                "--mode", "serve", *args, "--serve_port", str(port),
                "--serve_max_delay_ms", str(SERVE_MAX_DELAY_MS)]),
            cwd=workdir, env=dp_env(0), stdout=log_f,
            stderr=subprocess.STDOUT)
        try:
            t0 = time.monotonic()
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"dp serve exited {proc.returncode}:"
                                         f"\n{open(log_path).read()[-4000:]}")
                try:
                    http_json(port, "/healthz")
                    break
                except OSError:
                    if time.monotonic() - t0 > 300:
                        raise AssertionError("dp serve: not up in 300 s")
                    time.sleep(0.25)
            up = time.monotonic() - t0
            served = [np.load(io.BytesIO(http(port, "/sample", {
                "n": BATCH, "temperature": t, "format": "npy"})[2]))
                for t in DP_SERVE_TEMPERATURES]
            info = http_json(port, "/stats")
            os.kill(rank_pid(proc.pid, 0), signal.SIGTERM)
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rc != 0:
        raise AssertionError(f"dp serve exited {rc} after SIGTERM:\n"
                             f"{open(log_path).read()[-4000:]}")
    per_rank = dp_counts(workdir, "serve")
    want = dict.fromkeys(KERNEL_NAMES, 0)
    # Each rank: its rows of the warm-up call and of each dispatch.
    want["fused_swish_depthwise5x5"] = per_fwd * (1 + len(served))
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    for r, c in enumerate(per_rank):
        if c != want:
            raise AssertionError(f"dp serve rank {r}: launches {c}, want "
                                 f"{want}")
        for k, v in c.items():
            counts[k] += v
    models = os.path.join(workdir, "models")
    payload = ckpt.load_payload(models, ckpt.all_steps(models)[-1])
    sd = {k[len("model/"):]: v for k, v in payload.items()
          if k.startswith("model/")}
    cfg = get_preset("mnist_step_sn")[0]
    diffs, bitwise = [], []
    with IN_PROCESS:  # 12d-3 samples in this process too
        sampler = Sampler(dataclasses.replace(cfg, use_pallas_kernels=True),
                          sd, BATCH, device=device)
        for d, (t, got) in enumerate(zip(DP_SERVE_TEMPERATURES, served)):
            ref = sampler(dispatch_seed(seed, d), torch.full((BATCH,), t))
            ref = ref.cpu().numpy()
            diffs.append(float(np.abs(got - ref).max()))
            bitwise.append(bool(np.array_equal(got, ref)))
        del sampler
    log(f"dp 12c serve: up in {up:.1f} s over {info['weights']}; "
        f"{len(served)} requests of {BATCH} rows at T="
        f"{DP_SERVE_TEMPERATURES}: bitwise against the single-rank sampler "
        f"{bitwise}, max |diff| {diffs}; per-rank launches {per_rank}")
    if max(diffs) > DP_SERVE_ATOL:
        raise AssertionError(f"dp serve: images {diffs} from the single "
                             f"sampler's")
    return {"counts": counts, "serve_bitwise": bitwise, "serve_diffs": diffs}


def phase_fsdp_cli(workdir: str, device) -> dict:
    """12d-3: ``--mode train --data_parallel 2 --fsdp`` over torchrun at
    full width (gloo; at the default min_size the large tensors shard): an
    epoch with eval and image hooks, then a resume for a second, exact
    launch counts on each rank, checkpoints of the replicated layout's
    keys and shapes; beside the resume, a world-1 ``--mode sample`` (a
    subprocess) over a copy of the first epoch's checkpoint, whose PNGs
    equal bit for bit those this process writes through the CLI's sampling
    path from the same checkpoint restored in the replicated layout."""
    from nvae_torch import cli
    from nvae_torch.train import checkpoint as ckpt
    from nvae_torch.train.trainer import Trainer

    t0 = time.monotonic()
    per_fwd = expected_launches(configs()["default"])
    args = [*cli_args(workdir), "--data_parallel", str(DP_RANKS), "--fsdp"]
    models = os.path.join(workdir, "models")
    copy = os.path.join(workdir, "sample_models")
    counts = dict.fromkeys(KERNEL_NAMES, 0)

    def train(label: str, epochs: int, hooks: list) -> None:
        per_rank = run_torchrun(label, ["--mode", "train", "--epochs",
                                        str(epochs), *args, *hooks], workdir)
        # Each rank: its rows of 4 steps and 4 eval batches; rank 0 also
        # the sample and reconstruction hooks (every rank gathers).
        for r, c in enumerate(per_rank):
            check_cli_counts(f"dp {label} rank {r}", c, per_fwd, CLI_BATCHES,
                             0 if hooks else CLI_BATCHES + (2 if r == 0
                                                            else 0))
            for k, v in c.items():
                counts[k] += v
        if ckpt.all_steps(models) != [CLI_BATCHES * e
                                      for e in range(1, epochs + 1)]:
            raise AssertionError(f"dp {label}: checkpoints "
                                 f"{ckpt.all_steps(models)}")

    train("fsdp_train", 1, [])
    # The sample reads a copy of the first checkpoint while the resume
    # writes the second beside it.
    shutil.copytree(models, copy)
    _, sample = run_concurrently(
        lambda: train("fsdp_resume", 2, ["--evaluate_frequency", "0",
                                         "--sample_frequency", "0"]),
        lambda: run_cli("fsdp_sample", [
            "--mode", "sample", "--n_samples", str(BATCH),
            *cli_args(workdir), "--model_save_dir", copy,
            "--tensorboard_log_dir", copy + "_logs"], workdir))
    check_cli_counts("fsdp sample", sample["counts"], per_fwd, 0, 1)
    for k, v in sample["counts"].items():
        counts[k] += v
    payloads = [ckpt.load_payload(d, ckpt.all_steps(d)[-1])
                for d in (models, copy)]
    entries = len(payloads[-1])
    ref_dir = os.path.join(workdir, "replicated")
    a = cli.parse_args(["--mode", "sample", "--n_samples", str(BATCH),
                        *cli_args(workdir), "--sample_dir", ref_dir,
                        "--model_save_dir", copy])
    model_cfg, train_cfg, _ = cli.configs_from_args(a)
    with IN_PROCESS:  # 12c's serve check samples in this process too
        trainer = Trainer(model_cfg, train_cfg, CLI_BATCHES, device=device)
        want = ckpt.flatten_state(trainer.state)
        shapes = {k: tuple(v.shape) for k, v in want.items()
                  if isinstance(v, torch.Tensor)}
        for p in payloads:  # the train's and the resume's checkpoints
            if set(p) != set(want) or any(
                    tuple(p[k].shape) != s for k, s in shapes.items()):
                raise AssertionError("dp 12d-3: an FSDP checkpoint's keys "
                                     "or shapes differ from the replicated "
                                     "layout's")
        del want, payloads
        cli._sample(a, trainer)
        del trainer
    torch.cuda.empty_cache()

    def pngs_in(d: str) -> list:
        # The PNGs' names are uuid4s: compare their bytes, sorted.
        out = []
        for n in os.listdir(d):
            with open(os.path.join(d, n), "rb") as f:
                out.append(f.read())
        return sorted(out)

    pngs, same = 0, True
    for t in SAMPLE_TEMPERATURES:
        got = pngs_in(os.path.join(workdir, "results", f"t_{t}"))
        ref = pngs_in(os.path.join(ref_dir, f"t_{t}"))
        if len(got) != BATCH or len(ref) != BATCH:
            raise AssertionError(f"dp 12d-3: {len(got)} and {len(ref)} PNGs "
                                 f"at T={t}")
        same &= got == ref
        pngs += len(got)
    seconds = time.monotonic() - t0
    log(f"dp 12d-3: torchrun --data_parallel {DP_RANKS} --fsdp train and "
        f"resume, beside the resume a world-1 --mode sample of the first "
        f"checkpoint: {pngs} PNGs bit for bit equal to those of the "
        f"replicated restore: {same}; checkpoints of {entries} entries of "
        f"the replicated layout's shapes; "
        f"{seconds:.1f} s beside 12c")
    if not same:
        raise AssertionError("dp 12d-3: the samples differ from the "
                             "replicated restore's")
    return {"counts": counts, "seconds": seconds}


def phase_data_parallel(device) -> dict:
    """Phase 12: 12a, 12b and 12c, and 12d (FSDP) beside them: 12d-1 on
    12a's ranks, 12b with 12d-2 here while 12a's ranks step (its counts
    are this process's, the ranks count theirs), 12d-3 at the same time
    as 12c; with the seconds of each."""
    t0 = time.monotonic()
    workdir = tempfile.mkdtemp(prefix="nvae_chip_smoke_dp_")
    fsdp_dir = tempfile.mkdtemp(prefix="nvae_chip_smoke_fsdp_")
    timed = {}

    def graph_phase():
        t = time.monotonic()
        out = phase_dp_graph(device)
        timed["graph"] = time.monotonic() - t
        return out

    try:
        steps = phase_dp_steps(device, workdir, meanwhile=graph_phase)
        graph = steps["meanwhile"]
        t1 = time.monotonic()
        torch.cuda.empty_cache()  # the subprocesses need the card's memory
        cli, fsdp_cli = run_concurrently(
            lambda: phase_dp_cli(workdir, device),
            lambda: phase_fsdp_cli(fsdp_dir, device))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(fsdp_dir, ignore_errors=True)
    seconds = time.monotonic() - t0
    rank_fsdp = max(r["fsdp"]["seconds"] for r in steps["ranks"])
    log(f"phase 12 (data parallel) took {seconds:.1f} s: 12a with 12d-1, "
        f"and 12b with 12d-2 beside 12a's ranks, {t1 - t0:.1f} (12d-1 "
        f"{rank_fsdp:.1f} of it on the ranks, 12b with 12d-2 "
        f"{timed['graph']:.1f}, 12d-2 {graph['fsdp_seconds']:.1f}), 12c "
        f"with 12d-3 beside it {t0 + seconds - t1:.1f} (12d-3 "
        f"{fsdp_cli['seconds']:.1f}); 12d's own: "
        f"{rank_fsdp + graph['fsdp_seconds']:.1f} s besides 12d-3's launches")
    return {"counts": {k: steps["counts"][k] + graph["counts"][k]
                       + cli["counts"][k] + fsdp_cli["counts"][k]
                       for k in KERNEL_NAMES},
            "replayed": graph["replayed"], "seconds": seconds}


# ---- phase 13: the pipeline -------------------------------------------------

# (label, config, stages, microbatches, schedule, the run it must equal
# bit for bit)
PP_RUNS = (
    ("fp32 S=2 M=2 1f1b", "default", 2, 2, "1f1b", None),
    ("fp32 S=4 M=4 1f1b", "default", 4, 4, "1f1b", None),
    ("fp32 S=4 M=4 gpipe", "default", 4, 4, "gpipe", "fp32 S=4 M=4 1f1b"),
    ("bf16 depthwise S=3 M=2 1f1b", "depthwise bf16", 3, 2, "1f1b", None),
)
PP_STEPS = 2
PP_LR = 1e-5
# JAX's pipeline limits (tests/test_pipeline.py): fp32 lockstep, and the
# bf16 depthwise configuration's.
PP_LOSS_RTOL = 1e-4
PP_STATE_ATOL = 2e-6
PP_BF16_LOSS_RTOL = 2e-2
PP_BF16_PARAM_ATOL = 5e-3
# 13f: the data-parallel stages, PP_DP_STAGES x PP_DP gloo ranks on the one
# card (``chip_smoke.py --pp-rank DIR``), 1f1b over PP_DP_M microbatches.
PP_DP_STAGES, PP_DP, PP_DP_M = 2, 2, 2
PP_DP_RANKS = PP_DP_STAGES * PP_DP
# 13f holds its ranks from a warm start (from the seeded init a reordered
# sum moves the fp32 step's grad_norm by 1.3e-2 on the card: the seeded
# step is chaotic), the loss and parameters at PP_LOSS_RTOL / PP_STATE_ATOL,
# the BatchNorm statistics at PP_DP_BN_RTOL of max(1, |value|): there the
# running variances are far above 1, and the grad_accum=2 step with each
# microbatch's halves swapped (the same function summed in another order)
# moves them by 3.0e-6 of that (1.29e-5 absolute; H100 80GB HBM3, 700 W).
PP_DP_BN_RTOL = 1e-5
# Phase 14: the tensor-parallel layout, TP_DATA x TP_MODEL gloo ranks on the
# one card (``chip_smoke.py --tp-rank DIR``, started with phase 13), from
# 13f's warm start, against the one-process step from the same start, rows
# and noise.  One fp32 step of SGD at TP_SGD_LR with the spectral
# projection (13f's optimizer: a linear update, so the parameters track the
# gradient) holds the gradient and the update of every element: the loss
# at PP_LOSS_RTOL, grad_norm at TP_GRAD_NORM_RTOL (JAX's lockstep limit),
# the parameters within PP_STATE_ATOL, the BatchNorm statistics within
# PP_DP_BN_RTOL of their scale.  Its control: the one-process step with the
# split kernels' gradient dropped must lie at least TP_CONTROL_MARGIN x
# PP_STATE_ATOL from the true one (at 13f's lr, 1e-5, the blocks' update
# is too small for that; at 1e-4 the control read 3.20e-5 and the error
# 1.49e-8 on an H100 80GB HBM3, both in proportion to lr).  Then TP_STEPS production Adamax steps (the spectral
# projection, at PP_LR) in fp32 and one in bf16: the fp32 loss and
# grad_norm as above, the parameters within 3 PP_LR a step (Adamax moves
# an element by about lr a step whatever its gradient: this holds the
# projection's sigma, not the gradient), the statistics after the first
# step (after it the parameters differ by the sign noise); the bf16 step's
# loss at PP_LOSS_RTOL of the one-process bf16 step's (the loss sums in
# fp32: both bf16 forms lie ~1e-6 from the fp32 loss, H100 80GB HBM3, 700
# W), its grad_norm, parameters and statistics no farther from the
# one-process fp32 step than TP_BF16_ROUNDING times the one-process bf16
# step's (RGB_CARD_VS_CPU_ROUNDING: another order of bf16 sums).
TP_DATA, TP_MODEL = 2, 2
TP_RANKS = TP_DATA * TP_MODEL
TP_ROWS = BATCH // TP_DATA
TP_STEPS = 2
TP_SGD_LR = 1e-3
TP_CONTROL_MARGIN = 10.0
TP_GRAD_NORM_RTOL = 1e-4
TP_BF16_ROUNDING = 2.0
# The shapes TP gives #2-#4 (the generative cells' halves of their hidden
# channels, TP_ROWS rows a data index).
TP_SHAPES = [(h, c // TP_MODEL, bias, n, d)
             for h, c, bias, n, d in PATH_SHAPES if n]


def pp_launches(cfg, n_stages: int, m: int, stage=None) -> dict:
    """#2-#4 launches of one pipeline step (of stage ``stage`` alone, if
    given: each rank of a stage launches its stage's on its rows): each
    generative cell runs #2 in the decoder's forward and again in its
    recompute when the decoder is not the last stage, #3 and #4 once in
    the backward pass; each node of the depthwise postprocess (always in
    the last stage) one of each."""
    from nvae_torch.parallel.pipeline import stage_names

    names = stage_names(n_stages)
    mine = names if stage is None else [names[stage]]
    cells = (cfg.n_total_groups - 1) * cfg.res_cells_per_group
    post = (cfg.n_postprocess_blocks * cfg.n_postprocess_cells
            if cfg.postprocess_5x5_depthwise else 0)
    if not any("decoder" in n for n in mine):
        cells = 0
    if not any("postprocess" in n for n in mine):
        post = 0
    fwd = 1 if "decoder" in names[-1] else 2
    fwd_k, dx_k, dw_k = TRAIN_KERNELS[cfg.compute_dtype]
    return {fwd_k: (fwd * cells + post) * m, dx_k: (cells + post) * m,
            dw_k: (cells + post) * m}


def pp_sgd(sn_keys, lr: float = PP_LR, drop=()):
    """SGD at ``lr`` with the spectral projection (JAX's lockstep
    optimizer): a linear update, so the parameters track the gradients.
    The parameters in ``drop`` get no update from their gradient (a
    control)."""
    from nvae_torch.train import optim

    sgd = optim.GradientTransformation(
        lambda params: None,
        lambda updates, state, params=None: (
            {k: g * (0.0 if k in drop else -lr) for k, g in updates.items()},
            None))
    return optim.chain(sgd, optim.spectral_projection(sn_keys))


def pp_state(cfg, device, grad_accum: int, start=None):
    """Seed-0 weights on the card (or ``start``'s, a state dict) and the
    SGD chain, for a run of ``grad_accum`` microbatches a step."""
    from nvae_torch.config import TrainConfig
    from nvae_torch.nn.spectral import sn_kernel_names
    from nvae_torch.train.state import create_train_state

    tc = TrainConfig(batch_size=BATCH, step_based_warmup=True,
                     grad_accum=grad_accum)
    model, state, _ = create_train_state(cfg, tc, 1000, device=device,
                                         seed=0)
    if start is not None:
        model.load_state_dict(start)
    tx = pp_sgd(sn_kernel_names(model))
    state.opt_state = tx.init(state.params())
    return tc, state, tx


def pp_step_record(fn, device) -> tuple:
    """``fn()`` timed to the card's end: (its metrics as floats, ms)."""
    torch.cuda.synchronize(device)
    t0 = time.monotonic()
    m = fn()
    torch.cuda.synchronize(device)
    return {k: float(v) for k, v in m.items()}, 1e3 * (time.monotonic() - t0)


def pp_snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def pp_reference(cfg, device, m: int, batches, start=None,
                 swap: bool = False) -> dict:
    """The ``grad_accum=m`` step over ``batches`` (from ``start``'s
    weights, if given): each step's metrics, state and ms.  ``swap`` swaps
    the halves of each microbatch and of its noise (the step's own draw):
    the same function summed in another order."""
    from nvae_torch.models.nvae import posterior_noise_shapes
    from nvae_torch.train.step import make_train_step, step_seed

    tc, state, tx = pp_state(cfg, device, m, start)
    step = make_train_step(state.model, tx, tc, 1000, 100)
    out = {"metrics": [], "states": [], "ms": [],
           "params": {k for k, _ in state.model.named_parameters()}}
    for b in batches:
        eps = None
        if swap:
            mb = b.shape[0] // m
            perm = torch.arange(mb, device=device).roll(mb // 2)
            b = torch.cat([b[i * mb:(i + 1) * mb][perm] for i in range(m)])
            eps = []
            for i in range(m):
                gen = torch.Generator(device=device).manual_seed(
                    step_seed(state.seed, state.step, i))
                eps.append([torch.randn(sh, generator=gen,
                                        device=device)[perm]
                            for sh in posterior_noise_shapes(cfg, mb)])

        def run(b=b, eps=eps):
            nonlocal state
            state, metrics = step(state, b, eps=eps)
            return metrics
        metrics, ms = pp_step_record(run, device)
        out["metrics"].append(metrics)
        out["ms"].append(ms)
        out["states"].append(pp_snapshot(state.model))
    return out


def pp_run(cfg, device, n_stages: int, m: int, schedule: str,
           batches, start=None) -> dict:
    """The pipeline over ``batches`` (from ``start``'s weights, if given),
    with the counts set to 0 just before and read just after: each step's
    metrics, merged state and ms, the peak stash and the counts."""
    from nvae_torch.parallel import PipelineTrainer

    tc, state, _ = pp_state(cfg, device, 1, start)
    pp = PipelineTrainer(state.model, tc, 1000, 100, n_stages=n_stages,
                         n_microbatches=m, devices=[device] * n_stages,
                         state=state, tx_factory=pp_sgd, schedule=schedule)
    del state
    out = {"metrics": [], "states": [], "ms": []}
    reset_counts()
    for b in batches:
        metrics, ms = pp_step_record(lambda b=b: pp.step(b), device)
        out["metrics"].append(metrics)
        out["ms"].append(ms)
        out["states"].append(pp_snapshot(pp.merged_state().model))
    out["counts"] = read_counts()
    out["peak_stash"] = pp.peak_stash
    return out


def pp_errors(run: dict, ref: dict, params) -> dict:
    """The largest relative loss error, and the largest absolute error of
    the parameters and of the BatchNorm statistics, over the steps; and of
    the statistics each over ``max(1, |value|)`` (``bn_stats_scaled``).
    Each state's maxima are read back in one transfer: one read per
    tensor, over a whole model's thousands, costs seconds."""
    loss = max(abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1.0)
               for a, b in zip(run["metrics"], ref["metrics"]))
    err = {"loss_rel": loss, "params": 0.0, "bn_stats": 0.0,
           "bn_stats_scaled": 0.0}
    for got, want in zip(run["states"], ref["states"]):
        maxima = {kind: [] for kind in err if kind != "loss_rel"}
        for k, v in want.items():
            kind = "params" if k in params else "bn_stats"
            diff = (got[k] - v).abs()
            maxima[kind].append(diff.max().to(torch.float64))
            if kind == "bn_stats":
                maxima["bn_stats_scaled"].append(
                    (diff / v.abs().clamp(min=1.0)).max().to(torch.float64))
        for kind, ms in maxima.items():
            if ms:
                err[kind] = max(err[kind], float(torch.stack(ms).max()))
    return err


def pp_within(err: dict, scaled: bool = False) -> bool:
    """``err`` (:func:`pp_errors`) within the fp32 pipeline limits: the
    BatchNorm statistics within PP_STATE_ATOL, or with ``scaled`` within
    PP_DP_BN_RTOL of ``max(1, |value|)``."""
    stats = (err["bn_stats_scaled"] <= PP_DP_BN_RTOL if scaled
             else err["bn_stats"] <= PP_STATE_ATOL)
    return (err["loss_rel"] <= PP_LOSS_RTOL
            and err["params"] <= PP_STATE_ATOL and stats)


def pp_rank(workdir: str) -> int:
    """One rank of phase 13f (``chip_smoke.py --pp-rank DIR``, its rank
    and coordinator in the environment), one host thread, as torchrun
    gives each of its ranks: the default configuration's seed-0 weights
    and SGD chain (phase 13's start) as ``PipelineTrainer`` of
    PP_DP_STAGES stages x PP_DP ranks over the gloo world, and one step
    from there on phase 13's first batch (its metrics are the seeded
    reading; it also loads the card's libraries) while phase 13 runs in
    its own process; then, once ``DIR/pp_start.pt`` holds the warm start,
    that state loaded into the stages and PP_STEPS 1f1b steps on phase
    13's batches under deterministic cuDNN, with the counts set to 0 just
    before and read just after: each step's metrics and ms, this rank's
    peak memory, its stage's checksums and the merged state after each
    step (rank 0 writes it)."""
    sys.path.insert(0, ROOT)
    from nvae_torch.device import fp32_math
    from nvae_torch.parallel import PipelineTrainer, initialize, make_mesh
    from nvae_torch.parallel.mesh import checksums
    from nvae_torch.train.optim import state_tensors
    from nvae_torch.train.state import TrainState

    torch.set_num_threads(1)
    initialize()
    device = make_mesh().device  # this rank's card
    cfg = configs()["default"]
    tc, state, _ = pp_state(cfg, device, 1)
    model, seed = state.model, state.seed
    pp = PipelineTrainer(model, tc, 1000, 100, n_stages=PP_DP_STAGES,
                         n_microbatches=PP_DP_M,
                         devices=[device] * PP_DP_RANKS, dp=PP_DP,
                         state=state, tx_factory=pp_sgd, schedule="1f1b")
    del state
    batches = [train_batch(BATCH, 40 + i).to(device)
               for i in range(PP_STEPS)]
    rank, s = torch.distributed.get_rank(), pp.stage
    rec = {"rank": rank, "stage": s, "index": pp.stage_mesh.rank,
           "device": str(device), "rows": BATCH // PP_DP_M // PP_DP,
           "metrics": [], "ms": [], "sums": []}
    with fp32_math(deterministic=True):
        rec["seeded"], rec["seeded_ms"] = pp_step_record(
            lambda: pp.step(batches[0]), device)
    torch.cuda.empty_cache()  # phase 14's ranks warm up meanwhile
    warm = wait_for_file(os.path.join(workdir, "pp_start.pt"), torch.load)
    with torch.no_grad():
        model.load_state_dict(warm)
    pp.load_state(TrainState(0, 0, model, None, seed))
    states = []
    with fp32_math(deterministic=True):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        for b in batches:
            metrics, ms = pp_step_record(lambda b=b: pp.step(b), device)
            rec["metrics"].append(metrics)
            rec["ms"].append(ms)
            rec["sums"].append(checksums(
                list(pp.stages[s].state_dict().values())
                + state_tensors(pp.opt[s])).tolist())
            merged = pp.merged_state()
            if rank == 0:
                states.append({k: v.detach().to("cpu", copy=True)
                               for k, v in
                               merged.model.state_dict().items()})
            del merged
        rec["counts"] = read_counts()
        rec["peak_mb"] = torch.cuda.max_memory_allocated(device) / 1e6
    if rank == 0:
        torch.save(states, os.path.join(workdir, "pp_rank0_states.pt"))
    with open(os.path.join(workdir, f"pp_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def start_pp_ranks(workdir: str) -> tuple:
    """13f's ranks, started now (they build their stages and take the
    seeded step, then wait for ``pp_start.pt``): the processes and their
    log files."""
    port = free_port()
    logs = [open(os.path.join(workdir, f"pp_rank{r}.log"), "w")
            for r in range(PP_DP_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--pp-rank",
         workdir], cwd=workdir, env=dp_env(port, r, PP_DP_RANKS),
        stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(PP_DP_RANKS)]
    return procs, logs


def finish_ranks(workdir: str, procs, logs, prefix: str) -> list:
    """The records ``DIR/{prefix}_rank{r}.json`` of ranks that have exited
    0."""
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rcs):
        tails = [open(f.name).read()[-3000:] for f in logs]
        raise AssertionError(f"{prefix} ranks exited {rcs}:\n"
                             + "\n".join(tails))
    ranks = []
    for r in range(len(procs)):
        with open(os.path.join(workdir, f"{prefix}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def check_pp_ranks(ranks: list, ref: dict, seeded: dict, one: dict, cfg,
                   device, workdir: str) -> None:
    """13f's checks: each rank's stage and rows, its exact launches (its
    stage's share of :func:`pp_launches` a step), the replicas of a stage
    equal bit for bit after every step and every rank's metrics equal,
    and the merged state against the ``grad_accum=2`` reference ``ref``
    from the warm start at PP_LOSS_RTOL / PP_STATE_ATOL, the BatchNorm
    statistics at PP_DP_BN_RTOL (``pp_within(scaled=True)``).  Logs the ms a
    step beside ``one``'s (the one-process S=2 pipeline from the same
    start), each rank's peak MB, and the seeded step's loss and grad_norm
    against ``seeded`` (13(a)'s reference's first step)."""
    for rec in ranks:
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want.update({k: v * PP_STEPS for k, v in pp_launches(
            cfg, PP_DP_STAGES, PP_DP_M, rec["stage"]).items()})
        if rec["stage"] != rec["rank"] // PP_DP or rec["index"] != \
                rec["rank"] % PP_DP:
            raise AssertionError(f"pp 13f rank {rec['rank']}: stage "
                                 f"{rec['stage']} index {rec['index']}")
        if rec["counts"] != want:
            raise AssertionError(f"pp 13f rank {rec['rank']} (stage "
                                 f"{rec['stage']}): launches "
                                 f"{rec['counts']}, expected {want}")
        if rec["metrics"] != ranks[0]["metrics"] or \
                rec["seeded"] != ranks[0]["seeded"]:
            raise AssertionError(f"pp 13f rank {rec['rank']}: metrics "
                                 f"{rec['metrics']} vs rank 0's "
                                 f"{ranks[0]['metrics']}")
        first = ranks[rec["stage"] * PP_DP]
        if rec["sums"] != first["sums"]:
            raise AssertionError(f"pp 13f: rank {rec['rank']}'s stage "
                                 f"state differs from rank "
                                 f"{first['rank']}'s")
    states = torch.load(os.path.join(workdir, "pp_rank0_states.pt"),
                        map_location=device)
    err = pp_errors({"metrics": ranks[0]["metrics"], "states": states},
                    ref, ref["params"])
    got = ranks[0]["seeded"]
    log(f"pipeline 13f: {PP_DP_STAGES} stages x {PP_DP} ranks, "
        f"{PP_DP_RANKS} gloo ranks on {ranks[0]['device']}, {PP_STEPS} "
        f"steps of {BATCH} rows ({ranks[0]['rows']} a rank a microbatch) "
        f"from the warm start: ms a step "
        f"{[round(x, 1) for x in ranks[0]['ms']]} against the one-process "
        f"S=2 M=2 pipeline's {[round(x, 1) for x in one['ms']]} from the "
        f"same start (the ranks share the card and sum over gloo: no "
        f"scaling); peak MB a rank "
        f"{[round(r['peak_mb'], 1) for r in ranks]}; errors against the "
        f"grad_accum=2 step {err}; per-rank launches "
        f"{[{k: v for k, v in r['counts'].items() if v} for r in ranks]}; "
        f"the seeded step (unchecked: the seeded fp32 step is chaotic "
        f"under reordered sums) loss {got['loss']:.9g} against "
        f"{seeded['loss']:.9g}, grad_norm {got['grad_norm']:.9g} against "
        f"{seeded['grad_norm']:.9g}, {ranks[0]['seeded_ms']:.1f} ms")
    for i, mt in enumerate(ranks[0]["metrics"]):
        log(f"  step {i}: " + ", ".join(
            f"{k} {v:.9g}" for k, v in sorted(mt.items())))
    if not pp_within(err, scaled=True):
        raise AssertionError(f"pipeline 13f: {err}")


def pp_cli(workdir: str) -> dict:
    """13f's entry point, beside 13(a)-(e):
    ``torchrun --nproc_per_node 4 -m nvae_torch.cli --mode train
    --pp_stages 2 --data_parallel 2`` at full width for an epoch with eval
    and image hooks (one checkpoint), then a resume for a second without
    them: exact launches on each rank (the last stage's ranks their
    microbatch rows' #2-#4, rank 0 the eval and the hooks on the merged
    model, the other stage-0 rank none), the checkpoints, the metrics
    lines and the layout printed."""
    from nvae_torch.train import checkpoint as ckpt

    t0 = time.monotonic()
    d = os.path.join(workdir, "cli")
    os.makedirs(d)
    cfg = configs()["default"]
    per_fwd = expected_launches(cfg)
    args = [*cli_args(d), "--pp_stages", str(PP_DP_STAGES),
            "--data_parallel", str(PP_DP), "--pp_microbatches",
            str(PP_DP_M)]
    out, counts = [], dict.fromkeys(KERNEL_NAMES, 0)
    for label, epochs, hooks in (
            ("pp train", 1, []),
            ("pp resume", 2, ["--evaluate_frequency", "0",
                              "--sample_frequency", "0"])):
        per_rank = run_torchrun(
            label.replace(" ", "_"),
            ["--mode", "train", "--epochs", str(epochs), *args, *hooks], d,
            world=PP_DP_RANKS, phase="pipeline 13f", stdout=out)
        fwd_k = TRAIN_KERNELS["float32"][0]
        for r, c in enumerate(per_rank):
            want = dict.fromkeys(KERNEL_NAMES, 0)
            want.update({k: v * CLI_BATCHES for k, v in pp_launches(
                cfg, PP_DP_STAGES, PP_DP_M, r // PP_DP).items()})
            if r == 0 and not hooks:
                want[fwd_k] += per_fwd * (CLI_BATCHES + 2)
            if c != want:
                raise AssertionError(f"pp 13f {label} rank {r}: launches "
                                     f"{c}, expected {want}")
            for k, v in c.items():
                counts[k] += v
    models = os.path.join(d, "models")
    if ckpt.all_steps(models) != [CLI_BATCHES, 2 * CLI_BATCHES]:
        raise AssertionError(f"pp 13f: checkpoints {ckpt.all_steps(models)}")
    lines = read_jsonl(os.path.join(d, "logs", "metrics.jsonl"))
    tr = [r for r in lines if "train/loss" in r]
    if [r["step"] for r in tr] != [0, 1] or [
            r["step"] for r in lines if "test/elbo" in r] != [0] or not all(
            math.isfinite(r["train/loss"]) for r in tr):
        raise AssertionError(f"pp 13f: metrics lines {lines}")
    shown = f"Pipeline: {PP_DP_STAGES} stages x dp={PP_DP}, 1f1b over " \
            f"{PP_DP_M} microbatches"
    if not all(o.count(shown) == 1 for o in out):
        raise AssertionError(f"pp 13f: no {shown!r} from rank 0 alone")
    log(f"pipeline 13f CLI: train and resume over {PP_DP_RANKS} ranks, "
        f"checkpoints {ckpt.all_steps(models)}, train/loss "
        f"{[r['train/loss'] for r in tr]}, "
        f"{time.monotonic() - t0:.1f} s")
    return counts


def pp_warm_start(device) -> dict:
    """13f's start: the default configuration's seed-0 weights after
    DP_WARM_STEPS Adamax steps (phase 12a's warm start), under
    deterministic cuDNN: a state dict on the host."""
    from nvae_torch.device import fp32_math

    with fp32_math(deterministic=True):
        state, step = train_setup(configs()["default"], device, BATCH)
        for i in range(DP_WARM_STEPS):
            state, _ = step(state, train_batch(BATCH, 1000 + i).to(device))
    return {k: v.detach().to("cpu", copy=True)
            for k, v in state.model.state_dict().items()}


def phase_pipeline(device, one_ms: dict) -> dict:
    """Phase 13 (see the module docstring): 13f's ranks start up and take
    their seeded step, and its CLI runs, beside (a)-(e), the warm start,
    its ``grad_accum=2`` reference and phase 14's one-process reference in
    this process; phase 14's ranks start with 13f's and, from the warm
    start, take their SGD step and build their states beside the CLI;
    then, alone on
    the card, the one-process S=2 M=2 pipeline from the warm start and
    13f's timed steps, then phase 14's (:func:`phase_tensor_parallel`,
    its ms beside ``one_ms``).  Returns the counts of the pipeline and TP
    runs and the seconds."""
    from nvae_torch.device import fp32_math

    t0 = time.monotonic()
    cfg = configs()["default"]
    batches = [train_batch(BATCH, 40 + i).to(device)
               for i in range(PP_STEPS)]
    workdir = tempfile.mkdtemp(prefix="nvae_chip_smoke_pp_")
    procs, logs = start_pp_ranks(workdir)
    tp_procs, tp_logs = start_tp_ranks(workdir)
    procs, logs = procs + tp_procs, logs + tp_logs
    try:
        def in_process():
            rec = phase_pipeline_one_process(device)
            warm = pp_warm_start(device)
            with fp32_math(deterministic=True):
                rec["warm_ref"] = pp_reference(cfg, device, PP_DP_M,
                                               batches, start=warm)
                rec["swapped"] = pp_errors(
                    pp_reference(cfg, device, PP_DP_M, batches, start=warm,
                                 swap=True), rec["warm_ref"],
                    rec["warm_ref"]["params"])
            save_file(tp_reference(device, warm, batches),
                      os.path.join(workdir, "tp_ref.pt"))
            torch.cuda.empty_cache()
            save_file(warm, os.path.join(workdir, "tp_start.pt"))
            rec["warm"] = warm
            return rec

        cli_counts, rec = run_concurrently(lambda: pp_cli(workdir),
                                           in_process)
        torch.cuda.empty_cache()
        with fp32_math(deterministic=True):
            one = pp_run(cfg, device, PP_DP_STAGES, PP_DP_M, "1f1b",
                         batches, start=rec["warm"])
        err_one = pp_errors(one, rec["warm_ref"], rec["warm_ref"]["params"])
        if not pp_within(err_one):
            raise AssertionError(f"pipeline 13f one process: {err_one}")
        log(f"pipeline 13f: the grad_accum=2 step from the warm start with "
            f"each microbatch's halves swapped (a sound reordering) against "
            f"it: {rec['swapped']}")
        if not pp_within(rec["swapped"], scaled=True):
            raise AssertionError(f"pipeline 13f: the halves swapped "
                                 f"{rec['swapped']}")
        save_file(rec.pop("warm"), os.path.join(workdir, "pp_start.pt"))
        ranks = finish_ranks(workdir, procs[:PP_DP_RANKS],
                             logs[:PP_DP_RANKS], "pp")
        check_pp_ranks(ranks, rec.pop("warm_ref"),
                             rec.pop("ref")["metrics"][0], one, cfg, device,
                             workdir)
        tp = phase_tensor_parallel(workdir, one_ms, tp_procs, tp_logs)
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        raise
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    counts = rec["counts"]
    for k in KERNEL_NAMES:
        counts[k] += (cli_counts[k] + one["counts"][k] + tp["counts"][k]
                      + sum(r["counts"][k] for r in ranks))
    seconds = time.monotonic() - t0
    log(f"phase 13 (pipeline) took {seconds:.1f} s (the one-process run "
        f"from the warm start against its grad_accum=2 step: {err_one})")
    return {"counts": counts, "seconds": seconds}


def save_file(obj, path: str) -> None:
    """``torch.save`` to ``path`` whole or not at all (a rank waits for
    the file)."""
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def phase_tensor_parallel(workdir: str, one_ms: dict, procs, logs) -> dict:
    """Phase 14 (see the module docstring), once 13f's ranks are done: the
    TP ranks' Adamax steps alone on the card (the ranks took their SGD
    step and built their states beside phase 13's CLI), checked by
    :func:`check_tp_ranks`.  Returns their counts and its seconds."""
    t0 = time.monotonic()
    torch.cuda.empty_cache()
    open(os.path.join(workdir, "tp_go"), "w").close()
    ranks = finish_ranks(workdir, procs, logs, "tp")
    counts = check_tp_ranks(ranks, one_ms)
    seconds = time.monotonic() - t0
    log(f"phase 14 (tensor parallel) took {seconds:.1f} s after 13f (its "
        f"ranks built and took their SGD step beside phase 13's CLI)")
    return {"counts": counts, "seconds": seconds}


def phase_pipeline_one_process(device) -> dict:
    """Phase 13 (a)-(e), in this process.  Returns their counts, seconds
    and the fp32 ``grad_accum=2`` reference from the seeded start
    (``ref``)."""
    from nvae_torch.config import TrainConfig
    from nvae_torch.device import fp32_math
    from nvae_torch.train.trainer import Trainer

    t0 = time.monotonic()
    cfgs = {**configs(), **bf16_configs()}
    cfgs = {"default": cfgs["default"],
            "depthwise bf16": cfgs["depthwise bf16"]}
    batches = [train_batch(BATCH, 40 + i).to(device)
               for i in range(PP_STEPS)]
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    runs, refs = {}, {}
    with fp32_math(deterministic=True):
        for label, name, n_stages, m, schedule, same in PP_RUNS:
            cfg = cfgs[name]
            if (name, m) not in refs:
                refs[(name, m)] = pp_reference(cfg, device, m, batches)
            ref = refs[(name, m)]
            rec = pp_run(cfg, device, n_stages, m, schedule, batches)
            for k, v in rec["counts"].items():
                counts[k] += v
            err = pp_errors(rec, ref, ref["params"])
            want = dict.fromkeys(KERNEL_NAMES, 0)
            want.update({k: v * PP_STEPS
                         for k, v in pp_launches(cfg, n_stages, m).items()})
            log(f"pipeline {label}: {rec['ms'][-1]:.1f} ms/step (first "
                f"{rec['ms'][0]:.1f}) against the grad_accum={m} step's "
                f"{ref['ms'][-1]:.1f} (first {ref['ms'][0]:.1f}); peak "
                f"stash {rec['peak_stash']}; errors {err}; counts "
                f"{ {k: v for k, v in rec['counts'].items() if v} }")
            for i, mt in enumerate(rec["metrics"]):
                log(f"  step {i}: " + ", ".join(
                    f"{k} {v:.9g}" for k, v in sorted(mt.items())))
            if rec["counts"] != want:
                raise AssertionError(f"pipeline {label}: counts "
                                     f"{rec['counts']}, expected {want}")
            if cfg.compute_dtype == "bfloat16":
                if not (err["loss_rel"] <= PP_BF16_LOSS_RTOL
                        and err["params"] <= PP_BF16_PARAM_ATOL):
                    raise AssertionError(f"pipeline {label}: {err}")
            elif not (err["loss_rel"] <= PP_LOSS_RTOL
                      and err["params"] <= PP_STATE_ATOL
                      and err["bn_stats"] <= PP_STATE_ATOL):
                raise AssertionError(f"pipeline {label}: {err}")
            if same is not None:
                other = runs[same]
                bitwise = (rec["metrics"] == other["metrics"] and all(
                    torch.equal(a[k], b[k])
                    for a, b in zip(rec["states"], other["states"])
                    for k in a))
                if not (bitwise and rec["peak_stash"] == m
                        and other["peak_stash"] <= 2):
                    raise AssertionError(
                        f"pipeline {label} vs {same}: bitwise {bitwise}, "
                        f"peak stash {rec['peak_stash']} / "
                        f"{other['peak_stash']}")
                log(f"pipeline {label} equals {same} bit for bit; peak "
                    f"stash {rec['peak_stash']} against "
                    f"{other['peak_stash']}")
            runs[label] = rec
    ref = refs[("default", PP_DP_M)]
    del runs, refs
    torch.cuda.empty_cache()
    try:
        Trainer(cfgs["default"], TrainConfig(batch_size=BATCH,
                                             pipeline_stages=2), 4,
                device=device)
    except ValueError as e:
        if "pipeline needs 2 devices (2 stages x dp=1), have 1" not in str(e):
            raise
        log(f"pipeline (e): the Trainer with pipeline_stages=2 stops: {e}")
    else:
        raise AssertionError("pipeline (e): the Trainer with "
                             "pipeline_stages=2 ran on one card")
    seconds = time.monotonic() - t0
    log(f"phase 13 (a)-(e) took {seconds:.1f} s")
    return {"counts": counts, "seconds": seconds, "ref": ref}


# ---- phase 14: the tensor-parallel layout -----------------------------------


def tp_state(cfg, device, warm: dict, mesh=None, sgd: bool = False,
             drop=()):
    """``cfg``'s seed-0 state on ``device`` with ``warm``'s weights, its
    optimizer made from them (the production one, Adamax with the spectral
    projection at PP_LR; with ``sgd``, :func:`pp_sgd` at TP_SGD_LR, with
    no update from the gradient of ``drop``), and the train step; over
    ``mesh`` in the TP layout."""
    from nvae_torch.config import TrainConfig
    from nvae_torch.nn.spectral import sn_kernel_names
    from nvae_torch.parallel import shard_state_tp
    from nvae_torch.train.state import create_train_state
    from nvae_torch.train.step import make_train_step

    tc = TrainConfig(batch_size=BATCH, step_based_warmup=True,
                     learning_rate=PP_LR)
    model, state, tx = create_train_state(cfg, tc, 1000, device=device,
                                          seed=0)
    with torch.no_grad():
        model.load_state_dict(warm)
    if sgd:
        tx = pp_sgd(sn_kernel_names(model), TP_SGD_LR, drop)
    state.opt_state = tx.init(state.params())
    if mesh is not None:
        state = shard_state_tp(state, mesh)
    return state, make_train_step(model, tx, tc, 1000, 100, mesh=mesh)


def tp_configs() -> dict:
    """Phase 14's runs: (configuration, steps, SGD or Adamax)."""
    return {"sgd": (configs()["default"], 1, True),
            "fp32": (configs()["default"], TP_STEPS, False),
            "bf16": (bf16_configs()["default bf16"], 1, False)}


def tp_step_errors(got: dict, metrics: dict, want: dict,
                   want_metrics: dict, params) -> dict:
    """One step's :func:`pp_errors` of the whole state ``got`` against
    ``want`` (moved to ``got``'s device), and the grad_norm's relative
    error."""
    device = next(iter(got.values())).device
    e = pp_errors({"metrics": [metrics], "states": [got]},
                  {"metrics": [want_metrics],
                   "states": [{k: v.to(device) for k, v in want.items()}]},
                  params)
    e["grad_norm_rel"] = (abs(metrics["grad_norm"] - want_metrics["grad_norm"])
                          / abs(want_metrics["grad_norm"]))
    return e


def tp_reference(device, warm: dict, batches) -> dict:
    """The one-process steps of :func:`tp_configs` from ``warm``, under
    deterministic cuDNN: each step's metrics and state (on the host), the
    parameters' names, the bf16 step's errors from the fp32 step; and the
    SGD check's control: how far the SGD step with the split kernels'
    gradient dropped lies from the SGD step on those kernels
    (``sgd_control``)."""
    from nvae_torch.device import fp32_math
    from nvae_torch.parallel import tp_param_sharding

    out = {}
    with fp32_math(deterministic=True):
        for name, (cfg, n, sgd) in tp_configs().items():
            state, step = tp_state(cfg, device, warm, sgd=sgd)
            rec = {"metrics": [], "states": []}
            for b in batches[:n]:
                state, metrics = step(state, b)
                rec["metrics"].append({k: float(v)
                                       for k, v in metrics.items()})
                rec["states"].append(pp_snapshot(state.model))
            out[name] = rec
            out["params"] = {k for k, _ in state.model.named_parameters()}
            if sgd:
                split = tp_param_sharding(state.model, TP_MODEL)
            del state, step
        state, step = tp_state(configs()["default"], device, warm, sgd=True,
                               drop=split)
        state, _ = step(state, batches[0])
        got, want = state.model.state_dict(), out["sgd"]["states"][0]
        out["sgd_control"] = float(torch.stack(
            [(got[k] - want[k]).abs().max() for k in split]).max())
        out["split"] = len(split)
        del state, step, got, want
    out["one bf16 vs fp32"] = tp_step_errors(
        out["bf16"]["states"][0], out["bf16"]["metrics"][0],
        out["fp32"]["states"][0], out["fp32"]["metrics"][0], out["params"])
    for name in tp_configs():
        out[name]["states"] = [{k: v.to("cpu", copy=True)
                                for k, v in s.items()}
                               for s in out[name]["states"]]
    return out


def tp_rank(workdir: str) -> int:
    """One rank of phase 14 (``chip_smoke.py --tp-rank DIR``, its rank and
    coordinator in the environment), one host thread: the
    ``make_mesh(0, TP_MODEL)`` grid over the gloo world; once
    ``DIR/tp_start.pt`` holds 13f's warm start, the SGD run of
    :func:`tp_configs` from it in the TP layout, beside phase 13's CLI
    (the first step's cuDNN plans, gloo's connections and the kernels'
    first launches happen there), then the Adamax states of
    :func:`tp_configs`, one after the other; once ``DIR/tp_go`` exists
    (the card free), their steps.  Each run takes its steps on this data
    index's rows of 13f's batches under deterministic cuDNN, with the
    counts set to 0 just before it and read just after: each step's
    metrics and ms, the tensors that differ across ranks, this rank's
    peak MB (and at-rest MB with the fp32 Adamax state).  After each step
    the state is gathered whole, and rank 0 holds it to the one-process
    step of ``DIR/tp_ref.pt`` (read mapped: one state at a time reaches
    the card; :func:`tp_step_errors`)."""
    import gc

    sys.path.insert(0, ROOT)
    from nvae_torch.device import fp32_math
    from nvae_torch.parallel import initialize, make_mesh, shard_batch
    from nvae_torch.parallel.mesh import replica_mismatches, whole

    torch.set_num_threads(1)
    # Below phase 13's CLI (its critical path), which runs beside this
    # rank's build and its SGD step; its Adamax steps run alone on the card.
    os.nice(10)
    initialize()
    mesh = make_mesh(0, TP_MODEL)
    device = mesh.device
    rank = torch.distributed.get_rank()
    warm = wait_for_file(os.path.join(workdir, "tp_start.pt"), torch.load)
    ref = None
    if rank == 0:  # written before the warm start
        ref = torch.load(os.path.join(workdir, "tp_ref.pt"), mmap=True)
    batches = [shard_batch(train_batch(BATCH, 40 + i), mesh).to(device)
               for i in range(TP_STEPS)]
    rec = {"rank": rank, "grid": [mesh.rank, mesh.model.rank],
           "device": str(device), "rows": batches[0].shape[0], "runs": {},
           "errs": {}}

    def check(name: str, i: int, full: dict, metrics: dict) -> None:
        errs = rec["errs"]
        e = tp_step_errors(full, metrics, ref[name]["states"][i],
                           ref[name]["metrics"][i], ref["params"])
        prev = errs.get(name, {})
        errs[name] = {**prev, **{k: max(v, prev.get(k, 0.0))
                                 for k, v in e.items()}}
        if i == 0:
            errs[name]["bn_stats_scaled_step0"] = e["bn_stats_scaled"]
        if name == "bf16":
            errs["bf16 vs fp32"] = tp_step_errors(
                full, metrics, ref["fp32"]["states"][0],
                ref["fp32"]["metrics"][0], ref["params"])

    def run(name: str, state, step, n: int) -> None:
        r = {"metrics": [], "ms": [], "mismatches": []}
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        for i, b in enumerate(batches[:n]):
            def one(b=b):
                nonlocal state
                state, metrics = step(state, b)
                return metrics
            metrics, ms = pp_step_record(one, device)
            r["metrics"].append(metrics)
            r["ms"].append(ms)
            r["mismatches"].append(replica_mismatches(state, mesh))
            sd = state.model.state_dict(keep_vars=True)
            with torch.no_grad():
                full = dict(zip(sd, whole(list(sd.values()))))
            if rank == 0:
                check(name, i, full, metrics)
            del sd, full
        r["counts"] = read_counts()
        r["peak_mb"] = torch.cuda.max_memory_allocated(device) / 1e6
        rec["runs"][name] = r

    runs = tp_configs()
    with fp32_math(deterministic=True):
        cfg, n, _ = runs.pop("sgd")
        run("sgd", *tp_state(cfg, device, warm, mesh, sgd=True), n)
    gc.collect()
    states = {}
    for name, (cfg, _, _) in runs.items():
        states[name] = tp_state(cfg, device, warm, mesh)
        if name == "fp32":
            torch.cuda.synchronize(device)
            rec["rest_mb"] = torch.cuda.memory_allocated(device) / 1e6
    del warm
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()  # the card's memory, for 13f meanwhile
    rec["ready_s"] = time.monotonic() - T_IMPORT
    wait_for_file(os.path.join(workdir, "tp_go"))
    with fp32_math(deterministic=True):
        for name, (_, n, _) in runs.items():
            run(name, *states.pop(name), n)
    if rank == 0:
        rec["errs"]["one bf16 vs fp32"] = ref["one bf16 vs fp32"]
        rec["sgd_control"] = ref["sgd_control"]
        rec["split"] = ref["split"]
    with open(os.path.join(workdir, f"tp_rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def wait_for_file(path: str, read=None, timeout: float = 900.0):
    """Wait for ``path`` to exist; ``read(path)`` then, if given."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"no {path} in {timeout:.0f} s")
        time.sleep(0.1)
    return None if read is None else read(path)


def start_tp_ranks(workdir: str) -> tuple:
    """Phase 14's ranks, started now (they wait for ``tp_start.pt``, build
    their states and warm up, then wait for ``tp_go``): the processes and
    their log files."""
    port = free_port()
    logs = [open(os.path.join(workdir, f"tp_rank{r}.log"), "w")
            for r in range(TP_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--tp-rank",
         workdir], cwd=workdir, env=dp_env(port, r, TP_RANKS),
        stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(TP_RANKS)]
    return procs, logs


def check_tp_ranks(ranks: list, one_ms: dict) -> dict:
    """Phase 14's checks: each rank's place in JAX's grid, exactly 14 of
    each of #2-#4 a step in the run's dtype (the generative cells', on the
    rank's half of their hidden channels) and none of the other, every
    rank's metrics equal, no tensor differing across the ranks that must
    hold it alike after any step; the SGD step and the fp32 Adamax run
    against the one-process steps from the same start at the limits above,
    the SGD check's control, and the bf16 step by its distance from the
    one-process fp32 step (rank 0's errors, :func:`tp_step_errors`).  Logs
    the ms a step beside ``one_ms`` (the one-process step's alone on the
    card, phase 5's).  Returns the ranks' counts."""
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    errs, control = ranks[0]["errs"], ranks[0]["sgd_control"]
    for name, (cfg, n, _) in tp_configs().items():
        want = dict.fromkeys(KERNEL_NAMES, 0)
        want.update({k: expected_launches(cfg) * n
                     for k in TRAIN_KERNELS[cfg.compute_dtype]})
        for rec in ranks:
            r = rec["runs"][name]
            if rec["grid"] != [rec["rank"] // TP_MODEL,
                               rec["rank"] % TP_MODEL]:
                raise AssertionError(f"tp rank {rec['rank']}: grid "
                                     f"{rec['grid']}")
            if r["counts"] != want:
                raise AssertionError(f"tp {name} rank {rec['rank']}: "
                                     f"launches {r['counts']}, expected "
                                     f"{want}")
            if r["metrics"] != ranks[0]["runs"][name]["metrics"]:
                raise AssertionError(f"tp {name} rank {rec['rank']}: "
                                     f"metrics {r['metrics']} vs rank 0's")
            if any(r["mismatches"]):
                raise AssertionError(f"tp {name} rank {rec['rank']}: "
                                     f"differ across ranks "
                                     f"{r['mismatches']}")
            for k, v in r["counts"].items():
                counts[k] += v
    r0 = ranks[0]["runs"]
    log(f"tensor parallel (phase 14): {TP_DATA} data x {TP_MODEL} model "
        f"gloo ranks on {ranks[0]['device']}, {ranks[0]['rows']} rows a "
        f"data index, from 13f's warm start: the SGD step (lr {TP_SGD_LR}, "
        f"beside 13f's CLI, the ranks' first) "
        f"{[round(x, 1) for x in r0['sgd']['ms']]} ms; Adamax at lr "
        f"{PP_LR}, ms a step fp32 {[round(x, 1) for x in r0['fp32']['ms']]}"
        f" against the one process's {one_ms['fp32']:.1f}, bf16 (its first "
        f"bf16 step) {[round(x, 1) for x in r0['bf16']['ms']]} against "
        f"{one_ms['bf16']:.1f} (phase 5's B={BATCH} steps alone on the "
        f"card; the ranks share the card and sum through the host: no "
        f"scaling); MB a rank at rest "
        f"{[round(r['rest_mb'], 1) for r in ranks]}, peak fp32 "
        f"{[round(r['runs']['fp32']['peak_mb'], 1) for r in ranks]}, bf16 "
        f"{[round(r['runs']['bf16']['peak_mb'], 1) for r in ranks]}; "
        f"ranks ready (states built) {[round(r['ready_s'], 1) for r in ranks]}"
        f" s after their start; errors {errs}; the SGD check's control (the "
        f"{ranks[0]['split']} split kernels' gradient dropped): {control:.4g}"
        f" from the SGD step, limit {TP_CONTROL_MARGIN * PP_STATE_ATOL:.3g}")
    for name in r0:
        for i, mt in enumerate(r0[name]["metrics"]):
            log(f"  {name} step {i}: " + ", ".join(
                f"{k} {v:.9g}" for k, v in sorted(mt.items())))
    e = errs["sgd"]
    if not (e["loss_rel"] <= PP_LOSS_RTOL
            and e["grad_norm_rel"] <= TP_GRAD_NORM_RTOL
            and e["params"] <= PP_STATE_ATOL
            and e["bn_stats_scaled"] <= PP_DP_BN_RTOL):
        raise AssertionError(f"tensor parallel SGD: {e}")
    if not control >= TP_CONTROL_MARGIN * PP_STATE_ATOL:
        raise AssertionError(f"tensor parallel SGD: the check cannot fail: "
                             f"the split kernels' update dropped moves the "
                             f"parameters by {control}")
    e = errs["fp32"]
    if not (e["loss_rel"] <= PP_LOSS_RTOL
            and e["grad_norm_rel"] <= TP_GRAD_NORM_RTOL
            and e["params"] <= 3 * PP_LR * TP_STEPS
            and e["bn_stats_scaled_step0"] <= PP_DP_BN_RTOL):
        raise AssertionError(f"tensor parallel fp32: {e}")
    if errs["bf16"]["loss_rel"] > PP_LOSS_RTOL:
        raise AssertionError(f"tensor parallel bf16: {errs['bf16']}")
    got, one = errs["bf16 vs fp32"], errs["one bf16 vs fp32"]
    far = {k: (got[k], one[k]) for k in ("grad_norm_rel", "params",
                                         "bn_stats_scaled")
           if got[k] > TP_BF16_ROUNDING * one[k]}
    if far:
        raise AssertionError(f"tensor parallel bf16: farther from the fp32 "
                             f"step than {TP_BF16_ROUNDING} x the one "
                             f"process's bf16 step: {far}")
    return counts


def kernel_records(errs, launches, entries) -> list:
    """One record per kernel of ``entries`` (name, timing rows, the rows'
    key, the TPU kernel it replaces, the path call it times).  Times and
    bounds are per depthwise-config call of the path that runs the kernel
    (a ``sample`` call for the forwards, a training step for dx and dW/db):
    each shape weighted by its calls there (9, 5, 3, 3).  ``launches`` sums
    the main paths' counts."""
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
                "bound_share": max(b_bytes, b_ops) / r["ms"],
                "vs_library": r["ms"] / r["library_ms"],
                "max_abs_err": errs[name][(h, c)],
                **{k: row[k] for k in ("sets", "x_mb_in_sets") if k in row},
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


def kernel_times(root: str) -> None:
    """Times kernels #1-#5 of the ``nvae_torch`` found under ``root`` at the
    path and SE shapes, as phase 9 does, and prints them as one JSON line:
    run it on two trees in one call (parent, change, change, parent) to
    compare two versions of the kernels on one card."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import nvae_torch  # noqa: F401
    from nvae_torch.kernels import _build

    log(f"kernel times of {os.path.dirname(nvae_torch.__file__)}")
    _build.build(["depthwise5x5", "se_gate"])
    device = torch.device("cuda", 0)
    out = {"root": root, "forward": phase_forward_timing(device),
           "backward": phase_backward_timing(device),
           "se_gate": phase_se_timing(device)}
    from nvae_torch.kernels import depthwise as dw

    if hasattr(dw, "fused_swish_depthwise5x5_bf16"):  # trees with bf16 #2
        out["forward_bf16"] = phase_bf16_timing(device)
    if hasattr(dw, "fused_swish_depthwise5x5_dx_bf16"):  # and bf16 #3, #4
        out["backward_bf16"] = phase_bf16_backward_timing(device)
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--kernel-times", metavar="ROOT",
        help="only time kernels #1-#5 of the repository tree at ROOT")
    parser.add_argument("--dp-rank", metavar="DIR",
                        help="run one rank of phases 12a and 12d-1 (started "
                             "by phase 12 itself), writing its record to DIR")
    parser.add_argument("--pp-rank", metavar="DIR",
                        help="run one rank of phase 13f (started by phase "
                             "13 itself), writing its record to DIR")
    parser.add_argument("--tp-rank", metavar="DIR",
                        help="run one rank of phase 14 (started by phase "
                             "13 itself), writing its record to DIR")
    parser.add_argument("--host-refs", metavar="DIR",
                        help="run the CPU references of DIR's jobs (started "
                             "by the run itself)")
    parser.add_argument("--programs", metavar="DIR",
                        help="make phase 8's program artifacts in DIR "
                             "(started by the run itself)")
    args = parser.parse_args(argv)
    if args.host_refs:
        return host_refs(args.host_refs)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card",
              file=sys.stderr)
        return 1
    if args.programs:
        return program_helper(args.programs)
    if args.dp_rank:
        return dp_rank(args.dp_rank)
    if args.pp_rank:
        return pp_rank(args.pp_rank)
    if args.tp_rank:
        return tp_rank(args.tp_rank)
    if args.kernel_times:
        kernel_times(args.kernel_times)
        return 0
    sys.path.insert(0, ROOT)
    import nvae_torch  # noqa: F401  (fails outside the repository)

    t_start = time.monotonic()
    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    phase_build()
    # The program artifacts of phase 8 from a helper process, from now on.
    programs = ProgramHelper()
    # The CPU references of phases 5 and 11 from a helper process.
    host = HostRefs()
    add_host_jobs(host)
    try:
        return run_phases(device, host, programs, t_start)
    finally:
        host.close()
        programs.close()


def run_phases(device, host: HostRefs, programs: ProgramHelper,
               t_start: float) -> int:
    """Every phase after the build, in order; the result lines."""
    errs = checked_kernel_errors(device, PATH_SHAPES, FWD_BATCHES,
                                 BWD_BATCHES)
    phase_function_grads(device)
    se_errs = phase_se_gate(device)
    bf16_errs = phase_bf16_kernel(device)
    bf16_bwd_errs = phase_bf16_backward_kernels(device)
    tp_errs, tp_bf16 = phase_tp_kernels(device)
    for k, v in tp_errs.items():
        errs[k].update(v)
    log(f"kernels checked at {time.monotonic() - t_start:.1f} s")

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
    matrix = []
    for name, cfg in configs().items():
        rec = phase_matrix(name, cfg, device)
        matrix += rec["rows"]
        samplers[f"{name} bf16"] = rec["bf16_sampler"]
        for k, v in rec["launches"].items():
            launches[k] += v
    log(f"samplers and matrix done at {time.monotonic() - t_start:.1f} s")
    trainers, train_ms = {}, {}
    for name, cfg in {**configs(), **bf16_configs()}.items():
        rec = phase_train(cfg, device)
        train_ms[name] = rec["ms_per_step"]
        want = expected_launches(cfg) * TRAIN_STEPS
        log(f"train {name}: {TRAIN_STEPS} steps, counts {rec['counts']}, "
            f"first step {rec['first_step_ms']:.1f} ms, then "
            f"{rec['ms_per_step']:.2f} ms/step "
            f"({1e3 * BATCH / rec['ms_per_step']:.1f} img/s), peak memory "
            f"{rec['peak_mem_gb']:.2f} GB")
        for i, m in enumerate(rec["metrics"]):
            log(f"  step {i}: " + ", ".join(
                f"{k} {v:.6g}" for k, v in sorted(m.items())))
        # The reconstruction term: the whole loss rises with the KL
        # warm-up's beta over these first steps.
        losses = [m["reconstruction_loss"] for m in rec["metrics"]]
        if not rec["finite"] or rec["steps"] != TRAIN_STEPS:
            raise AssertionError(f"train {name}: non-finite metrics")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train {name}: the reconstruction loss "
                                 f"did not fall {losses}")
        # Each kernel of the compute dtype per step, none of the other.
        for dtype, names in TRAIN_KERNELS.items():
            n = want if dtype == cfg.compute_dtype else 0
            for k in names:
                if rec["counts"][k] != n:
                    raise AssertionError(
                        f"train {name}: {k} launched {rec['counts'][k]} "
                        f"times in {TRAIN_STEPS} steps, expected {n}")
        for k, v in rec["counts"].items():
            launches[k] += v
        if name in ("default", "depthwise", "depthwise bf16"):
            trainers[name] = rec  # profiled in phase 10
        del rec
    # Phase 5: the B=4 steps on the card now, held to the CPU's (from the
    # helper, started here) after phase 5b.
    host.start()
    card_steps = {}
    for name, cfg in configs().items():
        bf16_cfg = bf16_configs()["depthwise bf16"] if name == "depthwise" \
            else None
        card_steps[name] = train_vs_cpu_card(cfg, device, bf16_cfg)
    log(f"training done at {time.monotonic() - t_start:.1f} s")
    replayed = dict.fromkeys(KERNEL_NAMES, 0)
    scans = {}
    data = scan_data(device)
    for name, cfg in scan_configs().items():
        rec = phase_scan(cfg, device, data, repeat=name == "default")
        r = rec["timed"]
        log(f"scan {name}: epochs "
            + ", ".join(f"{t:.3f}" for t in r["epoch_seconds"])
            + f" s, last epoch {r['ms_per_step']:.2f} ms/step "
            f"({1e3 * BATCH / r['ms_per_step']:.1f} img/s), peak memory "
            f"{r['peak_mem_gb']:.2f} GB; {rec['eager_steps']} eager step, "
            f"{rec['replays']} replays of "
            f"{ {k: v for k, v in rec['launches_per_replay'].items() if v} }")
        for e, m in enumerate(r["means"]):
            log(f"  epoch {e}: " + ", ".join(
                f"{k} {v:.9g}" for k, v in sorted(m.items())))
        log(f"scan {name}: graph vs eager over {SCAN_CHECK_STEPS} steps, "
            f"deterministic cuDNN: {rec['check']['state']}, means equal "
            f"{rec['check']['means_equal']}, peak memory "
            f"{rec['check']['graph_peak_mem_gb']:.2f} / "
            f"{rec['check']['eager_peak_mem_gb']:.2f} GB"
            + (f"; eager vs eager, cuDNN's defaults: "
               f"{rec['repeat']['state']}, means equal "
               f"{rec['repeat']['means_equal']}" if "repeat" in rec else ""))
        check_scan(name, cfg, rec)
        for k, v in rec["counts"].items():
            launches[k] += v
        for k, v in r["replayed"].items():
            replayed[k] += v
        scans[name] = rec  # a replay profiled in phase 10
    del data
    log(f"scan path done at {time.monotonic() - t_start:.1f} s")
    for name, (card, card16) in card_steps.items():
        rec = train_vs_cpu_record(card, card16, host.ref(f"train {name}")())
        check_train_vs_cpu(name, rec)
        # bf16: the card no further from float64 than 1.5 times the CPU's
        # bf16 step (the kernels' plain versions) is.
        if card16 is not None and not (
                rec["bf16_card_vs_f64"]["grad_rel_l2"] <= CARD_VS_CPU_ROUNDING
                * rec["bf16_cpu_vs_f64"]["grad_rel_l2"]):
            raise AssertionError(f"train {name} bf16: card vs CPU {rec}")
    del card_steps
    for k, v in phase_se_entry(device).items():
        launches[k] += v
    workdir = tempfile.mkdtemp(prefix="nvae_chip_smoke_")
    try:
        torch.cuda.empty_cache()  # the subprocesses need the card's memory
        cli_rec, cli16, cli_scan = run_concurrently(
            lambda: phase_cli(workdir), lambda: phase_cli_bf16(workdir),
            lambda: phase_cli_scan(workdir))
        for k, v in cli_rec["counts"].items():
            launches[k] += v
        report_cli(cli_rec)
        for k, v in cli16["counts"].items():
            launches[k] += v
        report_cli(cli16)
        for k, v in cli_scan["counts"].items():
            launches[k] += v
        for k, v in cli_scan["replayed"].items():
            replayed[k] += v
        report_cli(cli_scan)
        log(f"cli done at {time.monotonic() - t_start:.1f} s")
        for k, v in phase_serving(workdir, device, programs).items():
            launches[k] += v
        log(f"serving done at {time.monotonic() - t_start:.1f} s")
        for k, v in phase_eval(workdir, device)["counts"].items():
            launches[k] += v
        log(f"metric suite done at {time.monotonic() - t_start:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    host.open_gate("rgb")  # the helper's RGB jobs from here on
    timing = phase_timing(device, samplers)
    bwd_timing = phase_backward_timing(device)
    bf16_timing = phase_bf16_timing(device)
    bf16_bwd_timing = phase_bf16_backward_timing(device)
    se_timing = phase_se_timing(device)
    tool_timing = phase_tool_timing(device)
    phase_profile(samplers, trainers, scans)
    # Phase 11 needs the card's memory: celeba64's step without remat
    # alone peaks near 46 GB.
    del samplers, trainers, scans
    torch.cuda.empty_cache()
    # The records' worst errors cover the RGB shapes too.
    for k, v in phase_rgb_kernels(device).items():
        errs[k].update(v)
    rgb_bf16 = phase_rgb_bf16_kernels(device)
    log(f"RGB kernels checked at {time.monotonic() - t_start:.1f} s")
    rgb_launches, rgb_replayed = phase_rgb_models(device, host)
    log(f"RGB models done at {time.monotonic() - t_start:.1f} s")
    workdir = tempfile.mkdtemp(prefix="nvae_chip_smoke_rgb_")
    try:
        cli_launches, cli_replayed = phase_rgb_cli(workdir, device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for k in KERNEL_NAMES:
        launches[k] += rgb_launches[k] + cli_launches[k]
        replayed[k] += rgb_replayed[k] + cli_replayed[k]
    log(f"RGB entry points done at {time.monotonic() - t_start:.1f} s")
    dp = phase_data_parallel(device)
    for k in KERNEL_NAMES:
        launches[k] += dp["counts"][k]
        replayed[k] += dp["replayed"][k]
    log(f"data parallel done at {time.monotonic() - t_start:.1f} s")
    one_ms = {"fp32": train_ms["default"], "bf16": train_ms["default bf16"]}
    for k, v in phase_pipeline(device, one_ms)["counts"].items():
        launches[k] += v
    log(f"pipeline done at {time.monotonic() - t_start:.1f} s")
    for k in (*TRAIN_KERNELS["float32"], *TRAIN_KERNELS["bfloat16"],
              "se_gate"):
        if launches[k] == 0:
            raise AssertionError(f"the main paths never launched {k}")
    rgb_timing = phase_rgb_timing(device)
    records = kernel_records(errs, launches, [
        ("fused_swish_depthwise5x5", timing["shapes"], "fused",
         "nvae_tpu/kernels/depthwise.py:239", "sample call"),
        ("depthwise_conv5x5", timing["shapes"], "thin",
         "nvae_tpu/kernels/depthwise.py:105", "sample call"),
        ("fused_swish_depthwise5x5_dx", bwd_timing, "dx",
         "nvae_tpu/kernels/depthwise.py:274", "training step"),
        ("fused_swish_depthwise5x5_dw", bwd_timing, "dw",
         "nvae_tpu/kernels/depthwise.py:288", "training step"),
    ])
    fused = next(r for r in records if r["name"] == "fused_swish_depthwise5x5")
    fused["tool_shapes"] = [
        {"shape": r["shape"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "library_ms": r["library_ms"], "bound_ms": max(r["bound"])}
        for r in tool_timing]
    records.append(bf16_record(bf16_errs, launches, bf16_timing))
    records += bf16_backward_records(bf16_bwd_errs, launches, bf16_bwd_timing)
    records.append(se_record(se_errs, launches, se_timing))
    for rec in records:  # #2 runs as this op, eager and in the programs
        if rec["name"] in ("fused_swish_depthwise5x5",
                           "fused_swish_depthwise5x5_bf16"):
            rec["op"] = "nvae_torch::fused_swish_dw5x5"
    for rec in records:  # bf16 #2-#4 at the RGB shapes (phase 11)
        if rec["name"] in ("fused_swish_depthwise5x5_bf16",
                           "fused_swish_depthwise5x5_dx_bf16"):
            kind = "fwd" if rec["name"].endswith("5x5_bf16") else "dx"
            rec["rgb_check"] = {
                "shapes": rgb_bf16["shapes"],
                "max_abs_err": rgb_bf16[f"{kind}_err"],
                "max_sum_ulps": rgb_bf16[f"{kind}_sum_ulps"],
                "bitwise_share": rgb_bf16[f"{kind}_equal"]}
        elif rec["name"] == "fused_swish_depthwise5x5_dw_bf16":
            rec["rgb_check"] = {"shapes": rgb_bf16["shapes"],
                                "max_abs_err": rgb_bf16["dw_err"]}
    for rec in records:  # bf16 #2-#4 at TP's shapes (phase 14)
        kind = {"fused_swish_depthwise5x5_bf16": "fwd",
                "fused_swish_depthwise5x5_dx_bf16": "dx",
                "fused_swish_depthwise5x5_dw_bf16": "dw"}.get(rec["name"])
        if kind is not None:
            rec["tp_check"] = {"shapes": tp_bf16["shapes"],
                               "max_abs_err": tp_bf16[f"{kind}_err"]}
    for rec in records:
        rec["replayed_launches"] = replayed.get(rec["name"], 0)
        if rec["name"] in rgb_timing:
            rec["rgb_shapes"] = [
                {**r, "max_abs_err": errs[rec["name"]][(r["shape"][1],
                                                        r["shape"][3])]}
                for r in rgb_timing[rec["name"]]]
    for row in matrix:
        log(f"matrix row: {json.dumps(row)}")
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
