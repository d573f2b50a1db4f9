#!/usr/bin/env python3
"""Why ``chip_smoke.py`` holds the bf16 cifar10_dml step's gradient card vs
CPU from a warmed-up state, on one NVIDIA GPU.

Run from the repository root (needs a CUDA card and ``nvcc``)::

    python3 chip_dml_probe.py

For the full-width ``cifar10_dml`` config with its groups cut to
``RGB_CPU_GROUPS`` (the card-vs-CPU step's config), it takes the seeded
init and the states after 10, 30 and 60 Adamax steps at the preset's
batch from it (``chip_smoke.dml_warm_start``), and from each runs the
B=4 step of ``chip_smoke.phase_train_vs_cpu`` (its batch and noise) in
bf16 on the card and on the CPU (the kernels' plain versions), and in
fp32 on the card, on the CPU and on the CPU in float64.  It prints, per
start, each step's distance from the float64 one (``grad_errors``: the
loss, the whole gradient and its median leaf in relative L2, the
BatchNorm statistics) and the bf16 card's distance from the bf16 CPU's.
About three minutes.  ``--warm-steps 30 30`` takes only those starts:
the same count twice shows that the warm start (under deterministic
cuDNN) gives the same state, by the sum of its values, and the same
readings.
"""

import dataclasses
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

WARM_STEPS = (0, 10, 30, 60)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--warm-steps", type=int, nargs="+",
                        default=list(WARM_STEPS),
                        help="the Adamax steps of each start (a repeated "
                             "count shows the warm start is reproducible)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_dml_probe: no CUDA device", file=sys.stderr)
        return 1
    from nvae_torch.models.nvae import posterior_noise_shapes

    sys.path.insert(0, cs.ROOT)
    cs.phase_build()
    device = torch.device("cuda", 0)
    cfgs, batch = cs.rgb_configs("cifar10_dml")
    cut = dataclasses.replace(cfgs["cifar10_dml"],
                              n_groups_per_scale=cs.RGB_CPU_GROUPS)
    cut16 = dataclasses.replace(cut, **cs.BF16)
    x = cs.train_batch(4, 3, cut)
    rng = np.random.RandomState(4)
    eps = [[rng.randn(*s).astype(np.float32)
            for s in posterior_noise_shapes(cut, 4)]]
    for n in args.warm_steps:
        t0 = time.monotonic()
        start = cs.dml_warm_start(cut, device, batch, n) if n else None
        if start is not None:
            total = sum(float(v.double().abs().sum()) for v in start.values()
                        if v.is_floating_point())
            print(f"{n} Adamax steps: the state's sum of |values| "
                  f"{total!r}", flush=True)
        steps = {"bf16 card": cs.one_step_grads(cut16, device, x, eps,
                                                weights=start),
                 "bf16 CPU": cs.one_step_grads(cut16, "cpu", x, eps,
                                               weights=start),
                 "fp32 card": cs.one_step_grads(cut, device, x, eps,
                                                weights=start),
                 "fp32 CPU": cs.one_step_grads(cut, "cpu", x, eps,
                                               weights=start)}
        ref = cs.one_step_grads(cut, "cpu", x, eps, float64=True,
                                weights=start)
        print(f"{n} Adamax steps at batch {batch} "
              f"({time.monotonic() - t0:.1f} s): loss "
              f"{ref[0]['loss']:.9g}, grad_norm {ref[0]['grad_norm']:.9g}")
        for name, got in steps.items():
            print(f"  {name} vs float64: {cs.grad_errors(got, ref)}")
        print("  bf16 card vs bf16 CPU: "
              f"{cs.grad_errors(steps['bf16 card'], steps['bf16 CPU'])}",
              flush=True)
        del start, steps, ref
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
