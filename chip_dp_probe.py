#!/usr/bin/env python3
"""Why phase 12a of ``chip_smoke.py`` holds the data-parallel step from a
warmed-up state, on one NVIDIA GPU.

Run from the repository root (needs a CUDA card and ``nvcc``)::

    python3 chip_dp_probe.py

A data-parallel step sums in another order than the single step, so it can
be held to JAX's lockstep limits only where the step itself does not move
further than they allow when its sums are reordered.  For two starts of
the full-width default fp32 model (``chip_smoke.configs()["default"]``) at
batch 144, the seeded init and the state after phase 12a's Adamax warm-up,
it runs phase 12a's plain SGD steps on phase 12a's batches, once as they
are and once with each batch's halves swapped (the noise's with them): the
same function of the same rows, summed in another order.  It prints, per
start, each step's loss and grad_norm beside the swapped run's, their
relative differences, the parameters' largest difference, and which of
phase 12a's limits the reordering alone breaks.  About a minute, under
deterministic cuDNN.
"""

import subprocess
import sys

import torch

import chip_smoke as cs


def snapshot(state) -> dict:
    return {"sd": {k: v.detach().cpu() for k, v in
                   state.model.state_dict().items()}, "step": state.step}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_dp_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, cs.ROOT)
    cs.phase_build()
    device = torch.device("cuda", 0)
    cfg = cs.configs()["default"]
    with cs.deterministic_cudnn():
        state, step = cs.train_setup(cfg, device, cs.BATCH)
        starts = {"seeded init": snapshot(state)}
        for i in range(cs.DP_WARM_STEPS):
            state, _ = step(state, cs.train_batch(cs.BATCH, 1000 + i)
                            .to(device))
        starts[f"after {cs.DP_WARM_STEPS} Adamax steps"] = snapshot(state)
        del state, step
        runs = cs.SGDSteps(device)
        for name, start in starts.items():
            single = runs.run(start, cs.DP_STEPS)
            swapped = runs.run(start, cs.DP_STEPS, swap=True)
            r = cs.dp_readings(swapped["metrics"], swapped["params"][-1],
                               single)
            print(f"{name} (step {start['step']}), {cs.DP_STEPS} SGD steps "
                  f"at lr {cs.DP_LR}, as they are vs halves swapped:")
            for i, (a, b) in enumerate(zip(single["metrics"],
                                           swapped["metrics"])):
                print(f"  step {i}: loss {a['loss']:.9g} vs {b['loss']:.9g} "
                      f"(rel {r['loss'][i]:.3g}), grad_norm "
                      f"{a['grad_norm']:.9g} vs {b['grad_norm']:.9g} (rel "
                      f"{r['grad_norm'][i]:.3g})")
            print(f"  parameters: largest difference {r['params']:.3g}; "
                  f"phase 12a's limits ({cs.DP_LOSS_RTOL}, "
                  f"{cs.DP_GRAD_NORM_RTOL}, {cs.DP_PARAMS_ATOL}) broken: "
                  f"{cs.dp_over_limits(r) or 'none'}", flush=True)
            del single, swapped
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
