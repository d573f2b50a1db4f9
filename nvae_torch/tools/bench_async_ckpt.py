"""How much checkpoint time the port's background writes hide during
training (twin of ``tools/bench_async_ckpt.py``).

The reference checkpoints synchronously from a Keras callback (its
``train.py:13-14,28``); the port's trainer takes a host snapshot of the
state and writes it in a background thread
(``nvae_torch.train.checkpoint.AsyncCheckpointWriter``), so the card keeps
training while the file is written.  On the scan path (the epoch runner,
one CUDA graph replay a step on the card), one model, state and runner
run, after a warm-up epoch (the eager step and the capture):

  baseline  E epochs, no checkpoint
  sync      E epochs, ``save_checkpoint`` (blocking) after every epoch
  async     E epochs, ``AsyncCheckpointWriter.save`` after every epoch and
            one ``close`` at the end (the trainer's discipline)

Prints one JSON line: each mode's steady seconds an epoch (the first epoch
left out), the exposed overhead an epoch, the runs' totals, and the ms a
save held the loop (sync: the whole write; async: the host snapshot).
Checkpoints go to a temporary directory that is removed.

Usage: ``python -m nvae_torch.tools.bench_async_ckpt [--epochs 4]
[--quick] [--cpu]``
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

from nvae_torch.tools.common import add_cpu_flag, device_info, log, tool_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch_size", type=int, default=144)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--n_train", type=int, default=14976)
    p.add_argument("--quick", action="store_true",
                   help="Tiny debug model, few steps (for tests)")
    add_cpu_flag(p)
    args = p.parse_args(argv)

    import numpy as np

    from nvae_torch.config import ModelConfig, TrainConfig, debug_config
    from nvae_torch.data import synthetic_dataset
    from nvae_torch.parallel.mesh import state_bytes
    from nvae_torch.train import checkpoint as ckpt
    from nvae_torch.train.epoch_runner import make_epoch_runner, stage_dataset
    from nvae_torch.train.state import create_train_state

    device = tool_device(args)
    if args.quick:
        model_cfg = debug_config(use_pallas_kernels=True)
        args.batch_size, args.n_train = 16, 32
    else:
        model_cfg = ModelConfig(use_pallas_kernels=True)
    bs = args.batch_size
    n_train = args.n_train // bs * bs
    steps_per_epoch = n_train // bs
    train_cfg = TrainConfig(batch_size=bs, step_based_warmup=True)
    total_steps = 400 * (60000 // bs)

    t0 = time.time()
    model, state, tx = create_train_state(model_cfg, train_cfg, total_steps,
                                          device=device)
    n_params = sum(p.numel() for p in model.parameters())
    nbytes = state_bytes(state)
    log(f"init: {time.time() - t0:.1f}s, {n_params / 1e6:.2f}M params, "
        f"full train state {nbytes / 1e6:.0f} MB")
    bundle = synthetic_dataset(n_train=n_train, n_test=bs)
    runner = make_epoch_runner(model, tx, train_cfg, total_steps,
                               steps_per_epoch, target_size=32)
    data = stage_dataset(bundle.train_x, device)
    epoch = [0]

    def run_one_epoch():
        nonlocal state
        state, means = runner(state, data, epoch[0])  # ends in one fetch
        epoch[0] += 1
        return means

    log("warm-up epoch (eager step, capture) ...")
    run_one_epoch()

    def run(mode: str):
        ckpt_dir = tempfile.mkdtemp(prefix=f"nvae_ckpt_{mode}_")
        writer = (ckpt.AsyncCheckpointWriter(ckpt_dir) if mode == "async"
                  else None)
        times, held = [], []
        t_total = time.time()
        try:
            for _ in range(args.epochs):
                t0 = time.time()
                run_one_epoch()
                if mode == "sync":
                    t1 = time.perf_counter()
                    ckpt.save_checkpoint(ckpt_dir, state.step, state)
                    held.append(1e3 * (time.perf_counter() - t1))
                elif mode == "async":
                    writer.save(state.step, state)
                times.append(time.time() - t0)
                log(f"  {mode} epoch: {times[-1]:.2f}s")
            t_wait = time.time()
            if writer is not None:
                writer.close()
                held = [blocking for _, blocking, _ in writer.timings]
            wait_s = time.time() - t_wait
            if wait_s > 0.01:
                log(f"  {mode} final durability wait: {wait_s:.2f}s")
            return times, time.time() - t_total, held
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

    results = {}
    for mode in ("baseline", "sync", "async"):
        times, total, held = run(mode)
        steady = times[1:] or times
        results[mode] = {"epoch_s": round(sum(steady) / len(steady), 3),
                         "total_s": round(total, 2),
                         "held_ms": [round(h, 1) for h in held]}
        log(f"{mode}: {results[mode]['epoch_s']:.2f}s/epoch steady, "
            f"{total:.1f}s total")
    base = results["baseline"]["epoch_s"]
    report = {
        "metric": "async_ckpt_overlap",
        "state_mb": round(nbytes / 1e6, 1),
        "epochs": args.epochs,
        "steps_per_epoch": steps_per_epoch,
        "batch_size": bs,
        "baseline_epoch_s": results["baseline"]["epoch_s"],
        "sync_epoch_s": results["sync"]["epoch_s"],
        "async_epoch_s": results["async"]["epoch_s"],
        "sync_overhead_s_per_epoch": round(results["sync"]["epoch_s"] - base,
                                           3),
        "async_overhead_s_per_epoch": round(
            results["async"]["epoch_s"] - base, 3),
        "sync_total_s": results["sync"]["total_s"],
        "async_total_s": results["async"]["total_s"],
        "sync_blocked_ms": results["sync"]["held_ms"],
        "async_blocked_ms": results["async"]["held_ms"],
        "device": device_info(device),
    }
    if not np.isfinite(report["async_epoch_s"]):
        raise SystemExit("bench_async_ckpt: no epoch time")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
