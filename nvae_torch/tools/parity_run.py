"""A training run of the port's bit-parity configuration with held-out
curves (twin of ``tools/parity_run.py``).

Trains the ``mnist_step_sn_parity`` preset (per-forward spectral
normalization, the reference's ``> 0`` binarization, step-based KL warm-up)
on the scan path (``--scan_epochs``: one CUDA graph replay a step on the
card), tracking the held-out ELBO's parts and the IWAE NLL every
``--eval_every`` epochs.  ``--perf`` trains ``mnist_step_sn`` (projection
spectral normalization, proper binarization) with the depthwise postprocess
in bf16 compute and bf16 BatchNorm apply instead: the fastest configuration,
as a real training run, which measures bf16 training's convergence.

Without a local MNIST file (``--data_dir``) the dataset is ``synthetic``
(MNIST-shaped strokes), and the output says so.

Writes ``<out>/curves.json`` and prints a markdown table.  ``--quick``
trains a debug-size model for 2 epochs (for tests); ``--cpu`` runs on the
CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from nvae_torch.tools.common import add_cpu_flag, device_info, log, tool_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--dataset", type=str, default="synthetic")
    ap.add_argument("--data_dir", type=str, default="")
    ap.add_argument("--eval_every", type=int, default=5)
    ap.add_argument("--nll_attempts", type=int, default=10)
    ap.add_argument("--nll_batches", type=int, default=4)
    ap.add_argument("--out", type=str, default="results/parity_run")
    ap.add_argument("--batch_size", type=int, default=144)
    ap.add_argument("--n_train", type=int, default=15000,
                    help="synthetic dataset size (ignored for file datasets)")
    ap.add_argument("--perf", action="store_true",
                    help="Train the fastest configuration instead of the "
                         "bit-parity one: mnist_step_sn (projection SN, "
                         "proper binarization) + depthwise postprocess + "
                         "bf16 compute + bf16 BN apply")
    ap.add_argument("--quick", action="store_true",
                    help="Debug-size model, 2 epochs, few batches (tests)")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from nvae_torch.config import debug_config
    from nvae_torch.data import load_dataset, make_iterators, synthetic_dataset
    from nvae_torch.eval.nll import neg_log_likelihood
    from nvae_torch.presets import get_preset
    from nvae_torch.train.step import make_eval_step
    from nvae_torch.train.trainer import Trainer
    from nvae_torch.utils.logging import MetricsLogger
    from nvae_torch.utils.seeds import derive_seed

    device = tool_device(args)
    if args.quick:
        args.epochs, args.batch_size, args.n_train = min(args.epochs, 2), 16, 64
        args.nll_attempts, args.nll_batches = 2, 1
        args.eval_every = 1
    os.makedirs(args.out, exist_ok=True)
    preset = "mnist_step_sn" if args.perf else "mnist_step_sn_parity"
    model_cfg, train_cfg = get_preset(preset)
    model_cfg = dataclasses.replace(model_cfg, use_pallas_kernels=True)
    if args.perf:
        model_cfg = dataclasses.replace(
            model_cfg, postprocess_5x5_depthwise=True,
            compute_dtype="bfloat16", bn_apply_dtype="bfloat16")
    if args.quick:
        model_cfg = debug_config(
            spectral_mode=model_cfg.spectral_mode, use_pallas_kernels=True,
            postprocess_5x5_depthwise=model_cfg.postprocess_5x5_depthwise,
            compute_dtype=model_cfg.compute_dtype,
            bn_apply_dtype=model_cfg.bn_apply_dtype)
    train_cfg = dataclasses.replace(
        train_cfg, dataset=args.dataset, epochs=args.epochs,
        batch_size=args.batch_size, scan_epochs=True,
        sample_frequency=10**9,       # no image dumps in this run
        evaluate_frequency=10**9,     # the held-out pass below instead
        model_save_frequency=10**9,   # the final checkpoint only
        model_save_dir=os.path.join(args.out, "ckpt"),
        tensorboard_log_dir=os.path.join(args.out, "logs"),
        data_dir=args.data_dir)
    log(f"device: {device}")
    log(f"model: {model_cfg}")
    log(f"train: {train_cfg}")

    if args.dataset == "synthetic":
        log("dataset: synthetic (MNIST-shaped strokes; no local MNIST)")
        bundle = synthetic_dataset(n_train=args.n_train,
                                   n_test=max(args.nll_batches, 1)
                                   * args.batch_size)
    else:
        bundle = load_dataset(args.dataset, args.data_dir)
    train_iter, test_iter = make_iterators(
        bundle, args.batch_size, target_size=model_cfg.image_size,
        binarize=train_cfg.binary,
        parity_binarize_255=train_cfg.parity_binarize_255,
        seed=train_cfg.seed, device=device)
    logger = MetricsLogger(train_cfg.tensorboard_log_dir, tensorboard=False)
    trainer = Trainer(model_cfg, train_cfg, train_iter.batches_per_epoch,
                      logger=logger, device=device)
    eval_fn = make_eval_step(trainer.model, train_cfg)
    curves = []

    def held_out(epoch):
        test_batches = []
        for i, b in enumerate(test_iter.epoch(0)):
            if i >= args.nll_batches:
                break
            test_batches.append(b)
        gen = torch.Generator(device=device).manual_seed(
            derive_seed(train_cfg.seed, "held_out", epoch))
        em = eval_fn(trainer.state, test_batches[0], generator=gen)
        elbo = {k: float(v) for k, v in em.items()}
        t0 = time.time()
        nll_mean, nll_std = neg_log_likelihood(
            trainer.model, test_batches, seed=31 + epoch,
            n_attempts=args.nll_attempts)
        log(f"  [epoch {epoch}] held-out ELBO={elbo['elbo']:.2f} "
            f"IWAE-{args.nll_attempts} NLL={nll_mean:.2f}±{nll_std:.2f} "
            f"({time.time() - t0:.0f}s)")
        return {"epoch": epoch, "nll": nll_mean, "nll_std": nll_std, **elbo}

    def on_epoch_end(epoch, tr, means):
        log(f"epoch {epoch}: loss={means['loss']:.2f} "
            f"recon={means.get('reconstruction_loss', float('nan')):.2f} "
            f"kl={means.get('kl_loss', float('nan')):.2f} "
            f"{means['images_per_sec']:.0f} img/s")
        if epoch % args.eval_every == 0 or epoch == args.epochs - 1:
            curves.append(held_out(epoch))
            with open(os.path.join(args.out, "curves.json"), "w") as f:
                json.dump({"curves": curves, "history_len": epoch + 1}, f,
                          indent=2)

    t0 = time.time()
    result = trainer.fit(train_iter, test_iter, on_epoch_end=on_epoch_end)
    wall = time.time() - t0
    hist = result.history
    with open(os.path.join(args.out, "curves.json"), "w") as f:
        json.dump({"curves": curves, "history": hist, "wall_seconds": wall,
                   "config": preset + ("+perf" if args.perf else ""),
                   "dataset": args.dataset,
                   "device": device_info(device)}, f, indent=2)

    print("\n| epoch | train loss | train recon | train KL | held-out ELBO "
          f"| held-out IWAE-{args.nll_attempts} NLL |")
    print("|---|---|---|---|---|---|")
    for c in curves:
        e = c["epoch"]
        h = hist[e] if e < len(hist) else {}
        print(f"| {e} | {h.get('loss', float('nan')):.1f} "
              f"| {h.get('reconstruction_loss', float('nan')):.1f} "
              f"| {h.get('kl_loss', float('nan')):.1f} "
              f"| {c.get('elbo', float('nan')):.1f} "
              f"| {c['nll']:.1f} ± {c['nll_std']:.1f} |")
    log(f"total wall: {wall:.0f}s for {args.epochs} epochs "
        f"({result.best_loss:.2f} best train loss)")
    if not all(np.isfinite(c["nll"]) for c in curves):
        raise SystemExit("parity_run: a non-finite held-out NLL")
    return {"curves": curves, "history": hist, "wall_seconds": wall}


if __name__ == "__main__":
    main()
