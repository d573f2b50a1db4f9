"""One command that reproduces the reference's headline MNIST numbers with
the port (twin of ``tools/reproduce_baseline.py``): train the chosen
variant for the reference's 400 epochs, run both the corrected and the
bug-for-bug (``--eval_parity``) evaluation protocols, and print a table
against BASELINE.md (the reference's ``README.md:29-42``).

The numbers are comparable only with two local inputs the repository does
not hold: real MNIST (``--data_dir`` with ``mnist.npz`` or IDX files) and
ImageNet backbone weights (``$NVAE_TPU_WEIGHTS`` or ``--weights_dir`` with
``inception_v3.npz`` and ``vgg16.npz``).  Without them the run uses
``--dataset synthetic`` and fixed-seed random backbones, and the table
says that it is not comparable.  The full run::

    python -m nvae_torch.tools.reproduce_baseline --data_dir DIR \\
        --weights_dir DIR

Smoke mode (no data needed; ``--tiny_model`` swaps in the debug
architecture, ``--cpu`` runs on the CPU)::

    python -m nvae_torch.tools.reproduce_baseline --debug --dataset \\
        synthetic --tiny_model --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from nvae_torch.tools.common import add_cpu_flag, device_info, log, tool_device

# Reference numbers per variant (BASELINE.md / reference README.md:29-42).
BASELINE = {
    "step_sn": {
        "nll": (87.06, 2.18), "fid": 8.87,
        "precision": (0.8950, 0.0999), "recall": (0.9227, 0.0879),
        "ppl": (7.351e6, 6.31e5), "train_hours": 49.0,
    },
    "step_sr": {
        "nll": (80.33, 2.01), "fid": 30.37,
        "precision": (0.8559, 0.0608), "recall": (0.8803, 0.0546),
        "ppl": (7.391e6, 5.88e5), "train_hours": 104.0,
    },
    "epoch_sn": {
        "nll": (98.92, 1.83), "fid": 20.85,
        "precision": (0.7541, 0.152), "recall": (0.8828, 0.114),
        "ppl": (6.602e6, 5.30e5), "train_hours": 71.0,
    },
}

PRESET = {
    "step_sn": "mnist_step_sn_parity",  # forward SN + parity binarization
    "step_sr": "mnist_step_sr",
    "epoch_sn": "mnist_epoch_sn",
}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", choices=sorted(BASELINE), default="step_sn")
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--batch_size", type=int, default=144)
    ap.add_argument("--dataset", type=str, default="mnist")
    ap.add_argument("--data_dir", type=str, default="")
    ap.add_argument("--weights_dir", type=str, default="",
                    help="Directory with inception_v3.npz / vgg16.npz "
                         "(sets $NVAE_TPU_WEIGHTS)")
    ap.add_argument("--out", type=str, default="results/reproduce_baseline")
    ap.add_argument("--eval_attempts", type=int, default=10)
    ap.add_argument("--fid_sample_size", type=int, default=10000)
    ap.add_argument("--debug", action="store_true",
                    help="Smoke mode: 2 epochs, 4 batches, tiny eval, "
                         "random_conv backbones")
    ap.add_argument("--tiny_model", action="store_true",
                    help="The debug architecture in the preset's spectral "
                         "mode: a rehearsal of the whole tool, whose "
                         "numbers mean nothing")
    ap.add_argument("--seed", type=int, default=1)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)

    if args.weights_dir:
        os.environ["NVAE_TPU_WEIGHTS"] = args.weights_dir
    have_weights = all(
        os.path.exists(os.path.join(os.environ.get("NVAE_TPU_WEIGHTS", ""), f))
        for f in ("inception_v3.npz", "vgg16.npz"))
    if not have_weights:
        log("WARNING: no converted backbone weights found "
            "($NVAE_TPU_WEIGHTS/{inception_v3,vgg16}.npz): FID/P&R/PPL use "
            "fixed-seed random backbones and are NOT comparable to the "
            "reference's absolute numbers.")

    from nvae_torch.config import debug_config
    from nvae_torch.data import load_dataset, make_iterators, synthetic_dataset
    from nvae_torch.eval.evaluate import evaluate_model
    from nvae_torch.presets import get_preset
    from nvae_torch.train.trainer import Trainer
    from nvae_torch.utils.logging import MetricsLogger

    device = tool_device(args)
    os.makedirs(args.out, exist_ok=True)
    model_cfg, train_cfg = get_preset(PRESET[args.variant])
    model_cfg = dataclasses.replace(model_cfg, use_pallas_kernels=True)
    if args.tiny_model:
        model_cfg = debug_config(spectral_mode=model_cfg.spectral_mode,
                                 use_pallas_kernels=True)
    epochs = 2 if args.debug else args.epochs
    train_cfg = dataclasses.replace(
        train_cfg, dataset=args.dataset, epochs=epochs,
        batch_size=args.batch_size, seed=args.seed, debug=args.debug,
        scan_epochs=not args.debug, sample_frequency=10**9,
        evaluate_frequency=10**9, model_save_frequency=10**9,
        model_save_dir=os.path.join(args.out, "ckpt"),
        tensorboard_log_dir=os.path.join(args.out, "logs"),
        data_dir=args.data_dir)
    log(f"device: {device}")
    log(f"variant {args.variant} -> preset {PRESET[args.variant]}, "
        f"{epochs} epochs, dataset {args.dataset}")

    if args.dataset == "synthetic":
        bundle = synthetic_dataset(n_train=576 if args.debug else 15000,
                                   n_test=288)
    else:
        bundle = load_dataset(args.dataset, args.data_dir)
    train_iter, test_iter = make_iterators(
        bundle, args.batch_size, target_size=model_cfg.image_size,
        binarize=train_cfg.binary,
        parity_binarize_255=train_cfg.parity_binarize_255,
        seed=train_cfg.seed, device=device, debug=args.debug)
    logger = MetricsLogger(train_cfg.tensorboard_log_dir, tensorboard=False)
    trainer = Trainer(model_cfg, train_cfg, train_iter.batches_per_epoch,
                      logger=logger, device=device)

    # ---- train (resumes from the final checkpoint if present) ------------
    t0 = time.time()
    result = trainer.fit(train_iter, test_iter)
    train_hours = (time.time() - t0) / 3600.0
    log(f"training: {train_hours:.2f} h, best loss {result.best_loss:.2f}")

    # ---- evaluate: corrected protocol, then bug-for-bug ------------------
    eval_kw = dict(
        batch_size=args.batch_size,
        n_attempts=1 if args.debug else args.eval_attempts,
        temperatures=(1.0,) if args.debug else (0.6, 0.8, 1.0),
        fid_sample_size=(args.batch_size if args.debug
                         else args.fid_sample_size),
        feature_backbone="random_conv" if args.debug else "vgg16",
        fid_backbone="random_conv" if args.debug else "inception")
    log("corrected-protocol evaluation ...")
    corrected = evaluate_model(trainer, test_iter, **eval_kw)
    log("bug-for-bug (--eval_parity) evaluation ...")
    parity = evaluate_model(
        trainer, test_iter, pr_parity_accounting=True,
        pr_parity_orientation=True, parity_resize_299=True,
        parity_fid_uint8=True, parity_unit_input=True, **eval_kw)
    for name, ev in (("corrected", corrected), ("parity", parity)):
        with open(os.path.join(args.out, f"evaluation_{name}.json"), "w") as f:
            json.dump(ev.to_dict(), f, indent=2)

    # ---- comparison table ------------------------------------------------
    ref = BASELINE[args.variant]
    # The reference table's numbers are its T=1.0 row.
    t1 = [m for m in parity.sample_metrics if m.temperature == 1.0]
    t1 = t1[0] if t1 else parity.sample_metrics[-1]
    t1c = [m for m in corrected.sample_metrics if m.temperature == 1.0]
    t1c = t1c[0] if t1c else corrected.sample_metrics[-1]
    rows = [
        ("NLL (nats)", f"{ref['nll'][0]:.2f} ± {ref['nll'][1]:.2f}",
         f"{parity.nll.mean:.2f} ± {parity.nll.stddev:.2f}",
         f"{corrected.nll.mean:.2f} ± {corrected.nll.stddev:.2f}"),
        ("FID (10k, T=1.0)", f"{ref['fid']:.2f}", f"{t1.fid:.2f}",
         f"{t1c.fid:.2f}"),
        ("Precision", f"{ref['precision'][0]:.4f} ± {ref['precision'][1]:.4f}",
         f"{t1.precision.mean:.4f} ± {t1.precision.stddev:.4f}",
         f"{t1c.precision.mean:.4f} ± {t1c.precision.stddev:.4f}"),
        ("Recall", f"{ref['recall'][0]:.4f} ± {ref['recall'][1]:.4f}",
         f"{t1.recall.mean:.4f} ± {t1.recall.stddev:.4f}",
         f"{t1c.recall.mean:.4f} ± {t1c.recall.stddev:.4f}"),
        ("PPL", f"{ref['ppl'][0]:.3g} ± {ref['ppl'][1]:.2g}",
         f"{t1.ppl.mean:.3g} ± {t1.ppl.stddev:.2g}",
         f"{t1c.ppl.mean:.3g} ± {t1c.ppl.stddev:.2g}"),
        ("Train wall (h)", f"{ref['train_hours']:.0f}",
         f"{train_hours:.2f}", "same run"),
    ]
    comparable = have_weights and args.dataset == "mnist"
    caveat = "" if comparable else (
        " (NOT comparable: "
        + ("random backbones" if not have_weights else "")
        + ("," if not have_weights and args.dataset != "mnist" else "")
        + (f" dataset={args.dataset}" if args.dataset != "mnist" else "")
        + ")")
    print(f"\n## {args.variant} vs reference{caveat}\n")
    print("| Metric | Reference | Ours (bug-for-bug protocol) "
          "| Ours (corrected protocol) |")
    print("|---|---|---|---|")
    for r in rows:
        print("| " + " | ".join(r) + " |")
    print(f"\nArtifacts: {args.out}/evaluation_{{corrected,parity}}.json; "
          f"comparable={'yes' if comparable else 'no'}")
    with open(os.path.join(args.out, "comparison.json"), "w") as f:
        json.dump({"variant": args.variant, "comparable": comparable,
                   "reference": ref, "train_hours": train_hours,
                   "rows": rows, "device": device_info(device)}, f, indent=2)
    logger.close()


if __name__ == "__main__":
    main()
