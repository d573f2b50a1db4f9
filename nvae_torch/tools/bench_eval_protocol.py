"""Wall time of one complete evaluation protocol of the port (twin of
``tools/bench_eval_protocol.py``).

Times one ``nvae_torch.eval.evaluate.evaluate_model`` call: 3 temperatures
x ``--attempts`` sampling attempts with P&R and PPL on VGG16 features, FID
over ``--fid_sample_size`` generated images on InceptionV3 features, and
the IWAE-10 NLL over the whole test set, against a checkpoint (that of
``python -m nvae_torch.tools.parity_run``; without one, an untrained model
of the same architecture, whose wall time is the same).  Prints one JSON
line, with each stage's seconds.

The backbones run at the reference's architectures (VGG16 at 224,
InceptionV3 at 299); without local ImageNet ``.npz`` weights they carry a
fixed-seed random init: the same work, so a representative time, while the
metric values are the framework's own (the evaluation records the weights'
provenance).

Usage::

    python -m nvae_torch.tools.bench_eval_protocol --ckpt \\
        results/parity_run/ckpt [--n_test 10000] [--fid_sample_size 10000] \\
        [--attempts 10] [--cpu] [--quick]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

from nvae_torch.tools.common import add_cpu_flag, device_info, log, tool_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default="results/parity_run/ckpt")
    ap.add_argument("--preset", default="mnist_step_sn_parity")
    ap.add_argument("--batch_size", type=int, default=144)
    ap.add_argument("--n_test", type=int, default=10000,
                    help="Test-set size (MNIST test = 10,000)")
    ap.add_argument("--n_train_for_steps", type=int, default=15000,
                    help="Training-set size the checkpoint was trained on "
                         "(fixes steps_per_epoch for restore)")
    ap.add_argument("--fid_sample_size", type=int, default=10000)
    ap.add_argument("--attempts", type=int, default=10)
    ap.add_argument("--temperatures", nargs="+", type=float,
                    default=[0.6, 0.8, 1.0])
    ap.add_argument("--out", default="")
    ap.add_argument("--quick", action="store_true",
                    help="Debug-size model, small test set and FID, "
                         "random_conv backbones, one attempt (tests)")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)

    from nvae_torch.config import debug_config
    from nvae_torch.data import make_iterators, synthetic_dataset
    from nvae_torch.eval.evaluate import evaluate_model
    from nvae_torch.presets import get_preset
    from nvae_torch.train.trainer import Trainer

    device = tool_device(args)
    backbones = ("vgg16", "inception")
    if args.quick:
        args.batch_size, args.n_test, args.fid_sample_size = 8, 16, 16
        args.attempts, args.temperatures = 1, [1.0]
        backbones = ("random_conv", "random_conv")
    log(f"device: {device}")
    model_cfg, train_cfg = get_preset(args.preset)
    model_cfg = dataclasses.replace(model_cfg, use_pallas_kernels=True)
    if args.quick:
        model_cfg = debug_config(spectral_mode=model_cfg.spectral_mode,
                                 use_pallas_kernels=True)
    steps_per_epoch = max(args.n_train_for_steps // args.batch_size, 1)
    train_cfg = dataclasses.replace(
        train_cfg, batch_size=args.batch_size, model_save_dir=args.ckpt,
        sample_frequency=10**9, evaluate_frequency=10**9,
        model_save_frequency=10**9)
    trainer = Trainer(model_cfg, train_cfg, steps_per_epoch, device=device)
    start_epoch = trainer.maybe_resume()
    if start_epoch == 0:
        log("WARNING: no checkpoint restored: timing an untrained model "
            "(the wall time is the architecture's, still representative)")
    else:
        log(f"restored checkpoint at epoch {start_epoch}")

    bundle = synthetic_dataset(n_train=args.batch_size, n_test=args.n_test)
    _, test_iter = make_iterators(bundle, args.batch_size,
                                  target_size=model_cfg.image_size,
                                  device=device)
    n_test = args.n_test // args.batch_size * args.batch_size

    timings: dict = {}
    t0 = time.time()
    evaluation = evaluate_model(
        trainer, test_iter, batch_size=args.batch_size,
        n_attempts=args.attempts, temperatures=tuple(args.temperatures),
        fid_sample_size=args.fid_sample_size,
        feature_backbone=backbones[0], fid_backbone=backbones[1],
        timings=timings)
    wall = time.time() - t0
    log(f"full protocol: {wall:.1f}s ({len(args.temperatures)} T x "
        f"{args.attempts} attempts, FID {args.fid_sample_size}, IWAE-10 "
        f"NLL over {n_test})")
    for m in evaluation.sample_metrics:
        log(f"  T={m.temperature}: fid={m.fid:.2f} p={m.precision} "
            f"r={m.recall} ppl={m.ppl}")
    log(f"  nll: {evaluation.nll}")

    # The reference protocol's cost: >10 h of P&R and ~5 h of PPL (its
    # report, section 4.1.2) before FID and NLL: at least 54,000 s.
    result = {
        "metric": "full_eval_protocol_wall",
        "value": round(wall, 1),
        "unit": "seconds",
        "vs_baseline": round(54000.0 / wall, 1),
        "n_test": n_test,
        "fid_sample_size": args.fid_sample_size,
        "attempts": args.attempts,
        "temperatures": args.temperatures,
        "checkpoint_epoch": start_epoch,
        "backbone_weights": evaluation.feature_backbone_weights,
        "stage_seconds": {k: round(v, 2) for k, v in timings.items()},
        "device": device_info(device),
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "evaluation": evaluation.to_dict()}, f,
                      indent=2)
    return result


if __name__ == "__main__":
    main()
