"""Command-line entry point of the port, with the JAX CLI's flag names
(``nvae_tpu/cli.py``, itself the reference's ``train.py:145-297``).

Modes:
  train   run the training loop with checkpoints and image hooks
  sample  write sample PNGs at temperatures {0.7, 0.8, 0.9, 1.0}
          (and, with --scale_temperatures, t_annealed/)
  test    evaluate the checkpoint (nvae_torch/eval/evaluate.py): per
          --eval_temperatures, --eval_attempts rounds of precision/recall
          and PPL, then FID over --fid_sample_size samples, then the IWAE
          NLL; prints it, and each stage's wall seconds, and writes
          evaluation.json to --tensorboard_log_dir
  serve   serve the checkpoint over HTTP (nvae_torch/serving_http.py):
          dynamic batching at --batch_size and --serve_batches, weights
          in --serve_dtype, hot reload from --model_save_dir

It runs on the card unless --cpu asks for the CPU, and raises if there is
no card.  --data_parallel N trains, tests and serves over N ranks, one
process per device, started by a launcher:
  torchrun --nproc_per_node N -m nvae_torch.cli ... --data_parallel N
(N must be the launcher's world size, or 0 for it; rank 0 alone writes
logs, images, checkpoints and evaluation.json, and serves HTTP).  --fsdp
with it trains in the FSDP layout (parameters, Adamax moments and EMA
sharded 1/N over the ranks, parallel/mesh.py); in a world of 1 it is the
replicated layout, as in the JAX CLI.  --mode test, sample and serve read
the checkpoint, which is whole in either layout, into the replicated
layout: their results are those of the state gathered once, which equal
JAX's in either layout.  --pp_stages S > 1 trains through the pipeline
(parallel/pipeline.py: the four stage modules over S stages;
--pp_microbatches microbatches a step, --pp_schedule 1f1b or gpipe), each
stage over --data_parallel N ranks (default: the world's ranks, or in one
process the cards, over the stages).  N = 1 is one process over the first
S cards, or S times the CPU with --cpu; N > 1 is S*N processes, one per
device, stage-major (ranks [s*N, (s+1)*N) hold stage s):
  torchrun --nproc_per_node S*N -m nvae_torch.cli ... --pp_stages S \
      --data_parallel N
and any other world stops with that line.  With --fsdp or --scan_epochs it
stops with the JAX CLI's message.  Its checkpoint is the whole model's:
--mode test, sample and serve read it whatever --pp_stages says, in one
process on one device, and in a world of ranks over the world's ranks as
under --data_parallel.  bf16 (--compute_dtype,
--bn_apply_dtype) trains, samples and serves, each flag composing with a
preset as in the JAX CLI.  --scan_epochs stages the training set on the
device and replays each step as one CUDA graph (with --cpu the same steps
run eagerly); with --grad_accum > 1 it stops, as in the JAX CLI.
--workers, --multiprocessing and --verbose are accepted as no-ops, as in
the JAX CLI.  With --preset the
flags compose exactly as the JAX CLI composes them: the preset's batch
size, warm-up, parity and EMA settings win over those flags.

Usage:
  python -m nvae_torch.cli --mode train --dataset synthetic --debug --epochs 2
  python -m nvae_torch.cli --mode train --dataset synthetic --debug --cpu \\
      --n_encoder_channels 8 --n_decoder_channels 8 --n_groups_per_scale 1 1
  python -m nvae_torch.cli --mode serve --preset mnist_step_sn --use_pallas \\
      --dataset synthetic --serve_dtype int8 --compute_dtype bfloat16 \\
      --serve_batches 144 576 --serve_port 8000
  python -m nvae_torch.cli --mode test --preset mnist_step_sn --use_pallas \\
      --dataset synthetic --debug --eval_attempts 2
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import random

import numpy as np

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    # -- reference flags (train.py:145-297), same names and defaults --------
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--batch_size", type=int, default=144)
    p.add_argument("--mode", type=str,
                   choices=["train", "test", "sample", "serve"],
                   default="train")
    p.add_argument("--n_encoder_channels", type=int, default=32)
    p.add_argument("--n_decoder_channels", type=int, default=32)
    p.add_argument("--res_cells_per_group", type=int, default=1)
    p.add_argument("--n_preprocess_blocks", type=int, default=2)
    p.add_argument("--n_preprocess_cells", type=int, default=3)
    p.add_argument("--n_postprocess_blocks", type=int, default=2)
    p.add_argument("--n_postprocess_cells", type=int, default=3)
    p.add_argument("--n_latent_per_group", type=int, default=20)
    p.add_argument("--n_groups_per_scale", nargs="+", type=int, default=[5, 10])
    p.add_argument("--sr_lambda", type=float, default=0.01)
    p.add_argument("--scale_factor", type=int, default=2)
    # Default None (= mnist without a preset) so an explicit "--dataset
    # mnist" can override a preset's dataset.
    p.add_argument("--dataset", type=str, default=None,
                   choices=["mnist", "fashion_mnist", "omniglot", "cifar10",
                            "celeba", "synthetic", "synthetic_rgb",
                            "synthetic_rgb64"])
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (default: the CUDA card)")
    p.add_argument("--debug", action="store_true",
                   help="Use only the first 4 batches of data")
    p.add_argument("--n_samples", type=int, default=10)
    p.add_argument("--verbose", action="store_true",
                   help="Accepted for reference CLI parity; no-op")
    p.add_argument("--model_save_dir", type=str, default="models")
    p.add_argument("--sample_dir", type=str, default="results")
    p.add_argument("--resume_from", type=int, default=0)
    p.add_argument("--tensorboard_log_dir", type=str, default="logs")
    p.add_argument("--sample_frequency", type=int, default=5)
    p.add_argument("--evaluate_frequency", type=int, default=10)
    p.add_argument("--log_frequency", type=int, default=1)
    p.add_argument("--binary_eval", action="store_true")
    p.add_argument("--patience", type=int, default=0)
    p.add_argument("--model_save_frequency", type=int, default=10)
    p.add_argument("--step_based_warmup", action="store_true")
    p.add_argument("--workers", type=int, default=1,
                   help="Accepted for reference CLI parity; no-op")
    p.add_argument("--multiprocessing", action="store_true",
                   help="Accepted for reference CLI parity; no-op")
    p.add_argument("--seed", type=int, default=1)
    # -- extras of the JAX CLI ----------------------------------------------
    p.add_argument("--data_dir", type=str, default="",
                   help="Directory with local dataset files")
    p.add_argument("--spectral_mode", type=str, default="projection",
                   choices=["projection", "forward", "penalty", "none"])
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--bn_apply_dtype", type=str, default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--likelihood", type=str, default="",
                   help="bernoulli|dml; default picks by dataset")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="Ranks on the data axis: 0 or the launcher's world "
                        "size (torchrun --nproc_per_node N); with "
                        "--pp_stages S, the ranks of each stage (a world of "
                        "S*N)")
    p.add_argument("--fsdp", action="store_true",
                   help="Train in the FSDP layout over the data axis")
    p.add_argument("--profile_dir", type=str, default="",
                   help="Write a torch.profiler trace of one epoch here")
    p.add_argument("--parity_binarize_255", action="store_true",
                   help="Reproduce the reference's >0-threshold binarization")
    p.add_argument("--parity_frozen_norm", action="store_true",
                   help="Reproduce the reference's training-mode defect: "
                        "BatchNorm and spectral normalization run in "
                        "inference mode during training")
    p.add_argument("--temperature_all_groups", action="store_true",
                   help="Apply sampling temperature to every latent group "
                        "(the reference only scales z0)")
    p.add_argument("--scale_temperatures", nargs="+", type=float,
                   default=None, metavar="T",
                   help="Annealed sampling: one temperature per decoder "
                        "scale, top-down; sample mode writes an extra "
                        "t_annealed/ directory with this schedule")
    p.add_argument("--preset", type=str, default="",
                   help="Named experiment preset (nvae_torch/presets.py); "
                        "runtime flags (epochs, dirs, seed, debug, ...) "
                        "still apply")
    p.add_argument("--scan_epochs", action="store_true",
                   help="Run each epoch as one CUDA graph replay per "
                        "step over a device-resident dataset (fastest "
                        "path; dataset must fit HBM)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="Exponential moving average of the params inside "
                        "the optimizer (e.g. 0.9999); 0 disables. Sample on "
                        "the average with --use_ema")
    p.add_argument("--use_ema", action="store_true",
                   help="sample mode: run on the EMA weights from the "
                        "checkpoint (requires --ema_decay training)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="Microbatches per optimizer step")
    p.add_argument("--pp_stages", type=int, default=1,
                   help="Pipeline parallelism (GPipe): split the model's "
                        "stage modules over this many stages (2-4), each "
                        "over --data_parallel ranks; each stage holds 1/S "
                        "of params+optimizer. Excludes "
                        "--scan_epochs/--grad_accum/--fsdp")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="GPipe microbatches per optimizer step (0 = "
                        "pp_stages); the pipeline's gradient accumulation")
    p.add_argument("--pp_schedule", choices=("1f1b", "gpipe"), default="1f1b",
                   help="Pipeline dispatch order: 1f1b bounds the "
                        "boundary-activation stash at O(stages); gpipe is "
                        "classic fill-drain (O(microbatches)). Bitwise "
                        "identical results either way")
    p.add_argument("--postprocess_depthwise", action="store_true",
                   help="Depthwise postprocess 5x5 (non-parity, faster)")
    p.add_argument("--use_pallas", action="store_true",
                   help="The hand-written fused swish->depthwise-5x5 CUDA "
                        "kernels on the hot spots (the JAX flag's name)")
    p.add_argument("--serve_host", type=str, default="127.0.0.1")
    p.add_argument("--serve_port", type=int, default=8000)
    p.add_argument("--serve_max_delay_ms", type=float, default=10.0,
                   help="Launch a partial batch once the oldest queued "
                        "request has waited this long (0 = full batches "
                        "only)")
    p.add_argument("--serve_batches", type=int, nargs="*", default=None,
                   help="Further serving batch sizes beside --batch_size: "
                        "a partial dispatch runs the smallest size that "
                        "covers the backlog")
    p.add_argument("--serve_fetch_workers", type=int, default=2,
                   help="Threads copying dispatch results to the host")
    p.add_argument("--serve_follow_s", type=float, default=0.0,
                   help="Poll the checkpoint dir every N seconds and "
                        "hot-reload newer steps; 0 = reload only on POST "
                        "/reload or SIGHUP")
    p.add_argument("--serve_dtype", type=str, default="",
                   choices=["", "bfloat16", "int8"],
                   help="Weight serving dtype: bfloat16 casts the "
                        "parameters, int8 quantizes the large kernels per "
                        "output channel (BatchNorm statistics stay fp32)")
    p.add_argument("--serve_output", type=str, default="",
                   choices=["", "uint8"],
                   help="Serve uint8 pixels, round(p * 255) on the device")
    # The evaluation protocol (--mode test); the reference hardcodes 10
    # attempts, {0.6, 0.8, 1.0} and 10,000 FID samples (evaluate.py:58-156).
    p.add_argument("--eval_attempts", type=int, default=10)
    p.add_argument("--eval_temperatures", nargs="+", type=float,
                   default=[0.6, 0.8, 1.0])
    p.add_argument("--fid_sample_size", type=int, default=10000)
    p.add_argument("--feature_backbone", type=str, default="vgg16",
                   choices=["vgg16", "inception", "random_conv"],
                   help="P&R/PPL feature space (the reference's VGG16)")
    p.add_argument("--fid_backbone", type=str, default="inception",
                   choices=["vgg16", "inception", "random_conv"],
                   help="FID feature space (the reference's Inception "
                        "pool_3; published FIDs are only comparable there)")
    # The metric protocol's parity switches (PARITY.md); --eval_parity
    # turns all of them on.
    p.add_argument("--pr_parity_accounting", action="store_true",
                   help="The reference's [0, 2]-scaled P&R accounting")
    p.add_argument("--pr_parity_orientation", action="store_true",
                   help="The reference's swapped P&R argument order")
    p.add_argument("--parity_resize_299", action="store_true",
                   help="Nearest resize to 299x299 before the backbones")
    p.add_argument("--parity_fid_uint8", action="store_true",
                   help="uint8-quantize images before the FID features")
    p.add_argument("--parity_unit_input", action="store_true",
                   help="Feed raw [0, 1] images to the backbones")
    p.add_argument("--eval_parity", action="store_true",
                   help="Turn on every metric-protocol parity switch")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Stop with ``SystemExit`` on a combination of flags the port does not
    run: ``--pp_stages`` with ``--fsdp`` or ``--scan_epochs``, with the JAX
    CLI's refusal (``nvae_tpu/cli.py:416-419``)."""
    if args.pp_stages > 1 and (args.fsdp or args.scan_epochs):
        raise SystemExit("--pp_stages excludes --fsdp/--scan_epochs "
                         "(per-stage placement vs whole-mesh GSPMD layouts)")


def build_configs(args, bundle):
    from nvae_torch.config import ModelConfig, TrainConfig

    likelihood = args.likelihood or (
        "dml" if bundle.channels == 3 else "bernoulli"
    )
    target = 32 if bundle.image_size <= 32 else bundle.image_size
    model_cfg = ModelConfig(
        image_size=target,
        in_channels=bundle.channels,
        n_encoder_channels=args.n_encoder_channels,
        n_decoder_channels=args.n_decoder_channels,
        res_cells_per_group=args.res_cells_per_group,
        n_preprocess_blocks=args.n_preprocess_blocks,
        n_preprocess_cells=args.n_preprocess_cells,
        n_postprocess_blocks=args.n_postprocess_blocks,
        n_postprocess_cells=args.n_postprocess_cells,
        n_latent_per_group=args.n_latent_per_group,
        n_groups_per_scale=tuple(args.n_groups_per_scale),
        scale_factor=args.scale_factor,
        sr_lambda=args.sr_lambda,
        likelihood=likelihood,
        spectral_mode=args.spectral_mode,
        compute_dtype=args.compute_dtype or "float32",
        bn_apply_dtype=args.bn_apply_dtype or "float32",
        temperature_all_groups=args.temperature_all_groups,
        remat=args.remat,
        postprocess_5x5_depthwise=args.postprocess_depthwise,
        use_pallas_kernels=args.use_pallas,
    )
    train_cfg = TrainConfig(
        epochs=args.epochs,
        batch_size=args.batch_size,
        dataset=args.dataset,
        seed=args.seed,
        step_based_warmup=args.step_based_warmup,
        parity_binarize_255=args.parity_binarize_255,
        parity_frozen_norm=args.parity_frozen_norm,
        binary=likelihood == "bernoulli",
        debug=args.debug,
        sample_frequency=args.sample_frequency,
        evaluate_frequency=args.evaluate_frequency,
        log_frequency=args.log_frequency,
        model_save_frequency=args.model_save_frequency,
        patience=args.patience or 0,
        resume_from=args.resume_from,
        n_samples=args.n_samples,
        binary_eval=args.binary_eval,
        model_save_dir=args.model_save_dir,
        sample_dir=args.sample_dir,
        tensorboard_log_dir=args.tensorboard_log_dir,
        data_dir=args.data_dir,
        scan_epochs=args.scan_epochs,
        # --use_ema alone (sampling an EMA checkpoint) must still build the
        # optimizer chain WITH the EMA slot, or the checkpoint's optimizer
        # state will not fit the template; the decay itself is unused.
        ema_decay=args.ema_decay or (0.9999 if args.use_ema else 0.0),
        grad_accum=args.grad_accum,
        data_parallel=args.data_parallel,
        pipeline_stages=args.pp_stages,
        pipeline_microbatches=args.pp_microbatches,
        pipeline_schedule=args.pp_schedule,
    )
    return model_cfg, train_cfg


def preset_configs(args):
    """(model_cfg, train_cfg) of ``--preset`` composed with the flags
    exactly as the JAX CLI composes them: the preset fixes the
    architecture and its training settings (batch size, warm-up, parity
    switches, EMA); the dtype flags override it only when given, and the
    other performance switches can only turn a feature on; the runtime
    flags and an explicit ``--dataset`` apply as given."""
    from nvae_torch.presets import get_preset

    model_cfg, preset_train = get_preset(args.preset)
    model_cfg = dataclasses.replace(
        model_cfg,
        compute_dtype=args.compute_dtype or model_cfg.compute_dtype,
        bn_apply_dtype=args.bn_apply_dtype or model_cfg.bn_apply_dtype,
        postprocess_5x5_depthwise=(
            model_cfg.postprocess_5x5_depthwise or args.postprocess_depthwise),
        use_pallas_kernels=model_cfg.use_pallas_kernels or args.use_pallas,
        remat=model_cfg.remat or args.remat,
    )
    train_cfg = dataclasses.replace(
        preset_train,
        dataset=args.dataset or preset_train.dataset,
        epochs=args.epochs,
        seed=args.seed,
        debug=args.debug,
        sample_frequency=args.sample_frequency,
        evaluate_frequency=args.evaluate_frequency,
        log_frequency=args.log_frequency,
        model_save_frequency=args.model_save_frequency,
        patience=args.patience or 0,
        resume_from=args.resume_from,
        n_samples=args.n_samples,
        model_save_dir=args.model_save_dir,
        sample_dir=args.sample_dir,
        tensorboard_log_dir=args.tensorboard_log_dir,
        data_dir=args.data_dir,
        scan_epochs=args.scan_epochs,
        grad_accum=args.grad_accum,
        data_parallel=args.data_parallel,
        pipeline_stages=args.pp_stages,
        pipeline_microbatches=args.pp_microbatches,
        pipeline_schedule=args.pp_schedule,
    )
    return model_cfg, train_cfg


def configs_from_args(args):
    """``(model_cfg, train_cfg, dataset)`` of parsed flags, as a run takes
    them: from ``--preset`` composed with the flags, or from the flags and
    the dataset's shape.  Fills in ``args.dataset`` and ``args.batch_size``
    (the preset's batch size wins, as in the JAX CLI)."""
    from nvae_torch.data import load_dataset

    if args.preset:
        model_cfg, train_cfg = preset_configs(args)
        bundle = load_dataset(train_cfg.dataset, args.data_dir)
        args.dataset = train_cfg.dataset
        args.batch_size = train_cfg.batch_size
    else:
        args.dataset = args.dataset or "mnist"
        bundle = load_dataset(args.dataset, args.data_dir)
        model_cfg, train_cfg = build_configs(args, bundle)
    return model_cfg, train_cfg, bundle


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)

    import torch

    from nvae_torch.parallel import (
        initialize,
        is_primary,
        make_mesh,
        process_count,
    )
    from nvae_torch.parallel.pipeline import pipeline_dp

    # Before anything touches the card: binds this rank to its device.
    initialize(device="cpu" if args.cpu else "cuda")
    pipeline = args.pp_stages > 1
    try:
        if pipeline and args.mode == "train":
            # The stages' ranks: --data_parallel is a stage's share of the
            # world, which must be S*N.
            pipeline_dp(args.pp_stages, args.data_parallel, process_count(),
                        1 if args.cpu else torch.cuda.device_count())
            mesh = None
        else:
            # --data_parallel must be 0 or the launcher's world size; the
            # other modes read a pipeline's checkpoint over its world.
            mesh = make_mesh(0 if pipeline else args.data_parallel,
                             device="cpu" if args.cpu else None)
    except ValueError as e:
        flag = "--pp_stages" if pipeline else "--data_parallel"
        raise SystemExit(f"{flag}: {e}") from None
    primary = is_primary()
    if primary:
        print(f"Args: {vars(args)}")
    random.seed(args.seed)
    np.random.seed(args.seed)

    from nvae_torch.data import make_iterators
    from nvae_torch.device import resolve_device
    from nvae_torch.train.trainer import Trainer
    from nvae_torch.utils.logging import MetricsLogger

    model_cfg, train_cfg, bundle = configs_from_args(args)
    device = (mesh.device if mesh is not None
              else resolve_device("cpu" if args.cpu else "cuda"))
    # The other modes read the checkpoint, whole in either layout (and
    # whatever the pipeline's stage count).
    param_sharding = ("fsdp" if args.fsdp and args.mode == "train"
                      else "replicated")
    if args.mode != "train":
        train_cfg = dataclasses.replace(train_cfg, pipeline_stages=1)
    if mesh is not None and primary:
        print(f"Mesh: {mesh.size} ranks over {mesh.backend}, "
              f"{param_sharding} layout", flush=True)

    if args.scale_temperatures is not None and len(
            args.scale_temperatures) != model_cfg.n_latent_scales:
        raise SystemExit(
            f"--scale_temperatures needs one value per decoder scale "
            f"({model_cfg.n_latent_scales} for this config), got "
            f"{len(args.scale_temperatures)}"
        )

    train_iter, test_iter = make_iterators(
        bundle, args.batch_size, target_size=model_cfg.image_size,
        binarize=train_cfg.binary if args.mode == "train" else args.binary_eval,
        parity_binarize_255=args.parity_binarize_255, seed=args.seed,
        device=device, debug=args.debug,
        # --mode test takes the whole test set on every rank, as JAX's
        # global batches hold it; its feature passes split the rows.
        mesh=mesh if args.mode == "train" else None,
        grad_accum=train_cfg.grad_accum,
    )
    if primary:
        print(f"Dataset {bundle.name}: {len(bundle.train_x)} train / "
              f"{len(bundle.test_x)} test, {len(train_iter)} batches/epoch")

    logger = MetricsLogger(args.tensorboard_log_dir) if primary else None
    try:
        trainer = Trainer(model_cfg, train_cfg,
                          steps_per_epoch=len(train_iter), logger=logger,
                          device=device, mesh=mesh,
                          param_sharding=param_sharding)
        pp = trainer.pipeline
        if pp is not None and primary:
            print(f"Pipeline: {pp.n_stages} stages x dp={pp.dp}, "
                  f"{pp.schedule} over {pp.n_microbatches} microbatches",
                  flush=True)
        if args.mode == "train":
            result = trainer.fit(train_iter, test_iter,
                                 profile_dir=args.profile_dir or None)
            last = result.history[-1] if result.history else {}
            if primary:
                print(f"Training done: best_loss={result.best_loss:.3f} "
                      f"last_throughput="
                      f"{last.get('images_per_sec', 0):.1f} img/s")
        elif args.mode == "serve":
            _serve(args, trainer)
        elif args.mode == "test":
            _test(args, trainer, test_iter)
        else:  # sample
            _sample(args, trainer)
    finally:
        if logger is not None:
            logger.close()


def _test(args, trainer, test_iter) -> None:
    from nvae_torch.eval.evaluate import evaluate_model

    start = trainer.maybe_resume()
    if args.use_ema:
        trainer.swap_in_ema()
    if trainer.primary:
        print(f"Evaluating checkpoint at epoch {start}"
              f"{' (EMA weights)' if args.use_ema else ''}")
    timings = {}
    evaluation = evaluate_model(
        trainer,
        test_iter,
        batch_size=args.batch_size,
        n_attempts=args.eval_attempts,
        binary=args.binary_eval,
        temperatures=tuple(args.eval_temperatures),
        fid_sample_size=args.fid_sample_size,
        feature_backbone=args.feature_backbone,
        fid_backbone=args.fid_backbone,
        pr_parity_accounting=args.pr_parity_accounting or args.eval_parity,
        pr_parity_orientation=args.pr_parity_orientation or args.eval_parity,
        parity_resize_299=args.parity_resize_299 or args.eval_parity,
        parity_fid_uint8=args.parity_fid_uint8 or args.eval_parity,
        parity_unit_input=args.parity_unit_input or args.eval_parity,
        timings=timings,
        mesh=trainer.mesh,
    )
    if not trainer.primary:
        return
    print(f"Negative log likelihood: {evaluation.nll}")
    print(evaluation)
    print(f"Stage seconds: {json.dumps(timings)}")
    with open(os.path.join(args.tensorboard_log_dir, "evaluation.json"),
              "w") as f:
        json.dump(evaluation.to_dict(), f, indent=2)


def _sample(args, trainer) -> None:
    from nvae_torch.train.trainer import SAMPLE_TEMPERATURES
    from nvae_torch.utils.images import sample_sweep_to_dirs, sample_to_dir

    start = trainer.maybe_resume()
    if not trainer.primary:
        return  # sampling needs no collective: rank 0 writes the images
    if args.use_ema:
        trainer.swap_in_ema()
    print(f"Sampling the checkpoint of epoch {start} (step "
          f"{trainer.state.step}){' with EMA weights' if args.use_ema else ''}")

    def sample_fn(n, t, b, scale_temperatures=None):
        # Every batch index draws from the step's sampling seed, as the
        # JAX CLI does, so a second batch repeats the first.
        images = trainer.sample_images(n, t,
                                       scale_temperatures=scale_temperatures)
        return images[0].cpu().numpy()

    # The whole sweep rides one sampling call per batch index.
    written = sample_sweep_to_dirs(sample_fn, args.batch_size, args.n_samples,
                                   SAMPLE_TEMPERATURES, args.sample_dir)
    for t, n in written.items():
        print(f"Wrote {n} samples at T={t} to "
              f"{os.path.join(args.sample_dir, f't_{t:.1f}')}")
    if args.scale_temperatures:
        st = tuple(args.scale_temperatures)
        out_dir = os.path.join(args.sample_dir, "t_annealed")
        n = sample_to_dir(functools.partial(sample_fn, scale_temperatures=st),
                          args.batch_size, args.n_samples, 1.0, out_dir)
        print(f"Wrote {n} annealed samples (per-scale T={st}) to {out_dir}")


def _serve(args, trainer) -> None:
    from nvae_torch import serving_http

    start = trainer.maybe_resume()
    if args.use_ema:
        trainer.swap_in_ema()
    if trainer.mesh is not None:
        _serve_mesh(args, trainer, start)
        return
    print(f"Serving checkpoint at epoch {start} (step {trainer.state.step};"
          f" untrained weights if 0 and no checkpoint)"
          f"{' (EMA weights)' if args.use_ema else ''}")
    call, reloader_factory, batches = _build_serve_call(args, trainer)
    print(f"serving on http://{args.serve_host}:{args.serve_port} "
          f"(batch{'es' if len(batches) > 1 else ''} "
          f"{'/'.join(str(b) for b in batches)}, "
          f"max_delay {args.serve_max_delay_ms} ms, weights "
          f"{call.info['serve_dtype']}, compute "
          f"{trainer.model_cfg.compute_dtype}, reloadable)", flush=True)
    serving_http.serve(
        call, batches if len(batches) > 1 else args.batch_size,
        host=args.serve_host, port=args.serve_port,
        max_delay_ms=args.serve_max_delay_ms, seed=args.seed,
        drain_signals=True, reloader_factory=reloader_factory,
        follow_seconds=args.serve_follow_s,
        fulfill_workers=args.serve_fetch_workers)


def _serve_mesh(args, trainer, start: int) -> None:
    """``--mode serve --data_parallel N``: one batch shape, split over the
    ranks (:func:`nvae_torch.serving.build_mesh_sampler`); rank 0 runs the
    HTTP server and the others follow its dispatches until it stops.  The
    weights are fixed: there is no reload, as in the JAX CLI."""
    from nvae_torch import serving_http
    from nvae_torch.serving import build_mesh_sampler, variables_from_state
    from nvae_torch.serving_http import warm

    if args.serve_batches and set(args.serve_batches) != {args.batch_size}:
        raise SystemExit("--serve_batches is for single-rank serving; the "
                         "mesh sampler serves one batch shape, --batch_size")
    st = tuple(args.scale_temperatures) if args.scale_temperatures else None
    call = build_mesh_sampler(
        trainer.model_cfg, variables_from_state(trainer.state),
        args.batch_size, trainer.mesh, scale_temperatures=st,
        output_dtype=args.serve_output, serve_dtype=args.serve_dtype)
    call.sampler.step = int(trainer.state.step)
    if not trainer.primary:
        call.follow()
        return
    try:
        warm(call, [args.batch_size])
        print(f"Serving checkpoint at epoch {start} (step "
              f"{trainer.state.step}) on http://{args.serve_host}:"
              f"{args.serve_port} (batch {args.batch_size} over "
              f"{trainer.mesh.size} ranks, max_delay "
              f"{args.serve_max_delay_ms} ms, weights "
              f"{call.info['serve_dtype']}, compute "
              f"{trainer.model_cfg.compute_dtype})", flush=True)
        serving_http.serve(
            call, args.batch_size, host=args.serve_host,
            port=args.serve_port, max_delay_ms=args.serve_max_delay_ms,
            seed=args.seed, drain_signals=True,
            fulfill_workers=args.serve_fetch_workers)
    finally:
        call.close()


def _build_serve_call(args, trainer):
    """The ``(seed, f32[B]) -> images`` sampler for ``--mode serve`` (a
    :class:`~nvae_torch.serving.Sampler` of the trainer's weights in
    ``--serve_dtype``, at the step it restored), its hot-reload factory
    (``POST /reload`` and SIGHUP restore a step of the checkpoint directory
    and swap it in, cast the same way), and the served batch sizes.  Every
    batch size is called once before the server takes traffic."""
    from nvae_torch.serving import (
        Sampler,
        make_checkpoint_reloader,
        variables_from_state,
    )
    from nvae_torch.serving_http import warm

    st = tuple(args.scale_temperatures) if args.scale_temperatures else None
    batches = sorted(set((args.serve_batches or []) + [args.batch_size]))
    # The trainer's parameters already hold the EMA average under
    # --use_ema (swap_in_ema); a reload extracts it from the checkpoint.
    call = Sampler(trainer.model_cfg, variables_from_state(trainer.state),
                   args.batch_size, scale_temperatures=st,
                   output_dtype=args.serve_output, device=trainer.device,
                   serve_dtype=args.serve_dtype)
    call.step = int(trainer.state.step)
    reloader = make_checkpoint_reloader(call, trainer.ckpt_dir, trainer.state,
                                        use_ema=args.use_ema)
    warm(call, batches)
    return call, (lambda _sampler: reloader), batches


if __name__ == "__main__":
    main()
