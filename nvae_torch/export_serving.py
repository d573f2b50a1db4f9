"""Export the sampler as one serving artifact file (counterpart of
``tools/export_serving.py``).

Two forms (``--format``):

- ``program`` (the default, the JAX tool's only form):
  :func:`nvae_torch.serving.export_program`, a ``torch.export`` program of
  the sampler at ``--batch`` with the weights inside, cast or quantized to
  ``--weights_dtype``, and the fused depthwise forward recorded as the op
  ``nvae_torch::fused_swish_dw5x5``.  A host runs it with torch and
  ``nvae_torch.kernels`` alone (``nvae_torch/serving_program.py``).  Its
  inputs are the temperature and the sampler's Gaussian draws, which the
  loader draws from the seed, so the caller's convention stays ``(seed,
  temperature) -> images``;
- ``weights``: :func:`nvae_torch.serving.export_sampler`, the model config
  and only the tensors ``NVAE.sample`` reads, rebuilt into a ``Sampler`` by
  the port's model code.

Either one is served by ``python -m nvae_torch.serving_http --artifact
FILE``.  Produce (fresh-init weights, or ``--ckpt`` for a checkpoint
directory of the port's trainer)::

    python -m nvae_torch.export_serving --out sampler.pt2 --batch 144 \\
        --preset mnist_step_sn --use_pallas --per_sample_temperature \\
        --ckpt models --weights_dtype int8 --check

Run once (on the card; ``--cpu`` for the CPU)::

    python -m nvae_torch.export_serving --load sampler.pt2 --run \\
        --temperature 0.8 --save_png samples

A JSON line describes the file (``bytes``: its size) and writes it beside the
artifact as ``<out>.json``.  ``--check`` loads the file and holds its images
bitwise against the live sampler on the same weights and seed (the weights
file: its tensors too); with ``--weights_dtype int8`` it also prints how far
the int8 images lie from the full-precision sampler's.  The program is
traced on the card, or with ``--cpu`` or ``--export_on_cpu`` on the CPU (it
is moved to the card when loaded there).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def _configs(args):
    """(model config, train config) of the flags, as the JAX tool takes
    them: the preset's, the tiny debug model, or the default MNIST model."""
    from nvae_torch.config import ModelConfig, TrainConfig, debug_config

    train_cfg = TrainConfig()
    if args.preset:
        from nvae_torch.presets import get_preset

        cfg, train_cfg = get_preset(args.preset)
    elif args.debug:
        cfg = debug_config(n_encoder_channels=8, n_decoder_channels=8,
                           n_groups_per_scale=(1, 1), n_latent_per_group=2)
    else:
        cfg = ModelConfig()
    if args.use_ema:  # the checkpoint's optimizer carries the EMA slot
        train_cfg = dataclasses.replace(train_cfg, ema_decay=0.9999)
    return dataclasses.replace(
        cfg,
        compute_dtype=args.compute_dtype or cfg.compute_dtype,
        bn_apply_dtype=args.bn_apply_dtype or cfg.bn_apply_dtype,
        postprocess_5x5_depthwise=(cfg.postprocess_5x5_depthwise
                                   or args.postprocess_depthwise),
        use_pallas_kernels=cfg.use_pallas_kernels or args.use_pallas,
    ), train_cfg


def _check(args, cfg, sd, device) -> None:
    """Load the file on ``device`` and hold it against the live sampler."""
    import numpy as np
    import torch

    from nvae_torch.serving import Sampler, load_artifact

    served = load_artifact(args.out, device)
    live = Sampler(cfg, sd, args.batch, args.scale_temperatures,
                   args.output_dtype, device=device,
                   serve_dtype=args.weights_dtype)
    if args.format == "weights":
        for k, v in live._weights.items():
            w = served._weights[k]
            same = (torch.equal(v.q, w.q) and torch.equal(v.scale, w.scale)
                    if hasattr(v, "q") else torch.equal(v, w))
            if not same:
                raise SystemExit(f"check failed: the artifact's {k} differs "
                                 "from the live sampler's")
    t = torch.full((args.batch,), 0.8) if args.per_sample_temperature else 0.8
    got = served(42, t)
    if not torch.equal(got, live(42, t)):
        raise SystemExit("check failed: the artifact's samples differ "
                         "from the live sampler's")
    what = "weights and samples" if args.format == "weights" else "samples"
    print(f"check OK: {args.format} artifact == live sampler ({what} "
          "bitwise)")
    if args.weights_dtype == "int8":
        # JAX's quality line: the int8 images against the full-precision
        # sampler's, same seed and temperature.
        full = Sampler(cfg, sd, args.batch, args.scale_temperatures,
                       args.output_dtype, device=device)(42, t)
        d = np.abs(full.cpu().numpy().astype(np.float64)
                   - got.cpu().numpy().astype(np.float64))
        print(json.dumps({"int8_vs_fp_max_abs": float(d.max()),
                          "int8_vs_fp_mean_abs": float(d.mean())}))


def export_artifact(args) -> dict:
    from nvae_torch.models.nvae import NVAE
    from nvae_torch.serving import export_program, export_sampler

    cfg, train_cfg = _configs(args)
    step = -1
    if args.ckpt:
        from nvae_torch.serving import variables_from_state
        from nvae_torch.train.checkpoint import restore_checkpoint
        from nvae_torch.train.state import create_train_state

        _, template, _ = create_train_state(cfg, train_cfg, 1, device="cpu")
        state = restore_checkpoint(os.path.abspath(args.ckpt), template)
        sd, step = variables_from_state(state, args.use_ema), int(state.step)
        print(f"Restored checkpoint: {args.ckpt} (step {step})")
    else:
        sd = NVAE(cfg, device="cpu", seed=args.seed).state_dict()
    device = "cpu" if args.cpu else "cuda"
    kw = dict(per_sample_temperature=args.per_sample_temperature,
              output_dtype=args.output_dtype, serve_dtype=args.weights_dtype,
              step=step)
    extra = {}
    if args.format == "program":
        from nvae_torch.serving_program import read_meta

        n_bytes = export_program(
            args.out, cfg, sd, args.batch, args.scale_temperatures,
            device="cpu" if args.export_on_cpu else device, **kw)
        # How many times the graph calls the fused depthwise op (#2).
        extra["op_nodes"] = read_meta(args.out)["op_nodes"]
    else:
        n_bytes = export_sampler(args.out, cfg, sd, args.batch,
                                 args.scale_temperatures, **kw)
    meta = {
        "format": args.format,
        "batch": args.batch,
        "image_size": cfg.image_size,
        "in_channels": cfg.in_channels,
        "likelihood": cfg.likelihood,
        "n_mix": cfg.n_mix,
        "compute_dtype": cfg.compute_dtype,
        "scale_temperatures": args.scale_temperatures,
        "weights_dtype": args.weights_dtype or "float32",
        "output_dtype": args.output_dtype or "float32",
        "per_sample_temperature": args.per_sample_temperature,
        "calling_convention": (
            "(seed, temperature_f32[batch]) -> images"
            if args.per_sample_temperature
            else "(seed, temperature_f32) -> images"),
        "step": step,
        "bytes": n_bytes,
        **extra,
    }
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps({"exported": args.out, **meta}))
    if args.check:
        _check(args, cfg, sd, device)
    return meta


def load_and_run(args):
    import torch

    from nvae_torch.serving import load_artifact

    sampler = load_artifact(args.load, "cpu" if args.cpu else "cuda")
    batch = sampler.artifact["batch"]
    t = (torch.full((batch,), args.temperature)
         if sampler.artifact["per_sample_temperature"] else args.temperature)
    images = sampler(args.seed, t).float().cpu().numpy()
    print(json.dumps({"artifact": args.load, "images": list(images.shape),
                      "mean": float(images.mean()),
                      "min": float(images.min()),
                      "max": float(images.max())}))
    if args.save_png:
        from nvae_torch.utils.images import save_images_to_dir

        os.makedirs(args.save_png, exist_ok=True)
        save_images_to_dir(images, args.save_png)
        print(f"wrote {images.shape[0]} PNGs to {args.save_png}")
    return images


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="",
                   help="Artifact to write (default: sampler.pt2, or "
                        "sampler.pt with --format weights)")
    p.add_argument("--format", default="program",
                   choices=["program", "weights"],
                   help="program: a torch.export program with the weights "
                        "inside; weights: the config and the tensors")
    p.add_argument("--export_on_cpu", action="store_true",
                   help="Trace the program on the CPU (it is moved to the "
                        "card when loaded there)")
    p.add_argument("--load", default="",
                   help="Load an existing artifact instead of exporting")
    p.add_argument("--run", action="store_true",
                   help="With --load: run the artifact once")
    p.add_argument("--ckpt", default="",
                   help="Checkpoint directory of the port's trainer")
    p.add_argument("--use_ema", action="store_true",
                   help="Export the EMA parameter average")
    p.add_argument("--preset", default="")
    p.add_argument("--debug", action="store_true",
                   help="Tiny debug model (fast; for tests)")
    p.add_argument("--compute_dtype", default="",
                   choices=["", "float32", "bfloat16"])
    p.add_argument("--bn_apply_dtype", default="",
                   choices=["", "float32", "bfloat16"])
    p.add_argument("--postprocess_depthwise", action="store_true")
    p.add_argument("--use_pallas", action="store_true",
                   help="The hand-written depthwise kernels")
    p.add_argument("--batch", type=int, default=16,
                   help="Serving batch size")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--scale_temperatures", type=float, nargs="*",
                   default=None,
                   help="One temperature per decoder scale, stored in the "
                        "artifact")
    p.add_argument("--weights_dtype", default="",
                   choices=["", "bfloat16", "int8"],
                   help="Cast the stored weights: bfloat16, or int8 per "
                        "output channel (BatchNorm statistics stay fp32)")
    p.add_argument("--per_sample_temperature", action="store_true",
                   help="Serve a temperature per row (the HTTP server "
                        "needs it)")
    p.add_argument("--output_dtype", default="", choices=["", "uint8"],
                   help="Quantize the output pixels to uint8 on the device")
    p.add_argument("--check", action="store_true",
                   help="After export: reload and compare with the live "
                        "sampler")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_png", default="",
                   help="With --load --run: write sampled PNGs here")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    args.out = args.out or ("sampler.pt2" if args.format == "program"
                            else "sampler.pt")
    if args.load:
        return load_and_run(args)
    return export_artifact(args)


if __name__ == "__main__":
    main()
