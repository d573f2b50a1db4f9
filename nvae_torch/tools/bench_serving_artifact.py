"""Size and throughput of the port's serving artifact, bf16 against int8
weights, in both its forms (twin of ``tools/bench_serving_artifact.py``).

The program form (``nvae_torch.serving.export_program``, the JAX tool's
only form: a ``torch.export`` program with the weights inside, run by
``nvae_torch.serving_program.ProgramSampler``) fills the JAX tool's keys,
``bf16`` and ``int8``; the weights-file form (``export_sampler``: the model
config and the tensors the sampler reads, rebuilt into a ``Sampler``) goes
beside them under ``weights_file``.  Either int8 form dequantizes each
leaf with one multiply at call time.  This tool exports the sampler at
``--batch`` in each form under both weight dtypes, loads each file on the
card and times its calls end to end (one sync after ``--iters`` calls).

Weight values do not change the time, so the model is a seeded init
(``--ckpt`` serves trained weights).  The default model is the serving
ladder's best: depthwise postprocess, bf16 compute and bf16 BatchNorm
apply, on the hand-written kernels.

Prints one JSON line::

    {"metric": "serving_artifact_int8_vs_bf16", "batch": N,
     "bf16": {"mb": ..., "img_per_s": ...}, "int8": {...},
     "weights_file": {"bf16": {...}, "int8": {...}}, ...}

Usage: ``python -m nvae_torch.tools.bench_serving_artifact [--batch 1152]
[--quick] [--cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

from nvae_torch.tools.common import (
    add_cpu_flag,
    device_info,
    log,
    sync,
    tool_device,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=1152,
                   help="Serving batch")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--ckpt", default="",
                   help="Optional checkpoint directory to serve")
    p.add_argument("--quick", action="store_true",
                   help="Tiny debug model and a small batch (for tests)")
    add_cpu_flag(p)
    args = p.parse_args(argv)

    import numpy as np

    from nvae_torch.config import ModelConfig, TrainConfig, debug_config
    from nvae_torch.models.nvae import NVAE
    from nvae_torch.serving import (
        export_program,
        export_sampler,
        load_artifact,
    )

    device = tool_device(args)
    if args.quick:
        model_cfg = debug_config(use_pallas_kernels=True)
        args.batch, args.iters, args.warmup = 16, 3, 1
    else:
        model_cfg = ModelConfig(compute_dtype="bfloat16",
                                bn_apply_dtype="bfloat16",
                                postprocess_5x5_depthwise=True,
                                use_pallas_kernels=True)
    t0 = time.time()
    if args.ckpt:
        from nvae_torch.serving import variables_from_state
        from nvae_torch.train.checkpoint import restore_checkpoint
        from nvae_torch.train.state import create_train_state

        _, template, _ = create_train_state(model_cfg, TrainConfig(), 1,
                                            device="cpu")
        state_dict = variables_from_state(
            restore_checkpoint(os.path.abspath(args.ckpt), template))
    else:
        state_dict = NVAE(model_cfg, device="cpu", seed=0).state_dict()
    log(f"init: {time.time() - t0:.1f}s")
    tmp = tempfile.mkdtemp(prefix="nvae_artifact_")

    def bench(tag: str, serve_dtype: str, form: str):
        path = os.path.join(tmp, f"{tag}_{form}.pt2" if form == "program"
                            else f"{tag}_{form}.pt")
        t0 = time.time()
        if form == "program":
            nbytes = export_program(path, model_cfg, state_dict, args.batch,
                                    serve_dtype=serve_dtype, device=device)
        else:
            nbytes = export_sampler(path, model_cfg, state_dict, args.batch,
                                    serve_dtype=serve_dtype)
        log(f"{tag} {form}: exported {nbytes / 1e6:.1f} MB in "
            f"{time.time() - t0:.1f}s")
        call = load_artifact(path, device)
        imgs = None
        for _ in range(args.warmup):
            imgs = call(0, 0.8)
            float(imgs.float().mean())
        t0 = time.time()
        for _ in range(args.iters):
            imgs = call(0, 0.8)
        float(imgs.float().mean())  # one sync at the end
        sync(device)
        dt = time.time() - t0
        ips = args.batch * args.iters / dt
        log(f"{tag} {form}: {ips:.1f} img/s at b{args.batch} "
            f"({dt / args.iters * 1e3:.1f} ms/call)")
        rec = {"mb": round(nbytes / 1e6, 1), "img_per_s": round(ips, 1),
               "ms_per_call": round(dt / args.iters * 1e3, 2),
               "weights_mb_on_device": round(call.weights_bytes / 1e6, 1),
               "ran_via": "load_artifact", "form": form}
        return rec, imgs.float().cpu().numpy()

    runs = {}
    try:
        for form in ("program", "weights"):
            for tag, dtype in (("bf16", "bfloat16"), ("int8", "int8")):
                runs[form, tag] = bench(tag, dtype, form)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (r_bf16, img_bf16), (r_int8, img_int8) = (runs["program", "bf16"],
                                              runs["program", "int8"])
    for tag in ("bf16", "int8"):
        # Both forms draw the same noise from the same seed.
        if not np.array_equal(runs["program", tag][1],
                              runs["weights", tag][1]):
            raise AssertionError(f"{tag}: the program's images differ from "
                                 "the weights file's")
    # The two artifacts on the same seed: mean |delta| of the Bernoulli
    # means (in [0, 1]).
    mad = float(np.mean(np.abs(img_bf16 - img_int8)))
    report = {
        "metric": "serving_artifact_int8_vs_bf16",
        "batch": args.batch,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "bf16": r_bf16,
        "int8": r_int8,
        "size_ratio": round(r_bf16["mb"] / max(r_int8["mb"], 1e-9), 2),
        "throughput_ratio": round(
            r_int8["img_per_s"] / max(r_bf16["img_per_s"], 1e-9), 3),
        "mean_abs_pixel_delta": round(mad, 5),
        "weights_file": {"bf16": runs["weights", "bf16"][0],
                         "int8": runs["weights", "int8"][0]},
        "device": device_info(device),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
