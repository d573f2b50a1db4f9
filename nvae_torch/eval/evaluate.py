"""The evaluation protocol (counterpart of ``nvae_tpu/eval/evaluate.py``;
the reference's ``evaluate_model``, ``evaluate.py:48-108``).

For each temperature, ``n_attempts`` rounds of {a sample call, precision and
recall of generated against real features over the test set in halves,
PPL through the final decoder group}; then FID over ``fid_sample_size``
generated samples; last, the IWAE NLL over the test set.  Sampling, feature
extraction and the P&R distances run on the trainer's device; the reported
FID runs in fp64 on the host.

The noise comes from generators seeded by ``derive_seed`` where the JAX
package folds a number into its key: ``(seed, "eval", t, attempt,
"sample")``, ``(..., "half", h)`` and ``(..., "ppl")`` within an attempt,
``(seed, "fid", t, b)`` for FID batch ``b`` and ``derive_seed(seed,
"nll")`` for the NLL.

The result dataclasses are the reference's ``Metric`` / ``Metrics`` /
``ModelEvaluation`` (``util.py:53-75``) with the JAX package's JSON keys.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from nvae_torch.device import fp32_math
from nvae_torch.eval import ppl as ppl_mod
from nvae_torch.eval.features import (
    backbone_weights_status,
    extract_features,
    get_extractor,
)
from nvae_torch.eval.frechet import fid_from_features
from nvae_torch.eval.nll import neg_log_likelihood
from nvae_torch.eval.precision_recall import knn_precision_recall_features
from nvae_torch.utils.seeds import derive_seed

EVAL_TEMPERATURES = (0.6, 0.8, 1.0)  # reference evaluate.py:58
FID_SAMPLE_SIZE = 10000  # reference evaluate.py:156


def quantize_uint8(images):
    """The reference's PNG round trip as a pure function: [0, 1] -> uint8
    by truncation -> back to float32 in [0, 1].  Numpy in, numpy out; a
    tensor stays a tensor on its device."""
    if isinstance(images, torch.Tensor):
        x = torch.clamp(images.to(torch.float32) * 255.0, 0.0, 255.0)
        return x.to(torch.uint8).to(torch.float32) / 255.0
    x = np.asarray(images, dtype=np.float32)
    return np.clip(x * 255.0, 0.0, 255.0).astype(np.uint8).astype(
        np.float32) / 255.0


@dataclasses.dataclass
class Metric:
    mean: float
    stddev: float

    @staticmethod
    def from_list(values) -> "Metric":
        return Metric(float(np.mean(values)), float(np.std(values)))

    def __str__(self):
        return f"{self.mean:.4f} ± {self.stddev:.4f}"


@dataclasses.dataclass
class Metrics:
    temperature: float
    fid: float
    ppl: Metric
    precision: Metric
    recall: Metric


@dataclasses.dataclass
class ModelEvaluation:
    nll: Optional[Metric]
    sample_metrics: List[Metrics]
    feature_backbone: str = "random_conv"
    fid_backbone: str = "inception"
    # Weight provenance ("imagenet" | "random-init" | "fixed-seed"): FID
    # and P&R of a "random-init" backbone are framework-internal only.
    feature_backbone_weights: str = "unknown"
    fid_backbone_weights: str = "unknown"

    def to_dict(self):
        return dataclasses.asdict(self)

    def comparable(self) -> bool:
        """True iff both backbones run ImageNet weights, so FID and P&R
        compare with published numbers."""
        return (self.feature_backbone_weights == "imagenet"
                and self.fid_backbone_weights == "imagenet")


def _sampler(model, binary: bool):
    """``sample(n, t, seed)`` -> (images, last_s, z1, z2), NHWC on the
    model's device: the prior pass in eval mode, fp32 math, probabilities
    (or, with ``binary``, Bernoulli draws)."""
    device = model.decoder.h.device

    def sample(n: int, t: float, seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad(), fp32_math():
            return model.sample(int(n), float(t), not binary, generator=gen)

    return sample


class _StageClock:
    """Adds each call's wall seconds to ``timings[stage]``, the device
    synchronized at the call's end so that its queued work counts in its
    own stage; does nothing when ``timings`` is None."""

    def __init__(self, device: torch.device, timings: Optional[dict]):
        self.device, self.timings = device, timings

    def timed(self, stage: str, fn):
        if self.timings is None:
            return fn

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings[stage] = (self.timings.get(stage, 0.0)
                                   + time.perf_counter() - t0)
            return out

        return call


def evaluate_model(
    trainer,
    test_iter,
    batch_size: int,
    n_attempts: int = 10,
    binary: bool = False,
    temperatures=EVAL_TEMPERATURES,
    fid_sample_size: int = FID_SAMPLE_SIZE,
    feature_backbone: str = "vgg16",
    fid_backbone: str = "inception",
    seed: int = 0,
    pr_parity_accounting: bool = False,
    pr_parity_orientation: bool = False,
    parity_resize_299: bool = False,
    parity_fid_uint8: bool = False,
    parity_unit_input: bool = False,
    timings: Optional[dict] = None,
    mesh=None,
) -> ModelEvaluation:
    """The full evaluation of ``trainer``'s model (anything with ``.model``)
    on its device.  FID features come from ``fid_backbone`` (InceptionV3
    pool features by default), P&R and PPL features from
    ``feature_backbone`` (VGG16 by default), as in the reference.

    Parity switches (all off by default; PARITY.md):

    - ``pr_parity_orientation``: the reference's argument order, real and
      generated swapped, so its "precision" is the textbook recall;
    - ``pr_parity_accounting``: the reference's sum of two half-batch
      values per batch, so P&R live in [0, 2];
    - ``parity_resize_299``: nearest resize of every image to 299 before
      either backbone;
    - ``parity_fid_uint8``: truncating uint8 quantization of both FID
      inputs (the reference's PNG round trip);
    - ``parity_unit_input``: raw [0, 1] backbone inputs.

    ``timings``, when given a dict, receives the wall seconds of each
    stage (sampling, each backbone's features, precision/recall, PPL, the
    host FID, the NLL), the device synchronized at each stage's end.

    ``mesh`` (``parallel.mesh.DataMesh``, JAX's ``mesh=``): every rank
    runs the protocol on the same samples; the feature passes and P&R split
    their rows over the ranks and gather them, so every rank returns the
    same evaluation.
    """
    model = trainer.model
    device = model.decoder.h.device
    extractor_opts = dict(
        input_size=299 if parity_resize_299 else 0,
        resize_method="nearest" if parity_resize_299 else "bilinear",
        input_scaling="unit" if parity_unit_input else "pm1",
    )
    extractor = get_extractor(feature_backbone, device=device,
                              **extractor_opts)
    fid_extractor = get_extractor(fid_backbone, device=device,
                                  **extractor_opts)
    clock = _StageClock(device, timings)
    sample = clock.timed("sampling", _sampler(model, binary))
    features = clock.timed(f"{feature_backbone} features",
                           lambda x: extract_features(x, extractor,
                                                      mesh=mesh))
    fid_features = clock.timed(
        f"{fid_backbone} features",
        lambda x: extract_features(
            quantize_uint8(x) if parity_fid_uint8 else x, fid_extractor,
            mesh=mesh))
    precision_recall = clock.timed(
        "precision/recall",
        lambda ref, ev: knn_precision_recall_features(ref, ev, device=device,
                                                      mesh=mesh))

    def ppl_images(z1, z2, last_s, seed_):
        za, zb = ppl_mod.slerp_pair(z1, z2, torch.Generator(
            device=device).manual_seed(seed_))
        with fp32_math():
            return (model.sample_with_z(za, last_s),
                    model.sample_with_z(zb, last_s))

    ppl_images = clock.timed("ppl", ppl_images)
    ppl_value = clock.timed("ppl", lambda a, b: ppl_mod.evaluate(a, b))
    fid_value = clock.timed("fid", lambda a, b: fid_from_features(a, b))

    # The real test images, once; their FID features, once.
    test_batches = list(test_iter.epoch(0))
    real_feats = fid_features(
        torch.cat([torch.as_tensor(b) for b in test_batches]))
    # The real halves' P&R features, once: they change with no attempt.
    real_halves = []
    for real_batch in test_batches:
        for half in torch.tensor_split(torch.as_tensor(real_batch), 2):
            real_halves.append((len(half), features(half)))

    was = model.training
    model.eval()
    evaluation = ModelEvaluation(
        nll=None,
        sample_metrics=[],
        feature_backbone=feature_backbone,
        fid_backbone=fid_backbone,
        feature_backbone_weights=backbone_weights_status(feature_backbone),
        fid_backbone_weights=backbone_weights_status(fid_backbone),
    )
    if not evaluation.comparable():
        print("[nvae_torch.eval] WARNING: backbone weights are "
              f"feature={evaluation.feature_backbone_weights} "
              f"fid={evaluation.fid_backbone_weights} — FID/P&R/PPL values "
              "are framework-internal only, not comparable to published "
              "numbers.")
    try:
        for t_i, temperature in enumerate(temperatures):
            precisions, recalls, ppls = [], [], []
            for attempt in range(n_attempts):
                tag = (seed, "eval", t_i, attempt)
                _, last_s, z1, z2 = sample(batch_size, temperature,
                                           derive_seed(*tag, "sample"))

                # P&R of generated against real features, in halves of
                # each test batch, as the reference does.
                p_sum, r_sum, n_micro = 0.0, 0.0, 0
                for h_i, (n_half, real_f) in enumerate(real_halves):
                    gen, *_ = sample(n_half, temperature,
                                     derive_seed(*tag, "half", h_i))
                    gen_f = features(gen)
                    # The reference's order is ref=generated, eval=real.
                    pr = (precision_recall(gen_f, real_f)
                          if pr_parity_orientation
                          else precision_recall(real_f, gen_f))
                    p_sum += pr["precision"]
                    r_sum += pr["recall"]
                    n_micro += 1
                # The reference sums the two halves of a batch and divides
                # by the batch count ([0, 2]); the default is the mean.
                denom = (max(n_micro // 2, 1) if pr_parity_accounting
                         else n_micro)
                precisions.append(p_sum / denom)
                recalls.append(r_sum / denom)

                # PPL through the final decoder group.
                img_a, img_b = ppl_images(z1, z2, last_s,
                                          derive_seed(*tag, "ppl"))
                ppls.append(ppl_value(features(img_a), features(img_b)))

            # FID at this temperature over fid_sample_size samples.
            gen_feats = []
            for b in range(max(fid_sample_size // batch_size, 1)):
                gen, *_ = sample(batch_size, temperature,
                                 derive_seed(seed, "fid", t_i, b))
                gen_feats.append(fid_features(gen))
            fid = fid_value(real_feats, np.concatenate(gen_feats))

            evaluation.sample_metrics.append(Metrics(
                temperature=temperature,
                fid=fid,
                ppl=Metric.from_list(ppls),
                precision=Metric.from_list(precisions),
                recall=Metric.from_list(recalls),
            ))
    finally:
        model.train(was)

    mean, std = clock.timed("nll", lambda: neg_log_likelihood(
        model, test_batches, seed=derive_seed(seed, "nll"),
        n_attempts=n_attempts))()
    evaluation.nll = Metric(mean, std)
    return evaluation


def evaluate_fid_against_dir(
    trainer,
    real_dir: str,
    out_dir: str,
    batch_size: int,
    temperature: float,
    sample_size: int = FID_SAMPLE_SIZE,
    feature_backbone: str = "inception",
) -> float:
    """The reference's disk-based FID protocol (``evaluate.py:143-163``):
    real PNGs in ``real_dir``; ``sample_size`` samples regenerated as PNGs
    into ``out_dir`` (its earlier images removed, nothing else touched);
    FID between the two directories, read lazily, on the trainer's
    device."""
    from nvae_torch.utils.images import ImageDirectory, sample_to_dir

    for f in os.listdir(out_dir) if os.path.isdir(out_dir) else []:
        if f.lower().endswith((".png", ".jpg", ".jpeg")):
            os.remove(os.path.join(out_dir, f))
    sample_to_dir(
        lambda n, t, b: trainer.sample_images(n, t)[0].cpu().numpy(),
        batch_size, sample_size, temperature, out_dir)
    extractor = get_extractor(feature_backbone, device=trainer.device)
    return fid_from_features(
        extract_features(ImageDirectory(real_dir), extractor),
        extract_features(ImageDirectory(out_dir), extractor))
