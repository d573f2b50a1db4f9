"""FID between image directories or cached statistics, and its command line
(counterpart of ``nvae_tpu/eval/fid.py``; the reference's vendored
``fid_utils.py:454-550``).

    python -m nvae_torch.eval.fid <path1> <path2> [--backbone vgg16] ...
    python -m nvae_torch.eval.fid --save_stats <image_dir> <stats.npz>

A path ending in ``.npz`` is loaded as statistics (keys ``mu`` and
``sigma``, the reference's names); anything else is a directory of PNG/JPG
images, read lazily one batch at a time.  Features are extracted on the
card unless ``--cpu`` (or ``device="cpu"``) asks for the CPU; the distance
runs in fp64 on the host.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np

from nvae_torch.device import DeviceLike
from nvae_torch.eval.features import extract_features, get_extractor
from nvae_torch.eval.frechet import fid_from_stats


def compute_statistics_of_path(
    path: str,
    backbone: str = "vgg16",
    input_size: int = 0,
    batch_size: int = 256,
    limit: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of a stats ``.npz`` or of an image directory's
    features."""
    if path.endswith(".npz"):
        with np.load(path) as d:
            return d["mu"], d["sigma"]
    if not os.path.isdir(path):
        raise FileNotFoundError(f"not a stats file or image directory: {path}")
    from nvae_torch.utils.images import ImageDirectory

    feats = extract_features(
        ImageDirectory(path, limit=limit),
        get_extractor(backbone, input_size=input_size, device=device),
        batch_size)
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def save_statistics(stats_path: str, mu: np.ndarray, sigma: np.ndarray) -> None:
    """Cache (mu, sigma) as ``.npz``."""
    os.makedirs(os.path.dirname(os.path.abspath(stats_path)), exist_ok=True)
    np.savez(stats_path, mu=mu, sigma=sigma)


def calculate_fid_given_paths(
    paths,
    backbone: str = "vgg16",
    input_size: int = 0,
    batch_size: int = 256,
    device: DeviceLike = "cuda",
) -> float:
    """FID between two paths, each an image directory or a stats
    ``.npz``."""
    if len(paths) != 2:
        raise ValueError(f"need two paths, got {paths}")
    mu1, s1 = compute_statistics_of_path(paths[0], backbone, input_size,
                                         batch_size, device=device)
    mu2, s2 = compute_statistics_of_path(paths[1], backbone, input_size,
                                         batch_size, device=device)
    return fid_from_stats(mu1, s1, mu2, s2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", nargs=2,
                    help="Image directory or precomputed stats .npz; with "
                         "--save_stats: <image_dir> <output.npz>")
    ap.add_argument("--backbone", default="vgg16",
                    choices=["vgg16", "inception", "random_conv"])
    ap.add_argument("--input_size", type=int, default=0,
                    help="Resize target (0 = backbone native)")
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--save_stats", action="store_true",
                    help="Precompute statistics of path[0] into path[1] "
                         "instead of scoring")
    ap.add_argument("--cpu", action="store_true",
                    help="Extract features on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    if args.save_stats:
        mu, sigma = compute_statistics_of_path(
            args.path[0], args.backbone, args.input_size, args.batch_size,
            device=device)
        save_statistics(args.path[1], mu, sigma)
        print(f"saved stats for {args.path[0]} -> {args.path[1]} "
              f"(D={mu.shape[0]})")
        return 0
    fid = calculate_fid_given_paths(args.path, args.backbone, args.input_size,
                                    args.batch_size, device=device)
    print(f"FID: {fid:.6g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
