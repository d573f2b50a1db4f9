"""Dataset registry with local-file loaders and a synthetic dataset: the
port's copy of ``nvae_tpu/data/datasets.py`` (numpy only).

Every dataset loads from local files (searched across ``data_dir``,
``$NVAE_TPU_DATA``, ``~/.keras/datasets`` and ``~/data``, as in the JAX
package), and the deterministic ``synthetic`` dataset is always available,
so the train/eval stack runs without downloads.  With the same seed,
:func:`synthetic_dataset` gives the same bytes as the JAX package's.

Loaded arrays are uint8 in [0, 255], (N, H, W, C); padding, scaling and
binarization run on the device (:mod:`nvae_torch.data.pipeline`).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Optional

import numpy as np


class DatasetUnavailable(RuntimeError):
    pass


@dataclasses.dataclass
class DataBundle:
    name: str
    train_x: np.ndarray  # (N, H, W, C) uint8
    test_x: np.ndarray  # (M, H, W, C) uint8
    train_y: Optional[np.ndarray] = None
    test_y: Optional[np.ndarray] = None

    @property
    def image_size(self) -> int:
        return self.train_x.shape[1]

    @property
    def channels(self) -> int:
        return self.train_x.shape[-1]


def _search_paths(data_dir: str, *names: str):
    roots = [
        data_dir,
        os.environ.get("NVAE_TPU_DATA", ""),
        os.path.expanduser("~/.keras/datasets"),
        os.path.expanduser("~/data"),
    ]
    for root in roots:
        if not root:
            continue
        for name in names:
            p = os.path.join(root, name)
            if os.path.exists(p):
                return p
    return None


def _read_idx_images(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise DatasetUnavailable(f"bad IDX magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols, 1)


def _read_idx_labels(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise DatasetUnavailable(f"bad IDX magic {magic} in {path}")
        return np.frombuffer(f.read(n), dtype=np.uint8)


def _load_mnist_like(name: str, data_dir: str) -> DataBundle:
    """MNIST/Fashion-MNIST from a keras-style .npz or raw IDX files."""
    npz = _search_paths(data_dir, f"{name}.npz")
    if npz:
        with np.load(npz) as d:
            return DataBundle(
                name,
                d["x_train"][..., None],
                d["x_test"][..., None],
                d.get("y_train"),
                d.get("y_test"),
            )
    idx = _search_paths(
        data_dir, "train-images-idx3-ubyte.gz", "train-images-idx3-ubyte"
    )
    if idx:
        root = os.path.dirname(idx)

        def pick(stem):
            for suffix in (".gz", ""):
                p = os.path.join(root, stem + suffix)
                if os.path.exists(p):
                    return p
            raise DatasetUnavailable(f"missing {stem} next to {idx}")

        return DataBundle(
            name,
            _read_idx_images(pick("train-images-idx3-ubyte")),
            _read_idx_images(pick("t10k-images-idx3-ubyte")),
            _read_idx_labels(pick("train-labels-idx1-ubyte")),
            _read_idx_labels(pick("t10k-labels-idx1-ubyte")),
        )
    raise DatasetUnavailable(
        f"{name}: no local copy found. Place {name}.npz (keras format) or the "
        f"four IDX files under --data_dir, $NVAE_TPU_DATA, or "
        f"~/.keras/datasets. (This framework never downloads.)"
    )


def _load_npz_pair(name: str, data_dir: str, keys=("train", "test")) -> DataBundle:
    npz = _search_paths(data_dir, f"{name}.npz")
    if not npz:
        raise DatasetUnavailable(
            f"{name}: place {name}.npz with arrays {keys} under --data_dir, "
            f"$NVAE_TPU_DATA, or ~/.keras/datasets."
        )
    with np.load(npz) as d:
        train, test = d[keys[0]], d[keys[1]]
    if train.ndim == 3:
        train, test = train[..., None], test[..., None]
    return DataBundle(name, train, test)


def synthetic_dataset(
    n_train: int = 4096,
    n_test: int = 1024,
    image_size: int = 28,
    channels: int = 1,
    seed: int = 0,
) -> DataBundle:
    """Deterministic procedural stroke images (digit-like statistics).

    Random-walk pen strokes on a blank canvas, blurred once — enough visual
    structure for a VAE to learn, fully reproducible, zero I/O.  This is the
    framework's always-available stand-in where the reference hard-requires a
    TFDS download.
    """
    rng = np.random.RandomState(seed)
    n = n_train + n_test
    n_strokes = rng.randint(1, 4, size=n)
    # The draws of each stroke, in the order the JAX package's loop draws
    # them: its start, its velocity, its length T, then T (vr, vc) noises.
    starts, vel0, noise = [], [], []
    for _ in range(int(n_strokes.sum())):
        starts.append(rng.randint(4, image_size - 4, size=2))
        vel0.append(rng.randn(2) * 1.2)
        steps = rng.randint(8, 20)
        noise.append(rng.randn(2 * steps).reshape(steps, 2) * 0.6)
    # Every stroke's random walk at once, step by step, in float64 as the
    # loop's scalars: pen position t, then v <- clip(v + noise_t), p += v.
    lengths = np.array([len(x) for x in noise])
    t_max = int(lengths.max()) if len(noise) else 0
    nz = np.zeros((len(noise), t_max, 2))
    for k, x in enumerate(noise):
        nz[k, :len(x)] = x
    pos = np.array(starts, dtype=np.float64).reshape(-1, 2)
    vel = np.array(vel0, dtype=np.float64).reshape(-1, 2)
    pen = np.empty((len(noise), t_max, 2))
    for t in range(t_max):
        pen[:, t] = pos
        vel = np.clip(vel + nz[:, t], -2, 2)
        pos = pos + vel
    rr, cc = np.round(pen).astype(np.int64).transpose(2, 0, 1)
    img = np.broadcast_to(np.repeat(np.arange(n), n_strokes)[:, None],
                          rr.shape)
    on = ((np.arange(t_max) < lengths[:, None]) & (rr >= 0)
          & (rr < image_size) & (cc >= 0) & (cc < image_size))
    # A pixel the pen was on is 1.0; one only right of or below it, 0.6,
    # whatever the order of the loop's writes (1.0 wins every max).
    imgs = np.zeros((n, image_size, image_size), dtype=np.float32)
    below = on & (rr + 1 < image_size)
    right = on & (cc + 1 < image_size)
    imgs[img[below], rr[below] + 1, cc[below]] = 0.6
    imgs[img[right], rr[right], cc[right] + 1] = 0.6
    imgs[img[on], rr[on], cc[on]] = 1.0
    # One-tap box blur for soft edges.
    blurred = imgs.copy()
    blurred[:, 1:, :] += 0.25 * imgs[:, :-1, :]
    blurred[:, :, 1:] += 0.25 * imgs[:, :, :-1]
    imgs = np.clip(blurred, 0.0, 1.0)
    data = (imgs * 255).astype(np.uint8)[..., None]
    if channels > 1:
        # Per-image random color tint so RGB configs (DML likelihood) see
        # genuine cross-channel structure, not three identical planes.
        tint = 0.35 + 0.65 * rng.rand(n, 1, 1, channels)
        data = np.clip(
            data.astype(np.float32) * tint, 0, 255
        ).astype(np.uint8)
    return DataBundle("synthetic", data[:n_train], data[n_train:])


def load_dataset(name: str, data_dir: str = "", **synth_kwargs) -> DataBundle:
    """Registry entry point (replaces reference ``datasets.py``)."""
    name = name.lower()
    if name.startswith("synthetic"):
        # synthetic | synthetic_rgb | synthetic_rgb64 — procedural data in
        # the shape of each BASELINE config family (grayscale 28->32-pad,
        # CIFAR-like 32x32 RGB, CelebA-like 64x64 RGB).
        if name == "synthetic_rgb":
            synth_kwargs.setdefault("channels", 3)
            synth_kwargs.setdefault("image_size", 32)
        elif name == "synthetic_rgb64":
            synth_kwargs.setdefault("channels", 3)
            synth_kwargs.setdefault("image_size", 64)
        elif name != "synthetic":
            raise ValueError(f"unknown dataset {name!r}")
        return synthetic_dataset(**synth_kwargs)
    if name == "mnist":
        return _load_mnist_like("mnist", data_dir)
    if name in ("fashion_mnist", "fashion-mnist"):
        return _load_mnist_like("fashion_mnist", data_dir)
    if name == "omniglot":
        return _load_npz_pair("omniglot", data_dir)
    if name == "cifar10":
        npz = _search_paths(data_dir, "cifar10.npz")
        if npz:
            with np.load(npz) as d:
                return DataBundle(
                    "cifar10", d["x_train"], d["x_test"],
                    d.get("y_train"), d.get("y_test"),
                )
        raise DatasetUnavailable(
            "cifar10: place cifar10.npz (x_train/x_test uint8 NHWC) under "
            "--data_dir, $NVAE_TPU_DATA, or ~/.keras/datasets."
        )
    if name in ("celeba", "celeb_a", "celeba64"):
        # The reference's load_celeba is an empty stub (datasets.py:23-25);
        # here it is a real loader gated on a local npz.
        return _load_npz_pair("celeba64", data_dir)
    raise ValueError(f"unknown dataset {name!r}")
