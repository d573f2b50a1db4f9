"""Image tiling and PNG output (counterpart of ``nvae_tpu/utils/images.py``'s
writing half: ``tile_images``, ``to_uint8``, ``save_images_to_dir``,
``sample_to_dir``, ``sample_sweep_to_dirs``).

PNGs are written by a small encoder on the standard library (``zlib`` and
``struct``): 8-bit greyscale or RGB, no interlace, filter 0 on every row.
The directory reader of the metric suite comes with that suite.
"""

from __future__ import annotations

import math
import os
import struct
import uuid
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}  # channels -> PNG colour type (grey, RGB)


def tile_images(images: np.ndarray) -> np.ndarray:
    """(n^2, H, W, C) -> (n*H, n*W, C) square grid of contiguous tiles (the
    first ``floor(sqrt(N))^2`` images)."""
    n = int(math.floor(math.sqrt(images.shape[0])))
    _, h, w, c = images.shape
    x = images[: n * n].reshape(n, n, h, w, c)
    x = np.transpose(x, (0, 2, 1, 3, 4))  # (row, H, col, W, C)
    return x.reshape(n * h, n * w, c)


def to_uint8(images: np.ndarray) -> np.ndarray:
    if images.dtype == np.uint8:
        return images
    return np.clip(np.asarray(images) * 255.0, 0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """PNG bytes of one uint8 image, (H, W), (H, W, 1) or (H, W, 3)."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"need uint8 (H, W, 1 or 3), got {img.dtype} "
                         f"{img.shape}")
    h, w, c = img.shape
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(img).reshape(h, w * c)],
        axis=1)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_images_to_dir(images, out_dir: str) -> None:
    """Write each image (N, H, W, C), floats in [0, 1] or uint8, as a
    uuid4-named PNG (reference ``util.py:31-36``)."""
    os.makedirs(out_dir, exist_ok=True)
    for img in to_uint8(np.asarray(images)):
        with open(os.path.join(out_dir, f"{uuid.uuid4()}.png"), "wb") as f:
            f.write(encode_png(img))


def sample_to_dir(sample_fn, batch_size: int, sample_size: int,
                  temperature: float, out_dir: str) -> int:
    """Generate ``sample_size`` images in batches and write PNGs (reference
    ``util.py:22-28``).  ``sample_fn(n, t, batch_index)`` returns images in
    [0, 1].  Returns the number written."""
    os.makedirs(out_dir, exist_ok=True)
    batches = max(sample_size // batch_size, 1)
    written = 0
    for b in range(batches):
        save_images_to_dir(np.asarray(sample_fn(batch_size, temperature, b)),
                           out_dir)
        written += batch_size
    return written


def sample_sweep_to_dirs(sample_fn, batch_size: int, sample_size: int,
                         temperatures, out_root: str) -> dict:
    """The ``sample_to_dir`` protocol for a whole temperature sweep, one
    call per batch index: each call carries a per-row temperature vector
    over the sweep (``len(temperatures) * batch_size`` rows), and its rows
    land in ``out_root/t_{t:.1f}/``.  ``sample_fn(n, t_vector,
    batch_index)`` returns images in [0, 1].  Returns ``{t: written}``."""
    temperatures = [float(t) for t in temperatures]
    dirs = {}
    for t in temperatures:
        dirs[t] = os.path.join(out_root, f"t_{t:.1f}")
        os.makedirs(dirs[t], exist_ok=True)
    batches = max(sample_size // batch_size, 1)
    t_vec = np.repeat(np.asarray(temperatures, np.float32), batch_size)
    written = {t: 0 for t in temperatures}
    for b in range(batches):
        images = np.asarray(sample_fn(len(t_vec), t_vec, b))
        for i, t in enumerate(temperatures):
            save_images_to_dir(images[i * batch_size:(i + 1) * batch_size],
                               dirs[t])
            written[t] += batch_size
    return written
