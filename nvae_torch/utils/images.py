"""Image tiling, PNG output and image directories (counterpart of
``nvae_tpu/utils/images.py``: ``tile_images``, ``to_uint8``,
``save_images_to_dir``, ``sample_to_dir``, ``sample_sweep_to_dirs``, and the
metric suite's reader, ``ImageDirectory`` and ``load_images_from_dir``).

PNGs are written by the port's batch writer (``native_png``, C++ through
ctypes, built at first use) where a compiler exists, as the JAX package
writes through its own; otherwise, and for one image, by a small codec on
the standard library (``zlib`` and ``struct``), which also reads them.  The
encoder writes 8-bit greyscale or RGB, no interlace, filter 0 on every row.
The decoder reads 8-bit greyscale, greyscale + alpha, RGB and RGBA, every
filter type (0-4), no interlace, and raises on any other PNG, naming what it
is.  JPEGs need Pillow, and raise without it.
"""

from __future__ import annotations

import math
import os
import struct
import uuid
import zlib
from typing import Optional

import numpy as np

from nvae_torch.utils import native_png

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}  # channels -> PNG colour type (grey, RGB)
# PNG colour type -> channels: grey, RGB, grey + alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_NAMES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale+alpha",
                6: "RGBA"}


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
    uuid4-named PNG (reference ``util.py:31-36``): one call of the native
    batch writer where it is built, else the stdlib encoder, which also
    writes any file the native writer missed."""
    os.makedirs(out_dir, exist_ok=True)
    arr = to_uint8(np.asarray(images))
    paths = [os.path.join(out_dir, f"{uuid.uuid4()}.png") for _ in arr]
    if native_png.available() and native_png.write_batch(paths, arr) == len(
            arr):
        return
    for img, path in zip(arr, paths):
        if not os.path.exists(path):
            with open(path, "wb") as f:
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


def _unfilter(ftype: np.ndarray, lines: np.ndarray) -> np.ndarray:
    """Undo the per-row PNG filters of a batch of same-shaped 8-bit images:
    ``ftype`` (N, h) filter bytes, ``lines`` (N, h, w, bpp) filtered bytes;
    returns (N, h, w, bpp) uint8.

    A byte depends on its left, upper and upper-left neighbours (Sub, Up,
    Average, Paeth), so the images are decoded one anti-diagonal at a
    time, each step vectorised over the images and their rows: in a skewed
    copy where pixel (y, x) sits in column y + x + 2, step k reads column
    k - 1 (left in its own row, up in the row above) and k - 2 (upper left).
    Columns left of a row's first pixel stay 0, the filters' edge value."""
    unknown = ftype[ftype > 4]
    if unknown.size:
        raise ValueError(f"PNG row has unknown filter type {unknown[0]}")
    if not ftype.any():
        return lines
    n, h, w, bpp = lines.shape
    ys = np.arange(h)[:, None]
    cols = ys + 2 + np.arange(w)
    # Skewed column first, so that each step reads and writes whole blocks.
    raw = np.zeros((h + w + 1, n, h, bpp), np.int16)
    raw[cols, :, ys] = lines.transpose(1, 2, 0, 3)
    out = np.zeros((h + w + 1, n, h + 1, bpp), np.int16)  # row 0: above
    f = ftype[:, :, None].astype(np.int16)
    for k in range(2, h + w + 1):
        a, b, c = out[k - 1, :, 1:], out[k - 1, :, :-1], out[k - 2, :, :-1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(f == 4, paeth, np.where(f == 3, (a + b) >> 1,
                        np.where(f == 2, b, np.where(f == 1, a, 0))))
        out[k, :, 1:] = (raw[k] + pred) & 0xFF
    return out[cols, :, ys + 1].transpose(2, 0, 1, 3).astype(np.uint8)


def _parse_png(data: bytes):
    """The filter bytes (h,) and filtered rows (h, w, C) of an 8-bit,
    non-interlaced greyscale (C=1), greyscale + alpha (2), RGB (3) or RGBA
    (4) PNG.  Raises ValueError on any other PNG, naming its bit depth,
    colour type or interlace."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"unsupported PNG colour type {color} "
                         f"({_COLOR_NAMES.get(color, 'unknown')})")
    if depth != 8:
        raise ValueError(f"unsupported PNG bit depth {depth} "
                         f"({_COLOR_NAMES[color]}): only 8-bit is read")
    if interlace:
        raise ValueError("unsupported interlaced (Adam7) PNG")
    c = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (w * c + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected "
                         f"{h * (w * c + 1)}")
    rows = rows.reshape(h, w * c + 1)
    return rows[:, 0], rows[:, 1:].reshape(h, w, c)


def decode_pngs(blobs) -> list:
    """(H, W, C) uint8 of each PNG in ``blobs`` (see ``_parse_png``);
    images of one shape are unfiltered together."""
    parsed = [_parse_png(data) for data in blobs]
    out = [None] * len(parsed)
    groups = {}
    for i, (_, lines) in enumerate(parsed):
        groups.setdefault(lines.shape, []).append(i)
    for idx in groups.values():
        decoded = _unfilter(np.stack([parsed[i][0] for i in idx]),
                            np.stack([parsed[i][1] for i in idx]))
        for i, img in zip(idx, decoded):
            out[i] = img
    return out


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, C) uint8 of one PNG (see ``_parse_png``)."""
    return decode_pngs([data])[0]


def _read_images(paths) -> list:
    """Each file as (H, W, C) uint8: PNGs through ``decode_pngs``, other
    formats through Pillow."""
    out = [None] * len(paths)
    png = [i for i, p in enumerate(paths) if p.lower().endswith(".png")]
    blobs = []
    for i in png:
        with open(paths[i], "rb") as f:
            blobs.append(f.read())
    for i, img in zip(png, decode_pngs(blobs)):
        out[i] = img
    for i, p in enumerate(paths):
        if out[i] is None:
            out[i] = _read_with_pillow(p)
    return out


def _read_with_pillow(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"reading {path} needs Pillow, which is not "
                           "installed: JPEG decoding is not built in") from e
    img = np.asarray(Image.open(path))
    return img[..., None] if img.ndim == 2 else img


def _list_image_files(in_dir: str, limit: Optional[int] = None):
    files = sorted(f for f in os.listdir(in_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    return files[:limit] if limit else files


class ImageDirectory:
    """Lazy, sliceable view of a directory of PNG/JPG images, sorted by
    name: ``len()`` and slicing decode only the sliced files, so feature
    extraction streams a large directory at O(batch) host memory.
    ``scale=True`` yields float32 in [0, 1], ``scale=False`` raw uint8.
    ``max_slice_decoded`` is the most files one slice decoded."""

    def __init__(self, in_dir: str, limit: Optional[int] = None,
                 scale: bool = True):
        self.in_dir = in_dir
        self.files = _list_image_files(in_dir, limit)
        self.scale = scale
        self.max_slice_decoded = 0
        self._shape = None  # (H, W, C) of the files, for an empty slice

    def __len__(self) -> int:
        return len(self.files)

    def _decode(self, files) -> np.ndarray:
        if not files:
            # As ndarray slicing: an empty slice is (0, H, W, C).
            if self._shape is None and self.files:
                self._decode([self.files[0]])
            return np.empty((0, *(self._shape or (0, 0, 0))),
                            np.float32 if self.scale else np.uint8)
        arr = np.stack(_read_images([os.path.join(self.in_dir, f)
                                     for f in files]))
        self._shape = arr.shape[1:]
        self.max_slice_decoded = max(self.max_slice_decoded, len(files))
        return arr.astype(np.float32) / 255.0 if self.scale else arr

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self._decode(self.files[idx])
        return self._decode([self.files[idx]])[0]


def load_images_from_dir(in_dir: str,
                         limit: Optional[int] = None) -> np.ndarray:
    """Every PNG/JPG of a directory as one uint8 NHWC array."""
    return ImageDirectory(in_dir, limit=limit, scale=False)[:]
