"""ctypes binding of the port's batch PNG writer, ``csrc/pngio.cpp``
(counterpart of ``nvae_tpu/utils/native_png.py``).

The library is built at first use with ``g++ -O2 -fPIC -shared`` (``$CXX``
overrides the compiler) into ``nvae_torch/utils/_build/`` (git-ignored),
named by a hash of the source and the flags, so an edited source rebuilds.
Where no compiler exists :func:`available` is False and
:func:`~nvae_torch.utils.images.save_images_to_dir` takes its stdlib encoder.
One C call writes a whole (N, H, W, C) uint8 batch: stored deflate blocks,
no zlib, the bytes of the JAX package's writer for the same images.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "pngio.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-Wall")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpngio-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = _lib_path()
        if not os.path.exists(out) and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(out)
        except OSError:
            return None
        lib.pngio_write_batch.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.pngio_write_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built (building it now if a compiler exists)."""
    return _load() is not None


def write_batch(paths: Sequence[str], images: np.ndarray) -> int:
    """Write uint8 NHWC ``images`` (or NHW greyscale) to ``paths``, one C
    call; returns the number of files written.  Raises RuntimeError where
    the library is unavailable (callers check :func:`available` first)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the port's PNG writer is not built (no compiler)")
    imgs = np.ascontiguousarray(images, dtype=np.uint8)
    n, h, w = imgs.shape[:3]
    ch = imgs.shape[3] if imgs.ndim == 4 else 1
    if len(paths) != n:
        raise ValueError(f"{len(paths)} paths for {n} images")
    if ch not in (1, 3):
        raise ValueError(f"the writer takes 1 or 3 channels, got {ch}")
    blob = b"\0".join(os.fsencode(p) for p in paths) + b"\0"
    return lib.pngio_write_batch(
        blob, imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, ch)
