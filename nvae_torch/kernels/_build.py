"""Build the port's CUDA sources into shared libraries and load them.

Each source under ``csrc/`` is compiled by ``nvcc -shared`` into a ``.so``
with a plain C interface and loaded with :mod:`ctypes`.  No PyTorch header is
included, so a build takes seconds.  Libraries go to
``nvae_torch/kernels/_build/`` (git-ignored), named by a hash of the source
and the flags, so an edited source rebuilds.  Nothing here runs at import
time: the first call of a kernel wrapper builds what it needs, and
:func:`build` (used by ``chip_smoke.py``) builds everything up front, one
``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# Library name -> source file under csrc/.
SOURCES = {"depthwise5x5": "depthwise5x5.cu", "se_gate": "se_gate.cu"}

# sm_90a (not sm_90) keeps wgmma/setmaxnreg available to later kernels.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
        "built on the machine with the card"
    )


def _paths(name: str):
    src = os.path.join(CSRC_DIR, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every library in ``names`` (default: all) that is not built
    yet, one ``nvcc`` process per source, all started together.  Returns
    ``{name: compiler output}`` (``-Xptxas -v`` prints each kernel's
    registers and shared memory); raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    logs: Dict[str, str] = {}
    jobs = []
    try:
        for name in names:
            src, out = _paths(name)
            if os.path.exists(out):
                logs[name] = "(already built)"
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((name, proc, tmp, out))
    finally:
        failed = []
        for name, proc, tmp, out in jobs:
            logs[name], _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(name)
    if failed:
        detail = "\n".join(f"--- {n} ---\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            _, out = _paths(name)
            if not os.path.exists(out):
                build([name])
            lib = ctypes.CDLL(out)
            _loaded[name] = lib
        return lib
