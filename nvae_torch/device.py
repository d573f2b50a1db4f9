"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
Asking for the card where there is none raises: a run that silently fell
back to the CPU would report CPU numbers under the card's name.  Tests ask
for ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


@contextlib.contextmanager
def fp32_math(deterministic: bool = False):
    """Full fp32 on the card: cuDNN convolutions and cuBLAS products without
    TF32 (``torch.backends.cudnn.allow_tf32`` defaults to True, which would
    round every convolution's inputs to a 10-bit mantissa).  With
    ``deterministic``, cuDNN also takes deterministic algorithms without
    benchmarking, so a call repeats bitwise (the sampler's replay).  The
    flags are process-wide; the previous ones come back on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    if deterministic:
        cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved
