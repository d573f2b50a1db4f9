"""Perceptual path length over the last latent group (counterpart of
``nvae_tpu/eval/ppl.py``).

Two extra draws (z1, z2) from the final group's prior are slerped at ``t``
and ``t + eps``, both decoded through the final group alone
(``NVAE.sample_with_z``), and the feature-space displacement over eps^2 is
averaged with 1st/99th-percentile outlier rejection.

Parity note: the reference norms over ``axis=0``, the batch axis, giving
per-feature path lengths; ``per_sample=False`` (default) copies it, and
``per_sample=True`` gives the textbook per-sample metric.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nvae_torch.ops.math import slerp


def slerp_pair(z1: torch.Tensor, z2: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               epsilon: float = 1e-4, t: Optional[torch.Tensor] = None):
    """(slerp(t), slerp(t + eps)) with ``t ~ U[0, 1)`` per sample, drawn
    from ``generator`` unless ``t`` (shape (B,)) is given."""
    if t is None:
        t = torch.rand(z1.shape[0], generator=generator, device=z1.device)
    t = torch.as_tensor(t, dtype=z1.dtype, device=z1.device)
    return slerp(z1, z2, t), slerp(z1, z2, t + epsilon)


def evaluate(act1, act2, epsilon: float = 1e-4,
             per_sample: bool = False) -> float:
    """Mean filtered path length of two (N, D) feature sets."""
    act1 = np.asarray(act1)
    act2 = np.asarray(act2)
    axis = -1 if per_sample else 0
    distances = np.linalg.norm(act1 - act2, axis=axis) / (epsilon**2)
    lo = np.percentile(distances, 1, method="lower")
    hi = np.percentile(distances, 99, method="higher")
    kept = distances[(distances >= lo) & (distances <= hi)]
    return float(np.mean(kept))
