"""Core numerics of the port (counterpart of ``nvae_tpu/ops/math.py:18-34``).

Elementwise torch functions, shape-polymorphic; the rest of the JAX module
(KL, Bernoulli/DML likelihoods, slerp) comes with the slices that use it.
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def softclamp5(x: torch.Tensor) -> torch.Tensor:
    """Differentiable clamp to [-5, 5]: ``5 * tanh(x / 5)``."""
    return 5.0 * torch.tanh(x / 5.0)


def gaussian_log_prob(
    z: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor
) -> torch.Tensor:
    """Elementwise diagonal-Gaussian log density, parameterized by the
    standard deviation ``sigma``."""
    normalized = (z - mu) / sigma
    return -0.5 * normalized * normalized - 0.5 * _LOG_2PI - torch.log(sigma)
