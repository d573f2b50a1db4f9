"""Core numerics of the port (counterpart of ``nvae_tpu/ops/math.py:18-63``).

Elementwise torch functions, shape-polymorphic; the rest of the JAX module
(DML likelihood, slerp) comes with the slices that use it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def diagonal_gaussian_kl(
    enc_mu: torch.Tensor, enc_sigma: torch.Tensor,
    dec_mu: torch.Tensor, dec_sigma: torch.Tensor,
) -> torch.Tensor:
    """Elementwise KL(N(enc_mu, enc_sigma) || N(dec_mu, dec_sigma)):
    ``0.5 * (t1^2 + t2^2) - 0.5 - log(t2)`` with ``t1 = (mu_q - mu_p) /
    sigma_p`` and ``t2 = sigma_q / sigma_p``."""
    term1 = (enc_mu - dec_mu) / dec_sigma
    term2 = enc_sigma / dec_sigma
    return 0.5 * (term1 * term1 + term2 * term2) - 0.5 - torch.log(term2)


def bernoulli_log_prob(logits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Elementwise Bernoulli log-likelihood of ``x`` under ``logits``:
    ``-(x * softplus(-l) + (1 - x) * softplus(l))``."""
    return -(x * F.softplus(-logits) + (1.0 - x) * F.softplus(logits))
