"""Core numerics of the port (counterpart of ``nvae_tpu/ops/math.py``).

Elementwise torch functions, shape-polymorphic, the spherical
interpolation of latents that the perceptual path length uses, and the
mixture of discretized logistics (DML) likelihood of the RGB presets
(``math.py:89-170``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
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


def normalize_l2(v: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """L2-normalize along ``dim``: ``v / sqrt(sum(v^2) + eps)``."""
    return v / torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True) + eps)


def slerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation of batches of (B, H, W, C) latents: vectors
    are normalized along the channel axis (the last), and ``t`` has shape
    (B,) and broadcasts as (B, 1, 1, 1)."""
    a = normalize_l2(a)
    b = normalize_l2(b)
    d = torch.sum(a * b, dim=-1, keepdim=True)
    p = t.reshape(-1, 1, 1, 1) * torch.arccos(d)
    c = normalize_l2(b - d * a)
    return normalize_l2(a * torch.cos(p) + c * torch.sin(p))


# ---------------------------------------------------------------------------
# Mixture of discretized logistics (the CIFAR-10 / CelebA likelihood head).
# Per pixel a K-component mixture with per-channel means and scales and
# mixture weights shared across the channels; the head's channels, NHWC:
#   K * (1 + 2 * C) = [K weights, then (2, K, C): K*C means, K*C log-scales]
# ---------------------------------------------------------------------------


def _split_dml_params(params: torch.Tensor, n_channels: int, n_mix: int):
    """``(logit_probs (..., K), means (..., K, C), log_scales (..., K, C))``
    of NHWC head output; ``log_scales`` clamped at -7 from below only."""
    *batch, h, w, ch = params.shape
    if ch != n_mix * (1 + 2 * n_channels):
        raise ValueError(f"a DML head of {n_mix} components over "
                         f"{n_channels} channels has "
                         f"{n_mix * (1 + 2 * n_channels)} channels, not {ch}")
    logit_probs = params[..., :n_mix]
    rest = params[..., n_mix:].reshape(*batch, h, w, 2, n_mix, n_channels)
    return logit_probs, rest[..., 0, :, :], torch.clamp(rest[..., 1, :, :],
                                                        min=-7.0)


def dml_log_prob(params: torch.Tensor, x: torch.Tensor, n_mix: int,
                 n_bits: int = 8) -> torch.Tensor:
    """Log-likelihood of ``x`` (..., H, W, C) in [0, 1] under the mixture
    ``params`` (..., H, W, K(1 + 2C)): per pixel, (..., H, W); callers sum
    over H and W.  JAX's forms: ``x`` mapped to [-1, 1], the bin's CDF
    difference while it exceeds 1e-5 (its log of a value clipped at 1e-12,
    so that the unused branch's gradient is finite), else the density at
    the bin's centre; the edge bins (``x < -0.999``, ``x > 0.999``) take
    the open-ended CDFs."""
    n_channels = x.shape[-1]
    n_levels = float(2 ** n_bits - 1)
    logit_probs, means, log_scales = _split_dml_params(params, n_channels,
                                                       n_mix)
    x = (x * 2.0 - 1.0).unsqueeze(-2)  # (..., 1, C) over the components
    inv_s = torch.exp(-log_scales)
    centered = x - means
    plus_in = inv_s * (centered + 1.0 / n_levels)
    min_in = inv_s * (centered - 1.0 / n_levels)
    log_cdf_plus = plus_in - F.softplus(plus_in)
    log_one_minus_cdf_min = -F.softplus(min_in)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    mid_in = inv_s * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    log_prob_mid = torch.where(
        cdf_delta > 1e-5,
        torch.log(torch.clamp(cdf_delta, min=1e-12)),
        log_pdf_mid - math.log(n_levels / 2.0),
    )
    log_probs = torch.where(
        x < -0.999, log_cdf_plus,
        torch.where(x > 0.999, log_one_minus_cdf_min, log_prob_mid),
    )  # (..., K, C)
    log_probs = log_probs.sum(dim=-1) + F.log_softmax(logit_probs, dim=-1)
    return torch.logsumexp(log_probs, dim=-1)


def dml_sample(params: torch.Tensor, n_mix: int, n_channels: int, *,
               generator: Optional[torch.Generator] = None,
               gumbel: Optional[torch.Tensor] = None,
               uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A draw in [0, 1], (..., H, W, C), from the mixture ``params``.

    The component of each pixel is ``argmax(logit_probs + gumbel)``, JAX's
    ``categorical``; the logistic draw is ``mean + exp(log_scale) * (log u
    - log(1 - u))`` with ``u`` uniform in [1e-5, 1 - 1e-5] per channel.
    ``gumbel`` (..., H, W, K) and ``uniform`` (..., H, W, C) inject the
    two draws (``uniform`` already in that interval); each one not
    injected comes from ``generator``, the Gumbel noise first."""
    logit_probs, means, log_scales = _split_dml_params(params, n_channels,
                                                       n_mix)
    dev, dt = params.device, params.dtype
    if gumbel is None:
        tiny = torch.finfo(dt).tiny
        u = torch.rand(logit_probs.shape, generator=generator, device=dev,
                       dtype=dt)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    gumbel = _drawn(gumbel, logit_probs.shape, "gumbel", dev, dt)
    mix = torch.argmax(logit_probs + gumbel, dim=-1)
    one_hot = F.one_hot(mix, n_mix).to(dt).unsqueeze(-1)
    mean = (means * one_hot).sum(dim=-2)
    log_scale = (log_scales * one_hot).sum(dim=-2)
    if uniform is None:
        uniform = 1e-5 + (1.0 - 2e-5) * torch.rand(
            mean.shape, generator=generator, device=dev, dtype=dt)
    u = _drawn(uniform, mean.shape, "uniform", dev, dt)
    x = mean + torch.exp(log_scale) * (torch.log(u) - torch.log1p(-u))
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)


def dml_mean(params: torch.Tensor, n_mix: int, n_channels: int
             ) -> torch.Tensor:
    """The mixture's mean in [0, 1], (..., H, W, C): the greyscale image
    of a DML model, as ``sigmoid(logits)`` is a Bernoulli model's."""
    logit_probs, means, _ = _split_dml_params(params, n_channels, n_mix)
    w = torch.softmax(logit_probs, dim=-1).unsqueeze(-1)
    return torch.clamp(((means * w).sum(dim=-2) + 1.0) / 2.0, 0.0, 1.0)


def _drawn(t, shape, name: str, device, dtype) -> torch.Tensor:
    """An injected draw as a ``dtype`` tensor on ``device``, of ``shape``."""
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t, dtype=np.float32))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, the draw "
                         f"needs {tuple(shape)}")
    return t.to(device=device, dtype=dtype)
