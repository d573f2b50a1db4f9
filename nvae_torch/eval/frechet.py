"""Frechet distance (FID) (counterpart of ``nvae_tpu/eval/frechet.py``).

The trace term uses the PSD identity

    tr sqrtm(S1 @ S2) = tr sqrtm(A @ S2 @ A),   A = sqrtm(S1),

whose right side is symmetric PSD, so two symmetric eigendecompositions
give it: in fp32 on the device (``frechet_distance``, for in-training
gating) or in fp64 on the host (``fid_from_stats``, the reported number).
Both add the reference's 1e-6 jitter to each covariance and clip negative
eigenvalues to 0.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nvae_torch.device import DeviceLike, fp32_math, resolve_device


def activation_statistics(feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and covariance (divisor N - 1) of (N, D) activations, fp32."""
    feats = feats.to(torch.float32)
    mu = feats.mean(dim=0)
    centered = feats - mu
    with fp32_math():
        cov = centered.T @ centered / (feats.shape[0] - 1)
    return mu, cov


def _sqrtm_psd(mat: torch.Tensor) -> torch.Tensor:
    vals, vecs = torch.linalg.eigh(mat)
    return (vecs * torch.sqrt(torch.clamp(vals, min=0.0))) @ vecs.T


@torch.no_grad()
def frechet_distance(mu1: torch.Tensor, cov1: torch.Tensor,
                     mu2: torch.Tensor, cov2: torch.Tensor) -> torch.Tensor:
    """``|mu1-mu2|^2 + tr(S1 + S2 - 2 sqrtm(S1 S2))`` in fp32 on the
    tensors' device, a 0-d tensor."""
    eps = 1e-6
    jitter = eps * torch.eye(mu1.shape[-1], dtype=cov1.dtype,
                             device=cov1.device)
    c1, c2 = cov1 + jitter, cov2 + jitter
    with fp32_math():
        a = _sqrtm_psd(c1)
        inner_vals = torch.linalg.eigvalsh(a @ c2 @ a)
        tr_sqrt = torch.sum(torch.sqrt(torch.clamp(inner_vals, min=0.0)))
        diff = mu1 - mu2
        return (torch.dot(diff, diff) + torch.trace(c1) + torch.trace(c2)
                - 2.0 * tr_sqrt)


def fid_from_stats(mu1, sigma1, mu2, sigma2) -> float:
    """FID from precomputed (mu, sigma) pairs in fp64 on the host, by the
    same identity."""
    mu1 = np.asarray(mu1, dtype=np.float64)
    mu2 = np.asarray(mu2, dtype=np.float64)
    s1 = np.asarray(sigma1, dtype=np.float64)
    s2 = np.asarray(sigma2, dtype=np.float64)
    eps = 1e-6 * np.eye(s1.shape[0])
    s1, s2 = s1 + eps, s2 + eps
    vals1, vecs1 = np.linalg.eigh(s1)
    root1 = (vecs1 * np.sqrt(np.clip(vals1, 0, None))) @ vecs1.T
    inner_vals = np.linalg.eigvalsh(root1 @ s2 @ root1)
    tr_sqrt = np.sum(np.sqrt(np.clip(inner_vals, 0, None)))
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * tr_sqrt)


def fid_from_features(feats1, feats2, precise: bool = True,
                      device: DeviceLike = "cuda") -> float:
    """FID between two activation sets, each (N, D).

    ``precise=True`` (the reported number) runs in fp64 on the host;
    ``precise=False`` runs the fp32 device path on ``device``."""
    if not precise:
        dev = resolve_device(device)
        mu1, c1 = activation_statistics(torch.as_tensor(feats1, device=dev))
        mu2, c2 = activation_statistics(torch.as_tensor(feats2, device=dev))
        return float(frechet_distance(mu1, c1, mu2, c2))
    a = np.asarray(feats1, dtype=np.float64)
    b = np.asarray(feats2, dtype=np.float64)
    return fid_from_stats(a.mean(0), np.cov(a, rowvar=False),
                          b.mean(0), np.cov(b, rowvar=False))
