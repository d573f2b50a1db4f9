"""ELBO, KL balancing and warm-up, and regularization penalties (counterpart
of ``nvae_tpu/train/losses.py``), as functions over the port's
:class:`~nvae_torch.models.nvae.ForwardOutput`.  Metric keys are the JAX
package's."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from nvae_torch.config import ModelConfig, TrainConfig
from nvae_torch.models.nvae import LatentParams
from nvae_torch.nn.blocks import BatchNorm
from nvae_torch.ops import (
    bernoulli_log_prob,
    diagonal_gaussian_kl,
    dml_log_prob,
)
from nvae_torch.parallel.tp import once_over_model


def kl_per_group(latents: List[LatentParams]) -> torch.Tensor:
    """(G, B) KL summed over each group's elements."""
    return torch.stack([
        diagonal_gaussian_kl(g.enc_mu, g.enc_sigma, g.dec_mu, g.dec_sigma)
        .sum(dim=(1, 2, 3))
        for g in latents
    ])


def kl_alphas(n_scales: int, groups_per_scale: Sequence[int],
              device=None) -> torch.Tensor:
    """Square-decay balancing coefficients in the decoder's top-down group
    order: scale i gets ``(2^i)^2 / groups_per_scale[n - 1 - i]``, over
    their minimum.  ``groups_per_scale`` is bottom-up (config order)."""
    coeffs = []
    for i in range(n_scales):
        g = groups_per_scale[n_scales - i - 1]
        coeffs += [float((2**i) ** 2) / g] * g
    alphas = torch.tensor(coeffs, dtype=torch.float32, device=device)
    return alphas / alphas.min()


def balanced_kl_loss(kl_all: torch.Tensor, alphas: torch.Tensor,
                     mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample KL with warm-up balancing: coefficients
    ``(mean_b |KL_g| + 0.01) / alpha_g * sum_g(...)`` over their mean,
    detached (JAX's ``stop_gradient``).  ``mean_b`` is over the global
    batch: with a ``mesh`` (``parallel.mesh.DataMesh``) the ranks' means
    are averaged, so every rank weighs the groups alike.  Returns
    ``(loss_b, coeffs_g)``."""
    abs_mean = kl_all.abs().mean(dim=1)
    if mesh is not None:
        abs_mean = mesh.mean(abs_mean.detach())
    kl_coeff = abs_mean + 0.01
    total_kl = kl_coeff.sum()
    kl_coeff = kl_coeff / alphas * total_kl
    kl_coeff = (kl_coeff / kl_coeff.mean()).detach()
    return (kl_all * kl_coeff[:, None]).sum(dim=0), kl_coeff


def unbalanced_kl_loss(kl_all: torch.Tensor) -> torch.Tensor:
    """Plain sum over groups."""
    return kl_all.sum(dim=0)


def recon_loss(logits: torch.Tensor, x: torch.Tensor,
               likelihood: str = "bernoulli", n_mix: int = 10,
               crop: int = 0) -> torch.Tensor:
    """Per-sample negative log-likelihood summed over pixels, NHWC, under
    the Bernoulli head or the mixture of ``n_mix`` discretized logistics
    (``likelihood="dml"``, whose log-probability is per pixel).  ``crop``
    trims a border first."""
    if crop:
        x = x[:, crop:-crop, crop:-crop, :]
        logits = logits[:, crop:-crop, crop:-crop, :]
    if likelihood == "bernoulli":
        return -bernoulli_log_prob(logits, x).sum(dim=(1, 2, 3))
    return -dml_log_prob(logits, x, n_mix=n_mix).sum(dim=(1, 2))


def bn_gamma_penalty(model: nn.Module, sr_lambda: float) -> torch.Tensor:
    """``sr_lambda * sum max|gamma|`` over the BatchNorm scales of the
    encoder and decoder towers only (not preprocess, postprocess), the scope
    of ``losses.py:99-113``.  ``model`` is the NVAE or a pipeline stage's
    modules (``parallel/pipeline.py``), which may hold neither tower: the
    penalty is then 0.0.  Under TP the scale of a BatchNorm that reads its
    block (``tp``) is whole on every rank, and its gradient, this rank's
    share, is summed over the model axis: its term reaches it once
    (``parallel.tp.once_over_model``)."""
    total = 0.0
    for name in ("encoder", "decoder"):
        tower = getattr(model, name, None)
        if tower is None:
            continue
        for m in tower.modules():
            if isinstance(m, BatchNorm):
                g = m.weight.abs().max()
                total = total + (g if m.tp is None
                                 else once_over_model(g, m.tp))
    return sr_lambda * total


def beta_schedule(step, epoch, *, train_cfg: TrainConfig,
                  total_steps: int, total_epochs: int) -> torch.Tensor:
    """KL warm-up coefficient in [0, 1], a float32 scalar as in JAX, on the
    device of ``step`` and ``epoch`` (ints, or integer tensors such as the
    step's device counter, so that nothing is read back to the host):

    - step-based: ``min(step / (frac * total_steps), 1)``;
    - epoch-based: ``min(epoch / (frac * total_epochs), 1)``;
    - epoch-based, reference parity: ``min(epoch / (frac * total_steps), 1)``.
    """
    frac = train_cfg.warmup_fraction
    if train_cfg.step_based_warmup:
        metric, denom = step, frac * total_steps
    elif train_cfg.parity_epoch_warmup_in_steps:
        metric, denom = epoch, frac * total_steps
    else:
        metric, denom = epoch, frac * total_epochs
    metric = torch.as_tensor(metric).to(torch.float32)
    ratio = metric / torch.full((), max(denom, 1e-8), dtype=torch.float32,
                                device=metric.device)
    return torch.clamp(ratio, max=1.0)


def elbo_loss(output, x: torch.Tensor, beta: torch.Tensor,
              model_cfg: ModelConfig, *,
              alphas: Optional[torch.Tensor] = None, mesh=None
              ) -> Tuple[torch.Tensor, dict]:
    """``mean(recon + beta * kl)``, with balancing while ``beta < 1``.
    ``alphas`` are :func:`kl_alphas` of the config, made once by a caller
    that steps many times (a CUDA graph cannot copy them to the card).
    With a ``mesh`` ``x`` is this rank's rows, and the balancing
    coefficients are the global batch's; the loss and metrics stay this
    rank's means (the step averages them over the ranks).
    Returns ``(loss, metrics)``; the step adds the penalties."""
    rl = recon_loss(output.logits, x, model_cfg.likelihood, model_cfg.n_mix)
    kl_all = kl_per_group(output.latents)
    if alphas is None:
        alphas = kl_alphas(model_cfg.n_latent_scales,
                           model_cfg.n_groups_per_scale, device=kl_all.device)
    beta = beta.to(kl_all.device)
    # Both forms, and the one beta picks on the device: a branch on beta
    # would read it back to the host.
    balanced, _ = balanced_kl_loss(kl_all, alphas, mesh)
    kl = torch.where(beta < 1.0, balanced, unbalanced_kl_loss(kl_all))
    loss = (rl + beta * kl).mean()
    metrics = {
        "reconstruction_loss": rl.mean(),
        "kl_loss": kl.mean(),
        "kl_raw": kl_all.sum(dim=0).mean(),
        "beta": beta,
    }
    return loss, metrics
