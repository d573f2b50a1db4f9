"""Importance-weighted (IWAE) negative log-likelihood (counterpart of
``nvae_tpu/eval/nll.py``).

Reference protocol (``evaluate.py:111-123``): per test batch, K importance
samples; ``log w = -recon_crop - log q + log p``; batch NLL =
``-mean(logsumexp(log w) - log K)``; reported as mean and std over batches.
The reconstruction term crops the 32x32 canvas to the 28x28 MNIST interior
(``crop=2``).  Each importance sample is one posterior pass with ``nll``.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from nvae_torch.config import ModelConfig
from nvae_torch.device import fp32_math
from nvae_torch.models.nvae import NVAE, discard_buffer_updates
from nvae_torch.train.losses import recon_loss
from nvae_torch.utils.seeds import derive_seed


def make_nll_fn(model: NVAE, n_attempts: int = 10, crop: int = 2,
                bn_batch_stats: bool = True):
    """Returns ``nll_fn(batch, *, generator=None, eps=None)``: the batch's
    IWAE NLL, a scalar tensor on the model's device.

    ``bn_batch_stats`` normalizes with the batch's own statistics (see
    :func:`nvae_torch.train.step.make_eval_step`); every attempt starts
    from the model's buffers as they were, as each JAX attempt does, and
    the model ends with them and its mode unchanged.  The attempts' noise
    comes from ``generator`` or from ``eps``, one list of NHWC draws per
    attempt in the posterior pass's order.  Runs under ``no_grad`` and
    :func:`~nvae_torch.device.fp32_math`."""
    cfg: ModelConfig = model.cfg

    def nll_fn(batch, *, generator: Optional[torch.Generator] = None,
               eps: Optional[Sequence[Sequence]] = None) -> torch.Tensor:
        if eps is not None and len(eps) != n_attempts:
            raise ValueError(f"eps needs one list per attempt ({n_attempts}),"
                             f" got {len(eps)}")
        h = model.decoder.h
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.array(batch, dtype=np.float32))
        batch = batch.to(device=h.device, dtype=h.dtype)
        log_iws = []
        with (torch.no_grad(), fp32_math(),
              discard_buffer_updates(model, train=bn_batch_stats) as restore):
            for k in range(n_attempts):
                if k:
                    restore()
                out = model(batch, nll=True, generator=generator,
                            eps=None if eps is None else eps[k])
                rl = recon_loss(out.logits, batch, cfg.likelihood, cfg.n_mix,
                                crop=crop)
                log_iws.append(-rl - out.log_q + out.log_p)
            log_avg = (torch.logsumexp(torch.stack(log_iws), dim=0)
                       - math.log(n_attempts))
            return -log_avg.mean()

    return nll_fn


def neg_log_likelihood(model: NVAE, batches: Iterable[torch.Tensor],
                       seed: int = 0, n_attempts: int = 10,
                       crop: int = 2) -> Tuple[float, float]:
    """Mean and std of the per-batch IWAE NLL over ``batches``; batch ``i``
    draws its noise from a generator seeded with
    ``derive_seed(seed, "nll", i)``."""
    nll_fn = make_nll_fn(model, n_attempts, crop)
    device = model.decoder.h.device
    values = []
    for i, batch in enumerate(batches):
        gen = torch.Generator(device=device).manual_seed(
            derive_seed(seed, "nll", i))
        values.append(float(nll_fn(batch, generator=gen)))
    return float(np.mean(values)), float(np.std(values))
