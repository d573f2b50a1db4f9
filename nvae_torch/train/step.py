"""One training step and the eval step (counterpart of
``nvae_tpu/train/step.py``).  The step: the posterior pass, the ELBO with KL
warm-up and balancing, the penalties, the backward pass (through the fused
depthwise kernels' backward on the card), and one optimizer update.  The
eval step: the ELBO's pieces on a held-out batch, leaving the model as it
was."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from nvae_torch.config import ModelConfig, TrainConfig
from nvae_torch.device import fp32_math
from nvae_torch.models.nvae import NVAE, discard_buffer_updates
from nvae_torch.train import losses
from nvae_torch.train.optim import (
    GradientTransformation,
    apply_updates,
    find_spectral_state,
    global_norm,
    spectral_penalty,
)
from nvae_torch.train.state import TrainState
from nvae_torch.utils.seeds import derive_seed


def step_seed(seed: int, step: int, microbatch: int) -> int:
    """Generator seed of the posterior noise of ``microbatch`` in step
    ``step`` of a run seeded with ``seed``: :func:`derive_seed` of the
    triple, the BLAKE2b digest of ``f"{seed}:{step}:{microbatch}"``.  A pure
    function of the triple, so any step can be replayed."""
    return derive_seed(seed, step, microbatch)


def make_train_step(
    model: NVAE,
    tx: GradientTransformation,
    train_cfg: TrainConfig,
    total_steps: int,
    steps_per_epoch: int,
):
    """Returns ``step(state, batch, *, eps=None) -> (state, metrics)``.

    ``batch`` is (B, H, W, C) in [0, 1] (binarized for Bernoulli models), a
    tensor on the model's device or an array, cast to the model's dtype
    (float32; a float64 copy on the CPU serves as a reference).  Each module
    computes in the config's dtypes (``compute_dtype``, ``bn_apply_dtype``:
    bf16 where set, no loss scaling, as in JAX); the parameters, and so the
    gradients and the optimizer, stay fp32.  On the card its fp32 work runs
    in full fp32 (:func:`nvae_torch.device.fp32_math`:
    ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` are False while it runs).

    - ``beta`` and ``epoch = step // steps_per_epoch`` as in JAX.
    - Loss: ``elbo_loss + bn_gamma_penalty`` (+ ``spectral_penalty`` in
      penalty mode, with ``u`` from the optimizer state).
    - ``parity_frozen_norm`` runs the forward in eval mode (running
      BatchNorm statistics, no ``u`` update) while gradients still flow.
    - ``grad_accum`` M splits the batch into M microbatches; BatchNorm
      running statistics and forward-mode ``u`` chain through them in place,
      the gradients and metrics are their means.  Microbatch i draws its
      posterior noise from a generator seeded with
      ``step_seed(state.seed, state.step, i)``, or from ``eps[i]`` (one list
      of NHWC draws per microbatch, in the posterior pass's order).
    - One optimizer update.  The parameters are updated in place, where the
      JAX step donates the old state and returns new arrays; the returned
      state holds the same model and the new optimizer state and counters.

    Profiler ranges ``train_step.forward`` (posterior pass and loss),
    ``train_step.backward`` and ``train_step.update`` (gradient norm and
    optimizer) split a step's host time in a ``torch.profiler`` trace.

    Metrics (tensors on the device): ``loss``, ``reconstruction_loss``,
    ``kl_loss``, ``kl_raw``, ``beta``, ``bn_loss``, ``spectral_loss``
    (penalty mode only) and ``grad_norm`` (global L2 norm of the gradients,
    before the update).
    """
    model_cfg: ModelConfig = model.cfg
    total_epochs = max(total_steps // max(steps_per_epoch, 1), 1)
    grad_accum = max(int(train_cfg.grad_accum), 1)
    train_flag = not train_cfg.parity_frozen_norm
    params = dict(model.named_parameters())
    device, dtype = model.decoder.h.device, model.decoder.h.dtype

    def step(state: TrainState, batch, *,
             eps: Optional[Sequence[Sequence]] = None
             ) -> Tuple[TrainState, dict]:
        epoch = state.step // steps_per_epoch
        beta = losses.beta_schedule(
            state.step, epoch, train_cfg=train_cfg, total_steps=total_steps,
            total_epochs=total_epochs,
        )
        sn_u = None
        if model_cfg.spectral_mode == "penalty":
            sn_state = find_spectral_state(state.opt_state)
            sn_u = sn_state.u if sn_state is not None else None

        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.array(batch, dtype=np.float32))
        batch = batch.to(device=device, dtype=dtype)
        if batch.shape[0] % grad_accum:
            raise ValueError(f"batch size {batch.shape[0]} not divisible by "
                             f"grad_accum {grad_accum}")
        if eps is not None and len(eps) != grad_accum:
            raise ValueError(f"eps needs one list per microbatch "
                             f"({grad_accum}), got {len(eps)}")

        model.train(train_flag)
        for p in params.values():
            p.grad = None
        totals: dict = {}
        with fp32_math():
            for i, mb in enumerate(batch.chunk(grad_accum)):
                gen = None
                if eps is None:
                    gen = torch.Generator(device=device).manual_seed(
                        step_seed(state.seed, state.step, i))
                with record_function("train_step.forward"):
                    out = model(mb, generator=gen,
                                eps=None if eps is None else eps[i])
                    loss, metrics = losses.elbo_loss(out, mb, beta, model_cfg)
                    bn_loss = losses.bn_gamma_penalty(model,
                                                      model_cfg.sr_lambda)
                    loss = loss + bn_loss
                    metrics["bn_loss"] = bn_loss
                    if sn_u is not None:
                        sr = spectral_penalty(params, sn_u,
                                              model_cfg.sr_lambda)
                        loss = loss + sr
                        metrics["spectral_loss"] = sr
                with record_function("train_step.backward"):
                    loss.backward()
                metrics["loss"] = loss
                for k, v in metrics.items():
                    v = v.detach()
                    totals[k] = v if k not in totals else totals[k] + v
            with record_function("train_step.update"):
                grads = {k: p.grad if p.grad is not None
                         else torch.zeros_like(p) for k, p in params.items()}
                if grad_accum > 1:
                    grads = {k: g / grad_accum for k, g in grads.items()}
                    totals = {k: v / grad_accum for k, v in totals.items()}
                totals["grad_norm"] = global_norm(grads)
                updates, opt_state = tx.update(grads, state.opt_state, params)
                apply_updates(params, updates)
        for p in params.values():
            p.grad = None
        return dataclasses.replace(state, step=state.step + 1, epoch=epoch,
                                   opt_state=opt_state), totals

    return step


def make_eval_step(model: NVAE, train_cfg: TrainConfig,
                   bn_batch_stats: bool = True):
    """Returns ``eval_fn(state, batch, *, generator=None, eps=None) ->
    metrics``: ``reconstruction_loss``, ``kl_loss`` (the unbalanced KL sum)
    and ``elbo``, batch means as tensors on the device, from one posterior
    pass over ``state.model`` under ``no_grad`` and
    :func:`~nvae_torch.device.fp32_math`.

    ``bn_batch_stats`` (the default) normalizes with the batch's own
    statistics, in training mode, and throws the buffer updates away (JAX
    runs it with ``mutable=["batch_stats", "spectral"]`` and discards the
    mutations; see its docstring for why running-average BatchNorm corrupts
    the held-out KL).  Otherwise the pass runs in eval mode.  Either way
    every buffer keeps its bits and the model its mode.  Noise as in the
    train step: ``generator``, or ``eps`` (one list of NHWC draws in the
    posterior pass's order).
    """
    model_cfg: ModelConfig = model.cfg

    def eval_fn(state: TrainState, batch, *,
                generator: Optional[torch.Generator] = None,
                eps: Optional[Sequence] = None) -> dict:
        m = state.model
        with (torch.no_grad(), fp32_math(),
              discard_buffer_updates(m, train=bn_batch_stats)):
            h = m.decoder.h
            if not isinstance(batch, torch.Tensor):
                batch = torch.from_numpy(np.array(batch, dtype=np.float32))
            batch = batch.to(device=h.device, dtype=h.dtype)
            out = m(batch, generator=generator, eps=eps)
            rl = losses.recon_loss(out.logits, batch, model_cfg.likelihood,
                                   model_cfg.n_mix)
            kl = losses.kl_per_group(out.latents).sum(dim=0)
            return {
                "reconstruction_loss": rl.mean(),
                "kl_loss": kl.mean(),
                "elbo": (rl + kl).mean(),
            }

    return eval_fn
