"""One training step and the eval step (counterpart of
``nvae_tpu/train/step.py``).  The step: the posterior pass, the ELBO with KL
warm-up and balancing, the penalties, the backward pass (through the fused
depthwise kernels' backward on the card), and one optimizer update.  The
eval step: the ELBO's pieces on a held-out batch, leaving the model as it
was."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from nvae_torch.config import ModelConfig, TrainConfig
from nvae_torch.device import fp32_math
from nvae_torch.models.nvae import (
    NVAE,
    discard_buffer_updates,
    posterior_noise_shapes,
)
from nvae_torch.parallel.mesh import (
    batch_stats_over,
    gathered_params,
    shard_axis,
)
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


def global_noise_rows(cfg: ModelConfig, rows: int, mesh, eps, generator,
                      device, dtype) -> list:
    """This rank's ``rows`` of a posterior pass's noise over the global
    batch (``rows`` times the rank count): of ``eps`` (the global batch's
    draws) or of a draw of the global batch's shapes from ``generator``,
    the draw a single device makes, so the noise does not depend on the
    rank count."""
    n = rows * mesh.size
    if eps is None:
        dt = torch.promote_types(dtype, torch.float32)
        eps = [torch.randn(s, generator=generator, device=device, dtype=dt)
               for s in posterior_noise_shapes(cfg, n)]
    return [torch.as_tensor(e)[mesh.rows(n)] for e in eps]


class StepBody:
    """The training step's work on the device, shared by
    :func:`make_train_step` and the epoch runner
    (``train/epoch_runner.py``), which captures it in a CUDA graph.

    It reads nothing back to the host, and every tensor it writes lives in
    place: the step counter ``step_t`` (an int64 tensor on the model's
    device, from which beta and the epoch come), the parameters, the
    BatchNorm statistics and spectral ``u``, the optimizer state (see
    ``train/optim.py``) and the gradients, in buffers the body keeps: it
    zeroes them and binds them as the parameters' ``.grad`` for the
    backward pass, and unbinds them after the update.  The posterior noise
    comes from ``generator``, one persistent generator, or from injected
    ``eps``; whoever runs the body seeds the generator (``seeds`` reseeds
    it before each microbatch, which only an eager caller can do: a graph
    replays with the seed set before the replay).  ``train`` is the
    forward's mode.

    With a ``mesh`` (``parallel.mesh.DataMesh``) the body is one rank's
    share of a data-parallel step that equals the single-device step on the
    global batch, as JAX's GSPMD step does:

    - the batch is this rank's rows, microbatch-major under ``grad_accum``
      (``parallel.mesh.shard_batch``);
    - the posterior noise is the global batch's draw, of which the rank
      keeps its rows (so the noise does not depend on the rank count);
    - BatchNorm takes its statistics and the KL balancing its coefficients
      over the global batch;
    - the gradients (one buffer) are summed over the ranks and divided by
      their count before the norm, the clipping and the optimizer, so every
      rank applies the same update; the batch metrics are averaged too.

    Under the FSDP layout (``parallel.mesh.shard_state_fsdp``) a sharded
    parameter is this rank's block of it.  Each microbatch's forward,
    penalties and backward pass run inside ``parallel.mesh.gathered_params``:
    one all-gather makes every sharded parameter whole for the pass, and
    its backward reduce-scatters the whole gradients into the shards'
    gradient buffer as their mean over the ranks, once per microbatch (the
    rows of a microbatch are ``shard_batch``'s, as in the DP layout).  The
    replicated parameters keep the one flat buffer and its all-reduce;
    ``grad_norm`` sums the shards' squares over the ranks and counts the
    replicated gradients once (``optim.global_norm``), so it is the single
    device's norm, and the optimizer runs on the blocks (``optim.py``: the
    spectral strategies take sigma from the whole kernel).

    Under the TP layout (``parallel.mesh.shard_state_tp``: a mesh whose
    ``model`` is the model axis) the data axis is ``mesh`` as above: the
    rows, the noise, the BatchNorm statistics, the KL coefficients and the
    gradient's mean are the data index's, the same for every model rank of
    it.  A split kernel is this rank's block, and the modules that read it
    call the model axis's collectives in the pass.  The gradients stay in
    the one flat buffer; those of the whole parameters that the modules
    read in slices (``tp_partial``), this rank's share, lead it and are
    summed over the model axis first.  ``grad_norm`` sums the blocks'
    squares over the model axis and counts the whole gradients once; the
    penalties count each term once (``losses.bn_gamma_penalty``,
    ``optim.spectral_penalty``).
    """

    # The metrics that depend on the batch; the others are the same on
    # every rank.
    BATCH_METRICS = ("loss", "reconstruction_loss", "kl_loss", "kl_raw")

    def __init__(self, model: NVAE, tx: GradientTransformation,
                 train_cfg: TrainConfig, total_steps: int,
                 steps_per_epoch: int, *, train: bool, grad_accum: int = 1,
                 mesh=None):
        self.model = model
        self.tx = tx
        self.train_cfg = train_cfg
        self.model_cfg: ModelConfig = model.cfg
        self.total_steps = total_steps
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.total_epochs = max(total_steps // self.steps_per_epoch, 1)
        self.train = train
        self.grad_accum = max(int(grad_accum), 1)
        self.mesh = mesh
        self.params = dict(model.named_parameters())
        self.device = model.decoder.h.device
        self.dtype = model.decoder.h.dtype
        self.step_t = torch.zeros((), dtype=torch.int64, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self._grads: Optional[Dict[str, torch.Tensor]] = None
        # The replicated parameters' gradients (all-reduced) and the
        # shards' (reduce-scattered in the backward pass).
        self._flat: Optional[torch.Tensor] = None
        self._flat_shards: Optional[torch.Tensor] = None
        self.sharded = tuple(k for k, p in self.params.items()
                             if shard_axis(p) == "data")
        self.tp = getattr(mesh, "model", None)
        self.tp_sharded = tuple(
            k for k, p in self.params.items()
            if shard_axis(p) == "model")
        self.partial = tuple(k for k, p in self.params.items()
                             if getattr(p, "tp_partial", None) is not None)
        self._n_partial = sum(self.params[k].numel() for k in self.partial)
        self.alphas = losses.kl_alphas(self.model_cfg.n_latent_scales,
                                       self.model_cfg.n_groups_per_scale,
                                       device=self.device)

    def _flat_views(self, keys) -> torch.Tensor:
        """One zero buffer holding the gradients of the parameters
        ``keys``, each a view of it in its parameter's layout."""
        ps = [self.params[k] for k in keys]
        flat = torch.zeros(sum(p.numel() for p in ps), dtype=self.dtype,
                           device=self.device)
        offset = 0
        for k, p in zip(keys, ps):
            self._grads[k] = flat.as_strided(p.shape, p.stride(), offset)
            offset += p.numel()
        return flat

    def _bind_grads(self) -> Dict[str, torch.Tensor]:
        """The body's own gradient buffers, views of one flat buffer for the
        replicated parameters (one all-reduce sums them; under TP the
        ``tp_partial`` ones lead it) and one for the FSDP shards, zeroed and
        bound as each parameter's ``.grad``, so that the backward pass adds
        into them."""
        if self._grads is None:
            self._grads = {}
            self._flat = self._flat_views(list(self.partial) + [
                k for k in self.params
                if k not in self.sharded and k not in self.partial])
            self._flat_shards = self._flat_views(self.sharded)
            self._grads = {k: self._grads[k] for k in self.params}
        for k, p in self.params.items():
            p.grad = self._grads[k]
        self._flat.zero_()
        self._flat_shards.zero_()
        return self._grads

    def __call__(self, opt_state, batch: torch.Tensor, *,
                 eps: Optional[Sequence[Sequence]] = None,
                 seeds: Optional[Sequence[int]] = None):
        """One step on ``batch`` (on the model's device, in its dtype) from
        ``opt_state``; returns ``(opt_state, metrics)``, the metrics
        tensors on the device, and adds one to ``step_t``."""
        model_cfg = self.model_cfg
        epoch_t = torch.div(self.step_t, self.steps_per_epoch,
                            rounding_mode="floor")
        beta = losses.beta_schedule(
            self.step_t, epoch_t, train_cfg=self.train_cfg,
            total_steps=self.total_steps, total_epochs=self.total_epochs,
        )
        sn_u = None
        if model_cfg.spectral_mode == "penalty":
            sn_state = find_spectral_state(opt_state)
            sn_u = sn_state.u if sn_state is not None else None
        model = self.model
        model.train(self.train)
        grads = self._bind_grads()
        totals: dict = {}
        mesh = self.mesh
        with fp32_math(), batch_stats_over(model, mesh):
            for i, mb in enumerate(batch.chunk(self.grad_accum)):
                if seeds is not None:
                    self.generator.manual_seed(seeds[i])
                eps_i = None if eps is None else eps[i]
                if mesh is not None:
                    eps_i = global_noise_rows(model_cfg, mb.shape[0], mesh,
                                              eps_i, self.generator,
                                              self.device, self.dtype)
                with gathered_params(model) as whole:
                    with record_function("train_step.forward"):
                        out = model(mb, generator=self.generator, eps=eps_i)
                        loss, metrics = losses.elbo_loss(
                            out, mb, beta, model_cfg, alphas=self.alphas,
                            mesh=mesh)
                        bn_loss = losses.bn_gamma_penalty(model,
                                                          model_cfg.sr_lambda)
                        loss = loss + bn_loss
                        metrics["bn_loss"] = bn_loss
                        if sn_u is not None:
                            sr = spectral_penalty({**self.params, **whole},
                                                  sn_u, model_cfg.sr_lambda)
                            loss = loss + sr
                            metrics["spectral_loss"] = sr
                    with record_function("train_step.backward"):
                        loss.backward()
                metrics["loss"] = loss
                for k, v in metrics.items():
                    v = v.detach()
                    totals[k] = v if k not in totals else totals[k] + v
            with record_function("train_step.update"):
                if self.partial:
                    self.tp.all_reduce_(self._flat[:self._n_partial])
                if mesh is not None:
                    if self._flat.numel():
                        mesh.all_reduce_(self._flat).div_(mesh.size)
                    keys = [k for k in self.BATCH_METRICS if k in totals]
                    means = mesh.mean(torch.stack([totals[k] for k in keys]))
                    totals.update(zip(keys, means.unbind()))
                if self.grad_accum > 1:
                    grads = {k: g / self.grad_accum for k, g in grads.items()}
                    totals = {k: v / self.grad_accum
                              for k, v in totals.items()}
                totals["grad_norm"] = global_norm(grads, mesh, self.sharded,
                                                  self.tp_sharded)
                updates, opt_state = self.tx.update(grads, opt_state,
                                                    self.params)
                apply_updates(self.params, updates)
        self.step_t.add_(1)
        for p in self.params.values():
            p.grad = None  # the buffers stay the body's
        return opt_state, totals


def metric_means(sums: Dict[str, torch.Tensor], n: int) -> Dict[str, float]:
    """Each sum over ``n``, fetched to the host in one transfer."""
    if not sums or not n:
        return {}
    keys = list(sums)
    values = torch.stack([sums[k].to(torch.float32) for k in keys]).tolist()
    return {k: v / n for k, v in zip(keys, values)}


def make_train_step(
    model: NVAE,
    tx: GradientTransformation,
    train_cfg: TrainConfig,
    total_steps: int,
    steps_per_epoch: int,
    mesh=None,
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
    The work is :class:`StepBody`'s, run eagerly.

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
      state holds the same model and optimizer state (updated in place) and
      the new counters.

    Profiler ranges ``train_step.forward`` (posterior pass and loss),
    ``train_step.backward`` and ``train_step.update`` (gradient norm and
    optimizer) split a step's host time in a ``torch.profiler`` trace.

    Metrics (tensors on the device): ``loss``, ``reconstruction_loss``,
    ``kl_loss``, ``kl_raw``, ``beta``, ``bn_loss``, ``spectral_loss``
    (penalty mode only) and ``grad_norm`` (global L2 norm of the gradients,
    before the update).

    With a ``mesh`` (``parallel.mesh.DataMesh``) every rank calls the step
    on its rows of the global batch (``parallel.mesh.shard_batch``) with
    the same state; ``eps`` is then the global batch's noise.  The step
    equals the single-device step on the global batch (see
    :class:`StepBody`), and its metrics are the global batch's.
    """
    body = StepBody(model, tx, train_cfg, total_steps, steps_per_epoch,
                    train=not train_cfg.parity_frozen_norm,
                    grad_accum=train_cfg.grad_accum, mesh=mesh)

    def step(state: TrainState, batch, *,
             eps: Optional[Sequence[Sequence]] = None
             ) -> Tuple[TrainState, dict]:
        epoch = state.step // body.steps_per_epoch
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.array(batch, dtype=np.float32))
        batch = batch.to(device=body.device, dtype=body.dtype)
        if batch.shape[0] % body.grad_accum:
            raise ValueError(f"batch size {batch.shape[0]} not divisible by "
                             f"grad_accum {body.grad_accum}")
        if eps is not None and len(eps) != body.grad_accum:
            raise ValueError(f"eps needs one list per microbatch "
                             f"({body.grad_accum}), got {len(eps)}")
        seeds = None
        if eps is None:
            seeds = [step_seed(state.seed, state.step, i)
                     for i in range(body.grad_accum)]
        body.step_t.fill_(state.step)
        opt_state, totals = body(state.opt_state, batch, eps=eps, seeds=seeds)
        return dataclasses.replace(state, step=state.step + 1, epoch=epoch,
                                   opt_state=opt_state), totals

    return step


def make_eval_step(model: NVAE, train_cfg: TrainConfig,
                   bn_batch_stats: bool = True, mesh=None):
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
    posterior pass's order).  With a ``mesh``, as in the train step: the
    batch is this rank's rows, the noise and the BatchNorm statistics are
    the global batch's, and so are the returned means; under the FSDP
    layout the pass reads the parameters gathered whole, and under the TP
    layout each rank computes on its part of the split kernels, as in the
    train step.
    """
    model_cfg: ModelConfig = model.cfg

    def eval_fn(state: TrainState, batch, *,
                generator: Optional[torch.Generator] = None,
                eps: Optional[Sequence] = None) -> dict:
        m = state.model
        with (torch.no_grad(), fp32_math(),
              discard_buffer_updates(m, train=bn_batch_stats),
              batch_stats_over(m, mesh), gathered_params(m)):
            h = m.decoder.h
            if not isinstance(batch, torch.Tensor):
                batch = torch.from_numpy(np.array(batch, dtype=np.float32))
            batch = batch.to(device=h.device, dtype=h.dtype)
            if mesh is not None:
                eps = global_noise_rows(model_cfg, batch.shape[0], mesh, eps,
                                        generator, h.device, h.dtype)
            out = m(batch, generator=generator, eps=eps)
            rl = losses.recon_loss(out.logits, batch, model_cfg.likelihood,
                                   model_cfg.n_mix)
            kl = losses.kl_per_group(out.latents).sum(dim=0)
            means = torch.stack([rl.mean(), kl.mean(), (rl + kl).mean()])
            if mesh is not None:
                means = mesh.mean(means)
            return dict(zip(("reconstruction_loss", "kl_loss", "elbo"),
                            means.unbind()))

    return eval_fn
