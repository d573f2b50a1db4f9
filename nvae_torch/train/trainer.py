"""The training run loop (counterpart of ``nvae_tpu/train/trainer.py``).

Epoch loop over the port's train step with:

- per-epoch means of the step's metrics, seconds and images per second
  (and peak device memory on the card: the epoch's, or with
  ``scan_epochs`` the run's so far), logged as ``train/``;
- held-out evaluation over the whole test set every ``evaluate_frequency``
  epochs (``test/``: the ELBO's pieces and ms per eval batch);
- sample and reconstruction image dumps every ``sample_frequency`` epochs,
  the whole temperature sweep in one sampling call;
- periodic and final full-state checkpoints written in the background, and
  resume from the latest one (their timings are logged as
  ``checkpoint/`` once the run ends);
- early stopping that restores the best state from a copy on the device;
- SIGTERM/SIGINT: finish the step, save, return with ``interrupted=True``;
- an optional ``torch.profiler`` trace of one epoch.

The step's metrics stay on the device through an epoch and are fetched once
at its end, as the JAX loop fetches them once: a fetch per step would stall
the host between steps.  With ``scan_epochs`` the training set is staged on
the device once and each epoch runs through the epoch runner
(``train/epoch_runner.py``: one CUDA graph replay per step on the card);
the hooks, checkpoints and early stopping run between epochs as on the
per-step path.

With a data ``mesh`` (``parallel.mesh.DataMesh``, one per rank of a
``torchrun`` launch) every rank builds the same state, which
``parallel.mesh.shard_state`` replicates from rank 0, and steps on its rows
of each global batch; the state stays the same on every rank, bit for bit.
Every rank evaluates (the held-out means are the global batch's) and
restores; rank 0 alone logs, dumps images, writes checkpoints and traces.
An interrupt is honoured at the end of the epoch on every rank together.

``param_sharding="fsdp"`` with a mesh holds the state in the FSDP layout
(``parallel.mesh.shard_state_fsdp``: each large parameter, its Adamax
moments and its EMA as this rank's 1/N block).  What reads the parameters
whole gathers them on every rank, then rank 0 alone writes: the held-out
eval and the image hooks open ``parallel.mesh.gathered_params`` on every
rank, and a checkpoint's snapshot gathers on every rank
(``train/checkpoint.py``); the EMA swap copies block into block.  Without a
mesh ``"fsdp"`` is the replicated layout, as in JAX.

``pipeline_stages`` S > 1 trains through ``parallel.pipeline.PipelineTrainer``
(GPipe or 1F1B over ``pipeline_microbatches`` microbatches), as JAX's trainer
does, with ``data_parallel`` N ranks a stage (default: the world's ranks, or
in one process the cards, over the stages).  In one process (N = 1) the
stages live on the first S cards (on the CPU, S times the CPU); in a world
of S x N ranks (``torchrun --nproc_per_node S*N``) each rank runs its own
stage on its rows, and every rank steps the same iterator over the global
batches in lockstep.  Once an epoch the stages are merged into ``state``
on every rank (whose model is then the trainer's ``model``) before the
image hooks, the held-out evaluation, the checkpoint and early stopping,
which read the whole model: rank 0 alone evaluates, dumps images and writes
checkpoints, and the ranks meet only where every rank calls (the merge, the
checkpoint writer's barrier, the interrupt).  A checkpoint is the whole
model's, and resuming splits it back into the stages with the optimizer
state.  The pipeline excludes a data mesh and ``scan_epochs``.

The trainer runs no tensor-parallel layout: ``model_parallel > 1`` and a
mesh with a model axis raise, where JAX's trainer ignores the first and
refuses the second (its ``shard_state``).  TP runs through the API:
``parallel.make_mesh(n_model=...)``, ``parallel.shard_state_tp``,
``train.step.make_train_step``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nvae_torch.config import ModelConfig, TrainConfig
from nvae_torch.data.pipeline import BatchIterator
from nvae_torch.device import DeviceLike, fp32_math
from nvae_torch.parallel import (
    is_primary,
    process_count,
    shard_state,
    shard_state_fsdp,
)
from nvae_torch.parallel.mesh import gathered_params
from nvae_torch.parallel.pipeline import PipelineTrainer, pipeline_dp
from nvae_torch.train import checkpoint as ckpt
from nvae_torch.train.epoch_runner import (
    make_epoch_runner,
    refuse_grad_accum,
    stage_dataset,
)
from nvae_torch.train.optim import find_ema_params
from nvae_torch.train.state import TrainState, create_train_state
from nvae_torch.train.step import (
    make_eval_step,
    make_train_step,
    metric_means,
)
from nvae_torch.utils.logging import MetricsLogger
from nvae_torch.utils.seeds import derive_seed

SAMPLE_TEMPERATURES = (0.7, 0.8, 0.9, 1.0)  # reference evaluate.py:16


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    history: list
    best_loss: float
    # True when training stopped early on SIGTERM/SIGINT; the final
    # checkpoint holds the full state at that step and a fresh Trainer
    # resumes from it.
    interrupted: bool = False


TP_ROUTE = ("the trainer runs no tensor-parallel layout, as JAX's runs "
            "none: train over a model axis through the API, "
            "make_mesh(n_model=...) -> shard_state_tp -> make_train_step")


def _check_supported(tc: TrainConfig, param_sharding: str, mesh) -> None:
    if tc.model_parallel > 1 or getattr(mesh, "model", None) is not None:
        raise NotImplementedError(f"model_parallel > 1: {TP_ROUTE}")
    if tc.pipeline_stages > 1 and mesh is not None:
        raise ValueError(
            "pipeline_stages>1 does its own placement; pass mesh=None")
    if tc.pipeline_stages > 1 and tc.scan_epochs:
        raise ValueError("pipeline_stages>1 excludes scan_epochs")
    if param_sharding not in ("replicated", "fsdp"):
        raise ValueError(f"param_sharding must be 'replicated' or 'fsdp', "
                         f"got {param_sharding!r}")


def _accumulate(sums: Dict[str, torch.Tensor], metrics: dict) -> None:
    for k, v in metrics.items():
        v = v.detach()
        sums[k] = v if k not in sums else sums[k] + v


class Trainer:
    """Builds the model, optimizer and train step on ``device`` (the card
    unless ``"cpu"`` is asked for; raises if there is no card; with a
    ``mesh``, the mesh's device) and runs the epoch loop.  ``logger`` is
    rank 0's alone: pass None on the other ranks."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        steps_per_epoch: int,
        logger: Optional[MetricsLogger] = None,
        device: DeviceLike = "cuda",
        mesh=None,
        param_sharding: str = "replicated",
    ):
        _check_supported(train_cfg, param_sharding, mesh)
        if train_cfg.scan_epochs:
            refuse_grad_accum(train_cfg)
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.steps_per_epoch = steps_per_epoch
        self.total_steps = steps_per_epoch * train_cfg.epochs
        self.logger = logger
        self.mesh = mesh
        self.primary = is_primary()
        self.model, self.state, self.tx = create_train_state(
            model_cfg, train_cfg, self.total_steps,
            device=device if mesh is None else mesh.device
        )
        self.fsdp = param_sharding == "fsdp" and mesh is not None
        if self.fsdp:
            self.state = shard_state_fsdp(self.state, mesh)
        elif mesh is not None:
            self.state = shard_state(self.state, mesh)
        self.device = self.model.decoder.h.device
        self.pipeline = None
        # The ranks that step together: the data mesh, or the world of a
        # pipeline's ranks.
        self.sync = mesh
        if train_cfg.pipeline_stages > 1:
            self.pipeline = self._build_pipeline()
            self.sync = self.pipeline.world
            # The stages own the training state; the merged one holds the
            # model that the hooks, evaluation and checkpoints read.
            self.state = self.pipeline.merged_state()
            self.model = self.state.model
        self.step_fn = make_train_step(
            self.model, self.tx, train_cfg, self.total_steps, steps_per_epoch,
            mesh=mesh,
        ) if self.pipeline is None else None
        self._eval_fn = None
        self._epoch_runner = None  # built lazily for the scan-epochs path
        self._staged_data = None
        self._interrupted = False

    def _build_pipeline(self) -> PipelineTrainer:
        """The pipeline from this trainer's state, with ``data_parallel``
        ranks a stage (``parallel.pipeline.pipeline_dp``: by default the
        world's ranks, or in one process the cards, over the stages).  In
        one process its stages live on the first ``pipeline_stages`` cards,
        or on the CPU; in a world of ``S x dp`` ranks this rank holds its
        stage on its device.  Another layout raises with the launcher's
        command."""
        tc = self.train_cfg
        n = tc.pipeline_stages
        cpu = self.device.type == "cpu"
        world = process_count()
        dp = pipeline_dp(n, tc.data_parallel, world,
                         1 if cpu else torch.cuda.device_count())
        devices = None
        if cpu:
            devices = [self.device] * (world if world > 1 else n)
        elif world > 1:
            devices = [self.device] * world
        return PipelineTrainer(
            self.model, tc, self.total_steps, self.steps_per_epoch,
            n_stages=n, n_microbatches=tc.pipeline_microbatches,
            devices=devices, dp=dp, state=self.state)

    # ---- EMA --------------------------------------------------------------

    def ema_params(self):
        """The EMA parameters from the optimizer state (the pipeline's
        stages' under ``pipeline_stages``), or None when training ran
        without ``ema_decay``."""
        if self.pipeline is not None:
            return self.pipeline.ema_params()
        return find_ema_params(self.state.opt_state)

    def swap_in_ema(self) -> None:
        """Copy the EMA average into the model's parameters (``--use_ema``).
        Raises if the state carries no EMA."""
        ema = self.ema_params()
        if ema is None:
            raise ValueError(
                "no EMA in the optimizer state: train with --ema_decay"
            )
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(ema[name])

    # ---- sampling helpers -------------------------------------------------

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def sample_images(self, n: int, temperature, seed: Optional[int] = None,
                      scale_temperatures=None):
        """``(images, last_s, z1, z2)`` from the prior on the current
        weights, in eval mode, fp32.  ``temperature`` is a float or a
        per-sample ``(n,)`` vector; ``scale_temperatures`` (one per decoder
        scale) selects the annealed path.  The noise comes from a generator
        seeded with ``seed``, by default ``derive_seed(run seed, "sample",
        step)``.  In the FSDP layout every rank must call it (it gathers
        the parameters)."""
        if seed is None:
            seed = derive_seed(self.state.seed, "sample", self.state.step)
        was = self.model.training
        self.model.eval()
        try:
            with torch.no_grad(), fp32_math(), gathered_params(self.model):
                return self.model.sample(n, temperature, True,
                                         scale_temperatures,
                                         generator=self._generator(seed))
        finally:
            self.model.train(was)

    def sample_images_sweep(self, n_per_t: int, temperatures,
                            seed: Optional[int] = None) -> dict:
        """A whole temperature sweep in one sampling call: a per-sample
        temperature vector with ``n_per_t`` rows per entry of
        ``temperatures``.  Returns ``{temperature: images[n_per_t]}``."""
        temperatures = [float(t) for t in temperatures]
        temps = np.repeat(np.asarray(temperatures, np.float32), n_per_t)
        images, *_ = self.sample_images(len(temps), temps, seed=seed)
        return {t: images[i * n_per_t:(i + 1) * n_per_t]
                for i, t in enumerate(temperatures)}

    def reconstruct_images(self, batch) -> torch.Tensor:
        """Eval-mode reconstructions of the first 3 images of ``batch``,
        fp32, with noise seeded 0 (in the FSDP layout, on every rank)."""
        with fp32_math(), gathered_params(self.model):
            return self.model.reconstruct(batch[:3],
                                          generator=self._generator(0))

    def evaluate(self, test_iter: BatchIterator, epoch: int) -> dict:
        """The eval step over the whole test set: means of
        ``reconstruction_loss``, ``kl_loss`` and ``elbo``, and
        ``eval_ms_per_batch``.  Batch ``i`` draws its noise from
        ``derive_seed(run seed, "eval", epoch, i)``.  With a mesh every rank
        calls it on its rows of each batch."""
        if self._eval_fn is None:
            self._eval_fn = make_eval_step(self.model, self.train_cfg,
                                           mesh=self.mesh)
        t0 = time.perf_counter()
        sums: Dict[str, torch.Tensor] = {}
        n = 0
        for i, batch in enumerate(test_iter.epoch(0)):
            gen = self._generator(
                derive_seed(self.state.seed, "eval", epoch, i))
            _accumulate(sums, self._eval_fn(self.state, batch, generator=gen))
            n += 1
        out = metric_means(sums, n)
        out["eval_ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / max(n, 1)
        return out

    def _image_hooks(self, epoch: int,
                     test_iter: Optional[BatchIterator]) -> None:
        """The sample sweep and the test reconstructions, logged."""
        sweep = self.sample_images_sweep(3, SAMPLE_TEMPERATURES)
        for t, images in sweep.items():
            self.logger.images(epoch, f"samples_t{t:.1f}",
                               images.cpu().numpy())
        if test_iter is not None:
            test_batch = next(iter(test_iter.epoch(0)))
            recon = self.reconstruct_images(test_batch)
            pair = np.concatenate([test_batch[:3].cpu().numpy(),
                                   recon.cpu().numpy()], axis=2)
            self.logger.images(epoch, "test_reconstruction", pair)

    # ---- checkpointing ----------------------------------------------------

    @property
    def ckpt_dir(self) -> str:
        return os.path.abspath(self.train_cfg.model_save_dir)

    def maybe_resume(self) -> int:
        """Restore the checkpoint of epoch ``resume_from``, else the latest
        one, if present; returns the epoch to start from.  With a mesh (or
        a pipeline's ranks) every rank restores, then waits for the
        others."""
        epoch = self._resume()
        if self.sync is not None:
            self.sync.barrier()
        return epoch

    def _resume(self) -> int:
        tc = self.train_cfg
        if tc.resume_from > 0:
            step = tc.resume_from * self.steps_per_epoch
        else:
            step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return 0
        try:
            # The pipeline's merged state has the whole model's layout,
            # which every checkpoint has.
            template = (self.state if self.pipeline is None
                        else self.pipeline.merged_state())
            self.state = ckpt.restore_checkpoint(self.ckpt_dir, template,
                                                 step)
        except FileNotFoundError:
            return 0
        if self.pipeline is not None:
            self.pipeline.load_state(self.state, restore_opt=True)
        return int(step) // self.steps_per_epoch

    def _any_rank(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is True on any."""
        t = torch.tensor([float(flag)], device=self.sync.device)
        return bool(self.sync.all_reduce_(t).item() > 0)

    # ---- main loop --------------------------------------------------------

    def fit(
        self,
        train_iter: BatchIterator,
        test_iter: Optional[BatchIterator] = None,
        on_epoch_end: Optional[Callable] = None,
        profile_dir: Optional[str] = None,
    ) -> TrainResult:
        tc = self.train_cfg
        history = []
        best_loss, best_state, patience_left = float("inf"), None, tc.patience
        start_epoch = self.maybe_resume()
        writer = ckpt.AsyncCheckpointWriter(self.ckpt_dir, mesh=self.sync)
        # Preemption: on SIGTERM/SIGINT finish the step, save the full
        # state and return.  A handler can only be set from the main thread.
        self._interrupted = False
        prev_handlers = {}

        def on_signal(signum, frame):
            self._interrupted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, on_signal)
            except ValueError:  # not the main thread
                pass
        cuda = self.device.type == "cuda"
        if tc.scan_epochs and self._epoch_runner is None:
            self._epoch_runner = make_epoch_runner(
                self.model, self.tx, tc, self.total_steps,
                train_iter.batches_per_epoch,
                target_size=train_iter.target_size, mesh=self.mesh,
            )
            self._staged_data = stage_dataset(train_iter.images, self.device)
        try:
            for epoch in range(start_epoch, tc.epochs):
                t0 = time.perf_counter()
                profiler = None
                if (profile_dir and self.primary
                        and epoch == start_epoch + 1):
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA] if cuda else [])
                    profiler = profile(activities=acts)
                    profiler.start()
                if cuda and not tc.scan_epochs:
                    # A replay allocates nothing, so the scan path keeps
                    # the run's peak, which holds its graph's memory.
                    torch.cuda.reset_peak_memory_stats(self.device)
                if tc.scan_epochs:
                    # The whole epoch on the card; an interrupt is honoured
                    # at its end, as in JAX.
                    n_batches = train_iter.batches_per_epoch
                    self.state, means = self._epoch_runner(
                        self.state, self._staged_data, epoch)
                else:
                    sums: Dict[str, torch.Tensor] = {}
                    n_batches = 0
                    for batch in train_iter.epoch(epoch):
                        if self.pipeline is not None:
                            metrics = self.pipeline.step(batch)
                        else:
                            self.state, metrics = self.step_fn(self.state,
                                                               batch)
                        n_batches += 1
                        _accumulate(sums, metrics)
                        if self._interrupted and self.sync is None:
                            break
                    means = metric_means(sums, n_batches)  # one fetch
                    if self.pipeline is not None:
                        # The hooks, checkpoints and early stopping below
                        # read the merged state.
                        self.state = self.pipeline.merged_state()
                if profiler is not None:
                    profiler.stop()
                    os.makedirs(profile_dir, exist_ok=True)
                    profiler.export_chrome_trace(
                        os.path.join(profile_dir, f"epoch{epoch}.json"))
                dt = time.perf_counter() - t0
                means["epoch_seconds"] = dt
                means["images_per_sec"] = n_batches * train_iter.batch_size / dt
                if cuda:
                    means["peak_memory_gb"] = (
                        torch.cuda.max_memory_allocated(self.device) / 1e9)
                history.append(means)
                if self.logger and epoch % max(tc.log_frequency, 1) == 0:
                    self.logger.scalars(epoch, means, prefix="train/")

                # Preemption exit: skip the hooks, drop to the final save.
                if self.sync is not None:
                    self._interrupted = self._any_rank(self._interrupted)
                if self._interrupted:
                    break

                if ((self.logger or self.mesh is not None)
                        and test_iter is not None
                        and tc.evaluate_frequency
                        and epoch % tc.evaluate_frequency == 0):
                    test_means = self.evaluate(test_iter, epoch)
                    if self.logger:
                        self.logger.scalars(epoch, test_means, prefix="test/")

                if ((self.logger or self.fsdp) and tc.sample_frequency
                        and epoch % tc.sample_frequency == 0):
                    # Every rank joins the gather; rank 0 alone samples.
                    with gathered_params(self.model):
                        if self.logger:
                            self._image_hooks(epoch, test_iter)

                if (tc.model_save_frequency
                        and epoch % tc.model_save_frequency == 0):
                    writer.save(self.state.step, self.state)

                if on_epoch_end is not None:
                    on_epoch_end(epoch, self, means)

                # Early stopping on the training loss (the reference's
                # EarlyStopping), restoring the best state from a device copy.
                if tc.patience:
                    if means["loss"] < best_loss - 1e-9:
                        best_loss, patience_left = means["loss"], tc.patience
                        best_state = {
                            k: v.clone() if isinstance(v, torch.Tensor) else v
                            for k, v in ckpt.flatten_state(self.state).items()
                        }
                    else:
                        patience_left -= 1
                        if patience_left <= 0:
                            if best_state is not None:
                                self.state = ckpt.load_flat_state(self.state,
                                                                  best_state)
                            break
                else:
                    best_loss = min(best_loss, means["loss"])

            writer.save(self.state.step, self.state)
        finally:
            writer.close()
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
        if self.sync is not None:
            self.sync.barrier()  # rank 0's checkpoints are on disk
        if self.logger:
            for step, blocking_ms, total_ms in writer.timings:
                self.logger.scalars(step, {"blocking_ms": blocking_ms,
                                           "total_ms": total_ms},
                                    prefix="checkpoint/")
        return TrainResult(state=self.state, history=history,
                           best_loss=best_loss,
                           interrupted=self._interrupted)
