"""Device-resident epoch runner (counterpart of
``nvae_tpu/train/epoch_runner.py``, the JAX CLI's ``--scan_epochs``).

The JAX package stages the uint8 training set on the device once and runs
each epoch as one XLA program: a shuffle on the device, one gather of the
epoch's rows, then a ``lax.scan`` whose body pads, scales and binarizes a
batch and runs the training step.  The port does the same on the card with
a CUDA graph in place of the scan:

- :func:`stage_dataset` puts the uint8 rows on the device once;
- per epoch, a permutation from a generator seeded with
  :func:`shuffle_seed` is drawn on the device and the epoch's
  ``steps_per_epoch * batch_size`` rows are gathered once into a buffer the
  graph reads;
- each step is one replay of a graph of :class:`~nvae_torch.train.step.
  StepBody` behind the batch's gather from that buffer and
  ``prepare_batch`` (binarization noise from a generator seeded with
  :func:`data_seed`), with the step's metrics summed into device
  accumulators, which the epoch fetches once.

Before each replay the host reseeds the two generators the graph draws
from (the posterior noise with ``step_seed(seed, step, 0)``, as the
per-step path seeds it), which a registered generator reads at replay, so
a replay draws the noise the same step draws eagerly.  Everything else a
step reads or writes lives in place (``StepBody``, ``train/optim.py``).

The first ``WARMUP_STEPS`` steps of a run are real steps run eagerly on a
side stream (they build the kernels and cuDNN's plans); the next step is
captured, and it and every later step replay the graph.  A failed capture
or replay raises: nothing falls back to the eager step.  On the CPU the
same body runs eagerly, with no graph.

As JAX's scan runner (``epoch_runner.py:88``) does, the forward always runs
in training mode, whatever ``parity_frozen_norm`` says.

Over a data mesh (``parallel.mesh.DataMesh``) every rank stages the whole
uint8 dataset, draws the same permutation and binarization noise, prepares
the global batch and keeps its rows (``parallel.mesh.shard_batch``): the
port's form of JAX's row-sharded ``stage_dataset``, since copying the
dataset to each card (MNIST's is 47 MB) costs less than a gather across
ranks each step.  The step's collectives (``train/step.py``) are nodes of
the captured graph: NCCL's can be captured, gloo's cannot, so a graphed
runner over a gloo group raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from nvae_torch.config import TrainConfig
from nvae_torch.data.pipeline import prepare_batch
from nvae_torch.device import DeviceLike, resolve_device
from nvae_torch.kernels import depthwise
from nvae_torch.models.nvae import NVAE
from nvae_torch.parallel.mesh import shard_batch
from nvae_torch.train.optim import GradientTransformation, state_tensors
from nvae_torch.train.state import TrainState
from nvae_torch.train.step import StepBody, metric_means, step_seed
from nvae_torch.utils.seeds import derive_seed

# Eager steps on a side stream before the capture: the first builds the
# kernels' library and cuDNN's plans and makes every persistent buffer.
WARMUP_STEPS = 1


def refuse_grad_accum(train_cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for ``grad_accum > 1`` (JAX's trainer does)."""
    if train_cfg.grad_accum > 1:
        raise ValueError(
            "grad_accum > 1 is the per-step path; scan_epochs keeps the "
            "reference's one-forward-per-step shape. Pick one.")


def shuffle_seed(seed: int, epoch: int) -> int:
    """Seed of epoch ``epoch``'s permutation (JAX folds ``0x5EED`` and the
    epoch into the run's key)."""
    return derive_seed(seed, 0x5EED, epoch)


def data_seed(seed: int, step: int) -> int:
    """Seed of step ``step``'s binarization noise (JAX folds ``0xDA7A`` and
    the step into the run's key)."""
    return derive_seed(seed, 0xDA7A, step)


def stage_dataset(images: np.ndarray, device: DeviceLike = "cuda"
                  ) -> torch.Tensor:
    """The uint8 (N, H, W, C) dataset on ``device`` (the card unless
    ``"cpu"`` is asked for), copied once."""
    return torch.from_numpy(np.ascontiguousarray(images)).to(
        resolve_device(device))


class EpochRunner:
    """``run_epoch(state, data_u8, epoch_idx) -> (state, means)``; see the
    module's docstring and :func:`make_epoch_runner`."""

    def __init__(self, model: NVAE, tx: GradientTransformation,
                 train_cfg: TrainConfig, total_steps: int,
                 steps_per_epoch: int, target_size: int = 32, *,
                 graph: Optional[bool] = None, mesh=None):
        refuse_grad_accum(train_cfg)
        if getattr(mesh, "model", None) is not None:
            # No JAX entry point runs the epoch runner on a TP state, and a
            # CUDA graph cannot capture the gloo collectives a TP world of
            # ranks on one card runs.
            raise NotImplementedError("the epoch runner takes no model "
                                      "axis: step a TP state through "
                                      "make_train_step")
        self.body = StepBody(model, tx, train_cfg, total_steps,
                             steps_per_epoch, train=True, mesh=mesh)
        self.mesh = mesh
        self.train_cfg = train_cfg
        self.steps_per_epoch = steps_per_epoch
        self.batch_size = train_cfg.batch_size
        self.target_size = target_size
        device = self.body.device
        self.graphed = device.type == "cuda" if graph is None else bool(graph)
        if self.graphed and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs the model on the card, "
                             f"not {device}")
        if self.graphed and mesh is not None and mesh.backend != "nccl":
            raise ValueError(f"a CUDA graph captures NCCL's collectives, "
                             f"not {mesh.backend}'s: run the group on NCCL, "
                             f"or make the runner with graph=False")
        self.data_generator = torch.Generator(device=device)
        self._perm_generator = torch.Generator(device=device)
        self._rows: Optional[torch.Tensor] = None  # the epoch's batches
        self._slot = torch.zeros(1, dtype=torch.int64, device=device)
        self._sums: Optional[Dict[str, torch.Tensor]] = None
        self._stream = None
        self.graph = None
        self._held: list = []  # every tensor the graph reads or writes
        self.eager_steps = 0
        # What one replay launches of each counted kernel (the capture's
        # count), and the replays so far; each replay adds the former to
        # the kernels' ``replayed`` counts (kernels/depthwise.py).
        self.launches_per_replay: Dict[str, int] = {}
        self.replays = 0

    def _step(self, opt_state, uniform=None, eps=None):
        """One step on the next batch of the epoch's buffer: what a graph
        replay runs."""
        rows = self._rows.view(self.steps_per_epoch, self.batch_size,
                               *self._rows.shape[1:])
        batch_u8 = rows.index_select(
            0, torch.remainder(self._slot, self.steps_per_epoch))[0]
        self._slot.add_(1)
        tc = self.train_cfg
        batch = prepare_batch(batch_u8, self.data_generator, self.target_size,
                              binarize=tc.binary,
                              parity_binarize_255=tc.parity_binarize_255,
                              uniform=uniform).to(self.body.dtype)
        if self.mesh is not None:
            batch = shard_batch(batch, self.mesh)
        opt_state, metrics = self.body(opt_state, batch,
                                       eps=None if eps is None else [eps])
        if self._sums is None:
            self._sums = {k: torch.zeros_like(v) for k, v in metrics.items()}
        keys = list(self._sums)
        torch._foreach_add_([self._sums[k] for k in keys],
                            [metrics[k] for k in keys])
        return opt_state

    def _side_stream(self) -> torch.cuda.Stream:
        device = self.body.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(torch.cuda.current_stream(device))
        return self._stream

    def _eager_on_side_stream(self, opt_state):
        stream = self._side_stream()
        with torch.cuda.stream(stream):
            opt_state = self._step(opt_state)
        torch.cuda.current_stream(self.body.device).wait_stream(stream)
        self.eager_steps += 1
        return opt_state

    def _state(self, opt_state) -> list:
        model = self.body.model
        return [*state_tensors(opt_state), *model.parameters(),
                *model.buffers()]

    def _capture(self, opt_state) -> None:
        # The graph replays raw addresses: the runner holds the tensors
        # behind them, and each call checks that they are still the state.
        self._held = self._state(opt_state)
        graph = torch.cuda.CUDAGraph()
        for gen in (self.body.generator, self.data_generator):
            graph.register_generator_state(gen)
        before = depthwise.launch_counts()
        with torch.cuda.graph(graph, stream=self._side_stream()):
            self._step(opt_state)
        after = depthwise.launch_counts()
        self.launches_per_replay = {k: after[k] - before[k] for k in after}
        self.graph = graph

    def __call__(self, state: TrainState, data_u8: torch.Tensor, epoch_idx,
                 *, perm=None, uniforms: Optional[Sequence] = None,
                 eps: Optional[Sequence[Sequence]] = None
                 ) -> Tuple[TrainState, Dict[str, float]]:
        steps, b = self.steps_per_epoch, self.batch_size
        device = self.body.device
        need = steps * b
        if data_u8.device != device:
            raise ValueError(f"the dataset is on {data_u8.device}, the "
                             f"model on {device}: stage it there")
        if data_u8.shape[0] < need:
            raise ValueError(f"{data_u8.shape[0]} rows staged; an epoch of "
                             f"{steps} batches of {b} needs {need}")
        if self.graphed and (uniforms is not None or eps is not None):
            raise ValueError("injected noise runs eagerly: make the runner "
                             "with graph=False")
        if self.graph is not None and [
                t.data_ptr() for t in self._state(state.opt_state)] != [
                t.data_ptr() for t in self._held]:
            raise RuntimeError(
                "the state's tensors were rebound since the step was "
                "captured (the graph would write into the old ones): restore "
                "into the live tensors, or make a new runner")
        if perm is None:
            self._perm_generator.manual_seed(
                shuffle_seed(state.seed, int(epoch_idx)))
            perm = torch.randperm(data_u8.shape[0],
                                  generator=self._perm_generator,
                                  device=device)
        idx = torch.as_tensor(perm, device=device)[:need]
        if self._rows is None:
            self._rows = torch.empty((need, *data_u8.shape[1:]),
                                     dtype=data_u8.dtype, device=device)
        torch.index_select(data_u8, 0, idx, out=self._rows)
        self.body.step_t.fill_(state.step)
        self._slot.zero_()
        if self._sums is not None:
            torch._foreach_zero_(list(self._sums.values()))
        opt_state = state.opt_state
        for i in range(steps):
            step = state.step + i
            if eps is None:
                self.body.generator.manual_seed(step_seed(state.seed, step, 0))
            if uniforms is None:
                self.data_generator.manual_seed(data_seed(state.seed, step))
            if not self.graphed:
                opt_state = self._step(
                    opt_state, None if uniforms is None else uniforms[i],
                    None if eps is None else eps[i])
            elif self.graph is None and self.eager_steps < WARMUP_STEPS:
                opt_state = self._eager_on_side_stream(opt_state)
            else:
                if self.graph is None:
                    self._capture(opt_state)
                self.graph.replay()
                self.replays += 1
                depthwise.count_replays(self.launches_per_replay)
        means = metric_means(self._sums, steps)  # the epoch's one fetch
        last = state.step + steps - 1
        return dataclasses.replace(
            state, step=state.step + steps,
            epoch=last // self.body.steps_per_epoch,
            opt_state=opt_state), means


def make_epoch_runner(model: NVAE, tx: GradientTransformation,
                      train_cfg: TrainConfig, total_steps: int,
                      steps_per_epoch: int, target_size: int = 32, *,
                      graph: Optional[bool] = None,
                      mesh=None) -> EpochRunner:
    """Returns ``run_epoch(state, data_u8, epoch_idx, *, perm=None,
    uniforms=None, eps=None) -> (state, means)``.

    ``data_u8`` is the whole uint8 (N, H, W, C) training set on the model's
    device (:func:`stage_dataset`); an epoch trains on the first
    ``steps_per_epoch * batch_size`` rows of its permutation, padded or
    cropped to ``target_size`` and binarized as ``train_cfg`` says.
    ``means`` are the per-epoch means of the step's metrics, fetched once.
    The returned state holds the same model and optimizer state (updated in
    place) and the new counters.  ``graph`` (default: on the card) replays
    each step as a CUDA graph; ``graph=False`` runs the same body eagerly.
    Tests inject the permutation ``perm`` (N,), the binarization uniforms
    (one (B, S, S, C) tensor per step) and the posterior noise ``eps`` (one
    list of NHWC draws per step, in the posterior pass's order); injected
    noise runs eagerly.  Raises ``ValueError`` for ``grad_accum > 1``, as
    JAX's trainer does.  With a ``mesh`` each rank runs its rows of every
    global batch (see the module's docstring); the injected noise is the
    global batch's.
    """
    return EpochRunner(model, tx, train_cfg, total_steps, steps_per_epoch,
                       target_size, graph=graph, mesh=mesh)
