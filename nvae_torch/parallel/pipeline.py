"""Pipeline training over the NVAE's four stage modules, GPipe fill-drain
or 1F1B (counterpart of ``nvae_tpu/parallel/pipeline.py``).

The model's stage modules (preprocess, encoder, decoder, postprocess: the
children of :class:`~nvae_torch.models.nvae.NVAE`) are grouped into ``S``
contiguous stages (:func:`stage_names`), and each stage owns a copy of its
modules, their optimizer state and a generator on its own device.  One
optimizer step runs ``M`` microbatches through the stages:

- **forward** of a non-last stage runs without autograd, updates the
  stage's BatchNorm running statistics and forward-mode spectral ``u`` in
  place, and stashes its input with the buffers as they were before it;
- the **last stage** runs its forward, the ELBO and its penalties and its
  backward pass at once, and hands the cotangent of its input back;
- **backward** of a non-last stage recomputes the stage under autograd from
  the stashed input and buffers (and the same noise), back-propagates the
  cotangent, adds the gradient of the stage's own penalties, and throws the
  recompute's buffer updates away (GPipe's memory model: only stage inputs
  are kept between the passes);
- **update**: each stage divides its summed gradients by ``M`` and runs its
  own optimizer on its own parameters, in place.

In one process (``dp`` 1, a world of one rank) every stage lives in this
process and the boundary tensors move to the next stage's device with
``.to(device, non_blocking=True)``.  Two dispatch orders give the same
result bit for bit (each stage accumulates its gradients in microbatch
order under both): ``gpipe`` runs every forward chain, then every backward
chain, and stashes ``M`` inputs a stage; ``1f1b`` runs the backward chain of
microbatch ``i - 1`` right behind the forward chain of microbatch ``i``, and
stashes at most 2.

The contract, as in JAX: a pipeline step with ``M`` microbatches is the
``grad_accum=M`` step of ``train/step.py`` -- microbatch ``i`` draws its
posterior noise from a generator seeded with ``step_seed(seed, step, i)``
(or from injected ``eps[i]``), the BatchNorm and spectral buffers chain
through the microbatches in the same order, the gradients are the mean of
the microbatches' and every optimizer transform is local to a parameter
(Adamax, the spectral strategies, the EMA), so the stages' optimizers
together are the whole model's.

Data parallelism inside the stages (JAX's ``dp``: a one-process mesh per
stage, parameters replicated over it, batch rows sharded, BatchNorm
statistics global) runs here as one process per device: a world of
``S x N`` ranks (``torchrun --nproc_per_node S*N``), in which stage s is
held by world ranks ``[s N, (s + 1) N)`` (``parallel.mesh.make_stage_mesh``)
and each rank runs its own stage's part of the same schedule:

- each rank holds its stage's modules, optimizer and (the decoder's stage)
  generator, and its microbatch-major rows of each global microbatch
  (``parallel.mesh.shard_batch``), so that microbatch i on data rank r is
  the same global rows on every stage and rank (s, r) talks only to
  (s - 1, r) and (s + 1, r);
- the boundary tensors go point to point (:class:`_Link`): each message
  is the tensors of one dtype packed in one buffer, its layout sent once;
  sends do not block and every rank waits on them when its step ends, so
  the 1F1B order, in which stage s sends activation i + 1 while the last
  stage sends cotangent i back, cannot deadlock; gloo sends host tensors
  only, so under gloo the link goes through pinned host buffers, under
  NCCL it stays on the device;
- over the stage's N ranks (when N > 1) BatchNorm takes its statistics,
  in the forward and in the backward's recompute, the decoder draws the
  global microbatch's noise and keeps its rows
  (``train.step.global_noise_rows``), the last stage takes the KL
  balancing coefficients and the batch metrics, and each stage averages
  its gradients in one flat all-reduce before its update;
- the metrics, whose penalties and squared gradient norms come from every
  stage, are put together from one all-gather over the world, in the
  order the one-process form adds them, so every rank returns the same;
- :meth:`PipelineTrainer.merged_state` and
  :meth:`PipelineTrainer.ema_params` gather the stages (each from its
  first rank) on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.profiler import record_function

from nvae_torch.config import ModelConfig, TrainConfig
from nvae_torch.device import DeviceLike, fp32_math, resolve_device
from nvae_torch.models.nvae import (
    NVAE,
    ForwardOutput,
    LatentParams,
    discard_buffer_updates,
)
from nvae_torch.nn.spectral import sn_kernel_names
from nvae_torch.parallel.mesh import (
    DataMesh,
    batch_stats_over,
    make_stage_mesh,
    shard_batch,
    shard_state,
)
from nvae_torch.parallel.multihost import process_count
from nvae_torch.train import losses
from nvae_torch.train.optim import (
    GradientTransformation,
    apply_updates,
    find_ema_params,
    find_spectral_state,
    make_optimizer,
    spectral_penalty,
)
from nvae_torch.train.state import TrainState
from nvae_torch.train.step import StepBody, global_noise_rows, step_seed

STAGE_MODULES = ("preprocess", "encoder", "decoder", "postprocess")
_ALL_MODULES = frozenset(STAGE_MODULES)

TxFactory = Callable[[Tuple[str, ...]], GradientTransformation]


def launch_line(n_stages: int, dp: int) -> str:
    """The launcher's command for ``n_stages`` stages of ``dp`` ranks."""
    return (f"torchrun --nproc_per_node {n_stages * dp} -m nvae_torch.cli "
            f"--mode train ... --pp_stages {n_stages} --data_parallel {dp}")


def check_layout(n_stages: int, dp: int, world: int) -> None:
    """Raise ValueError unless ``n_stages`` stages of ``dp`` ranks fit a
    world of ``world`` processes: one process holds every stage at dp 1,
    and a world of more holds ``n_stages * dp`` ranks, one per device."""
    if world > 1 and world != n_stages * dp:
        raise ValueError(
            f"a pipeline of {n_stages} stages x dp={dp} needs "
            f"{n_stages * dp} ranks, one process per device: launch them "
            f"with {launch_line(n_stages, dp)} (this is a world of {world})")
    if world == 1 and dp > 1:
        raise ValueError(
            f"a pipeline of {n_stages} stages x dp={dp} runs "
            f"{n_stages * dp} processes, one per device, not one: launch "
            f"them with {launch_line(n_stages, dp)}")


def pipeline_dp(n_stages: int, data_parallel: int, world: int,
                cards: int) -> int:
    """The ranks a stage of ``n_stages`` takes (JAX's ``dp``):
    ``data_parallel`` when set, else in a world of several ranks the world
    over the stages, and in one process the cards over the stages (JAX's
    default: ``len(jax.devices()) // S``).  Raises where that layout does
    not fit the world (:func:`check_layout`)."""
    dp = data_parallel or max((world if world > 1 else cards) // n_stages, 1)
    check_layout(n_stages, dp, world)
    return dp


def stage_names(n_stages: int) -> Tuple[Tuple[str, ...], ...]:
    """Contiguous groupings of the four stage modules: 2 stages split
    (preprocess, encoder | decoder, postprocess), 3 give the postprocess
    tower a stage of its own, 4 one module each."""
    if n_stages == 1:
        return (STAGE_MODULES,)
    if n_stages == 2:
        return (("preprocess", "encoder"), ("decoder", "postprocess"))
    if n_stages == 3:
        return (("preprocess", "encoder"), ("decoder",), ("postprocess",))
    if n_stages == 4:
        return tuple((m,) for m in STAGE_MODULES)
    raise ValueError(f"pipeline supports 1-4 stages, got {n_stages}")


def module_of(name: str) -> str:
    """The stage module a parameter or buffer name belongs to."""
    return name.split(".", 1)[0]


def merge_named(parts: Sequence[Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """The stages' name-keyed dicts (``state_dict()``, the EMA) as the
    whole model's: their names are the whole model's already."""
    out: Dict[str, torch.Tensor] = {}
    for p in parts:
        out.update(p)
    return out


def _is_dataclass(node) -> bool:
    return dataclasses.is_dataclass(node) and not isinstance(node, type)


def _rebuild(node, children):
    """``node``'s container rebuilt from ``children`` (its fields or items
    in order)."""
    if _is_dataclass(node):
        return dataclasses.replace(node, **dict(zip(
            [f.name for f in dataclasses.fields(node)], children)))
    if hasattr(node, "_fields"):  # a NamedTuple
        return type(node)(*children)
    return type(node)(children)


def _children(node) -> list:
    if _is_dataclass(node):
        return [getattr(node, f.name) for f in dataclasses.fields(node)]
    return list(node)


def merge_opt_states(parts: Sequence):
    """The stages' optimizer states merged into the whole model's layout.

    Every transform of the chain keeps its state in dicts keyed by
    parameter names (Adamax moments, spectral ``u`` and sigma, the EMA) and
    in update counts that advance together on every stage.  The merge is
    structural: the name-keyed dicts are united in stage order, the
    containers (tuples, the transforms' dataclasses) merged field by field,
    and of a count the first stage's is kept.  The result has the structure
    of ``make_optimizer(...).init(full_params)``, so a pipeline's
    checkpoint restores on any topology."""
    p0 = parts[0]
    if isinstance(p0, dict):
        out: dict = {}
        for part in parts:
            for k, v in part.items():
                out[k] = merge_opt_states([out[k], v]) if k in out else v
        return out
    if _is_dataclass(p0) or isinstance(p0, (tuple, list)):
        kids = [_children(p) for p in parts]
        return _rebuild(p0, [merge_opt_states([k[i] for k in kids])
                             for i in range(len(kids[0]))])
    return p0  # a count (the same on every stage), or None


def split_opt_state(opt_state, names: Sequence[str]):
    """One stage's share of a whole model's optimizer state: the inverse of
    :func:`merge_opt_states`.  A dict whose keys are all parameter names of
    the stage modules keeps this stage's; the containers and the counts are
    shared (the counts are the same objects: copy before use)."""
    names = frozenset(names)

    def rec(node):
        if isinstance(node, dict):
            if node and all(module_of(k) in _ALL_MODULES for k in node):
                return {k: v for k, v in node.items()
                        if module_of(k) in names}
            return {k: rec(v) for k, v in node.items()}
        if _is_dataclass(node) or isinstance(node, (tuple, list)):
            return _rebuild(node, [rec(c) for c in _children(node)])
        return node

    return rec(opt_state)


def map_tensors(tree, fn):
    """``tree`` rebuilt with ``fn`` applied to each of its tensors."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if _is_dataclass(tree) or isinstance(tree, (tuple, list)):
        return _rebuild(tree, [map_tensors(c, fn) for c in _children(tree)])
    return tree


def _structure(tree):
    """Containers, keys, tensor shapes and dtypes of an optimizer state."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    if _is_dataclass(tree) or isinstance(tree, (tuple, list)):
        return (type(tree).__name__,
                tuple(_structure(c) for c in _children(tree)))
    return type(tree).__name__


def run_stage(mods: nn.ModuleDict, names: Sequence[str], val, *,
              generator: Optional[torch.Generator] = None,
              eps: Optional[Sequence] = None):
    """A contiguous slice of :meth:`NVAE.forward` over the stage modules
    ``mods``, wired as the whole pass wires them: the preprocess input is
    the NCHW image, the encoder's features are handed on reversed (top-down)
    with the trunk, the decoder samples every z from the posterior (noise
    from ``generator`` or ``eps``) and computes no NLL terms, and the
    postprocess tower ends in a :class:`ForwardOutput` with zero ``log_p``
    and ``log_q``."""
    for name in names:
        if name == "preprocess":
            val = mods.preprocess(val)
        elif name == "encoder":
            feats, trunk = mods.encoder(val)
            val = (tuple(feats[::-1]), trunk)
        elif name == "decoder":
            feats, trunk = val
            x, latents, _, _ = mods.decoder(trunk, list(feats), False,
                                            generator=generator, eps=eps)
            val = (x, tuple(latents))
        elif name == "postprocess":
            x, latents = val
            logits = mods.postprocess(x).permute(0, 2, 3, 1)
            zeros = logits.new_zeros(logits.shape[0])
            val = ForwardOutput(logits, list(latents), zeros, zeros.clone())
        else:
            raise ValueError(f"unknown stage module {name!r}")
    return val


def flatten_boundary(val) -> List[torch.Tensor]:
    """The tensors of a value handed from one stage to the next."""
    if isinstance(val, torch.Tensor):  # after preprocess
        return [val]
    first, second = val
    if isinstance(second, torch.Tensor):  # after the encoder
        return [*first, second]
    return [first] + [t for g in second  # after the decoder
                      for t in (g.enc_mu, g.enc_sigma, g.dec_mu, g.dec_sigma)]


def unflatten_boundary(after: str, ts: Sequence[torch.Tensor]):
    """The inverse of :func:`flatten_boundary` for the value that the stage
    module ``after`` hands on."""
    if after == "preprocess":
        return ts[0]
    if after == "encoder":
        return tuple(ts[:-1]), ts[-1]
    return ts[0], tuple(LatentParams(*ts[i:i + 4])
                        for i in range(1, len(ts), 4))


@dataclasses.dataclass
class _Stash:
    """A non-last stage's record of one microbatch's forward: its input,
    its buffers before the forward and its noise."""

    ins: List[torch.Tensor]
    buffers: List[torch.Tensor]
    seed: Optional[int]
    eps: Optional[Sequence]


_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)


def _channels_last(t: torch.Tensor) -> bool:
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


def _layout(ts: Sequence[Optional[torch.Tensor]]) -> Tuple[tuple, ...]:
    """Each boundary tensor's (dtype code, channels_last, shape), or None
    where there is none (a cotangent that no gradient reached)."""
    return tuple(None if t is None else
                 (_DTYPES.index(t.dtype), _channels_last(t), tuple(t.shape))
                 for t in ts)


def _encode(layout) -> List[int]:
    out = [len(layout)]
    for e in layout:
        if e is None:
            out.append(-1)
        else:
            code, cl, shape = e
            out += [code, int(cl), len(shape), *shape]
    return out


def _decode(words: List[int]) -> Tuple[tuple, ...]:
    n, i, out = words[0], 1, []
    for _ in range(n):
        if words[i] == -1:
            out.append(None)
            i += 1
            continue
        code, cl, nd = words[i:i + 3]
        out.append((code, bool(cl), tuple(words[i + 3:i + 3 + nd])))
        i += 3 + nd
    return tuple(out)


def _codes(layout) -> List[int]:
    """The dtype codes of a layout's messages, in order of first use."""
    return list(dict.fromkeys(e[0] for e in layout if e is not None))


class _Link:
    """Point-to-point transfers of the boundary tensors between this rank
    and the ranks of its neighbouring stages.  A message is the tensors of
    one dtype, each in its memory order (NCHW or channels-last), packed in
    one buffer; the first message between two ranks at a microbatch's row
    count is preceded by its layout (:func:`_layout`: the shapes, dtypes
    and memory formats, and which entries are None), which the receiver
    keeps.  Sends are ``isend`` and return at once (:meth:`wait` waits for
    them); a receive waits for its data.  gloo sends host tensors only:
    there the buffers go through pinned host memory, and the received ones
    onto ``device``."""

    def __init__(self, device: torch.device, backend: str):
        self.device = device
        self.host = backend != "nccl"
        self.wire = torch.device("cpu") if self.host else device
        self._sent: Dict[tuple, tuple] = {}
        self._known: Dict[tuple, tuple] = {}
        self._pending: list = []

    def _isend(self, t: torch.Tensor, peer: int) -> None:
        self._pending.append((dist.isend(t, peer), t))

    def _recv(self, t: torch.Tensor, peer: int) -> torch.Tensor:
        dist.irecv(t, peer).wait()
        return t

    def send(self, ts: Sequence[Optional[torch.Tensor]], peer: int,
             rows: int) -> None:
        layout = _layout(ts)
        key = (peer, rows)
        if key not in self._sent:
            words = torch.tensor(_encode(layout), dtype=torch.int64,
                                 device=self.wire)
            self._isend(torch.tensor([words.numel()], dtype=torch.int64,
                                     device=self.wire), peer)
            self._isend(words, peer)
            self._sent[key] = layout
        elif self._sent[key] != layout:
            raise RuntimeError(f"boundary layout to rank {peer} changed: "
                               f"{layout} after {self._sent[key]}")
        for code in _codes(layout):
            flat = torch.cat([
                (t.permute(0, 2, 3, 1) if e[1] else t.contiguous()).reshape(-1)
                for t, e in zip(ts, layout) if e is not None and e[0] == code])
            if self.host and flat.device.type != "cpu":
                buf = torch.empty(flat.shape, dtype=flat.dtype,
                                  pin_memory=True)
                flat = buf.copy_(flat)
            self._isend(flat, peer)

    def recv(self, peer: int, rows: int) -> List[Optional[torch.Tensor]]:
        key = (peer, rows)
        if key not in self._known:
            n = self._recv(torch.empty(1, dtype=torch.int64,
                                       device=self.wire), peer)
            words = self._recv(torch.empty(int(n.item()), dtype=torch.int64,
                                           device=self.wire), peer)
            self._known[key] = _decode(words.tolist())
        layout = self._known[key]
        out: List[Optional[torch.Tensor]] = [None] * len(layout)
        for code in _codes(layout):
            idx = [j for j, e in enumerate(layout)
                   if e is not None and e[0] == code]
            sizes = [int(np.prod(layout[j][2])) for j in idx]
            flat = torch.empty(sum(sizes), dtype=_DTYPES[code],
                               device=self.wire,
                               pin_memory=self.host
                               and self.device.type == "cuda")
            flat = self._recv(flat, peer).to(self.device)
            for j, part in zip(idx, flat.split(sizes)):
                _, cl, shape = layout[j]
                if cl:
                    n_, c_, h_, w_ = shape
                    out[j] = part.view(n_, h_, w_, c_).permute(0, 3, 1, 2)
                else:
                    out[j] = part.view(shape)
        return out

    def wait(self) -> None:
        """Wait for every send in flight."""
        pending, self._pending = self._pending, []
        for work, _ in pending:
            work.wait()


class PipelineTrainer:
    """Pipeline training of ``model`` over ``n_stages`` devices.

    ``model``, ``train_cfg``, ``total_steps``, ``steps_per_epoch``: as for
    :func:`nvae_torch.train.step.make_train_step`.  ``n_microbatches``
    (0: ``n_stages``) is the pipeline's gradient accumulation, so
    ``train_cfg.grad_accum`` must be 1.  ``dp`` is the ranks a stage takes.

    In one process (a world of one rank, ``dp`` 1) ``devices`` lists each
    stage's device (repeats allowed: ``["cpu"] * S`` on the CPU, or one
    card for every stage); by default the first ``S`` cards.  In a world of
    ``S x dp`` ranks (``parallel.multihost.initialize``; every rank builds
    the trainer) this process runs its own stage (module docstring):
    ``devices`` then lists each world rank's device, by default this
    rank's card.  Any other world, or ``dp`` > 1 in one process, raises
    with the launcher's command (:func:`check_layout`).

    ``state`` is the whole model's :class:`TrainState` to start from
    (default: ``model`` at step 0); its model is copied, never written.
    ``tx_factory(sn_keys)`` builds one stage's optimizer from the spectral
    kernels' names of its modules (default: ``make_optimizer`` of
    ``train_cfg``).  ``schedule`` is ``"1f1b"`` or ``"gpipe"`` (default:
    ``train_cfg.pipeline_schedule``).  :meth:`merged_state` puts the whole
    state on ``model``'s device.
    """

    def __init__(
        self,
        model: NVAE,
        train_cfg: TrainConfig,
        total_steps: int,
        steps_per_epoch: int,
        n_stages: int = 2,
        n_microbatches: int = 0,
        devices: Optional[Sequence[DeviceLike]] = None,
        dp: int = 1,
        state: Optional[TrainState] = None,
        tx_factory: Optional[TxFactory] = None,
        schedule: Optional[str] = None,
    ):
        if train_cfg.grad_accum > 1:
            raise ValueError(
                "pipeline microbatches ARE the gradient accumulation; "
                "set grad_accum=1 under pipeline_stages>1")
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.train_cfg = train_cfg
        self.total_steps = total_steps
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.total_epochs = max(total_steps // self.steps_per_epoch, 1)
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches or n_stages
        self.names = stage_names(n_stages)
        self.penalty_mode = self.cfg.spectral_mode == "penalty"
        self.train_mode = not train_cfg.parity_frozen_norm
        schedule = schedule or train_cfg.pipeline_schedule
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"pipeline_schedule must be 'gpipe' or '1f1b', "
                             f"got {schedule!r}")
        self.schedule = schedule
        # The most microbatch inputs a stage held at once in the last
        # step: M under gpipe, at most 2 under 1f1b.
        self.peak_stash = 0

        world = process_count()
        check_layout(n_stages, dp, world)
        self.dp = dp
        self.distributed = world > 1
        # This process's stages: every stage in one process, else its own.
        self.stage_mesh: Optional[DataMesh] = None
        self.world: Optional[DataMesh] = None
        self.link: Optional[_Link] = None
        if self.distributed:
            rank = dist.get_rank()
            if devices is not None and len(devices) != world:
                raise ValueError(f"devices lists each of the {world} "
                                 f"ranks' devices, got {len(devices)}")
            device = (torch.device("cuda", torch.cuda.current_device())
                      if devices is None else list(devices)[rank])
            stage, self.stage_mesh = make_stage_mesh(n_stages, dp, device)
            device = self.stage_mesh.device
            self.world = DataMesh(rank, world, device)
            self.link = _Link(device, self.world.backend)
            self.local = (stage,)
            self.devices = [device] * n_stages
        else:
            if devices is None:
                devices = [torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())]
            devices = list(devices)
            if len(devices) < n_stages:
                raise ValueError(
                    f"pipeline needs {n_stages} devices ({n_stages} stages "
                    f"x dp=1), have {len(devices)}")
            self.local = tuple(range(n_stages))
            self.devices = [resolve_device(d) for d in devices[:n_stages]]
        # The stage's data axis where it has more than one rank: BatchNorm
        # statistics, noise rows, KL coefficients, metrics and gradients
        # go over it.
        self.dp_mesh = self.stage_mesh if dp > 1 else None
        self.device = model.decoder.h.device
        self.dtype = model.decoder.h.dtype
        self.alphas = losses.kl_alphas(self.cfg.n_latent_scales,
                                       self.cfg.n_groups_per_scale,
                                       device=self.devices[-1])
        # The stage that samples the posterior owns the generator.
        self.generators = [
            torch.Generator(device=d)
            if "decoder" in names and s in self.local else None
            for s, (d, names) in enumerate(zip(self.devices, self.names))]
        self._whole: Optional[NVAE] = None
        self.tx_factory = tx_factory or (
            lambda keys: make_optimizer(train_cfg, total_steps,
                                        self.cfg.spectral_mode, keys))
        if state is None:
            state = TrainState(0, 0, model, None, train_cfg.seed)
        self.load_state(state)

    @property
    def stage(self) -> int:
        """This process's stage in a world of ``S x dp`` ranks."""
        return self.local[0]

    def _first_rank(self, s: int) -> int:
        """The world rank of stage ``s``'s first data rank."""
        return s * self.dp

    def _peer(self, s: int) -> int:
        """The world rank of stage ``s``'s rank at this rank's data
        index."""
        return s * self.dp + self.stage_mesh.rank

    # ---- state ------------------------------------------------------------

    @torch.no_grad()
    def load_state(self, state: TrainState,
                   tx_factory: Optional[TxFactory] = None,
                   restore_opt: bool = False) -> None:
        """Copy a whole model's state into the stages: each stage takes a
        copy of its modules (parameters, BatchNorm statistics, spectral
        ``u``) on its device.  The optimizer state is new, unless
        ``restore_opt``: then ``state.opt_state`` must have the whole
        model's layout (what :meth:`merged_state` and ``make_optimizer(
        ...).init`` give), and each stage takes a copy of its share
        (:func:`split_opt_state`), so the Adamax moments, spectral vectors
        and EMA resume exactly, whatever topology wrote them.  In a world of
        ``S x dp`` ranks each rank takes its stage's share, and the stage's
        ranks then hold its first rank's, bit for bit
        (``parallel.mesh.shard_state`` over the stage's group)."""
        if tx_factory is not None:
            self.tx_factory = tx_factory
        src = state.model
        n = self.n_stages
        self.stages: List[Optional[nn.ModuleDict]] = [None] * n
        self.params: List[Optional[Dict[str, nn.Parameter]]] = [None] * n
        self.txs: List[Optional[GradientTransformation]] = [None] * n
        self.opt: list = [None] * n
        for s in self.local:
            names, dev = self.names[s], self.devices[s]
            mods = nn.ModuleDict({n: copy.deepcopy(getattr(src, n))
                                  for n in names}).to(dev)
            mods.train(self.train_mode)
            params = dict(mods.named_parameters())
            tx = self.tx_factory(sn_kernel_names(mods))
            opt = tx.init(params)
            if restore_opt:
                part = split_opt_state(state.opt_state, names)
                if _structure(part) != _structure(opt):
                    raise ValueError(
                        f"stage {s} optimizer state from the checkpoint "
                        "does not match this run's optimizer chain "
                        "(different spectral_mode / ema_decay?); re-run "
                        "without opt restore or align the training config")
                opt = map_tensors(part, lambda t: t.to(dev, copy=True))
            if self.dp_mesh is not None:
                opt = shard_state(TrainState(int(state.step), 0, mods, opt,
                                             int(state.seed)),
                                  self.dp_mesh).opt_state
            self.stages[s] = mods
            self.params[s] = params
            self.txs[s] = tx
            self.opt[s] = opt
        self.step_count = int(state.step)
        self.seed = int(state.seed)

    def _from_stages(self, fn: Callable[[int], object]) -> list:
        """``fn(s)`` for every stage ``s``, on every rank: in one process
        computed here, in a world of ranks by the stage's first rank, its
        tensors on the host, and broadcast to every rank (a collective)."""
        if not self.distributed:
            return [fn(s) for s in range(self.n_stages)]
        out = []
        for s in range(self.n_stages):
            mine = self.stage == s and self.stage_mesh.rank == 0
            obj = [map_tensors(fn(s), lambda t: t.detach().cpu())
                   if mine else None]
            dist.broadcast_object_list(obj, src=self._first_rank(s))
            out.append(obj[0])
        return out

    @torch.no_grad()
    def merged_state(self) -> TrainState:
        """The stages gathered into one whole-model :class:`TrainState` on
        ``device``: its model (one model, kept by the trainer and
        rewritten by each call) takes the stages' parameters, BatchNorm
        statistics and spectral ``u``, and its optimizer state is a copy of
        the stages' in the whole model's layout (:func:`merge_opt_states`).
        A checkpoint of it restores on any topology: one device, the data
        parallel or FSDP layouts, or another stage count.  In a world of
        ranks every rank calls it (a collective) and gets the whole
        state."""
        parts = self._from_stages(
            lambda s: (self.stages[s].state_dict(), self.opt[s]))
        if self._whole is None:
            self._whole = copy.deepcopy(self.model).to(self.device)
        self._whole.load_state_dict(merge_named([sd for sd, _ in parts]))
        opt = map_tensors(merge_opt_states([o for _, o in parts]),
                          lambda t: t.to(self.device, copy=True))
        return TrainState(step=self.step_count,
                          epoch=self.step_count // self.steps_per_epoch,
                          model=self._whole, opt_state=opt, seed=self.seed)

    def ema_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The EMA of every parameter by name, on ``device``, from the
        stages' optimizer states (each tracks its own parameters), or None
        when the optimizers track no EMA.  In a world of ranks every rank
        calls it (a collective)."""
        parts = self._from_stages(lambda s: find_ema_params(self.opt[s]))
        if any(p is None for p in parts):
            return None
        return {k: v.to(self.device) for k, v in merge_named(parts).items()}

    # ---- the stage programs -----------------------------------------------

    def _noise(self, s: int, stash_seed: Optional[int], eps):
        gen = self.generators[s]
        if gen is not None and eps is None:
            gen.manual_seed(stash_seed)
        return dict(generator=gen if eps is None else None, eps=eps)

    def _stage_eps(self, s: int, seed: int, eps, rows: int):
        """The noise stage ``s`` draws for a microbatch of ``rows`` rows:
        over a stage's data axis, the decoder's stage draws the global
        microbatch's noise (or takes ``eps``, its draws) and keeps its rows,
        which the recompute takes again; else ``eps`` as it is."""
        gen = self.generators[s]
        if gen is None or self.dp_mesh is None:
            return eps
        if eps is None:
            gen.manual_seed(seed)
        return global_noise_rows(self.cfg, rows, self.dp_mesh, eps, gen,
                                 self.devices[s], self.dtype)

    def _penalties(self, s: int) -> Dict[str, torch.Tensor]:
        """The penalties on stage ``s``'s parameters, under the step's
        metric names: ``bn_loss``, BatchNorm gamma over its encoder and
        decoder towers, and in penalty mode ``spectral_loss``, sigma of its
        spectral kernels (each 0 where the stage has none), on the stage's
        device."""
        lam, dev = self.cfg.sr_lambda, self.devices[s]
        out = {"bn_loss": losses.bn_gamma_penalty(self.stages[s], lam)}
        if self.penalty_mode:
            st = find_spectral_state(self.opt[s])
            out["spectral_loss"] = spectral_penalty(
                self.params[s], {} if st is None else st.u, lam)
        return {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                for k, v in out.items()}

    def _input(self, s: int, ins: List[torch.Tensor]):
        """Stage ``s``'s input value from the boundary tensors ``ins``."""
        if s == 0:
            return ins[0]
        return unflatten_boundary(self.names[s - 1][-1], ins)

    def _leaves(self, s: int, ins: List[torch.Tensor]) -> List[torch.Tensor]:
        """The stage input as autograd leaves (stage 0's images need no
        gradient)."""
        if s == 0:
            return list(ins)
        return [t.detach().requires_grad_() for t in ins]

    def _forward(self, s: int, ins: List[torch.Tensor], seed, eps
                 ) -> List[torch.Tensor]:
        """A non-last stage's forward: no autograd, buffers updated."""
        with torch.no_grad(), batch_stats_over(self.stages[s], self.dp_mesh):
            out = run_stage(self.stages[s], self.names[s],
                            self._input(s, ins), **self._noise(s, seed, eps))
        return flatten_boundary(out)

    def _backward(self, s: int, stash: _Stash, ct: List[Optional[torch.Tensor]]):
        """A non-last stage's backward: the stage recomputed from the
        stashed input and buffers, the cotangent ``ct`` and the penalties'
        gradients added into the parameters' ``.grad``, the recompute's
        buffer updates thrown away.  Returns the input's cotangent and the
        penalties."""
        mods = self.stages[s]
        leaves = self._leaves(s, stash.ins)
        with (discard_buffer_updates(mods, train=self.train_mode),
              batch_stats_over(mods, self.dp_mesh)):
            with torch.no_grad():
                for b, v in zip(mods.buffers(), stash.buffers):
                    b.copy_(v)
            out = run_stage(mods, self.names[s], self._input(s, leaves),
                            **self._noise(s, stash.seed, stash.eps))
            roots, grads = [], []
            for o, c in zip(flatten_boundary(out), ct):
                if c is not None and o.requires_grad:
                    roots.append(o)
                    grads.append(c)
            pens = self._penalties(s)
            pen = sum(pens.values())
            if pen.requires_grad:
                roots.append(pen)
                grads.append(None)
            if roots:
                torch.autograd.backward(roots, grads)
        return ([t.grad if s > 0 else None for t in leaves],
                {k: v.detach() for k, v in pens.items()})

    def _last(self, ins: List[torch.Tensor], x: torch.Tensor, beta, seed,
              eps):
        """The last stage: forward, ELBO and penalties, and backward, at
        once.  Returns the metrics and the input's cotangent."""
        s = self.n_stages - 1
        leaves = self._leaves(s, ins)
        with batch_stats_over(self.stages[s], self.dp_mesh):
            out = run_stage(self.stages[s], self.names[s],
                            self._input(s, leaves),
                            **self._noise(s, seed, eps))
            loss, metrics = losses.elbo_loss(out, x, beta, self.cfg,
                                             alphas=self.alphas,
                                             mesh=self.dp_mesh)
            pens = self._penalties(s)
            for v in pens.values():
                loss = loss + v
            loss.backward()
        metrics.update(pens)
        metrics["loss"] = loss
        cts = [t.grad if s > 0 else None for t in leaves]
        return {k: v.detach() for k, v in metrics.items()}, cts

    @torch.no_grad()
    def _update(self, s: int) -> torch.Tensor:
        """Stage ``s``'s optimizer update on the mean of its microbatches'
        gradients (over a stage's data axis, first the mean over its ranks,
        in one flat all-reduce); returns the gradients' squared norm."""
        m = self.n_microbatches
        params = self.params[s]
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in params.items()}
        if self.dp_mesh is not None:
            flat = torch.cat([g.reshape(-1) for g in grads.values()])
            self.dp_mesh.all_reduce_(flat).div_(self.dp_mesh.size)
            grads = {k: v.view_as(g) for (k, g), v in zip(
                grads.items(), flat.split([g.numel()
                                           for g in grads.values()]))}
        grads = {k: g / m for k, g in grads.items()}
        sq = sum(torch.sum(g * g) for g in grads.values())
        updates, self.opt[s] = self.txs[s].update(grads, self.opt[s], params)
        apply_updates(params, updates)
        for p in params.values():
            p.grad = None
        return torch.as_tensor(sq, device=self.devices[-1])

    # ---- one optimizer step -----------------------------------------------

    def step(self, batch, *, eps: Optional[Sequence[Sequence]] = None
             ) -> Dict[str, torch.Tensor]:
        """One optimizer step over ``n_microbatches`` microbatches of
        ``batch`` (B, H, W, C), the ``grad_accum=M`` step's equal (module
        docstring).  ``eps`` injects each microbatch's posterior noise (one
        list of NHWC draws per microbatch, in the posterior pass's order).
        Returns the step's metrics as tensors on the last stage's device:
        the microbatches' means, with the other stages' penalties added to
        ``loss`` and to ``bn_loss`` (and ``spectral_loss``, which JAX's
        pipeline folds into ``bn_loss``), and ``grad_norm``.

        In a world of ``S x dp`` ranks every rank calls it with the same
        global ``batch`` (and ``eps``, the global microbatches' draws), of
        which the ranks of the first and the last stage take their rows; it
        returns the same metrics on every rank, on its device."""
        S, M = self.n_stages, self.n_microbatches
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.array(batch, dtype=np.float32))
        B = batch.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        if eps is not None and len(eps) != M:
            raise ValueError(f"eps needs one list per microbatch ({M}), "
                             f"got {len(eps)}")
        if self.dp_mesh is not None:
            if B % (M * self.dp):
                raise ValueError(f"batch {B} not divisible by {M} "
                                 f"microbatches x dp={self.dp}")
            batch = shard_batch(batch, self.dp_mesh, M)
        mb = batch.shape[0] // M
        first, last = self.devices[0], self.devices[-1]
        x_first = (batch.to(first, self.dtype, non_blocking=True)
                   if 0 in self.local else None)
        x_last = (batch.to(last, self.dtype, non_blocking=True)
                  if S - 1 in self.local else None)
        step_t = torch.tensor(self.step_count, device=last)
        beta = losses.beta_schedule(
            step_t, torch.div(step_t, self.steps_per_epoch,
                              rounding_mode="floor"),
            train_cfg=self.train_cfg, total_steps=self.total_steps,
            total_epochs=self.total_epochs)
        seeds = [step_seed(self.seed, self.step_count, i) for i in range(M)]

        saved: List[Dict[int, _Stash]] = [{} for _ in range(S - 1)]
        ct_last: Dict[int, List] = {}
        metrics: List[dict] = []
        pens: Dict[int, Dict[str, torch.Tensor]] = {}
        self.peak_stash = 0
        link = self.link

        def fwd_chain(i: int) -> None:
            eps_i = None if eps is None else eps[i]
            rows = slice(i * mb, (i + 1) * mb)
            ins = None
            if 0 in self.local:
                ins = [x_first[rows].permute(0, 3, 1, 2).contiguous(
                    memory_format=torch.channels_last)]
            for s in range(S - 1):
                if s not in self.local:
                    continue
                if link is not None and s > 0:
                    ins = link.recv(self._peer(s - 1), mb)
                eps_s = self._stage_eps(s, seeds[i], eps_i, mb)
                saved[s][i] = _Stash(
                    ins, [b.clone() for b in self.stages[s].buffers()],
                    seeds[i], eps_s)
                self.peak_stash = max(self.peak_stash, len(saved[s]))
                with record_function("pipeline.forward"):
                    outs = self._forward(s, ins, seeds[i], eps_s)
                if link is not None:
                    link.send(outs, self._peer(s + 1), mb)
                else:
                    ins = [t.to(self.devices[s + 1], non_blocking=True)
                           for t in outs]
            if S - 1 not in self.local:
                return
            if link is not None and S > 1:
                ins = link.recv(self._peer(S - 2), mb)
            with record_function("pipeline.last_stage"):
                m_i, ct = self._last(
                    ins, x_last[rows], beta, seeds[i],
                    self._stage_eps(S - 1, seeds[i], eps_i, mb))
            if link is not None and S > 1:
                link.send(ct, self._peer(S - 2), mb)
            else:
                ct_last[i] = ct
            metrics.append(m_i)

        def bwd_chain(i: int) -> None:
            ct = ct_last.pop(i, None)
            for s in range(S - 2, -1, -1):
                if s not in self.local:
                    continue
                if link is not None:
                    ct = link.recv(self._peer(s + 1), mb)
                else:
                    ct = [None if c is None else
                          c.to(self.devices[s], non_blocking=True)
                          for c in ct]
                with record_function("pipeline.backward"):
                    ct, pen = self._backward(s, saved[s].pop(i), ct)
                if link is not None and s > 0:
                    link.send(ct, self._peer(s - 1), mb)
                if i == 0:
                    # The penalties do not depend on the microbatch:
                    # microbatch 0's stands for the mean.
                    pens[s] = pen

        with fp32_math():
            if self.schedule == "gpipe":
                for i in range(M):
                    fwd_chain(i)
                for i in range(M):
                    bwd_chain(i)
            else:
                for i in range(M):
                    fwd_chain(i)
                    if i >= 1:
                        bwd_chain(i - 1)
                bwd_chain(M - 1)
            saved = None
            with record_function("pipeline.update"):
                gsq = {s: self._update(s) for s in self.local}
        if link is not None:
            link.wait()

        out: Dict[str, torch.Tensor] = {}
        for m_i in metrics:
            for k, v in m_i.items():
                out[k] = v if k not in out else out[k] + v
        if self.dp_mesh is not None and out:
            keys = [k for k in StepBody.BATCH_METRICS if k in out]
            means = self.dp_mesh.mean(torch.stack([out[k] for k in keys]))
            out.update(zip(keys, means.unbind()))
        out = {k: v / M for k, v in out.items()}
        if self.distributed:
            out, pens, gsq = self._gather_metrics(out, pens, gsq)
        for s in range(S - 2, -1, -1):
            for k, v in pens[s].items():
                v = v.to(last)
                out["loss"] = out["loss"] + v
                out[k] = out[k] + v
        out["grad_norm"] = torch.sqrt(sum(gsq[s] for s in range(S)))
        self.step_count += 1
        return out

    def _metric_keys(self) -> Tuple[str, ...]:
        keys = ("loss", "reconstruction_loss", "kl_loss", "kl_raw", "beta",
                "bn_loss")
        return keys + (("spectral_loss",) if self.penalty_mode else ())

    def _gather_metrics(self, out, pens, gsq):
        """Every stage's share of the metrics on every rank, by one
        all-gather over the world: the last stage's metrics, each other
        stage's penalties and each stage's squared gradient norm, taken
        from each stage's first rank."""
        keys = self._metric_keys()
        s, dev = self.stage, self.devices[-1]
        vals = out if s == self.n_stages - 1 else pens.get(s, {})
        if set(vals) - set(keys):
            raise RuntimeError(f"metrics {sorted(vals)} not in {keys}")
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        mine = torch.stack([vals.get(k, zero).to(torch.float32)
                            for k in keys] + [gsq[s].to(torch.float32)])
        every = self.world.all_gather_rows(mine[None])
        rows = [every[self._first_rank(t)] for t in range(self.n_stages)]
        last = dict(zip(keys, rows[-1].unbind()))
        out = {k: last[k] for k in keys}
        pen_keys = [k for k in keys if k in ("bn_loss", "spectral_loss")]
        pens = {t: {k: rows[t][keys.index(k)] for k in pen_keys}
                for t in range(self.n_stages - 1)}
        gsq = {t: rows[t][-1] for t in range(self.n_stages)}
        return out, pens, gsq
