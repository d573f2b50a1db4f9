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

The boundary tensors move to the next stage's device with
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

Data parallelism inside a stage (JAX's ``dp``, a one-process mesh per
stage with global BatchNorm statistics) waits for ROADMAP.md Queue 1 #14:
the port runs one process per card, and one process cannot hold a
cross-replica BatchNorm.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
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
from nvae_torch.train.step import step_seed

STAGE_MODULES = ("preprocess", "encoder", "decoder", "postprocess")
_ALL_MODULES = frozenset(STAGE_MODULES)
DP_WAITS = ("data parallelism inside a pipeline stage waits for the "
            "pipeline's data-parallel stages (ROADMAP.md Queue 1 #14)")

TxFactory = Callable[[Tuple[str, ...]], GradientTransformation]


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


class PipelineTrainer:
    """Pipeline training of ``model`` over ``n_stages`` devices.

    ``model``, ``train_cfg``, ``total_steps``, ``steps_per_epoch``: as for
    :func:`nvae_torch.train.step.make_train_step`.  ``n_microbatches``
    (0: ``n_stages``) is the pipeline's gradient accumulation, so
    ``train_cfg.grad_accum`` must be 1.  ``devices`` lists each stage's
    device (repeats allowed: ``["cpu"] * S`` on the CPU, or one card for
    every stage); by default the first ``S`` cards.  ``dp`` > 1 (data
    parallelism inside a stage) raises.  ``state`` is the whole model's
    :class:`TrainState` to start from (default: ``model`` at step 0); its
    model is copied, never written.  ``tx_factory(sn_keys)`` builds one
    stage's optimizer from the spectral kernels' names of its modules
    (default: ``make_optimizer`` of ``train_cfg``).  ``schedule`` is
    ``"1f1b"`` or ``"gpipe"`` (default: ``train_cfg.pipeline_schedule``).
    :meth:`merged_state` puts the whole state on ``model``'s device.
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

        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = list(devices)
        need = n_stages * dp
        if len(devices) < need:
            raise ValueError(
                f"pipeline needs {need} devices ({n_stages} stages x "
                f"dp={dp}), have {len(devices)}")
        if dp > 1:
            raise NotImplementedError(f"dp={dp}: {DP_WAITS}")
        self.devices = [resolve_device(d) for d in devices[:n_stages]]
        self.device = model.decoder.h.device
        self.dtype = model.decoder.h.dtype
        self.alphas = losses.kl_alphas(self.cfg.n_latent_scales,
                                       self.cfg.n_groups_per_scale,
                                       device=self.devices[-1])
        # The stage that samples the posterior owns the generator.
        self.generators = [
            torch.Generator(device=d) if "decoder" in names else None
            for d, names in zip(self.devices, self.names)]
        self._whole: Optional[NVAE] = None
        self.tx_factory = tx_factory or (
            lambda keys: make_optimizer(train_cfg, total_steps,
                                        self.cfg.spectral_mode, keys))
        if state is None:
            state = TrainState(0, 0, model, None, train_cfg.seed)
        self.load_state(state)

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
        and EMA resume exactly, whatever topology wrote them."""
        if tx_factory is not None:
            self.tx_factory = tx_factory
        src = state.model
        self.stages: List[nn.ModuleDict] = []
        self.params: List[Dict[str, nn.Parameter]] = []
        self.txs: List[GradientTransformation] = []
        self.opt: list = []
        for s, (names, dev) in enumerate(zip(self.names, self.devices)):
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
            self.stages.append(mods)
            self.params.append(params)
            self.txs.append(tx)
            self.opt.append(opt)
        self.step_count = int(state.step)
        self.seed = int(state.seed)

    @torch.no_grad()
    def merged_state(self) -> TrainState:
        """The stages gathered into one whole-model :class:`TrainState` on
        ``device``: its model (one model, kept by the trainer and
        rewritten by each call) takes the stages' parameters, BatchNorm
        statistics and spectral ``u``, and its optimizer state is a copy of
        the stages' in the whole model's layout (:func:`merge_opt_states`).
        A checkpoint of it restores on any topology: one device, the data
        parallel or FSDP layouts, or another stage count."""
        if self._whole is None:
            self._whole = copy.deepcopy(self.model).to(self.device)
        self._whole.load_state_dict(
            merge_named([m.state_dict() for m in self.stages]))
        opt = map_tensors(merge_opt_states(self.opt),
                          lambda t: t.to(self.device, copy=True))
        return TrainState(step=self.step_count,
                          epoch=self.step_count // self.steps_per_epoch,
                          model=self._whole, opt_state=opt, seed=self.seed)

    def ema_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The EMA of every parameter by name, on ``device``, from the
        stages' optimizer states (each tracks its own parameters), or None
        when the optimizers track no EMA."""
        parts = [find_ema_params(o) for o in self.opt]
        if any(p is None for p in parts):
            return None
        return {k: v.to(self.device) for k, v in merge_named(parts).items()}

    # ---- the stage programs -----------------------------------------------

    def _noise(self, s: int, stash_seed: Optional[int], eps):
        gen = self.generators[s]
        if gen is not None and eps is None:
            gen.manual_seed(stash_seed)
        return dict(generator=gen if eps is None else None, eps=eps)

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
        with torch.no_grad():
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
        with discard_buffer_updates(mods, train=self.train_mode):
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
        out = run_stage(self.stages[s], self.names[s],
                        self._input(s, leaves), **self._noise(s, seed, eps))
        loss, metrics = losses.elbo_loss(out, x, beta, self.cfg,
                                         alphas=self.alphas)
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
        gradients; returns the gradients' squared norm."""
        m = self.n_microbatches
        params = self.params[s]
        grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad) / m
                 for k, p in params.items()}
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
        pipeline folds into ``bn_loss``), and ``grad_norm``."""
        S, M = self.n_stages, self.n_microbatches
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.array(batch, dtype=np.float32))
        B = batch.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        if eps is not None and len(eps) != M:
            raise ValueError(f"eps needs one list per microbatch ({M}), "
                             f"got {len(eps)}")
        mb = B // M
        first, last = self.devices[0], self.devices[-1]
        x_first = batch.to(first, self.dtype, non_blocking=True)
        x_last = batch.to(last, self.dtype, non_blocking=True)
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

        def fwd_chain(i: int) -> None:
            eps_i = None if eps is None else eps[i]
            rows = slice(i * mb, (i + 1) * mb)
            ins = [x_first[rows].permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)]
            for s in range(S - 1):
                saved[s][i] = _Stash(
                    ins, [b.clone() for b in self.stages[s].buffers()],
                    seeds[i], eps_i)
                self.peak_stash = max(self.peak_stash, len(saved[s]))
                with record_function("pipeline.forward"):
                    outs = self._forward(s, ins, seeds[i], eps_i)
                ins = [t.to(self.devices[s + 1], non_blocking=True)
                       for t in outs]
            with record_function("pipeline.last_stage"):
                m_i, ct_last[i] = self._last(ins, x_last[rows], beta,
                                             seeds[i], eps_i)
            metrics.append(m_i)

        def bwd_chain(i: int) -> None:
            ct = ct_last.pop(i)
            for s in range(S - 2, -1, -1):
                ct = [None if c is None else
                      c.to(self.devices[s], non_blocking=True) for c in ct]
                with record_function("pipeline.backward"):
                    ct, pen = self._backward(s, saved[s].pop(i), ct)
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
                gsq = [self._update(s) for s in range(S)]

        out: Dict[str, torch.Tensor] = {}
        for m_i in metrics:
            for k, v in m_i.items():
                out[k] = v if k not in out else out[k] + v
        out = {k: v / M for k, v in out.items()}
        for stage_pens in pens.values():
            for k, v in stage_pens.items():
                v = v.to(last)
                out["loss"] = out["loss"] + v
                out[k] = out[k] + v
        out["grad_norm"] = torch.sqrt(sum(gsq))
        self.step_count += 1
        return out
