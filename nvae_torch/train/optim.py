"""Optimizer stack: Adamax + cosine decay, with the spectral-norm strategies
and the EMA as further transforms (counterpart of ``nvae_tpu/train/optim.py``,
which builds them on optax).

Each transform is a pair of plain functions on dicts of tensors with
optax's shape: ``init(params) -> state`` and ``update(updates, state,
params) -> (updates, state)``.  ``params`` and ``updates`` map a parameter's
name (``model.named_parameters()``) to a tensor.  Spectrally normalized
kernels are named by ``sn_keys``
(:func:`nvae_torch.nn.spectral.sn_kernel_names`); their weights are OIHW,
flattened to (in * kh * kw, out) for the power iteration, which gives the
same sigma and ``u`` as JAX's (kh * kw * in, out).

Where optax returns a new state, these transforms update theirs in place
and return the same object: the Adamax moments, the EMA, each spectral
``u`` and sigma, and every update count, which is an int64 tensor on the
parameters' device.  The bias correction ``1 - b1^count`` and the learning
rate are computed from that count on its device, in float32, so a step reads
nothing back to the host and a CUDA graph of it (``train/epoch_runner.py``)
replays with the current values.  The elementwise work runs as multi-tensor
``torch._foreach_*`` ops over all the parameters at once, in optax's order
of operations.  :func:`apply_updates` writes the parameters, in place.

Under the FSDP layout (``parallel.mesh.shard_state_fsdp``) a sharded
parameter, its update and its Adamax moments and EMA are this rank's block
of each: the elementwise transforms run on the blocks unchanged, and the
spectral strategies take sigma and ``u`` from the whole kernel, gathered
(``parallel.mesh.whole``, one all-gather for all the kernels), so that
every rank scales its block by the single device's sigma.  Under the TP
layout (``parallel.mesh.shard_state_tp``) the same holds of a split kernel
over the model axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Tuple)

import torch

from nvae_torch.config import TrainConfig
from nvae_torch.nn.spectral import power_iteration
from nvae_torch.parallel.mesh import shard_axis, shard_of, whole
from nvae_torch.parallel.tp import once_over_model

Tensors = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], object]
    update: Callable[[Tensors, object, Optional[Tensors]],
                     Tuple[Tensors, object]]


def _w2d(w: torch.Tensor) -> torch.Tensor:
    """An OIHW (or any out-first) kernel as (in_elems, out)."""
    return w.reshape(w.shape[0], -1).t()


def _f32(value, device=None) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def _counter(params: Tensors) -> torch.Tensor:
    """A zero update count on the parameters' device."""
    device = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int64, device=device)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Apply ``transforms`` in order; the state is the tuple of theirs."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


@dataclasses.dataclass
class AdamaxState:
    count: torch.Tensor
    mu: Tensors
    nu: Tensors


def scale_by_adamax(b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> GradientTransformation:
    """optax's ``scale_by_adamax``: ``mu <- b1 mu + (1 - b1) g``,
    ``nu <- max(b2 nu, |g| + eps)``, update ``mu / (1 - b1^t) / nu``."""

    def init(params):
        return AdamaxState(
            _counter(params),
            {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def update(updates, state, params=None):
        keys = list(updates)
        g = [updates[k] for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        state.count.add_(1)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        g_abs = torch._foreach_abs(g)
        torch._foreach_add_(g_abs, eps)
        torch._foreach_mul_(nu, b2)
        torch._foreach_maximum_(nu, g_abs)
        # 1 - b1^t in float32, on the count's device.
        correction = 1 - _f32(b1, state.count.device) ** state.count.to(
            torch.float32)
        out = torch._foreach_div(mu, correction)
        torch._foreach_div_(out, nu)
        return dict(zip(keys, out)), state

    return GradientTransformation(init, update)


def cosine_decay_schedule(init_value: float, decay_steps: int
                          ) -> Callable[[object], torch.Tensor]:
    """optax's ``cosine_decay_schedule`` (alpha 0, exponent 1), a float32
    scalar on the count's device (the count an int or an integer tensor):
    ``init_value * 0.5 * (1 + cos(pi * min(t, T) / T))``."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count) -> torch.Tensor:
        t = torch.clamp(torch.as_tensor(count), max=decay_steps).to(
            torch.float32)
        return init_value * (0.5 * (1 + torch.cos(math.pi * t / decay_steps)))

    return schedule


@dataclasses.dataclass
class ScheduleState:
    count: torch.Tensor


def scale_by_learning_rate(schedule: Callable[[torch.Tensor], torch.Tensor]
                           ) -> GradientTransformation:
    """``update * -schedule(t)``, ``t`` the count before this update."""

    def init(params):
        return ScheduleState(_counter(params))

    @torch.no_grad()
    def update(updates, state, params=None):
        step = -1 * schedule(state.count)  # float32, on the count's device
        out = torch._foreach_mul(list(updates.values()), step)
        state.count.add_(1)
        return dict(zip(updates, out)), state

    return GradientTransformation(init, update)


def adamax(learning_rate, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8) -> GradientTransformation:
    """optax's ``adamax``: :func:`scale_by_adamax` then the learning rate
    (a float or a schedule of the update count)."""
    schedule = (learning_rate if callable(learning_rate)
                else lambda count: _f32(learning_rate, count.device))
    return chain(scale_by_adamax(b1, b2, eps), scale_by_learning_rate(schedule))


@dataclasses.dataclass
class SpectralState:
    u: Tensors  # the power-iteration vector of each spectral kernel
    sigma: Tensors  # its last sigma estimate


@torch.no_grad()
def _init_u(w: torch.Tensor, n_warmup_iters: int = 5) -> torch.Tensor:
    """Deterministic start: ones over sqrt(out), then warm iterations."""
    out = w.shape[0]
    u = torch.ones(out, device=w.device) / math.sqrt(out)
    for _ in range(n_warmup_iters):
        _, u = power_iteration(_w2d(w), u)
    return u


def _spectral_init(sn_keys: Iterable[str]):
    keys = tuple(sn_keys)

    def init(params):
        return SpectralState(
            {k: _init_u(params[k]) for k in keys},
            {k: torch.ones((), device=params[k].device) for k in keys},
        )

    return keys, init


def spectral_projection(sn_keys: Iterable[str],
                        eps: float = 1e-9) -> GradientTransformation:
    """After the inner update, rescale each spectral kernel to sigma = 1:
    ``update' = (w + update) / sigma - w``, sigma from one power iteration
    on the updated kernel (gathered whole where ``w`` is a shard); ``u``
    takes the new estimate."""
    keys, init = _spectral_init(sn_keys)

    @torch.no_grad()
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("spectral_projection requires params")
        out = dict(updates)
        w_new = [params[k] + updates[k] for k in keys]
        w_whole = whole(w_new, [shard_of(params[k]) for k in keys])
        for k, wn, wf in zip(keys, w_new, w_whole):
            sigma, u = power_iteration(_w2d(wf), state.u[k])
            state.u[k].copy_(u)
            state.sigma[k].copy_(torch.clamp(sigma, min=eps))
            out[k] = wn / state.sigma[k] - params[k]
        return out, state

    return GradientTransformation(init, update)


def spectral_tracking(sn_keys: Iterable[str]) -> GradientTransformation:
    """Track ``u`` and sigma of each spectral kernel from the parameters
    before the update (gathered whole where they are shards), leaving the
    updates alone (penalty mode)."""
    keys, init = _spectral_init(sn_keys)

    @torch.no_grad()
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("spectral_tracking requires params")
        for k, w in zip(keys, whole([params[k] for k in keys])):
            sigma, u = power_iteration(_w2d(w), state.u[k])
            state.sigma[k].copy_(sigma)
            state.u[k].copy_(u)
        return updates, state

    return GradientTransformation(init, update)


def spectral_penalty(params: Tensors, u: Tensors,
                     sr_lambda: float) -> torch.Tensor:
    """``sr_lambda * sum sigma(W)`` with each ``u`` from the tracking state,
    differentiable in the kernels (``u`` and ``v`` are constants).  Under
    TP a split kernel is gathered whole (one all-gather, whose backward
    sums over the model axis), and the sigma of a kernel whose gradient
    the step sums over the model axis (a block, or ``tp_partial``) reaches
    it once (``parallel.tp.once_over_model``)."""
    keys = list(u)
    ws = whole([params[k] for k in keys],
               [shard_of(params[k]) if shard_axis(params[k]) == "model"
                else None for k in keys])
    total = 0.0
    for k, w in zip(keys, ws):
        sigma, _ = power_iteration(_w2d(w), u[k])
        tp = (getattr(shard_of(params[k]), "mesh", None)
              or getattr(params[k], "tp_partial", None))
        total = total + (sigma if tp is None else once_over_model(sigma, tp))
    return sr_lambda * total


@dataclasses.dataclass
class EmaState:
    ema: Tensors
    count: torch.Tensor


def track_ema(decay: float) -> GradientTransformation:
    """Exponential moving average of the post-update parameters, chained
    last: ``ema_0 = params_0``, ``ema <- decay * ema + (1 - decay) *
    (params + updates)``.  The updates pass through unchanged."""
    if not 0.0 < decay < 1.0:
        raise ValueError(f"ema decay must be in (0, 1), got {decay}")

    def init(params):
        return EmaState({k: p.detach().clone() for k, p in params.items()},
                        _counter(params))

    @torch.no_grad()
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("track_ema requires params")
        keys = list(updates)
        new = torch._foreach_add([params[k] for k in keys],
                                 [updates[k] for k in keys])
        torch._foreach_mul_(new, 1.0 - decay)
        ema = [state.ema[k] for k in keys]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, new)
        state.count.add_(1)
        return updates, state

    return GradientTransformation(init, update)


def _find(opt_state, cls):
    stack = [opt_state]
    while stack:
        s = stack.pop()
        if isinstance(s, cls):
            return s
        if isinstance(s, tuple):
            stack.extend(reversed(s))
    return None


def state_tensors(opt_state) -> List[torch.Tensor]:
    """Every tensor of a chain's state (tuples, dataclasses and dicts of
    tensors), in a fixed order."""
    out, stack = [], [opt_state]
    while stack:
        s = stack.pop()
        if isinstance(s, torch.Tensor):
            out.append(s)
        elif isinstance(s, (tuple, list)):
            stack.extend(reversed(s))
        elif isinstance(s, dict):
            stack.extend(reversed(list(s.values())))
        elif dataclasses.is_dataclass(s) and not isinstance(s, type):
            stack.extend(reversed([getattr(s, f.name)
                                   for f in dataclasses.fields(s)]))
    return out


def find_spectral_state(opt_state) -> Optional[SpectralState]:
    """The :class:`SpectralState` inside a chain's state, or None."""
    return _find(opt_state, SpectralState)


def find_ema_params(opt_state) -> Optional[Tensors]:
    """The EMA parameters inside a chain's state, or None."""
    s = _find(opt_state, EmaState)
    return None if s is None else s.ema


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """``p <- p + update`` in place: where JAX returns new parameters (and
    the jitted step donates the old ones), the port writes into the model's
    own tensors."""
    keys = list(updates)
    torch._foreach_add_([params[k] for k in keys], [updates[k] for k in keys])


def global_norm(tensors: Tensors, mesh=None, sharded: Iterable[str] = (),
                model_sharded: Iterable[str] = ()) -> torch.Tensor:
    """L2 norm of all the tensors together (``optax.global_norm``).  With a
    ``mesh`` the tensors named in ``sharded`` are this rank's blocks of
    theirs (the FSDP layout): their squares are summed over the ranks, in
    one all-reduce, and the others counted once, so every rank gets the
    norm of the whole tensors.  Those named in ``model_sharded`` are blocks
    over the mesh's model axis (the TP layout), summed over it alike."""
    axes = []
    if mesh is not None:
        axes = [(set(sharded), mesh), (set(model_sharded), mesh.model)]
    split = set().union(*(keys for keys, _ in axes))
    total = sum(torch.sum(t * t) for k, t in tensors.items()
                if k not in split)
    for keys, axis in axes:
        if keys:
            total = total + axis.all_reduce_(torch.stack(
                [torch.sum(t * t) for k, t in tensors.items()
                 if k in keys]).sum())
    return torch.sqrt(total)


def make_optimizer(train_cfg: TrainConfig, total_steps: int,
                   spectral_mode: str = "projection",
                   sn_keys: Iterable[str] = ()) -> GradientTransformation:
    """Adamax (eps 1e-7, Keras' default) with cosine decay from
    ``learning_rate`` over ``total_steps``, then the spectral strategy
    (projection, or tracking for the penalty), then the EMA when
    ``ema_decay > 0`` (``optim.py:227-246``)."""
    schedule = cosine_decay_schedule(train_cfg.learning_rate,
                                     max(total_steps, 1))
    parts = [adamax(schedule, eps=1e-7)]
    if spectral_mode == "projection":
        parts.append(spectral_projection(sn_keys))
    elif spectral_mode == "penalty":
        parts.append(spectral_tracking(sn_keys))
    if train_cfg.ema_decay > 0.0:
        parts.append(track_ema(train_cfg.ema_decay))
    return chain(*parts)
