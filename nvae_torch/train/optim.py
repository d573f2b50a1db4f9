"""Optimizer stack: Adamax + cosine decay, with the spectral-norm strategies
and the EMA as further transforms (counterpart of ``nvae_tpu/train/optim.py``,
which builds them on optax).

Each transform is a pair of plain functions on dicts of tensors with
optax's shape: ``init(params) -> state`` and ``update(updates, state,
params) -> (updates, state)``.  ``params`` and ``updates`` map a parameter's
name (``model.named_parameters()``) to a tensor.  Nothing is updated in
place: :func:`apply_updates` is the one function that writes the
parameters.  Spectrally normalized kernels are named by ``sn_keys``
(:func:`nvae_torch.nn.spectral.sn_kernel_names`); their weights are OIHW,
flattened to (in * kh * kw, out) for the power iteration, which gives the
same sigma and ``u`` as JAX's (kh * kw * in, out).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import torch

from nvae_torch.config import TrainConfig
from nvae_torch.nn.spectral import power_iteration

Tensors = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], object]
    update: Callable[[Tensors, object, Optional[Tensors]],
                     Tuple[Tensors, object]]


def _w2d(w: torch.Tensor) -> torch.Tensor:
    """An OIHW (or any out-first) kernel as (in_elems, out)."""
    return w.reshape(w.shape[0], -1).t()


def _f32(value) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32)


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
    count: int
    mu: Tensors
    nu: Tensors


def scale_by_adamax(b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> GradientTransformation:
    """optax's ``scale_by_adamax``: ``mu <- b1 mu + (1 - b1) g``,
    ``nu <- max(b2 nu, |g| + eps)``, update ``mu / (1 - b1^t) / nu``."""

    def init(params):
        return AdamaxState(
            0, {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()},
        )

    def update(updates, state, params=None):
        count = state.count + 1
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in updates.items()}
        nu = {k: torch.maximum(g.abs() + eps, b2 * state.nu[k])
              for k, g in updates.items()}
        # The float32 value optax computes, as a Python float (exact), so
        # no per-tensor host-to-device copy is made.
        correction = float(1 - _f32(b1) ** count)
        out = {k: (mu[k] / correction) / nu[k] for k in updates}
        return out, AdamaxState(count, mu, nu)

    return GradientTransformation(init, update)


def cosine_decay_schedule(init_value: float, decay_steps: int
                          ) -> Callable[[int], torch.Tensor]:
    """optax's ``cosine_decay_schedule`` (alpha 0, exponent 1), a float32
    scalar: ``init_value * 0.5 * (1 + cos(pi * min(t, T) / T))``."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> torch.Tensor:
        t = _f32(min(float(count), float(decay_steps)))
        return init_value * (0.5 * (1 + torch.cos(math.pi * t / decay_steps)))

    return schedule


@dataclasses.dataclass
class ScheduleState:
    count: int


def scale_by_learning_rate(schedule: Callable[[int], torch.Tensor]
                           ) -> GradientTransformation:
    """``update * -schedule(t)``, ``t`` the count before this update."""

    def init(params):
        return ScheduleState(0)

    def update(updates, state, params=None):
        step = float(-1 * schedule(state.count))  # float32, exact
        out = {k: step * g for k, g in updates.items()}
        return out, ScheduleState(state.count + 1)

    return GradientTransformation(init, update)


def adamax(learning_rate, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8) -> GradientTransformation:
    """optax's ``adamax``: :func:`scale_by_adamax` then the learning rate
    (a float or a schedule of the update count)."""
    schedule = (learning_rate if callable(learning_rate)
                else lambda count: _f32(learning_rate))
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
    on the updated kernel; ``u`` takes the new estimate."""
    keys, init = _spectral_init(sn_keys)

    @torch.no_grad()
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("spectral_projection requires params")
        out, u, sig = dict(updates), {}, {}
        for k in keys:
            w = params[k]
            w_new = w + updates[k]
            sigma, u[k] = power_iteration(_w2d(w_new), state.u[k])
            sig[k] = torch.clamp(sigma, min=eps)
            out[k] = w_new / sig[k] - w
        return out, SpectralState(u, sig)

    return GradientTransformation(init, update)


def spectral_tracking(sn_keys: Iterable[str]) -> GradientTransformation:
    """Track ``u`` and sigma of each spectral kernel from the parameters
    before the update, leaving the updates alone (penalty mode)."""
    keys, init = _spectral_init(sn_keys)

    @torch.no_grad()
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("spectral_tracking requires params")
        u, sig = {}, {}
        for k in keys:
            sig[k], u[k] = power_iteration(_w2d(params[k]), state.u[k])
        return updates, SpectralState(u, sig)

    return GradientTransformation(init, update)


def spectral_penalty(params: Tensors, u: Tensors,
                     sr_lambda: float) -> torch.Tensor:
    """``sr_lambda * sum sigma(W)`` with each ``u`` from the tracking state,
    differentiable in the kernels (``u`` and ``v`` are constants)."""
    total = 0.0
    for k, uk in u.items():
        sigma, _ = power_iteration(_w2d(params[k]), uk)
        total = total + sigma
    return sr_lambda * total


@dataclasses.dataclass
class EmaState:
    ema: Tensors
    count: int


def track_ema(decay: float) -> GradientTransformation:
    """Exponential moving average of the post-update parameters, chained
    last: ``ema_0 = params_0``, ``ema <- decay * ema + (1 - decay) *
    (params + updates)``.  The updates pass through unchanged."""
    if not 0.0 < decay < 1.0:
        raise ValueError(f"ema decay must be in (0, 1), got {decay}")

    def init(params):
        return EmaState({k: p.detach().clone() for k, p in params.items()}, 0)

    @torch.no_grad()
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("track_ema requires params")
        ema = {k: decay * state.ema[k] + (1.0 - decay) * (params[k] + g)
               for k, g in updates.items()}
        return updates, EmaState(ema, state.count + 1)

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
    for k, u in updates.items():
        params[k].add_(u)


def global_norm(tensors: Tensors) -> torch.Tensor:
    """L2 norm of all the tensors together (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors.values()))


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
