"""Spectrally-normalized and depthwise convolutions (counterpart of
``nvae_tpu/nn/spectral.py``), NCHW tensors in ``torch.channels_last`` memory.

The spectral modes differ only in ``forward``: ``projection``, ``penalty``
and ``none`` are a plain convolution (their normalization lives in the
optimizer or the loss), while ``forward`` divides the kernel by the sigma of
one power iteration from the stored ``u``, on every call, and stores the new
``u`` in place when the module is training (as the JAX module updates its
``spectral`` collection when ``train`` is set).  Gradients flow through the
kernel only: ``u`` and ``v`` are constants, as JAX's ``stop_gradient`` makes
them.

Initialisation follows Flax's: glorot-uniform kernels over
``receptive field x in/out channels``, zero biases, ``u`` a normalized
Gaussian draw.

Compute dtype: a module's ``dtype`` (the JAX module's ``dtype``; None here
for float32) is where the JAX module casts.  ``SNConv`` casts its input and
kernel to it, convolves, and adds the bias cast to it (two roundings, as
JAX's ``y + bias.astype(dtype)``); ``DepthwiseConv`` casts its input and
taps to it and hands the kernel an fp32 bias.  With ``dtype`` None the
convolution runs in the promoted dtype of input and weights, so bf16
serving weights run in fp32 and a float64 copy of the model in float64.

Under the tensor-parallel layout (``parallel.mesh.shard_state_tp``) a
module's ``tp`` is the model axis and it computes on this rank's part:
an ``SNConv`` by its ``tp_role`` (``"column"``: its block of output
channels, from the replicated input; ``"row"``: its block of input
channels, then the sum over the axis, then the bias; ``"gather"``: column,
then every rank's channels gathered), a ``DepthwiseConv`` on its block of
channels.  Sigma of a forward-mode kernel is the whole kernel's, gathered
where the weight is a block.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from nvae_torch.kernels.depthwise import (
    depthwise5x5_conv,
    fused_swish_depthwise5x5,
    fused_swish_depthwise5x5_plain,
)
from nvae_torch.parallel.mesh import shard_of, whole
from nvae_torch.parallel.tp import (
    block_of,
    copy_to_model,
    gather_channels,
    sum_over_model,
)


def compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor,
                  w: torch.Tensor) -> torch.dtype:
    """A module's compute dtype: its own, or else the promoted dtype of its
    input and weight."""
    return dtype if dtype is not None else torch.promote_types(x.dtype,
                                                               w.dtype)


def glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator] = None) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=generator)


def swish(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``.  In bf16 two roundings, as JAX's ``jax.nn.silu``
    (the sigmoid, then the product); ``F.silu`` rounds once."""
    if x.dtype == torch.bfloat16:
        return x * torch.sigmoid(x)
    return F.silu(x)


def _l2norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v) + eps)


def power_iteration(w2d: torch.Tensor, u: torch.Tensor):
    """One power-iteration step on ``w2d`` of shape (in_elems, out); returns
    ``(sigma, u_new)``.  Sigma does not depend on the order of the rows, so
    any flattening of the input axes gives the same value.  ``u``, ``v`` and
    ``u_new`` carry no gradient: sigma is differentiable in ``w2d`` alone."""
    with torch.no_grad():
        v = _l2norm(w2d @ u)
        u_new = _l2norm(w2d.t() @ v)
    sigma = torch.einsum("i,io,o->", v, w2d, u_new)
    return sigma, u_new


def _same_pad(n: int, k: int, stride: int):
    """(before, after) zero padding of one axis under JAX's ``SAME``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class SNConv(nn.Module):
    """``SAME`` 2-D convolution whose kernel is subject to spectral
    normalization.  ``weight`` is OIHW; ``u`` (forward mode only) is the
    right-singular estimate of shape (out,).

    Padding follows JAX's ``SAME``: with stride 2 and an even input a 3x3
    kernel pads 0 before and 1 after each axis (not torch's symmetric
    ``padding=1``), and a 1x1 kernel pads nothing."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 use_bias: bool = True, mode: str = "projection",
                 stride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("SAME padding needs an odd kernel size")
        self.mode = mode
        self.update_buffers = True  # False: a rematerialized second run
        self.stride = int(stride)
        self.dtype = dtype
        self.tp = None  # the model axis, under the TP layout
        self.tp_role = None
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.empty(out_ch)) if use_bias else None
        if mode == "forward":
            self.register_buffer("u", torch.empty(out_ch))
        else:
            self.u = None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        out_ch, in_ch, kh, kw = self.weight.shape
        glorot_uniform_(self.weight, in_ch * kh * kw, out_ch * kh * kw, generator)
        with torch.no_grad():
            if self.bias is not None:
                self.bias.zero_()
            if self.u is not None:
                u = torch.empty_like(self.u).normal_(generator=generator)
                self.u.copy_(_l2norm(u))

    def kernel(self) -> torch.Tensor:
        """The kernel the convolution uses.  In forward mode: the weight over
        the sigma of one power iteration from the stored ``u``; while
        training, ``u`` then takes the new estimate (the sigma of this call
        comes from the old ``u``, as in JAX).  Under TP, this rank's part of
        it (see the module docstring)."""
        w = self.weight
        if self.tp is None:
            return self._normalized(w)
        block = shard_of(w) is not None
        if self.mode == "forward" or (block and self.tp_role == "row"):
            w = self._normalized(whole([w])[0] if block else w)
        elif block:
            return w
        return block_of(w, self.tp, 1 if self.tp_role == "row" else 0)

    def _normalized(self, w: torch.Tensor) -> torch.Tensor:
        if self.mode == "forward":
            # bf16 serving weights: sigma in the dtype of u, as JAX promotes.
            w = w.to(torch.promote_types(w.dtype, self.u.dtype))
            w2d = w.reshape(w.shape[0], -1).t()  # (in * kh * kw, out)
            sigma, u_new = power_iteration(w2d, self.u)
            if self.training and self.update_buffers:
                with torch.no_grad():
                    self.u.copy_(u_new)
            w = w / sigma
        return w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self._conv(x, self.kernel(), self.bias)
        if self.tp_role == "row":
            y = sum_over_model(self._conv(x, self.kernel(), None), self.tp)
            if self.bias is None:
                return y
            return y + self.bias.to(y.dtype)[:, None, None]
        x = copy_to_model(x, self.tp)
        bias = None if self.bias is None else block_of(self.bias, self.tp)
        y = self._conv(x, self.kernel(), bias)
        return gather_channels(y, self.tp) if self.tp_role == "gather" else y

    def _conv(self, x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
        k, s = w.shape[-1], self.stride
        if k == 1 and s > 1:
            # A strided 1x1 conv reads every s-th pixel: take them first.
            # (The same result; PyTorch 2.13's CPU backward of a strided
            # 1x1 conv on a channels_last input crashes.)
            x, s = x[:, :, ::s, ::s], 1
        dt = compute_dtype(self.dtype, x, w)
        x, w = x.to(dt), w.to(dt)
        # Under a set compute dtype the bias comes after the convolution's
        # rounding, as in JAX; otherwise it folds into the convolution.
        bias = None if bias is None else bias.to(dt)
        fold = self.dtype is None
        top, bottom = _same_pad(x.shape[2], k, s)
        left, right = _same_pad(x.shape[3], k, s)
        if top == bottom and left == right:
            y = F.conv2d(x, w, bias if fold else None, stride=s,
                         padding=(top, left))
        else:
            x = F.pad(x, (left, right, top, bottom))
            y = F.conv2d(x, w, bias if fold else None, stride=s)
        return y if fold or bias is None else y + bias[:, None, None]


class DepthwiseConv(nn.Module):
    """Depthwise 5x5 convolution, not spectrally normalized.  ``weight`` is
    (C, 1, 5, 5).

    ``use_pallas`` (the JAX flag's name) routes through the hand-written CUDA
    kernels, :func:`~nvae_torch.kernels.depthwise.fused_swish_depthwise5x5`
    (forward, and dx and dW/db in its backward), on the card; on the CPU the
    same autograd Function runs their plain versions.  Otherwise the plain
    PyTorch forward runs under autograd, the counterpart of the JAX module's
    XLA path.  ``fuse_swish`` applies swish to the input first (the
    caller then feeds the pre-activation tensor)."""

    def __init__(self, channels: int, use_bias: bool = True,
                 use_pallas: bool = False, fuse_swish: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_pallas = use_pallas
        self.fuse_swish = fuse_swish
        self.dtype = dtype
        self.tp = None  # the model axis, under the TP layout
        self.weight = nn.Parameter(torch.empty(channels, 1, 5, 5))
        self.bias = nn.Parameter(torch.empty(channels)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        c = self.weight.shape[0]
        # Flax's fans for a (5, 5, 1, C) kernel: 25 * 1 in, 25 * C out.
        glorot_uniform_(self.weight, 25, 25 * c, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.weight)
        # Under TP the weight is this rank's block of channels, and x the
        # same channels: the bias is read as its block.
        own_bias = (self.bias if self.bias is None or self.tp is None
                    else block_of(self.bias, self.tp))
        if self.use_pallas or dt != torch.bfloat16:
            # The kernel's arguments as JAX passes them: x and the taps in
            # the compute dtype, the bias in fp32 (its dtype in float64).
            bias = (None if own_bias is None else
                    own_bias.to(torch.promote_types(dt, torch.float32)))
            x, s = x.to(dt), self.fuse_swish
        else:
            # JAX's XLA path in bf16: swish in x's dtype, then the
            # convolution and the bias in bf16.
            if self.fuse_swish:
                x = swish(x)
            x, bias, s = x.to(dt), None, False
        # An NCHW channels_last tensor is (B, H, W, C)-contiguous once
        # permuted: the kernel reads it in place.
        x = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        taps = self.weight.to(dt).permute(2, 3, 1, 0)
        if self.use_pallas:
            y = fused_swish_depthwise5x5(x, taps, bias, fuse_swish=s)
        elif dt == torch.bfloat16:
            y = depthwise5x5_conv(x, taps)
            if own_bias is not None:
                y = y + own_bias.to(dt)
        else:
            y = fused_swish_depthwise5x5_plain(x, taps, bias, fuse_swish=s)
        return y.permute(0, 3, 1, 2)


def sn_kernel_names(model: nn.Module) -> Tuple[str, ...]:
    """Parameter names of every :class:`SNConv` weight in ``model``: the
    kernels the optimizer's spectral strategies act on (JAX tags them
    ``sn_kernel``)."""
    return tuple(f"{name}.weight" if name else "weight"
                 for name, m in model.named_modules() if isinstance(m, SNConv))
