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
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from nvae_torch.kernels.depthwise import (
    fused_swish_depthwise5x5,
    fused_swish_depthwise5x5_plain,
)


def glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator] = None) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=generator)


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
                 stride: int = 1):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("SAME padding needs an odd kernel size")
        self.mode = mode
        self.stride = int(stride)
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
        comes from the old ``u``, as in JAX)."""
        w = self.weight
        if self.mode == "forward":
            w2d = w.reshape(w.shape[0], -1).t()  # (in * kh * kw, out)
            sigma, u_new = power_iteration(w2d, self.u)
            if self.training:
                with torch.no_grad():
                    self.u.copy_(u_new)
            w = w / sigma
        return w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.weight.shape[-1], self.stride
        if k == 1 and s > 1:
            # A strided 1x1 conv reads every s-th pixel: take them first.
            # (The same result; PyTorch 2.13's CPU backward of a strided
            # 1x1 conv on a channels_last input crashes.)
            x, s = x[:, :, ::s, ::s], 1
        top, bottom = _same_pad(x.shape[2], k, s)
        left, right = _same_pad(x.shape[3], k, s)
        if top == bottom and left == right:
            return F.conv2d(x, self.kernel(), self.bias, stride=s,
                            padding=(top, left))
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.kernel(), self.bias, stride=s)


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
                 use_pallas: bool = False, fuse_swish: bool = False):
        super().__init__()
        self.use_pallas = use_pallas
        self.fuse_swish = fuse_swish
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
        # An NCHW channels_last tensor is (B, H, W, C)-contiguous once
        # permuted: the kernel reads it in place.
        x = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        fn = (fused_swish_depthwise5x5 if self.use_pallas
              else fused_swish_depthwise5x5_plain)
        y = fn(x, self.weight.permute(2, 3, 1, 0), self.bias,
               fuse_swish=self.fuse_swish)
        return y.permute(0, 3, 1, 2)


def sn_kernel_names(model: nn.Module) -> Tuple[str, ...]:
    """Parameter names of every :class:`SNConv` weight in ``model``: the
    kernels the optimizer's spectral strategies act on (JAX tags them
    ``sn_kernel``)."""
    return tuple(f"{name}.weight" if name else "weight"
                 for name, m in model.named_modules() if isinstance(m, SNConv))
