"""The fused swish -> depthwise 5x5 forward (#2) as the registered op
``nvae_torch::fused_swish_dw5x5``.

A ``torch.library`` custom op is what a ``torch.export`` graph records by
name: an exported program that holds it runs wherever this module was
imported, with no model code (``import nvae_torch.kernels`` registers it).
One op covers both instances, fp32 and bf16 ``x`` (bf16 taps, fp32 bias):

- on a CUDA tensor it launches the hand-written kernel
  (``csrc/depthwise5x5.cu``, :func:`~nvae_torch.kernels.depthwise._launch`)
  or raises, and counts the launch in the wrapper's ``launches`` (fp32:
  ``fused_swish_depthwise5x5``, bf16: ``fused_swish_depthwise5x5_bf16``), so
  a call of an exported program counts as an eager call does;
- on a CPU tensor it is the plain version,
  :func:`~nvae_torch.kernels.depthwise.fused_swish_depthwise5x5_plain`, the
  port's per-device rule;
- its fake (meta) version gives ``y`` the shape, dtype and strides of ``x``,
  as the kernel's ``torch.empty_like(x)`` does.

The op has no gradient of its own: the autograd Function
:class:`~nvae_torch.kernels.depthwise.FusedSwishDepthwise5x5` calls it in its
forward and keeps the dx and dW/db kernels as its backward.  This module
imports nothing of ``nvae_torch.models``.
"""

from __future__ import annotations

from typing import Optional

import torch

from nvae_torch.kernels import depthwise as _dw

OP_NAME = "nvae_torch::fused_swish_dw5x5"


@torch.library.custom_op(OP_NAME, mutates_args=())
def fused_swish_dw5x5(x: torch.Tensor, kernel: torch.Tensor,
                      bias: Optional[torch.Tensor],
                      fuse_swish: bool) -> torch.Tensor:
    """``dwconv5x5(swish(x)) + bias`` (``fuse_swish=False``: no swish) of
    NHWC ``x`` by (5, 5, 1, C) taps, (C,) bias or None."""
    raise NotImplementedError(
        f"{OP_NAME} runs on CPU and CUDA tensors, got {x.device}")


@fused_swish_dw5x5.register_kernel("cpu")
def _cpu(x, kernel, bias, fuse_swish):
    return _dw.fused_swish_depthwise5x5_plain(x, kernel, bias,
                                              fuse_swish=fuse_swish)


@fused_swish_dw5x5.register_kernel("cuda")
def _cuda(x, kernel, bias, fuse_swish):
    if x.dtype == torch.bfloat16:
        return _dw.fused_swish_depthwise5x5_bf16(x, kernel, bias,
                                                 fuse_swish=fuse_swish)
    y = _dw._launch(x, kernel, bias, fuse_swish)
    _dw.fused_swish_depthwise5x5.launches += 1
    return y


@fused_swish_dw5x5.register_fake
def _fake(x, kernel, bias, fuse_swish):
    return torch.empty_like(x)
