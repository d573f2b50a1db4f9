"""Fused swish -> depthwise 5x5 convolution: the CUDA kernel's wrappers and
their plain PyTorch version.

Counterpart of ``nvae_tpu/kernels/depthwise.py``:

- :func:`fused_swish_depthwise5x5` replaces the Pallas forward kernel
  ``_fused_fwd_kernel`` (``fwd_call`` of ``_make_fused_dw``);
- :func:`depthwise_conv5x5` replaces the plain ``_dw_kernel``, as a thin entry
  on the same CUDA kernel with swish and bias off.

Both take the JAX package's layout: ``x`` (B, H, W, C), ``kernel``
(5, 5, 1, C), ``bias`` (C,) or None.  A tensor on the CPU goes to the plain
version (:func:`fused_swish_depthwise5x5_plain`: ``F.silu`` ->
``F.conv2d(groups=C)`` -> ``+ b``); a CUDA tensor always launches the kernel
(``csrc/depthwise5x5.cu``) or raises, whatever its shape.  Each wrapper keeps
a plain integer ``launches`` attribute that it increments once per kernel
launch, so a run can show that its path went through the kernel.

The kernel takes fp32 only, for now: the bf16 serving path comes later.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

K = 5
_CHUNK = 32  # channels per block in the CUDA kernel
_TILE_H = 8  # output rows per block in the CUDA kernel, at most
_MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper


def fused_swish_depthwise5x5_plain(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    fuse_swish: bool = True,
) -> torch.Tensor:
    """``dwconv5x5(swish(x)) + bias`` from stock PyTorch ops, NHWC in and out.

    The CPU path of the wrappers and the reference the kernel is held
    against on the card."""
    c = x.shape[-1]
    s = F.silu(x) if fuse_swish else x
    y = F.conv2d(
        s.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
        padding=K // 2, groups=c,
    )
    if bias is not None:
        y = y + bias.view(1, c, 1, 1)
    return y.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from nvae_torch.kernels._build import library

    lib = library("depthwise5x5")
    lib.nvae_dw5x5_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.nvae_dw5x5_fwd.restype = ctypes.c_int
    lib.nvae_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nvae_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor]) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    if tuple(kernel.shape) != (K, K, 1, c):
        raise ValueError(
            f"kernel must be ({K}, {K}, 1, {c}), got {tuple(kernel.shape)}"
        )
    tensors = [("x", x), ("kernel", kernel)]
    if bias is not None:
        if tuple(bias.shape) != (c,):
            raise ValueError(f"bias must be ({c},), got {tuple(bias.shape)}")
        if not bias.is_contiguous():
            raise ValueError("bias must be contiguous")
        tensors.append(("bias", bias))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous in (B, H, W, C) order")
    tile_h = min(h, _TILE_H)
    if b * -(-h // tile_h) > 65535:
        raise ValueError(f"batch {b} x {h} rows exceeds the kernel's grid")
    smem = (K * K + (tile_h + K - 1) * (w + K - 1)) * _CHUNK * 4
    if smem > _MAX_SMEM:
        raise ValueError(
            f"width {w} needs {smem} B of shared memory per block, more "
            f"than the {_MAX_SMEM} B a Hopper block may use"
        )


def _launch(x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor], fuse_swish: bool) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {x.device}")
    _check(x, kernel, bias)
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().nvae_dw5x5_fwd(
        x.data_ptr(), kernel.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(),
        b, h, w, c, kernel.stride(0), kernel.stride(1), kernel.stride(3),
        int(fuse_swish), x.device.index, stream,
    )
    if err != 0:
        msg = _lib().nvae_cuda_error_string(err).decode()
        raise RuntimeError(f"depthwise5x5 kernel launch failed: {msg} ({err})")
    return y


def fused_swish_depthwise5x5(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    fuse_swish: bool = True,
) -> torch.Tensor:
    """``dwconv5x5(swish(x)) + bias`` in one pass over NHWC memory.

    x: (B, H, W, C) contiguous; kernel: (5, 5, 1, C), any strides; bias:
    (C,) or None.  ``fuse_swish=False`` gives a plain depthwise conv."""
    if x.device.type == "cpu":
        return fused_swish_depthwise5x5_plain(
            x, kernel, bias, fuse_swish=fuse_swish
        )
    y = _launch(x, kernel, bias, fuse_swish)
    fused_swish_depthwise5x5.launches += 1
    return y


fused_swish_depthwise5x5.launches = 0


def depthwise_conv5x5(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain depthwise 5x5 conv (no swish, no bias): the thin entry that
    replaces the Pallas ``_dw_kernel``."""
    if x.device.type == "cpu":
        return fused_swish_depthwise5x5_plain(x, kernel, None, fuse_swish=False)
    y = _launch(x, kernel, None, False)
    depthwise_conv5x5.launches += 1
    return y


depthwise_conv5x5.launches = 0
