"""Fused swish -> depthwise 5x5 convolution: the CUDA kernels' wrappers, the
autograd Function around them, and their plain PyTorch versions.

Counterpart of ``nvae_tpu/kernels/depthwise.py``:

- :func:`fused_swish_depthwise5x5` is the op with its gradient
  (:class:`FusedSwishDepthwise5x5`, the counterpart of the ``jax.custom_vjp``
  of ``_make_fused_dw``).  Its forward replaces the Pallas
  ``_fused_fwd_kernel`` (``fwd_call``);
- :func:`fused_swish_depthwise5x5_dx` replaces ``_fused_dx_kernel`` and
  ``_fused_dx_nox_kernel`` (``dx_call``);
- :func:`fused_swish_depthwise5x5_dw` replaces ``_fused_dw_kernel``
  (``dw_call``), in two launches (per-block partial sums, then their sum in a
  fixed order) so that the result is the same bits on every run;
- :func:`depthwise_conv5x5` replaces the plain ``_dw_kernel``, as a thin entry
  on the forward kernel with swish and bias off (forward only, as in JAX).

All take the JAX package's layout: ``x`` (B, H, W, C), ``kernel``
(5, 5, 1, C), ``bias`` (C,) or None.  A tensor on the CPU goes to the plain
version (``*_plain`` below: ``F.silu`` -> ``F.conv2d(groups=C)`` -> ``+ b``
forward; the flipped-tap grouped convolution times ``swish'`` for dx; 25
shifted products and ``dy.sum`` for dW/db); a CUDA tensor always launches the
kernel (``csrc/depthwise5x5.cu``) or raises, whatever its shape.  Each wrapper
keeps a plain integer ``launches`` attribute that it increments once per
kernel launch, so a run can show that its path went through the kernel; the
dW/db wrapper counts its two launches (made by one C call) as one.

The kernels take fp32 only, for now: the bf16 path comes later.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

K = 5
_CHUNK = 32  # channels per block in the CUDA kernels
_TILE_H = 8  # output rows per block in the CUDA kernels, at most
_STRIP = 4  # output rows per thread item
_MAX_WARPS = 8
_SUMS = K * K + 1  # dW/db partials per channel: 25 taps and the bias
_MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
# dW/db stage 1 aims at this many blocks: 8 per SM of an H100's 132.
_DW_TARGET_BLOCKS = 8 * 132


def _swish_grad(x: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def fused_swish_depthwise5x5_plain(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    fuse_swish: bool = True,
) -> torch.Tensor:
    """``dwconv5x5(swish(x)) + bias`` from stock PyTorch ops, NHWC in and out.

    The CPU path of the forward and the reference the kernel is held
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


def fused_swish_depthwise5x5_dx_plain(
    dy: torch.Tensor, kernel: torch.Tensor, x: Optional[torch.Tensor],
    *, fuse_swish: bool = True,
) -> torch.Tensor:
    """dL/dx of the fused op from stock PyTorch ops, NHWC: ``dy`` correlated
    with the spatially flipped taps, times ``swish'(x)`` when swish is fused
    (``x`` is not read otherwise)."""
    c = dy.shape[-1]
    flipped = torch.flip(kernel, dims=(0, 1)).permute(3, 2, 0, 1)
    g = F.conv2d(dy.permute(0, 3, 1, 2), flipped, padding=K // 2, groups=c)
    g = g.permute(0, 2, 3, 1)
    return g * _swish_grad(x) if fuse_swish else g


def fused_swish_depthwise5x5_dw_plain(
    x: torch.Tensor, dy: torch.Tensor, *, fuse_swish: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dL/dkernel (5, 5, 1, C), dL/dbias (C,)) of the fused op from stock
    PyTorch ops: tap (i, j) is the sum over (b, h, w) of the padded
    ``swish(x)`` shifted by (i, j) times ``dy``."""
    b, h, w, c = x.shape
    s = F.silu(x) if fuse_swish else x
    sp = F.pad(s, (0, 0, K // 2, K // 2, K // 2, K // 2))
    taps = [
        (sp[:, i:i + h, j:j + w, :] * dy).sum(dim=(0, 1, 2))
        for i in range(K) for j in range(K)
    ]
    return torch.stack(taps).view(K, K, 1, c), dy.sum(dim=(0, 1, 2))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from nvae_torch.kernels._build import library

    lib = library("depthwise5x5")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nvae_dw5x5_fwd.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i64, i64, i64, i32, i32, ptr,
    ]
    lib.nvae_dw5x5_dx.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i64, i64, i64, i32, ptr,
    ]
    lib.nvae_dw5x5_dw.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr,
    ]
    for fn in (lib.nvae_dw5x5_fwd, lib.nvae_dw5x5_dx, lib.nvae_dw5x5_dw):
        fn.restype = ctypes.c_int
    lib.nvae_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nvae_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().nvae_cuda_error_string(err).decode()
        raise RuntimeError(f"depthwise5x5 {what} launch failed: {msg} ({err})")


def _tile_h(h: int) -> int:
    return min(h, _TILE_H)


def _warps(h: int, w: int) -> int:
    return min(-(-_tile_h(h) // _STRIP) * w, _MAX_WARPS)


def _check(x: torch.Tensor, kernel: Optional[torch.Tensor],
           bias: Optional[torch.Tensor], *others: torch.Tensor) -> None:
    """Raise on what the kernels do not take.  ``others`` are further
    (B, H, W, C) operands (dy, the saved x) held to the rules of ``x``;
    ``kernel`` is None for dW/db, which reads no taps."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    tensors = [("x", x)]
    if kernel is not None:
        if tuple(kernel.shape) != (K, K, 1, c):
            raise ValueError(
                f"kernel must be ({K}, {K}, 1, {c}), got {tuple(kernel.shape)}"
            )
        tensors.append(("kernel", kernel))
    if bias is not None:
        if tuple(bias.shape) != (c,):
            raise ValueError(f"bias must be ({c},), got {tuple(bias.shape)}")
        if not bias.is_contiguous():
            raise ValueError("bias must be contiguous")
        tensors.append(("bias", bias))
    for i, t in enumerate(others):
        if tuple(t.shape) != tuple(x.shape):
            raise ValueError(f"operand {i} has shape {tuple(t.shape)}, "
                             f"x {tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"operand {i} must be contiguous in (B, H, W, C) "
                             "order")
        tensors.append((f"operand {i}", t))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous in (B, H, W, C) order")
    th = _tile_h(h)
    if b * -(-h // th) > 65535:
        raise ValueError(f"batch {b} x {h} rows exceeds the kernel's grid")
    plane = (th + K - 1) * (w + K - 1) * _CHUNK
    smem = 4 * max(K * K * _CHUNK + plane,  # the stencils
                   plane + _warps(h, w) * _SUMS * _CHUNK)  # dW/db stage 1
    if smem > _MAX_SMEM:
        raise ValueError(
            f"width {w} needs {smem} B of shared memory per block, more "
            f"than the {_MAX_SMEM} B a Hopper block may use"
        )


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor], fuse_swish: bool) -> torch.Tensor:
    _require_cuda(x)
    _check(x, kernel, bias)
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    err = _lib().nvae_dw5x5_fwd(
        x.data_ptr(), kernel.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(),
        b, h, w, c, kernel.stride(0), kernel.stride(1), kernel.stride(3),
        int(fuse_swish), x.device.index, _stream(x),
    )
    _raise_on(err, "forward")
    return y


def _forward(x: torch.Tensor, kernel: torch.Tensor,
             bias: Optional[torch.Tensor], fuse_swish: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_swish_depthwise5x5_plain(
            x, kernel, bias, fuse_swish=fuse_swish
        )
    y = _launch(x, kernel, bias, fuse_swish)
    fused_swish_depthwise5x5.launches += 1
    return y


def fused_swish_depthwise5x5_dx(
    dy: torch.Tensor, kernel: torch.Tensor, x: Optional[torch.Tensor],
    *, fuse_swish: bool = True,
) -> torch.Tensor:
    """dL/dx of ``dwconv5x5(swish(x)) + bias`` given ``dy``, NHWC.  ``x`` is
    the forward's input, read only when ``fuse_swish`` (the epilogue's
    ``swish'(x)``); pass None otherwise."""
    if dy.device.type == "cpu":
        return fused_swish_depthwise5x5_dx_plain(
            dy, kernel, x, fuse_swish=fuse_swish
        )
    _require_cuda(dy)
    if fuse_swish and x is None:
        raise ValueError("the swish' epilogue needs the forward's x")
    _check(dy, kernel, None, *((x,) if fuse_swish else ()))
    b, h, w, c = dy.shape
    dx = torch.empty_like(dy)
    err = _lib().nvae_dw5x5_dx(
        dy.data_ptr(), kernel.data_ptr(),
        x.data_ptr() if fuse_swish else None, dx.data_ptr(),
        b, h, w, c, kernel.stride(0), kernel.stride(1), kernel.stride(3),
        dy.device.index, _stream(dy),
    )
    _raise_on(err, "dx")
    fused_swish_depthwise5x5_dx.launches += 1
    return dx


fused_swish_depthwise5x5_dx.launches = 0


def dw_parts(x_shape) -> int:
    """Blocks along the batch axis of dW/db stage 1 (the partials' leading
    size): enough, with the channel chunks, for ``_DW_TARGET_BLOCKS``, and no
    more than there are (batch row, row tile) units."""
    b, h, _, c = x_shape
    units = b * -(-h // _tile_h(h))
    chunks = -(-c // _CHUNK)
    return max(1, min(units, -(-_DW_TARGET_BLOCKS // chunks)))


def fused_swish_depthwise5x5_dw(
    x: torch.Tensor, dy: torch.Tensor, *, fuse_swish: bool = True,
    with_bias: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dL/dkernel (5, 5, 1, C), dL/dbias (C,) or None) of the fused op,
    fp32, from its input ``x`` and ``dy``, NHWC.  On the card: two kernel
    launches with no atomics (partial sums over (batch row, row tile) units
    per block, then their sum in a fixed order), so two runs on the same
    input give the same bits."""
    if x.device.type == "cpu":
        dk, db = fused_swish_depthwise5x5_dw_plain(x, dy, fuse_swish=fuse_swish)
        return dk, db if with_bias else None
    _require_cuda(x)
    b, h, w, c = x.shape
    _check(x, None, None, dy)
    n_parts = dw_parts(x.shape)
    partial = torch.empty(n_parts, _SUMS, c, device=x.device,
                          dtype=torch.float32)
    dk = torch.empty(K, K, 1, c, device=x.device, dtype=torch.float32)
    db = (torch.empty(c, device=x.device, dtype=torch.float32)
          if with_bias else None)
    err = _lib().nvae_dw5x5_dw(
        x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dk.data_ptr(),
        db.data_ptr() if with_bias else None, b, h, w, c, n_parts,
        int(fuse_swish), x.device.index, _stream(x),
    )
    _raise_on(err, "dW/db")
    fused_swish_depthwise5x5_dw.launches += 1
    return dk, db


fused_swish_depthwise5x5_dw.launches = 0


class FusedSwishDepthwise5x5(torch.autograd.Function):
    """``dwconv5x5(swish(x)) + bias`` with its gradient: the counterpart of
    the ``jax.custom_vjp`` of ``_make_fused_dw``.  The forward saves
    ``(x, kernel)``; the backward computes dx with the dx kernel and dW/db
    with the dW/db kernels, each only where an input needs it.  On CPU
    tensors every stage takes its plain version (explicit formulas, not
    autograd of the plain forward)."""

    @staticmethod
    def forward(ctx, x, kernel, bias, fuse_swish):
        ctx.fuse_swish = bool(fuse_swish)
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, kernel)
        return _forward(x, kernel, bias, ctx.fuse_swish)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        # The kernels read NHWC-contiguous memory: this copies only when
        # autograd hands over the gradient in another layout.
        dy = dy.contiguous()
        dx = dk = db = None
        if ctx.needs_input_grad[0]:
            dx = fused_swish_depthwise5x5_dx(
                dy, kernel, x if ctx.fuse_swish else None,
                fuse_swish=ctx.fuse_swish,
            )
        want_db = ctx.has_bias and ctx.needs_input_grad[2]
        if ctx.needs_input_grad[1] or want_db:
            dk, db = fused_swish_depthwise5x5_dw(
                x, dy, fuse_swish=ctx.fuse_swish, with_bias=want_db,
            )
            if not ctx.needs_input_grad[1]:
                dk = None
        return dx, dk, db, None


def fused_swish_depthwise5x5(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    fuse_swish: bool = True,
) -> torch.Tensor:
    """``dwconv5x5(swish(x)) + bias`` in one pass over NHWC memory, with its
    gradient (:class:`FusedSwishDepthwise5x5`).

    x: (B, H, W, C) contiguous; kernel: (5, 5, 1, C), any strides; bias:
    (C,) or None.  ``fuse_swish=False`` gives a plain depthwise conv."""
    return FusedSwishDepthwise5x5.apply(x, kernel, bias, fuse_swish)


fused_swish_depthwise5x5.launches = 0


def depthwise_conv5x5(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain depthwise 5x5 conv (no swish, no bias): the thin entry that
    replaces the Pallas ``_dw_kernel``, forward only."""
    if x.device.type == "cpu":
        return fused_swish_depthwise5x5_plain(x, kernel, None, fuse_swish=False)
    y = _launch(x, kernel, None, False)
    depthwise_conv5x5.launches += 1
    return y


depthwise_conv5x5.launches = 0
