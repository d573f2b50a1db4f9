"""Fused squeeze-and-excitation gate: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``nvae_tpu/kernels/se_gate.py``: :func:`se_gate` replaces the
Pallas ``_se_kernel`` (``se_gate``, ``pl.pallas_call`` at :53) and
:func:`se_gate_reference` is its plain version, the same formula as JAX's
``se_gate_reference``.  Both take the JAX layout, ``x`` (B, H, W, C), ``w1``
(C, Hd), ``b1`` (Hd,), ``w2`` (Hd, C), ``b2`` (C,), and return
``x * sigmoid(relu(mean_hw(x) @ w1 + b1) @ w2 + b2)``.

A tensor on the CPU goes to the plain version; a CUDA tensor always launches
the kernel (``csrc/se_gate.cu``) or raises.  The kernel is forward only, like
JAX's, and takes contiguous fp32 NHWC maps (the memory of the model's
``channels_last`` NCHW tensors).  Like the JAX package, the model does not
call it: :class:`~nvae_torch.nn.blocks.SqueezeExcitation` stays plain ops.
``se_gate.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

_MAX_WARPS = 32  # warps per block in the CUDA kernel, at most
_MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper


def se_gate_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The gate from stock PyTorch ops: the CPU path and the reference the
    kernel is held against on the card."""
    pooled = x.mean(dim=(1, 2))
    h = F.relu(pooled @ w1 + b1)
    g = torch.sigmoid(h @ w2 + b2)
    return x * g[:, None, None, :]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from nvae_torch.kernels._build import library

    lib = library("se_gate")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nvae_se_gate.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.nvae_se_gate.restype = ctypes.c_int
    lib.nvae_se_gate_error_string.argtypes = [ctypes.c_int]
    lib.nvae_se_gate_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, w1, b1, w2, b2) -> None:
    """Raise on what the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if w1.dim() != 2 or w1.shape[0] != c:
        raise ValueError(f"w1 must be ({c}, Hd), got {tuple(w1.shape)}")
    hd = w1.shape[1]
    for name, t, shape in (("b1", b1, (hd,)), ("w2", w2, (hd, c)),
                           ("b2", b2, (c,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    named = (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous"
                             + (" in (B, H, W, C) order" if name == "x" else ""))
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in named):
        raise RuntimeError(
            "se_gate is forward only (as the JAX kernel): call it under "
            "torch.no_grad() or on tensors that do not require grad"
        )
    warps = min(x.shape[1] * x.shape[2], _MAX_WARPS)
    smem = 4 * (2 * c + hd + 32 * warps)
    if smem > _MAX_SMEM:
        raise ValueError(f"{c} channels need {smem} B of shared memory per "
                         f"block, more than the {_MAX_SMEM} B of a Hopper block")


def se_gate(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Fused SE gate ``x * sigmoid(relu(mean_hw(x) @ w1 + b1) @ w2 + b2)``,
    NHWC: one pass to pool, the two dense layers in the same block, one pass
    to gate (see ``csrc/se_gate.cu``)."""
    if x.device.type == "cpu":
        return se_gate_reference(x, w1, b1, w2, b2)
    _check(x, w1, b1, w2, b2)
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    err = _lib().nvae_se_gate(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), b, h * w, c, w1.shape[1],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = _lib().nvae_se_gate_error_string(err).decode()
        raise RuntimeError(f"se_gate launch failed: {msg} ({err})")
    se_gate.launches += 1
    return y


se_gate.launches = 0
