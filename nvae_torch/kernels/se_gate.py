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
import dataclasses
import functools

import torch
import torch.nn.functional as F

# Threads per block of the CUDA kernel: 128, or 256 where a cluster is one
# block (a whole row on one SM, with little else to run there).
_THREADS = 128
_THREADS_ALONE = 256
_MAX_CLUSTER = 8  # blocks per cluster the C entry takes: the portable limit
# Blocks per cluster the geometry takes where the shape allows.  On an H100
# at the model's SE shapes the card holds only 124 clusters of 8
# (cudaOccupancyMaxActiveClusters), fewer than batch 144 needs for one wave,
# and clusters of 2 ran as fast as clusters of 4 or faster (PERF.md, §6).
_CLUSTER = 2
# The most x a block takes before the row is split further: past it a
# second block pays back the exchange (PERF.md, §6).
_SLICE_FLOATS = 8192
_MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
_BARRIER_BYTES = 16  # the block's mbarrier, before its floats


def se_gate_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The gate from stock PyTorch ops: the CPU path and the reference the
    kernel is held against on the card."""
    pooled = x.mean(dim=(1, 2))
    h = F.relu(pooled @ w1 + b1)
    g = torch.sigmoid(h @ w2 + b2)
    return x * g[:, None, None, :]


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _smem_bytes(hw: int, c: int, hd: int, k: int,
                threads: int = _THREADS) -> int:
    """A block's shared memory (``layout`` in ``csrc/se_gate.cu``, which the
    entry point holds the geometry to): the mbarrier, then, each on 16
    bytes, the pixel slice (ceil(HW / k) x C), the thread groups' pool sums
    (one row of C per group of C / 4 float4 lanes, or of C lanes where
    C % 4 != 0), the block's pool sums (C), w1 and w2 (C x Hd each), b1,
    b2, the first layer's sums over channel groups (max(threads, Hd)), the
    k blocks' first-layer sums (k x Hd), hidden and the gate."""
    npix = -(-hw // k)
    lanes = c // 4 if c % 4 == 0 else c
    groups = max(1, threads // lanes)
    floats = (npix * c, groups * c, c, c * hd, hd * c, hd, c,
              max(threads, hd), k * hd, hd, c)
    return _BARRIER_BYTES + 4 * sum(_round4(n) for n in floats)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Launch geometry of the gate at one shape; see ``csrc/se_gate.cu``.
    Batch row ``b`` is cluster ``b`` of ``cluster`` blocks; block ``r`` of a
    cluster owns the pixels :meth:`pixels` (r)."""

    batch: int
    hw: int
    c: int
    hd: int
    cluster: int
    threads: int
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return self.batch * self.cluster

    def pixels(self, rank: int) -> range:
        k = self.cluster
        return range(rank * self.hw // k, (rank + 1) * self.hw // k)

    def c_array(self):
        """The geometry as the C entry points take it."""
        return (ctypes.c_int * 3)(self.cluster, self.threads, self.smem_bytes)


@functools.lru_cache(maxsize=None)
def geometry(b: int, hw: int, c: int, hd: int) -> Geometry:
    """The launch geometry of the gate at batch ``b``, ``hw`` = H * W pixels,
    ``c`` channels and ``hd`` hidden units: a pure function of the shape (no
    device query), so one shape gets one summation order, and one set of
    bits, on any card.  :func:`_check` and the wrapper read it, and the C
    entry refuses a geometry whose shared bytes disagree with its own
    formula.

    The cluster size k is the fewest blocks that keep each block's slice of
    x within ``_SLICE_FLOATS`` (32 KB), at most 2: one block per row at
    4x4x256 and 8x8x128, 2 at 16x16x64 and 32x32x32.  A block alone in its
    cluster has 256 threads, else 128.  Where the slice does not fit a
    block's shared memory, k grows up to 8; a shape that still does not fit
    raises ``ValueError``.  Every block reads the weights whole (2 C Hd
    floats), so the weights bound C from above too."""
    b, hw, c, hd = (int(v) for v in (b, hw, c, hd))
    if min(b, hw, c, hd) < 1:
        raise ValueError(f"empty shape: batch {b}, H*W {hw}, C {c}, hidden {hd}")
    k = max(1, min(_CLUSTER, hw, -(-hw * c // _SLICE_FLOATS)))

    def threads():
        return _THREADS_ALONE if k == 1 else _THREADS

    while (_smem_bytes(hw, c, hd, k, threads()) > _MAX_SMEM
           and k < min(_MAX_CLUSTER, hw)):
        k += 1
    smem = _smem_bytes(hw, c, hd, k, threads())
    if smem > _MAX_SMEM:
        raise ValueError(
            f"{c} channels at H*W {hw} and hidden {hd} need {smem} B of "
            f"shared memory per block, more than the {_MAX_SMEM} B a Hopper "
            "block may use"
        )
    return Geometry(b, hw, c, hd, k, threads(), smem)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from nvae_torch.kernels._build import library

    lib = library("se_gate")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    geo = ctypes.POINTER(ctypes.c_int)
    lib.nvae_se_gate.argtypes = [ptr] * 6 + [i32] * 4 + [geo, i32, ptr]
    lib.nvae_se_gate.restype = ctypes.c_int
    lib.nvae_se_gate_max_active_clusters.argtypes = [i32] * 4 + [
        geo, i32, ctypes.POINTER(ctypes.c_int)]
    lib.nvae_se_gate_max_active_clusters.restype = ctypes.c_int
    lib.nvae_se_gate_error_string.argtypes = [ctypes.c_int]
    lib.nvae_se_gate_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().nvae_se_gate_error_string(err).decode()
        raise RuntimeError(f"se_gate {what} failed: {msg} ({err})")


def max_active_clusters(geo: Geometry, device: int = 0) -> int:
    """How many clusters of ``geo`` the card ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters``): a device query, for logs only."""
    out = ctypes.c_int(0)
    err = _lib().nvae_se_gate_max_active_clusters(
        geo.batch, geo.hw, geo.c, geo.hd, geo.c_array(), device,
        ctypes.byref(out))
    _raise_on(err, "occupancy query")
    return out.value


def _check(x, w1, b1, w2, b2) -> Geometry:
    """Raise on what the kernel does not take; return its geometry."""
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
    b, h, w, _ = x.shape
    return geometry(b, h * w, c, hd)


def se_gate(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
            w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Fused SE gate ``x * sigmoid(relu(mean_hw(x) @ w1 + b1) @ w2 + b2)``,
    NHWC: one cluster per batch row reads x once into shared memory, pools
    it, runs the dense layers over its blocks and gates the copy on chip
    (see ``csrc/se_gate.cu``)."""
    if x.device.type == "cpu":
        return se_gate_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got {x.device}")
    geo = _check(x, w1, b1, w2, b2)
    y = torch.empty_like(x)
    err = _lib().nvae_se_gate(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), geo.batch, geo.hw, geo.c, geo.hd,
        geo.c_array(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(err, "launch")
    se_gate.launches += 1
    return y


se_gate.launches = 0
