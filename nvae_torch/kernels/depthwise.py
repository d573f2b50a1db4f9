"""Fused swish -> depthwise 5x5 convolution: the CUDA kernels' wrappers, the
autograd Function around them, and their plain PyTorch versions.

Counterpart of ``nvae_tpu/kernels/depthwise.py``:

- :func:`fused_swish_depthwise5x5` is the op with its gradient
  (:class:`FusedSwishDepthwise5x5`, the counterpart of the ``jax.custom_vjp``
  of ``_make_fused_dw``).  Its forward replaces the Pallas
  ``_fused_fwd_kernel`` (``fwd_call``) and runs as the registered op
  ``nvae_torch::fused_swish_dw5x5`` (``ops.py``);
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

A CUDA graph can capture every wrapper: each launches on the current
stream, allocates its outputs from PyTorch's allocator and reads nothing
back to the host; the library is built and loaded by the first call, which
must come before a capture (``train/epoch_runner.py`` runs an eager step
first).  A capture counts its launches in ``launches``, as a call does; the
launches of the graph's replays go to ``replayed`` (:func:`count_replays`).

Every kernel also takes bf16 operands (the Pallas kernels under
``compute_dtype=bfloat16``): the forward bf16 ``x`` and taps with an fp32
bias (swish and the 25 taps in fp32, the bias in fp32, ``y`` rounded to bf16
once); dx bf16 ``dy``, taps and ``x`` (the flipped taps summed in fp32, times
``swish'(x)`` in fp32, ``dx`` rounded to bf16 once); dW/db bf16 ``x`` and
``dy`` (fp32 sums, as in fp32).  Their CUDA launches go through
:func:`fused_swish_depthwise5x5_bf16`, :func:`fused_swish_depthwise5x5_dx_bf16`
and :func:`fused_swish_depthwise5x5_dw_bf16`, which count them apart from the
fp32 ones.  The backward rounds dW to the taps' dtype, as JAX's ``f_bwd``
does; db stays fp32, the bias's dtype.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

K = 5
_CHUNK = 32  # channels per block in the CUDA kernels, one per lane
_RUN = 4  # adjacent outputs along W per thread item
_ROWS = 2  # adjacent output rows per thread item
_HALO = K - 1  # zero ring slots per image (two above, two below)
_WARPS = 8
_THREADS = _WARPS * _CHUNK
_SUMS = K * K + 1  # dW/db partials per channel: 25 taps and the bias
_MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
# The H100 the schedule is laid out for: 132 SMs of 233,472 bytes of shared
# memory, of which the runtime keeps 1 KB per block, and at most 4 blocks of
# 256 threads per SM (``__launch_bounds__``: 64 registers a thread).
_SMS = 132
_SM_SMEM = 233_472
_BLOCK_RESERVED_SMEM = 1024
_MIN_BLOCKS = 4
_MAX_AHEAD = 8  # passes of copies in flight, at most
_IN_FLIGHT = 8_192  # bytes of copies a block keeps in flight, at least
# A block's shared memory that still lets three share an SM.
_OCC_SMEM = _SM_SMEM // 3 - _BLOCK_RESERVED_SMEM
_KINDS = ("fwd", "dx", "dw")
# The bf16 kernels (``dw5x5_bf16``, the sliding-row kernel): a warp is one
# chunk's column strip of 4 outputs, a pass 5 slots (the register
# rotation), up to 1024 threads a block.  Registers a thread may use, by
# kernel and the block size a build is for (its ``__launch_bounds__``).
_BF16_STRIP = 4
_BF16_PERIOD = 5
_BF16_MAX_THREADS = 1024
_BF16_REGS = {"fwd": {256: 80, 512: 128, 1024: 64},
              "dx": {256: 128, 512: 128, 1024: 64},
              "dw": {256: 128, 512: 128, 1024: 64}}
_SM_REGS = 65_536
_SM_THREADS = 2048
_SM_BLOCKS = 32
# The widest W each bf16 kernel takes: its shared memory (the forward: its
# 1024 threads) fits a block up to there.
BF16_WIDEST = {"fwd": 128, "dx": 100, "dw": 88}
# Element types of x, the taps and y, by name as ``geometry`` takes them.
_DTYPES = ("float32", "bfloat16")


def _swish_grad(x: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def depthwise5x5_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME depthwise 5x5 convolution of NHWC ``x`` by (5, 5, 1, C) taps,
    one ``F.conv2d(groups=C)`` in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 padding=K // 2, groups=x.shape[-1])
    return y.permute(0, 2, 3, 1)


def fused_swish_depthwise5x5_plain(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    fuse_swish: bool = True,
) -> torch.Tensor:
    """``dwconv5x5(swish(x)) + bias`` from stock PyTorch ops, NHWC in and out.

    The CPU path of the forward and the reference the kernel is held
    against on the card.  bf16 ``x`` takes the Pallas kernel's bf16
    semantics (:func:`_plain_bf16`)."""
    if x.dtype == torch.bfloat16:
        return _plain_bf16(x, kernel, bias, fuse_swish)
    y = depthwise5x5_conv(F.silu(x) if fuse_swish else x, kernel)
    return y if bias is None else y + bias


def _stencil_f32(s: torch.Tensor, taps: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The 25 taps over fp32 NHWC ``s``, summed in fp32 in dy-major,
    dx-minor order, then the bias: the Pallas kernel's sum."""
    b, h, w, c = s.shape
    sp = F.pad(s, (0, 0, K // 2, K // 2, K // 2, K // 2))
    taps = taps.float().reshape(K, K, c)
    acc = torch.zeros_like(s)
    for i in range(K):
        for j in range(K):
            acc = acc + sp[:, i:i + h, j:j + w, :] * taps[i, j]
    return acc if bias is None else acc + bias.float()


def _plain_bf16(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor], fuse_swish: bool) -> torch.Tensor:
    """The bf16 forward as the Pallas kernel computes it
    (``_fused_fwd_kernel``): ``x`` widened to fp32, swish in fp32, the 25
    taps (widened) summed in fp32, the bias added in fp32, and ``y``
    rounded to bf16 once."""
    s = F.silu(x.float()) if fuse_swish else x.float()
    return _stencil_f32(s, kernel, bias).to(torch.bfloat16)


# How far the bf16 forward may lie from its plain version.  The two round
# the same 25-product fp32 sum differently (the kernel's FMAs, __expf and
# __fdividef), by a few fp32 ulps of the sum's scale |b| + sum |s(x) w|
# (``bf16_sum_scale``); the one rounding to bf16 may then go either way.
# Rounding s(x) to bf16 before the taps is off by up to 2^-9 of that scale.
BF16_SUM_ULPS = 32  # fp32 ulps of the scale, past one bf16 ulp
BF16_MIN_EQUAL_SHARE = 0.999  # of outputs bitwise equal to the plain version


def bf16_sum_scale(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, *,
                   fuse_swish: bool = True) -> torch.Tensor:
    """``|bias| + sum |s(x) * w|`` per output, fp32: the scale of the sum
    the bf16 forward rounds once."""
    s = F.silu(x.float()) if fuse_swish else x.float()
    return _stencil_f32(s.abs(), kernel.float().abs(),
                        None if bias is None else bias.abs())


def _f32_ulp(v: torch.Tensor) -> torch.Tensor:
    """The fp32 spacing above ``v >= 0`` (exact: adjacent floats)."""
    return torch.nextafter(v, torch.full_like(v, float("inf"))) - v


def bf16_sum_ulps(got: torch.Tensor, want: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """Per output, by how many fp32 ulps of ``scale`` the bf16 forward's
    ``|got - want|`` exceeds one bf16 ulp of the larger result (0 within
    it): at most ``BF16_SUM_ULPS`` against its plain version."""
    larger = torch.maximum(got.float().abs(), want.float().abs())
    # A bf16 value's bf16 spacing is its fp32 spacing times 2^16.
    excess = (got.float() - want.float()).abs() - 65536.0 * _f32_ulp(larger)
    return excess.clamp(min=0.0) / _f32_ulp(scale)


def fused_swish_depthwise5x5_dx_plain(
    dy: torch.Tensor, kernel: torch.Tensor, x: Optional[torch.Tensor],
    *, fuse_swish: bool = True,
) -> torch.Tensor:
    """dL/dx of the fused op from stock PyTorch ops, NHWC: ``dy`` correlated
    with the spatially flipped taps, times ``swish'(x)`` when swish is fused
    (``x`` is not read otherwise).  bf16 ``dy`` takes the Pallas kernel's
    bf16 semantics (:func:`_dx_plain_bf16`)."""
    if dy.dtype == torch.bfloat16:
        return _dx_plain_bf16(dy, kernel, x, fuse_swish)
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
    ``swish(x)`` shifted by (i, j) times ``dy``.  bf16 ``x`` and ``dy``
    take the Pallas kernel's bf16 semantics (:func:`_dw_plain_bf16`): the
    sums stay fp32."""
    if x.dtype == torch.bfloat16:
        return _dw_plain_bf16(x, dy, fuse_swish)
    b, h, w, c = x.shape
    s = F.silu(x) if fuse_swish else x
    sp = F.pad(s, (0, 0, K // 2, K // 2, K // 2, K // 2))
    taps = [
        (sp[:, i:i + h, j:j + w, :] * dy).sum(dim=(0, 1, 2))
        for i in range(K) for j in range(K)
    ]
    return torch.stack(taps).view(K, K, 1, c), dy.sum(dim=(0, 1, 2))


def _dx_plain_bf16(dy: torch.Tensor, kernel: torch.Tensor,
                   x: Optional[torch.Tensor], fuse_swish: bool) -> torch.Tensor:
    """The bf16 dx as the Pallas kernel computes it (``_fused_dx_kernel``):
    ``dy`` widened to fp32, the 25 flipped taps (widened) summed in fp32 in
    dy-major, dx-minor order, times ``swish'(x)`` computed in fp32 from the
    widened ``x``, and ``dx`` rounded to bf16 once."""
    g = _stencil_f32(dy.float(), torch.flip(kernel, dims=(0, 1)), None)
    if fuse_swish:
        g = g * _swish_grad(x.float())
    return g.to(torch.bfloat16)


def _dw_plain_bf16(x: torch.Tensor, dy: torch.Tensor,
                   fuse_swish: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 dW/db as the Pallas kernel computes them
    (``_fused_dw_kernel``): fp32 sums of the widened ``swish(x)`` times the
    widened ``dy``, and of ``dy``; both stay fp32."""
    return fused_swish_depthwise5x5_dw_plain(x.float(), dy.float(),
                                             fuse_swish=fuse_swish)


def bf16_dx_scale(dy: torch.Tensor, kernel: torch.Tensor,
                  x: Optional[torch.Tensor], *,
                  fuse_swish: bool = True) -> torch.Tensor:
    """``|swish'(x)| * sum |dy * w|`` per output (``sum |dy * w|`` without
    swish), fp32: the scale of the product the bf16 dx rounds once."""
    s = _stencil_f32(dy.float().abs(), torch.flip(kernel, dims=(0, 1)).abs(),
                     None)
    return s * _swish_grad(x.float()).abs() if fuse_swish else s


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from nvae_torch.kernels._build import library

    lib = library("depthwise5x5")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    geo = ctypes.POINTER(ctypes.c_int)
    lib.nvae_dw5x5_fwd.argtypes = lib.nvae_dw5x5_fwd_bf16.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i64, i64, i64, i32, geo, i32,
        ptr,
    ]
    lib.nvae_dw5x5_dx.argtypes = lib.nvae_dw5x5_dx_bf16.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i64, i64, i64, geo, i32, ptr,
    ]
    lib.nvae_dw5x5_dw.argtypes = lib.nvae_dw5x5_dw_bf16.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, geo, i32, ptr,
    ]
    for fn in (lib.nvae_dw5x5_fwd, lib.nvae_dw5x5_fwd_bf16, lib.nvae_dw5x5_dx,
               lib.nvae_dw5x5_dx_bf16, lib.nvae_dw5x5_dw,
               lib.nvae_dw5x5_dw_bf16):
        fn.restype = ctypes.c_int
    lib.nvae_dw5x5_bf16_blocks_per_sm.argtypes = [i32, i32, i32, i32]
    lib.nvae_dw5x5_bf16_blocks_per_sm.restype = ctypes.c_int
    lib.nvae_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nvae_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().nvae_cuda_error_string(err).decode()
        raise RuntimeError(f"depthwise5x5 {what} launch failed: {msg} ({err})")


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Launch geometry of one kernel at one (B, H, W, C) shape; see
    ``csrc/depthwise5x5.cu``.  Block ``i`` of the grid is channel chunk
    ``i // blocks_per_chunk`` and walks, in order, the batch rows of part
    ``i % blocks_per_chunk``; its ring is filled ``slots_per_pass`` rows per
    pass, ``ahead`` passes in flight."""

    batch: int
    chunks: int
    blocks_per_chunk: int
    slots_per_pass: int
    ahead: int
    threads: int
    smem_bytes: int
    # Channel chunks a block takes (the bf16 kernels: a power of two; the
    # row ring: 1).  ``blocks_per_chunk`` then counts the blocks
    # of each group of this many chunks.
    chunks_per_block: int = 1

    @property
    def groups(self) -> int:
        return -(-self.chunks // self.chunks_per_block)

    @property
    def blocks(self) -> int:
        return self.groups * self.blocks_per_chunk

    def batch_rows(self, part: int) -> range:
        """The batch rows part ``part`` walks, in order (as the kernel)."""
        n = self.blocks_per_chunk
        return range(part * self.batch // n, (part + 1) * self.batch // n)

    def block_chunks(self, block: int) -> range:
        """The channel chunks grid block ``block`` takes."""
        k = self.chunks_per_block
        g = block // self.blocks_per_chunk
        return range(g * k, min(self.chunks, (g + 1) * k))

    def c_array(self):
        """The geometry as the C entry points take it."""
        return (ctypes.c_int * 5)(self.blocks_per_chunk, self.slots_per_pass,
                                  self.ahead, self.threads, self.smem_bytes)


def _smem_bytes(kind: str, w: int, per_pass: int, ahead: int) -> int:
    """A block's shared memory in the row ring: the ring of (P + 1) G + 4
    rows of (W' + 4) x 32 fp32, the aux ring of (P + 1) G rows of W' x 32
    (dx, dW/db), W rounded up to W' = whole runs of 4 outputs, and for
    dW/db at least the warps' 26 sums (they alias the ring)."""
    rows = (ahead + 1) * per_pass
    padded = -(-w // _RUN) * _RUN
    floats = (rows + _HALO) * (padded + _HALO) * _CHUNK
    if kind != "fwd":
        floats += rows * padded * _CHUNK
    if kind == "dw":
        floats = max(floats, _WARPS * _SUMS * _CHUNK)
    return 4 * floats


def _bf16_smem_bytes(kind: str, w: int, per_pass: int, ahead: int,
                     chunks_per_block: int) -> int:
    """A block's shared memory in the bf16 kernels: the fp32 ring of 2 G
    (dW/db: 2 G + 2) rows of (S * 4 + 4) x 32 K, S = ceil(W / 4) strips
    and K chunks, for dW/db at least the warps' 26 sums (they alias it),
    then the bf16 staging rows of W x 32 K: P G of x (dx: dy), and for
    dW/db and dx (P + 1) G of g or x; for the forward two 4 x 32 bf16
    store tiles a warp (dx stores through its x rows)."""
    strips = -(-w // _BF16_STRIP)
    kc = _CHUNK * chunks_per_block
    floats = ((2 * per_pass + (2 if kind == "dw" else 0))
              * (strips * _BF16_STRIP + _HALO) * kc)
    if kind == "dw":
        floats = max(floats, strips * chunks_per_block * _SUMS * _CHUNK)
    staged = ahead * per_pass + ((ahead + 1) * per_pass if kind != "fwd"
                                 else 0)
    # The forward's store tiles: two of 4 x 32 bf16 a warp.
    tiles = (strips * chunks_per_block * 2 * _BF16_STRIP * _CHUNK
             if kind == "fwd" else 0)
    return 4 * floats + 2 * (staged * w * kc + tiles)


def _bf16_geometry(kind: str, b: int, h: int, w: int, c: int) -> Geometry:
    """A bf16 kernel's geometry (see :func:`geometry`), as the sweeps of
    ``chip_ring_probe.py --bf16`` found best at the path shapes (PERF.md,
    section 6); dx takes the forward's rule (the same stencil).

    - strips S = ceil(W / 4), one warp each per chunk, at most 32 (W <=
      128: 1024 threads); the rings fit a block up to ``BF16_WIDEST[kind]``
      columns (the forward 128, dx 100, dW/db 88), and a wider W raises;
    - chunks a block K, a power of two no more than the chunks: the
      forward and dx max(1, 2 // S), dW/db max(1, 4 // S) (two to four
      warps where the rows are short, a warp a strip where they are long);
    - slots per pass G = 5; passes ahead P: the forward and dx 1, dW/db 2
      where that keeps as many blocks an SM as 1 does;
    - blocks an SM: as many as the build's registers, the threads and the
      shared memory allow;
    - blocks: the forward one image a block, or 24 // (H + 4) images
      where they are short; dx two images a block up to H = 16, one past
      it (the sweep of ``chip_ring_probe.py --bf16 --sweep dx``); dW/db as
      :func:`_bf16_dw_parts` finds best."""
    strips = -(-w // _BF16_STRIP)
    chunks = -(-c // _CHUNK)
    if strips * _CHUNK > _BF16_MAX_THREADS:
        raise ValueError(
            f"the bf16 {kind} kernel takes W <= 128 (one warp per 4 columns, "
            f"at most {_BF16_MAX_THREADS} threads a block), got shape "
            f"{(b, h, w, c)}")
    per_pass = _BF16_PERIOD
    want = max(1, (4 if kind == "dw" else 2) // strips)
    k = 1
    while k * 2 <= min(want, chunks):
        k *= 2
    threads = _CHUNK * strips * k
    build = 256 if threads <= 256 else 512 if threads <= 512 else 1024
    most = min(_SM_REGS // (_BF16_REGS[kind][build] * threads),
               _SM_THREADS // threads, _SM_BLOCKS)

    def smem(ahead):
        return _bf16_smem_bytes(kind, w, per_pass, ahead, k)

    def per_sm(ahead):
        return min(most, _SM_SMEM // (smem(ahead) + _BLOCK_RESERVED_SMEM))

    if smem(1) > _MAX_SMEM:
        raise ValueError(
            f"width {w} needs {smem(1)} B of shared memory per block in the "
            f"bf16 {kind} kernel, more than the {_MAX_SMEM} B a Hopper block "
            f"may use (shape {(b, h, w, c)})")
    ahead = 2 if (kind == "dw" and smem(2) <= _MAX_SMEM
                  and per_sm(2) == per_sm(1)) else 1
    groups = -(-chunks // k)
    if kind == "dw":
        parts = _bf16_dw_parts(b, h, w, c, groups, k, per_sm(ahead))
    elif kind == "dx":
        parts = -(-b // max(1, min(2, 40 // (h + _HALO))))
    else:
        parts = -(-b // max(1, 24 // (h + _HALO)))
    return Geometry(b, chunks, parts, per_pass, ahead, threads,
                    smem(ahead), k)


def _bf16_dw_parts(b: int, h: int, w: int, c: int, groups: int, k: int,
                   per_sm: int) -> int:
    """Blocks per chunk group of the bf16 dW/db: the batch rows split evenly
    into parts, at least enough for two blocks on every SM (where the batch
    has them), and among those the count that makes the busiest SM's share
    least.  Blocks spread evenly over the SMs, an SM taking its share at
    about half of its part of the HBM rate whatever its blocks; the partial
    sums (written by stage 1, read by the reduction) cost their bytes at
    the HBM rate."""
    hbm = 3.35e12
    img_bytes = h * w * _CHUNK * k * 2 * 2  # an image's x and g, bf16
    least = min(b, -(-_SMS * min(per_sm, 2) // groups))
    best = None
    for rows in range(1, b + 1):
        parts = -(-b // rows)
        if parts < least:
            break
        if rows > 1 and -(-b // (rows - 1)) == parts:
            continue
        t = (-(-groups * parts // _SMS) * rows * img_bytes / (0.5 * hbm / _SMS)
             + 2 * parts * _SUMS * c * 4 / hbm)
        if best is None or t < best[0]:
            best = (t, parts)
    return best[1] if best else b


@functools.lru_cache(maxsize=None)
def geometry(kind: str, shape: Tuple[int, int, int, int],
             dtype: str = "float32") -> Geometry:
    """The launch geometry of kernel ``kind`` at (B, H, W, C) ``shape`` for
    elements of ``dtype`` ("float32" or "bfloat16"): a pure function of
    the shape and of the constants above, so one shape gets one schedule
    (and one set of dW bits) on any card.  The wrappers,
    :func:`_check` and :func:`dw_parts` read it, and the C entry points
    refuse a geometry whose shared bytes disagree with their own formula.
    bf16 takes the sliding-row kernel (:func:`_bf16_geometry`); fp32 the
    row ring:

    - slots per pass G (even: an item is two rows' run of 4 columns):
      enough items for one per warp: 32 at 4x4 (four images), 12 at 8x8, 6
      at 16x16, 4 at 32x32;
    - passes ahead P: at least ``_IN_FLIGHT`` bytes of copies in flight;
    - then G shrinks (2 at a time) until three blocks fit an SM
      (``_OCC_SMEM``), and P and G until one fits at all;
    - blocks: at most one wave at the occupancy the shared memory allows
      (at most ``_MIN_BLOCKS`` per SM), the batch rows split evenly: as
      few blocks as give the least rows per block, since a block's rows
      set the kernel's time.  Part j of a chunk walks rows
      [j B / n, (j + 1) B / n)."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    if dtype not in _DTYPES:
        raise ValueError(f"no {kind} kernel for {dtype}")
    b, h, w, c = (int(s) for s in shape)
    if dtype == "bfloat16":
        return _bf16_geometry(kind, b, h, w, c)
    chunks = -(-c // _CHUNK)
    runs = -(-w // _RUN)
    per_pass = _ROWS * -(-_WARPS * (h + _HALO) // (h * runs))
    # Bytes a pass copies from HBM: its H / (H + 4) real rows, and g or x
    # beside them for dx and dW/db.
    row_bytes = w * _CHUNK * 4 * (1 if kind == "fwd" else 2)
    ahead = -(-_IN_FLIGHT * (h + _HALO) // (per_pass * h * row_bytes))
    ahead = min(_MAX_AHEAD, max(1, ahead))

    def smem():
        return _smem_bytes(kind, w, per_pass, ahead)

    while smem() > _OCC_SMEM and per_pass > _ROWS:
        per_pass -= _ROWS
    while smem() > _MAX_SMEM and (ahead > 1 or per_pass > _ROWS):
        if ahead > 1:
            ahead -= 1
        else:
            per_pass -= _ROWS
    if smem() > _MAX_SMEM:
        raise ValueError(
            f"width {w} needs {smem()} B of shared memory per block, more "
            f"than the {_MAX_SMEM} B a Hopper block may use"
        )
    per_sm = min(_MIN_BLOCKS, _SM_SMEM // (smem() + _BLOCK_RESERVED_SMEM))
    cap = min(b, max(1, _SMS * per_sm // chunks))
    rows = -(-b // cap)
    return Geometry(b, chunks, -(-b // rows), per_pass, ahead, _THREADS,
                    smem())


def _check(x: torch.Tensor, kernel: Optional[torch.Tensor],
           bias: Optional[torch.Tensor], *others: torch.Tensor,
           kind: str = "fwd") -> None:
    """Raise on what the kernels do not take.  ``others`` are further
    (B, H, W, C) operands (dy, the saved x) held to the rules of ``x``;
    ``kernel`` is None for dW/db, which reads no taps.  ``kind`` is the
    kernel.  Each takes fp32 operands, or bf16 ones (C even, every
    (B, H, W, C) operand 4-byte aligned); a bias stays fp32."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    elem = torch.bfloat16 if bf16 else torch.float32
    tensors = [("x", x, elem)]
    if kernel is not None:
        if tuple(kernel.shape) != (K, K, 1, c):
            raise ValueError(
                f"kernel must be ({K}, {K}, 1, {c}), got {tuple(kernel.shape)}"
            )
        tensors.append(("kernel", kernel, elem))
    if bias is not None:
        if tuple(bias.shape) != (c,):
            raise ValueError(f"bias must be ({c},), got {tuple(bias.shape)}")
        if not bias.is_contiguous():
            raise ValueError("bias must be contiguous")
        tensors.append(("bias", bias, torch.float32))
    for i, t in enumerate(others):
        if tuple(t.shape) != tuple(x.shape):
            raise ValueError(f"operand {i} has shape {tuple(t.shape)}, "
                             f"x {tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"operand {i} must be contiguous in (B, H, W, C) "
                             "order")
        tensors.append((f"operand {i}", t, elem))
    for name, t, want in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want} here ({kind} takes "
                            "float32, or bfloat16 operands with a float32 "
                            f"bias), got {t.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous in (B, H, W, C) order")
    if bf16:
        # cp.async copies 16 or 4 bytes, never 2: two channels at least.
        if c % 2:
            raise ValueError(f"a bfloat16 x needs an even channel count "
                             f"(the copies move 4 or 16 bytes), got C={c}")
        if any(t.data_ptr() % 4 for t in (x, *others)):
            raise ValueError("bfloat16 operands must start 4-byte aligned")
    for k in _KINDS:
        # Raises where the ring does not fit.
        geometry(k, (b, h, w, c), "bfloat16" if bf16 else "float32")


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
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty_like(x)
    entry = _lib().nvae_dw5x5_fwd_bf16 if bf16 else _lib().nvae_dw5x5_fwd
    err = entry(
        x.data_ptr(), kernel.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(),
        b, h, w, c, kernel.stride(0), kernel.stride(1), kernel.stride(3),
        int(fuse_swish),
        geometry("fwd", (b, h, w, c),
                 "bfloat16" if bf16 else "float32").c_array(),
        x.device.index, _stream(x),
    )
    _raise_on(err, "forward")
    return y


def fused_swish_depthwise5x5_bf16(
    x: torch.Tensor, kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None, *, fuse_swish: bool = True,
) -> torch.Tensor:
    """The bf16 instance of the forward kernel on CUDA tensors: bf16 ``x``
    (B, H, W, C) and taps (5, 5, 1, C), fp32 ``bias`` (C,) or None; bf16
    ``y``.  It counts its launches in ``launches``, apart from the fp32
    forward's; :func:`fused_swish_depthwise5x5` routes bf16 CUDA tensors
    here, and the CPU takes the plain version."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the bf16 instance takes bfloat16 x, got {x.dtype}")
    y = _launch(x, kernel, bias, fuse_swish)
    fused_swish_depthwise5x5_bf16.launches += 1
    return y


fused_swish_depthwise5x5_bf16.launches = 0


def _forward(x: torch.Tensor, kernel: torch.Tensor,
             bias: Optional[torch.Tensor], fuse_swish: bool) -> torch.Tensor:
    # The registered op (``ops.py``, imported with this package): its CPU
    # implementation is the plain version, its CUDA one launches the fp32 or
    # bf16 kernel and counts it, and a ``torch.export`` graph records it by
    # name (tracing hands it fake tensors on the CPU or the card).  A tensor
    # on any other device raises here, as the other wrappers do.
    if x.device.type not in ("cpu", "cuda"):
        _require_cuda(x)
    return torch.ops.nvae_torch.fused_swish_dw5x5(x, kernel, bias,
                                                  bool(fuse_swish))


def _launch_dx(dy: torch.Tensor, kernel: torch.Tensor,
               x: Optional[torch.Tensor], fuse_swish: bool) -> torch.Tensor:
    _require_cuda(dy)
    if fuse_swish and x is None:
        raise ValueError("the swish' epilogue needs the forward's x")
    _check(dy, kernel, None, *((x,) if fuse_swish else ()), kind="dx")
    b, h, w, c = dy.shape
    bf16 = dy.dtype == torch.bfloat16
    dx = torch.empty_like(dy)
    entry = _lib().nvae_dw5x5_dx_bf16 if bf16 else _lib().nvae_dw5x5_dx
    err = entry(
        dy.data_ptr(), kernel.data_ptr(),
        x.data_ptr() if fuse_swish else None, dx.data_ptr(),
        b, h, w, c, kernel.stride(0), kernel.stride(1), kernel.stride(3),
        geometry("dx", (b, h, w, c),
                 "bfloat16" if bf16 else "float32").c_array(),
        dy.device.index, _stream(dy),
    )
    _raise_on(err, "dx")
    return dx


def fused_swish_depthwise5x5_dx(
    dy: torch.Tensor, kernel: torch.Tensor, x: Optional[torch.Tensor],
    *, fuse_swish: bool = True,
) -> torch.Tensor:
    """dL/dx of ``dwconv5x5(swish(x)) + bias`` given ``dy``, NHWC, in dy's
    dtype.  ``x`` is the forward's input, read only when ``fuse_swish``
    (the epilogue's ``swish'(x)``); pass None otherwise.  bf16 CUDA tensors
    go to :func:`fused_swish_depthwise5x5_dx_bf16`."""
    if dy.device.type == "cpu":
        return fused_swish_depthwise5x5_dx_plain(
            dy, kernel, x, fuse_swish=fuse_swish
        )
    if dy.dtype == torch.bfloat16:
        return fused_swish_depthwise5x5_dx_bf16(dy, kernel, x,
                                                fuse_swish=fuse_swish)
    dx = _launch_dx(dy, kernel, x, fuse_swish)
    fused_swish_depthwise5x5_dx.launches += 1
    return dx


fused_swish_depthwise5x5_dx.launches = 0


def fused_swish_depthwise5x5_dx_bf16(
    dy: torch.Tensor, kernel: torch.Tensor, x: Optional[torch.Tensor],
    *, fuse_swish: bool = True,
) -> torch.Tensor:
    """The bf16 instance of the dx kernel on CUDA tensors: bf16 ``dy``,
    taps and ``x`` (or None without swish); bf16 ``dx``, rounded once.  It
    counts its launches in ``launches``, apart from the fp32 dx's."""
    if dy.dtype != torch.bfloat16:
        raise TypeError(f"the bf16 instance takes bfloat16 dy, got {dy.dtype}")
    dx = _launch_dx(dy, kernel, x, fuse_swish)
    fused_swish_depthwise5x5_dx_bf16.launches += 1
    return dx


fused_swish_depthwise5x5_dx_bf16.launches = 0


def dw_parts(x_shape) -> int:
    """Blocks per channel chunk of dW/db stage 1 (the partials' leading
    size), from the dW/db launch geometry."""
    return geometry("dw", tuple(int(s) for s in x_shape)).blocks_per_chunk


def _launch_dw(x: torch.Tensor, dy: torch.Tensor, fuse_swish: bool,
               with_bias: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    _require_cuda(x)
    b, h, w, c = x.shape
    _check(x, None, None, dy, kind="dw")
    bf16 = x.dtype == torch.bfloat16
    geo = geometry("dw", (b, h, w, c), "bfloat16" if bf16 else "float32")
    n_parts = geo.blocks_per_chunk
    partial = torch.empty(n_parts, _SUMS, c, device=x.device,
                          dtype=torch.float32)
    dk = torch.empty(K, K, 1, c, device=x.device, dtype=torch.float32)
    db = (torch.empty(c, device=x.device, dtype=torch.float32)
          if with_bias else None)
    entry = _lib().nvae_dw5x5_dw_bf16 if bf16 else _lib().nvae_dw5x5_dw
    err = entry(
        x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dk.data_ptr(),
        db.data_ptr() if with_bias else None, b, h, w, c, n_parts,
        int(fuse_swish), geo.c_array(), x.device.index, _stream(x),
    )
    _raise_on(err, "dW/db")
    return dk, db


def fused_swish_depthwise5x5_dw(
    x: torch.Tensor, dy: torch.Tensor, *, fuse_swish: bool = True,
    with_bias: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dL/dkernel (5, 5, 1, C), dL/dbias (C,) or None) of the fused op,
    fp32 (bf16 ``x`` and ``dy`` too), from its input ``x`` and ``dy``, NHWC.
    On the card: two kernel launches with no atomics (partial sums over each
    block's batch rows, then their sum in a fixed order), so two runs on the
    same input give the same bits.  bf16 CUDA tensors go to
    :func:`fused_swish_depthwise5x5_dw_bf16`."""
    if x.device.type == "cpu":
        dk, db = fused_swish_depthwise5x5_dw_plain(x, dy, fuse_swish=fuse_swish)
        return dk, db if with_bias else None
    if x.dtype == torch.bfloat16:
        return fused_swish_depthwise5x5_dw_bf16(x, dy, fuse_swish=fuse_swish,
                                                with_bias=with_bias)
    out = _launch_dw(x, dy, fuse_swish, with_bias)
    fused_swish_depthwise5x5_dw.launches += 1
    return out


fused_swish_depthwise5x5_dw.launches = 0


def fused_swish_depthwise5x5_dw_bf16(
    x: torch.Tensor, dy: torch.Tensor, *, fuse_swish: bool = True,
    with_bias: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The bf16 instance of the dW/db kernels on CUDA tensors: bf16 ``x``
    and ``dy``; fp32 dW and db, the same two launches (counted as one in
    ``launches``, apart from the fp32 dW/db's)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the bf16 instance takes bfloat16 x, got {x.dtype}")
    out = _launch_dw(x, dy, fuse_swish, with_bias)
    fused_swish_depthwise5x5_dw_bf16.launches += 1
    return out


fused_swish_depthwise5x5_dw_bf16.launches = 0


class FusedSwishDepthwise5x5(torch.autograd.Function):
    """``dwconv5x5(swish(x)) + bias`` with its gradient: the counterpart of
    the ``jax.custom_vjp`` of ``_make_fused_dw``.  The forward saves
    ``(x, kernel)``; the backward computes dx with the dx kernel and dW/db
    with the dW/db kernels, each only where an input needs it.  On CPU
    tensors every stage takes its plain version (explicit formulas, not
    autograd of the plain forward).  As JAX's ``f_bwd``: dx comes out in
    x's dtype, dW (summed in fp32) is rounded to the taps' dtype here, and
    db keeps the fp32 sums (the bias's dtype)."""

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
            dk = dk.to(kernel.dtype) if ctx.needs_input_grad[1] else None
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


# The wrappers that count their launches.  A CUDA graph replay launches the
# kernels its capture recorded without calling a wrapper: ``launches``
# counts the calls (the capture's among them), ``replayed`` what replays
# launched, as :func:`count_replays` is told.
COUNTED = (
    fused_swish_depthwise5x5, fused_swish_depthwise5x5_bf16,
    fused_swish_depthwise5x5_dx, fused_swish_depthwise5x5_dx_bf16,
    fused_swish_depthwise5x5_dw, fused_swish_depthwise5x5_dw_bf16,
    depthwise_conv5x5,
)
for _fn in COUNTED:
    _fn.replayed = 0
del _fn


def launch_counts() -> dict:
    """Each counted wrapper's ``launches``, by name."""
    return {fn.__name__: fn.launches for fn in COUNTED}


def count_replays(per_replay: dict) -> None:
    """Add to each wrapper's ``replayed`` what one replay of a graph
    launches, ``per_replay``: the launches its capture counted, by name (a
    difference of :func:`launch_counts`)."""
    for fn in COUNTED:
        fn.replayed += per_replay.get(fn.__name__, 0)
