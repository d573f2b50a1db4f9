"""InceptionV3 feature trunk, (B, 2048) pooled features (counterpart of
``nvae_tpu/eval/inception.py``): the Keras topology, a conv stem, 3x
mixed-35, reduction A, 4x mixed-17, reduction B, 2x mixed-8, global average
pool.  NCHW.

Every layer keeps its Flax name, so a Flax parameter tree or a ``.npz`` of
Flax paths maps onto the ``state_dict`` one to one
(``nvae_torch.convert.backbone_state_dict_from_flax``): ``ConvBN`` ``name``
holds ``name.conv.weight`` (Flax ``name/conv/kernel``) and the frozen
BatchNorm's ``name.bn_mean``, ``name.bn_var`` and ``name.bn_beta``.
Convolutions pad as XLA's ``SAME`` does (the odd pixel of a strided conv on
an even input goes after, not before); max pools are VALID; the branch
average pools exclude the padding from their divisor.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after)."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """A Flax ``nn.Conv`` in NCHW: ``weight`` (out, in, kh, kw) from the
    HWIO ``kernel``, an optional ``bias``, ``"SAME"`` or ``"VALID"``."""

    def __init__(self, cin: int, cout: int, kernel_size=(3, 3),
                 strides=(1, 1), padding: str = "SAME", bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel_size),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(cout), requires_grad=False)
                     if bias else None)
        self.strides = tuple(strides)
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (0, 0)
        if self.padding == "SAME":
            (ht, hb), (wl, wr) = (
                _same_pads(x.shape[d], self.weight.shape[d], s)
                for d, s in ((2, self.strides[0]), (3, self.strides[1])))
            if (ht, wl) == (hb, wr):
                pad = (ht, wl)
            else:
                x = F.pad(x, (wl, wr, ht, hb))
        return F.conv2d(x, self.weight, self.bias, self.strides, pad)


class ConvBN(nn.Module):
    """Conv (no bias), frozen BatchNorm without scale (eps 1e-3), ReLU: the
    Keras ``conv2d_bn``."""

    def __init__(self, cin: int, features: int, kernel_size=(3, 3),
                 strides=(1, 1), padding: str = "SAME"):
        super().__init__()
        self.conv = Conv(cin, features, kernel_size, strides, padding,
                         bias=False)
        for name in ("bn_mean", "bn_var", "bn_beta"):
            self.register_buffer(name, torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        x = ((x - self.bn_mean[:, None, None])
             * torch.rsqrt(self.bn_var + 1e-3)[:, None, None]
             + self.bn_beta[:, None, None])
        return F.relu(x)


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionV3Features(nn.Module):
    """(B, 3, H, W) in [-1, 1] -> (B, 2048); H, W >= 75.

    Built as Flax's compact module is: one pass of ``_trunk`` over a small
    input creates each ``ConvBN`` where the topology first calls it, with
    the input width it meets there, so the topology is written once.  The
    weights start uninitialized; load them or call
    ``nvae_torch.eval.features.flax_init_``."""

    def __init__(self):
        super().__init__()
        self._building = True
        with torch.no_grad():
            self._trunk(torch.zeros(1, 3, 75, 75))
        self._building = False

    def _cb(self, name: str, x: torch.Tensor, features: int,
            kernel_size=(1, 1), strides=(1, 1), padding: str = "SAME"):
        if self._building:
            self.add_module(name, ConvBN(x.shape[1], features, kernel_size,
                                         strides, padding))
            nn.init.zeros_(self._modules[name].conv.weight)
            self._modules[name].bn_var.fill_(1.0)
        return self._modules[name](x)

    def _branch(self, x: torch.Tensor, spec: Sequence, prefix: str):
        for i, (f, k, s, p) in enumerate(spec):
            x = self._cb(f"{prefix}_{i}", x, f, k, s, p)
        return x

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        v, s = "VALID", "SAME"
        x = self._cb("stem_0", x, 32, (3, 3), (2, 2), v)
        x = self._cb("stem_1", x, 32, (3, 3), (1, 1), v)
        x = self._cb("stem_2", x, 64, (3, 3), (1, 1), s)
        x = F.max_pool2d(x, 3, 2)
        x = self._cb("stem_3", x, 80, (1, 1), (1, 1), v)
        x = self._cb("stem_4", x, 192, (3, 3), (1, 1), v)
        x = F.max_pool2d(x, 3, 2)

        # 3x mixed-35 (Inception-A), pool features 32, 64, 64.
        for bi, pool_f in enumerate((32, 64, 64)):
            n = f"mixed35_{bi}"
            b0 = self._branch(x, [(64, (1, 1), (1, 1), s)], f"{n}_b0")
            b1 = self._branch(x, [(48, (1, 1), (1, 1), s),
                                  (64, (5, 5), (1, 1), s)], f"{n}_b1")
            b2 = self._branch(x, [(64, (1, 1), (1, 1), s),
                                  (96, (3, 3), (1, 1), s),
                                  (96, (3, 3), (1, 1), s)], f"{n}_b2")
            bp = self._cb(f"{n}_bp", _avg_pool(x), pool_f)
            x = torch.cat([b0, b1, b2, bp], dim=1)

        # Reduction A (mixed 3).
        b0 = self._cb("red_a_b0", x, 384, (3, 3), (2, 2), v)
        b1 = self._branch(x, [(64, (1, 1), (1, 1), s),
                              (96, (3, 3), (1, 1), s),
                              (96, (3, 3), (2, 2), v)], "red_a_b1")
        x = torch.cat([b0, b1, F.max_pool2d(x, 3, 2)], dim=1)

        # 4x mixed-17 (Inception-B), factorized 7x1 / 1x7 convolutions.
        for bi, mid in enumerate((128, 160, 160, 192)):
            n = f"mixed17_{bi}"
            b0 = self._cb(f"{n}_b0", x, 192)
            b1 = self._branch(x, [(mid, (1, 1), (1, 1), s),
                                  (mid, (1, 7), (1, 1), s),
                                  (192, (7, 1), (1, 1), s)], f"{n}_b1")
            b2 = self._branch(x, [(mid, (1, 1), (1, 1), s),
                                  (mid, (7, 1), (1, 1), s),
                                  (mid, (1, 7), (1, 1), s),
                                  (mid, (7, 1), (1, 1), s),
                                  (192, (1, 7), (1, 1), s)], f"{n}_b2")
            bp = self._cb(f"{n}_bp", _avg_pool(x), 192)
            x = torch.cat([b0, b1, b2, bp], dim=1)

        # Reduction B (mixed 8).
        b0 = self._branch(x, [(192, (1, 1), (1, 1), s),
                              (320, (3, 3), (2, 2), v)], "red_b_b0")
        b1 = self._branch(x, [(192, (1, 1), (1, 1), s),
                              (192, (1, 7), (1, 1), s),
                              (192, (7, 1), (1, 1), s),
                              (192, (3, 3), (2, 2), v)], "red_b_b1")
        x = torch.cat([b0, b1, F.max_pool2d(x, 3, 2)], dim=1)

        # 2x mixed-8 (Inception-C), split 3x1 / 1x3 branches.
        for bi in range(2):
            n = f"mixed8_{bi}"
            b0 = self._cb(f"{n}_b0", x, 320)
            b1 = self._cb(f"{n}_b1", x, 384)
            b1a = self._cb(f"{n}_b1a", b1, 384, (1, 3))
            b1b = self._cb(f"{n}_b1b", b1, 384, (3, 1))
            b2 = self._branch(x, [(448, (1, 1), (1, 1), s),
                                  (384, (3, 3), (1, 1), s)], f"{n}_b2")
            b2a = self._cb(f"{n}_b2a", b2, 384, (1, 3))
            b2b = self._cb(f"{n}_b2b", b2, 384, (3, 1))
            bp = self._cb(f"{n}_bp", _avg_pool(x), 192)
            x = torch.cat([b0, b1a, b1b, b2a, b2b, bp], dim=1)
        return x.mean(dim=(2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._trunk(x)
