"""NVAE building blocks (counterpart of ``nvae_tpu/nn/blocks.py``).

Every block honours ``self.training`` as the JAX modules' ``train`` flag:
BatchNorm normalizes with the batch statistics and updates its running
statistics in place, and forward-mode spectral convolutions update ``u``.
Tensors are NCHW in ``torch.channels_last`` memory.  Constructors take the
input channel counts that Flax infers at the first call.  Each module's
``flax_names`` maps a child attribute to the name of the Flax submodule it
mirrors; ``nvae_torch/convert.py`` reads it to load the JAX package's
weights.

Kept from the JAX modules on purpose: BatchNorm eps 1e-5; generative cells
scale the identity branch by 0.1 and postprocess cells the residual branch;
squeeze-excitation hidden width ``max(C // 16, 4)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from nvae_torch.nn.spectral import DepthwiseConv, SNConv, glorot_uniform_


BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """BatchNorm over channels with Flax's semantics (``flax.linen.BatchNorm``
    as ``blocks.py:53-59`` configures it), eps 1e-5.

    Eval mode normalizes with the running statistics.  Training mode
    normalizes with the batch mean and the *biased* batch variance
    ``E[x^2] - E[x]^2`` (clipped at 0), with gradients flowing through both,
    and updates the running statistics in place as
    ``ra <- 0.05 * ra + 0.95 * batch`` (biased variance).  This is not
    ``F.batch_norm(training=True)``, whose momentum 0.05 would keep 95% of
    the old value and which stores the unbiased variance."""

    MOMENTUM = 0.05  # Flax's: the share of the old running value kept

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, training=False, eps=BN_EPS,
            )
        dims = (0, 2, 3)
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_((1.0 - m) * mean)
            self.running_var.mul_(m).add_((1.0 - m) * var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class SqueezeExcitation(nn.Module):
    """Squeeze-and-excitation gate as plain ops (``blocks.py:107-128``)."""

    flax_names = {"fc1": "Dense_0", "fc2": "Dense_1"}

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        hidden = int(max(channels // ratio, 4))
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, channels)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for fc in (self.fc1, self.fc2):
            glorot_uniform_(fc.weight, fc.in_features, fc.out_features, generator)
            with torch.no_grad():
                fc.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3))
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(s))))
        return x * s[:, :, None, None]


class Rescaler(nn.Module):
    """BN -> swish -> {up: nearest x``factor`` then a 3x3 ``SAME`` conv |
    down: a stride-``factor`` 3x3 ``SAME`` conv} (``blocks.py:131-162``)."""

    flax_names = {"bn": "BatchNorm_0", "conv": "SNConv_0"}

    def __init__(self, in_ch: int, features: int, factor: int = 2,
                 mode: str = "projection", up: bool = True):
        super().__init__()
        self.factor = factor
        self.up = up
        self.bn = BatchNorm(in_ch)
        self.conv = SNConv(in_ch, features, 3, mode=mode,
                           stride=1 if up else factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.bn(x))
        if self.up:
            x = F.interpolate(x, scale_factor=self.factor, mode="nearest")
        return self.conv(x)


class FactorizedDownsample(nn.Module):
    """Swish, then four 1x1 stride-2 convolutions over the input shifted by
    (0, 0), (1, 1), (0, 1) and (1, 0) pixels (row, column), concatenated on
    channels (``blocks.py:165-186``).  Factor 2 only."""

    flax_names = {"convs": "SNConv"}

    def __init__(self, in_ch: int, features: int, mode: str = "projection"):
        super().__init__()
        quarter = features // 4
        widths = (quarter, quarter, quarter, features - 3 * quarter)
        self.convs = nn.ModuleList(
            SNConv(in_ch, f, 1, mode=mode, stride=2) for f in widths
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.silu(x)
        views = (out, out[:, :, 1:, 1:], out[:, :, :, 1:], out[:, :, 1:, :])
        return torch.cat([conv(v) for conv, v in zip(self.convs, views)],
                         dim=1)


class StemCell(nn.Module):
    """Preprocess residual cell: ``n_nodes`` x (BN -> swish -> 3x3 conv, the
    first one stride 2 when downsampling) -> SE; ``skip(x) + 0.1 * y`` with a
    :class:`FactorizedDownsample` skip when downsampling
    (``blocks.py:189-220``)."""

    def __init__(self, in_ch: int, features: int, n_nodes: int = 2,
                 downsample: bool = False, se_ratio: int = 16,
                 mode: str = "projection"):
        super().__init__()
        if not downsample and in_ch != features:
            raise ValueError("a stem cell that keeps its size keeps its width")
        self.skip = (FactorizedDownsample(in_ch, features, mode=mode)
                     if downsample else None)
        self.bns = nn.ModuleList(
            BatchNorm(in_ch if i == 0 else features) for i in range(n_nodes)
        )
        self.convs = nn.ModuleList(
            SNConv(in_ch if i == 0 else features, features, 3, mode=mode,
                   stride=2 if downsample and i == 0 else 1)
            for i in range(n_nodes)
        )
        self.se = SqueezeExcitation(features, se_ratio)
        self.flax_names = {"bns": "BatchNorm", "convs": "SNConv",
                           "se": "SqueezeExcitation_0"}
        if downsample:
            self.flax_names["skip"] = "FactorizedDownsample_0"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = self.skip(x) if self.skip is not None else x
        y = x
        for bn, conv in zip(self.bns, self.convs):
            y = conv(F.silu(bn(y)))
        return skip + 0.1 * self.se(y)


class EncoderResidualCell(nn.Module):
    """(BN -> swish -> 3x3 conv) x 2 -> SE; ``0.1 * identity + residual``
    (``blocks.py:223-241``)."""

    flax_names = {"bn0": "BatchNorm_0", "conv0": "SNConv_0",
                  "bn1": "BatchNorm_1", "conv1": "SNConv_1",
                  "se": "SqueezeExcitation_0"}

    def __init__(self, features: int, se_ratio: int = 16,
                 mode: str = "projection"):
        super().__init__()
        self.bn0 = BatchNorm(features)
        self.conv0 = SNConv(features, features, 3, mode=mode)
        self.bn1 = BatchNorm(features)
        self.conv1 = SNConv(features, features, 3, mode=mode)
        self.se = SqueezeExcitation(features, se_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv0(F.silu(self.bn0(x)))
        y = self.conv1(F.silu(self.bn1(y)))
        return 0.1 * x + self.se(y)


class GenerativeResidualCell(nn.Module):
    """BN -> 1x1 expand -> BN -> [swish -> dw 5x5] -> BN-swish -> 1x1 project
    -> BN -> SE; ``0.1 * identity + residual`` (``blocks.py:244-276``).  The
    bracketed pair is one fused kernel under ``use_pallas``."""

    flax_names = {
        "bn0": "BatchNorm_0", "expand": "SNConv_0", "bn1": "BatchNorm_1",
        "dw": "DepthwiseConv_0", "bn2": "BatchNorm_2", "project": "SNConv_1",
        "bn3": "BatchNorm_3", "se": "SqueezeExcitation_0",
    }

    def __init__(self, features: int, expansion_ratio: int = 6,
                 se_ratio: int = 16, use_pallas: bool = False,
                 mode: str = "projection"):
        super().__init__()
        hidden = expansion_ratio * features
        self.bn0 = BatchNorm(features)
        self.expand = SNConv(features, hidden, 1, mode=mode)
        self.bn1 = BatchNorm(hidden)
        self.dw = DepthwiseConv(hidden, use_pallas=use_pallas, fuse_swish=True)
        self.bn2 = BatchNorm(hidden)
        self.project = SNConv(hidden, features, 1, mode=mode)
        self.bn3 = BatchNorm(features)
        self.se = SqueezeExcitation(features, se_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(self.bn0(x))
        y = self.dw(self.bn1(y))
        y = self.project(F.silu(self.bn2(y)))
        y = self.se(self.bn3(y))
        return 0.1 * x + y


class EncDecCombiner(nn.Module):
    """Bidirectional merge ``enc_x + conv1x1(dec_x)`` (``blocks.py:279-293``)."""

    flax_names = {"conv": "SNConv_0"}

    def __init__(self, dec_ch: int, features: int, mode: str = "projection"):
        super().__init__()
        self.conv = SNConv(dec_ch, features, 1, mode=mode)

    def forward(self, enc_x: torch.Tensor, dec_x: torch.Tensor) -> torch.Tensor:
        return enc_x + self.conv(dec_x)


class DecoderSampleCombiner(nn.Module):
    """``conv1x1(concat(x, z))`` (``blocks.py:296-308``)."""

    flax_names = {"conv": "SNConv_0"}

    def __init__(self, x_ch: int, z_ch: int, features: int,
                 mode: str = "projection"):
        super().__init__()
        self.conv = SNConv(x_ch + z_ch, features, 1, mode=mode)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([x, z], dim=1))


class ConvBNSwish(nn.Module):
    """conv (no bias) -> BN -> swish (``blocks.py:311-331``).
    ``emit_preact`` returns the BN output before the swish, for a following
    fused kernel to apply it."""

    flax_names = {"conv": "SNConv_0", "bn": "BatchNorm_0"}

    def __init__(self, in_ch: int, features: int, kernel_size: int = 1,
                 emit_preact: bool = False, mode: str = "projection"):
        super().__init__()
        self.emit_preact = emit_preact
        self.conv = SNConv(in_ch, features, kernel_size, use_bias=False,
                           mode=mode)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.emit_preact else F.silu(x)


class PostprocessNode(nn.Module):
    """[up-rescale] -> BN -> 1x1 expand -> 5x5 (full, or depthwise) -> 1x1
    project -> BN -> SE (``blocks.py:334-387``)."""

    def __init__(self, in_ch: int, features: int, upscale: bool = False,
                 factor: int = 2, expansion_ratio: int = 6,
                 se_ratio: int = 16, depthwise_5x5: bool = False,
                 use_pallas: bool = False, mode: str = "projection"):
        super().__init__()
        if not upscale and in_ch != features:
            raise ValueError("a node that does not upscale keeps its width")
        hidden = features * expansion_ratio
        fused = depthwise_5x5 and use_pallas
        self.flax_names = {}
        if upscale:
            self.rescale = Rescaler(in_ch, features, factor, mode=mode)
            self.flax_names["rescale"] = "Rescaler_0"
        else:
            self.rescale = None
        self.bn_in = BatchNorm(features)
        self.expand = ConvBNSwish(features, hidden, 1, emit_preact=fused,
                                  mode=mode)
        if depthwise_5x5:
            self.dw = DepthwiseConv(hidden, use_bias=False, use_pallas=fused,
                                    fuse_swish=fused)
            self.bn_mid = BatchNorm(hidden)
            self.conv5 = None
            self.flax_names.update(dw="DepthwiseConv_0", bn_mid="BatchNorm_1")
        else:
            self.dw = self.bn_mid = None
            self.conv5 = ConvBNSwish(hidden, hidden, 5, mode=mode)
            self.flax_names["conv5"] = "ConvBNSwish_1"
        self.project = SNConv(hidden, features, 1, use_bias=False, mode=mode)
        self.bn_out = BatchNorm(features)
        self.se = SqueezeExcitation(features, se_ratio)
        self.flax_names.update(
            bn_in="BatchNorm_0", expand="ConvBNSwish_0", project="SNConv_0",
            bn_out="BatchNorm_2" if depthwise_5x5 else "BatchNorm_1",
            se="SqueezeExcitation_0",
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rescale is not None:
            x = self.rescale(x)
        x = self.expand(self.bn_in(x))
        if self.conv5 is None:
            x = F.silu(self.bn_mid(self.dw(x)))
        else:
            x = self.conv5(x)
        x = self.bn_out(self.project(x))
        return self.se(x)


class PostprocessCell(nn.Module):
    """``skip(x) + 0.1 * nodes(x)``; the skip up-rescales when the cell
    upscales (``blocks.py:390-424``)."""

    def __init__(self, in_ch: int, features: int, n_nodes: int = 1,
                 upscale: bool = False, factor: int = 2, se_ratio: int = 16,
                 depthwise_5x5: bool = False, use_pallas: bool = False,
                 mode: str = "projection"):
        super().__init__()
        self.flax_names = {"nodes": "PostprocessNode"}
        if upscale:
            self.skip = Rescaler(in_ch, features, factor, mode=mode)
            self.flax_names["skip"] = "Rescaler_0"
        else:
            self.skip = None
        self.nodes = nn.ModuleList(
            PostprocessNode(
                in_ch if i == 0 else features, features,
                upscale=upscale and i == 0, factor=factor, se_ratio=se_ratio,
                depthwise_5x5=depthwise_5x5, use_pallas=use_pallas, mode=mode,
            )
            for i in range(n_nodes)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = self.skip(x) if self.skip is not None else x
        y = x
        for node in self.nodes:
            y = node(y)
        return skip + 0.1 * y
