"""Batched feature extractors for the metric suite (counterpart of
``nvae_tpu/eval/features.py``).

An extractor takes (B, H, W, C) images in [0, 1] and, on its device, turns
greyscale into RGB, resizes to the backbone's input size, scales the input,
runs the backbone in full fp32 and pools to (B, D).

Backbones:

- ``vgg16`` / ``inception``: the real architectures, whose ImageNet weights
  load from a local ``.npz`` of Flax paths (``$NVAE_TPU_WEIGHTS/<name>.npz``,
  ``~/.keras/models/<name>.npz`` or an explicit path: the JAX package's
  candidates, so one weights directory serves both packages).  Without one
  the extractor warns and runs a fixed-seed random initialization, recorded
  as ``"random-init"``: its metric values are only comparable within this
  framework.  It draws Flax's initializer distributions (LeCun-normal
  kernels, zero biases; zero mean, unit variance and zero beta for
  Inception's BatchNorm) from a seeded torch generator, so its values
  differ from the JAX package's random init.
- ``random_conv``: a small fixed-seed CNN for fast metric plumbing.

Resizing follows ``jax.image.resize``: ``bilinear`` antialiases when it
shrinks (``antialias=True``) and ``nearest`` uses half-pixel centres
(``nearest-exact``).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nvae_torch.device import DeviceLike, fp32_math, resolve_device
from nvae_torch.eval.inception import Conv, ConvBN, InceptionV3Features

# name -> (weights file stem, native input size, seed of the random init)
_BACKBONES = {"random_conv": ("random_conv", 64, 0),
              "vgg16": ("vgg16", 224, 16),
              "inception": ("inception_v3", 299, 299)}
_ALIASES = {"vgg": "vgg16", "inception_v3": "inception", "iv3": "inception"}


def canonical_name(name: str) -> str:
    name = _ALIASES.get(name, name)
    if name not in _BACKBONES:
        raise ValueError(f"unknown feature extractor {name!r}")
    return name


class _RandomConvNet(nn.Module):
    """4 stride-2 conv stages + global average pool -> 512-d features."""

    def __init__(self, features: int = 512):
        super().__init__()
        cin = 3
        for i, w in enumerate((64, 128, 256, features)):
            self.add_module(f"Conv_{i}", Conv(cin, w, strides=(2, 2)))
            cin = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.children():
            x = F.relu(conv(x))
        return x.mean(dim=(2, 3))


class _VGG16Features(nn.Module):
    """The VGG16 convolutional trunk + global average pool (Keras
    ``VGG16(include_top=False, pooling='avg')``), layers named
    ``block{b}_conv{i}``."""

    PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    def __init__(self):
        super().__init__()
        cin = 3
        for block, (width, convs) in enumerate(self.PLAN, start=1):
            for i in range(convs):
                self.add_module(f"block{block}_conv{i + 1}", Conv(cin, width))
                cin = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block, (_, convs) in enumerate(self.PLAN, start=1):
            for i in range(convs):
                x = F.relu(self._modules[f"block{block}_conv{i + 1}"](x))
            x = F.max_pool2d(x, 2, 2)
        return x.mean(dim=(2, 3))


def backbone_module(name: str) -> nn.Module:
    """The backbone's module on the CPU, weights not yet initialized."""
    name = canonical_name(name)
    if name == "random_conv":
        return _RandomConvNet()
    return _VGG16Features() if name == "vgg16" else InceptionV3Features()


def flax_init_(module: nn.Module, seed: int) -> nn.Module:
    """Initialize in place as Flax would, from a torch generator seeded
    with ``seed``, in module order: truncated-normal LeCun kernels (std
    ``sqrt(1 / fan_in) / 0.8796`` within 2 std), zero biases, and zero
    mean, unit variance and zero beta for each ``ConvBN``."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv):
                fan_in = m.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, ConvBN):
                m.bn_mean.zero_()
                m.bn_var.fill_(1.0)
                m.bn_beta.zero_()
    return module


def _resize_to(x: torch.Tensor, size: int,
               method: str = "bilinear") -> torch.Tensor:
    """(B, C, H, W) -> (B, 3, size, size): greyscale repeated to RGB, then
    resized as ``jax.image.resize`` resizes."""
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    if tuple(x.shape[2:]) != (size, size):
        if method == "bilinear":
            x = F.interpolate(x, size=(size, size), mode="bilinear",
                              align_corners=False, antialias=True)
        elif method == "nearest":
            x = F.interpolate(x, size=(size, size), mode="nearest-exact")
        else:
            raise ValueError(f"unknown resize method {method!r}")
    return x


def _find_weights(stem: str, weights_path: Optional[str]) -> Optional[str]:
    candidates = [
        weights_path or "",
        os.path.join(os.environ.get("NVAE_TPU_WEIGHTS", ""), f"{stem}.npz"),
        os.path.expanduser(f"~/.keras/models/{stem}.npz"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def backbone_weights_status(name: str,
                            weights_path: Optional[str] = None) -> str:
    """Provenance of a backbone's weights: ``"imagenet"`` when a local
    weights ``.npz`` exists, ``"random-init"`` when the fixed-seed random
    init would run instead, ``"fixed-seed"`` for ``random_conv``."""
    name = canonical_name(name)
    if name == "random_conv":
        return "fixed-seed"
    stem = _BACKBONES[name][0]
    return "imagenet" if _find_weights(stem, weights_path) else "random-init"


def _load_npz_weights(name: str, path: str) -> dict:
    """The backbone's ``state_dict`` from a ``.npz`` whose keys are Flax
    paths (``block1_conv1/kernel``, ``stem_0/conv/kernel``, ...)."""
    from nvae_torch.convert import backbone_state_dict_from_flax

    tree: dict = {}
    with np.load(path) as d:
        for key in d.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = d[key]
    return backbone_state_dict_from_flax(name, tree)


class Extractor:
    """``(B, H, W, C)`` images in [0, 1] (numpy or a tensor) -> (B, D)
    features, a tensor on ``device``."""

    def __init__(self, name: str, net: nn.Module, size: int,
                 resize_method: str, input_scaling: str,
                 device: torch.device, weights: str):
        self.name, self.net, self.size = name, net, size
        self.resize_method, self.input_scaling = resize_method, input_scaling
        self.device, self.weights = device, weights

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.asarray(images, np.float32))
        x = images.to(device=self.device, dtype=torch.float32)
        with fp32_math():
            x = _resize_to(x.permute(0, 3, 1, 2), self.size,
                           self.resize_method)
            if self.input_scaling == "pm1":
                x = x * 2.0 - 1.0  # ImageNet-style scaling to [-1, 1]
            return self.net(x)


@functools.lru_cache(maxsize=8)
def _cached_extractor(name, input_size, weights_path, resize_method,
                      input_scaling, device: str) -> Extractor:
    stem, native, seed = _BACKBONES[name]
    net = backbone_module(name)
    path = None if name == "random_conv" else _find_weights(stem,
                                                             weights_path)
    if path:
        net.load_state_dict(_load_npz_weights(name, path))
    else:
        if name != "random_conv":
            label = "VGG16" if name == "vgg16" else "InceptionV3"
            print(f"[nvae_torch.eval] WARNING: no local {stem}.npz found — "
                  f"using fixed-seed random {label} features. Metric values "
                  "are self-consistent but not comparable to published "
                  "numbers.")
        flax_init_(net, seed)
    net.eval().to(device)
    return Extractor(name, net, input_size or native, resize_method,
                     input_scaling, torch.device(device),
                     backbone_weights_status(name, weights_path))


def get_extractor(
    name: str = "random_conv",
    input_size: int = 0,
    weights_path: Optional[str] = None,
    resize_method: str = "bilinear",
    input_scaling: str = "pm1",
    device: DeviceLike = "cuda",
) -> Extractor:
    """The extractor of backbone ``name`` on ``device`` (the card unless
    the caller asks for the CPU), cached per argument set.

    ``input_size=0`` picks the backbone's native size (VGG 224, Inception
    299, random_conv 64); ``resize_method="nearest"`` with
    ``input_size=299`` is the reference's resize-to-299 protocol;
    ``input_scaling`` ``"pm1"`` scales to [-1, 1], ``"unit"`` feeds raw
    [0, 1] images as the reference does."""
    if input_scaling not in ("pm1", "unit"):
        raise ValueError(f"unknown input_scaling {input_scaling!r}")
    if resize_method not in ("bilinear", "nearest"):
        raise ValueError(f"unknown resize method {resize_method!r}")
    return _cached_extractor(canonical_name(name), int(input_size),
                             weights_path, resize_method, input_scaling,
                             str(resolve_device(device)))


def extract_features(images, extractor, batch_size: int = 256,
                     mesh=None) -> np.ndarray:
    """(N, D) numpy features of ``images`` (numpy, a tensor or anything
    sliceable, such as an ``ImageDirectory``), ``batch_size`` at a time,
    copied to the host once at the end.

    ``mesh`` (``parallel.mesh.DataMesh``): each batch is padded with zero
    images to a multiple of the rank count, each rank extracts its rows,
    the ranks gather the features and the padding rows are dropped, so
    every rank returns all of them (JAX's ``mesh=``).  That holds for an
    extractor that treats each image on its own, as every backbone here
    does."""
    out = []
    for i in range(0, len(images), batch_size):
        batch = images[i:i + batch_size]
        if mesh is None:
            out.append(extractor(batch))
            continue
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.asarray(batch, np.float32))
        out.append(mesh.map_rows(batch.to(mesh.device, torch.float32),
                                 extractor))
    return torch.cat(out).cpu().numpy()
