"""Load the JAX package's weights into the port.

The input is a Flax variables tree as nested dicts of numpy arrays:
``{"params": ..., "batch_stats": ..., "spectral": ...}`` (``spectral`` only in
forward spectral mode), for the whole ``NVAE`` or for one block.  The output
is the port module's ``state_dict``, every tensor filled exactly once.

Layout changes:

- conv ``sn_kernel`` HWIO -> ``weight`` OIHW;
- ``dw_kernel`` (5, 5, 1, C) -> ``weight`` (C, 1, 5, 5);
- ``Dense/kernel`` (in, out) -> ``weight`` (out, in);
- ``BatchNorm_i/BatchNorm_0/{scale, bias}`` and ``batch_stats/.../{mean, var}``
  -> ``weight``, ``bias``, ``running_mean``, ``running_var``;
- ``decoder/h`` (H, W, C) -> (C, H, W);
- ``spectral/.../u`` -> the SN ``u`` buffer.

The module tree is walked through each module's ``flax_names`` (child
attribute -> Flax submodule name; a ``ModuleList`` named ``x`` holds Flax's
``x_0``, ``x_1``, ... and a nested one ``x_0_0``, ...).  A Flax leaf that maps
to no port tensor raises, unless it lies in a subtree that sampling never
reads (:data:`SAMPLING_UNUSED`).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn as nn

from nvae_torch.models.nvae import Decoder
from nvae_torch.nn.blocks import BatchNorm
from nvae_torch.nn.spectral import DepthwiseConv, SNConv

# Flax subtrees of the full model that the prior sampler never reads: the
# encoder side (preprocess, encoder, enc-dec merges, posterior heads).
SAMPLING_UNUSED = (
    "preprocess",
    "encoder",
    "decoder/merges_",
    "decoder/heads/enc_heads_",
)

FlaxPath = Tuple[str, ...]  # (collection, module..., leaf)


def _identity(a: np.ndarray) -> np.ndarray:
    return a


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)


def _transpose(a: np.ndarray) -> np.ndarray:
    return a.T


def _hwc_to_chw(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 0, 1)


def _leaves(module: nn.Module) -> Iterable[Tuple[str, str, FlaxPath, Callable]]:
    """(port tensor name, collection, Flax leaf path below the module,
    transform) for the tensors a module owns itself."""
    if isinstance(module, SNConv):
        yield "weight", "params", ("sn_kernel",), _hwio_to_oihw
        if module.bias is not None:
            yield "bias", "params", ("bias",), _identity
        if module.u is not None:
            yield "u", "spectral", ("u",), _identity
    elif isinstance(module, DepthwiseConv):
        # (5, 5, 1, C) -> (C, 1, 5, 5) is the same HWIO -> OIHW swap.
        yield "weight", "params", ("dw_kernel",), _hwio_to_oihw
        if module.bias is not None:
            yield "bias", "params", ("bias",), _identity
    elif isinstance(module, BatchNorm):
        yield "weight", "params", ("BatchNorm_0", "scale"), _identity
        yield "bias", "params", ("BatchNorm_0", "bias"), _identity
        yield "running_mean", "batch_stats", ("BatchNorm_0", "mean"), _identity
        yield "running_var", "batch_stats", ("BatchNorm_0", "var"), _identity
    elif isinstance(module, nn.Linear):
        yield "weight", "params", ("kernel",), _transpose
        yield "bias", "params", ("bias",), _identity
    elif isinstance(module, Decoder):  # the constant input h
        yield "h", "params", ("h",), _hwc_to_chw


def _children(module: nn.Module) -> Iterable[Tuple[str, nn.Module, str]]:
    """(port child prefix, child module, Flax child name)."""
    names = getattr(module, "flax_names", {})
    for attr, child in module.named_children():
        if attr not in names:
            raise KeyError(f"{type(module).__name__}.{attr} has no Flax name")
        base = names[attr]
        if isinstance(child, nn.ModuleList):
            for i, sub in enumerate(child):
                if isinstance(sub, nn.ModuleList):
                    for j, subsub in enumerate(sub):
                        yield f"{attr}.{i}.{j}", subsub, f"{base}_{i}_{j}"
                else:
                    yield f"{attr}.{i}", sub, f"{base}_{i}"
        else:
            yield attr, child, base


def _flax_layout(module: nn.Module) -> Dict[FlaxPath, Tuple[str, Callable]]:
    """Map every Flax leaf path (collection first) to the port
    ``state_dict`` key it fills and the transform it needs."""
    out: Dict[FlaxPath, Tuple[str, Callable]] = {}

    def walk(m: nn.Module, prefix: str, fpath: Tuple[str, ...]):
        for name, coll, leaf, fn in _leaves(m):
            out[(coll, *fpath, *leaf)] = (prefix + name, fn)
        for attr, child, fname in _children(m):
            walk(child, f"{prefix}{attr}.", (*fpath, fname))

    walk(module, "", ())
    return out


def _flatten(tree, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flatten(v, (*prefix, str(k)))
    else:
        yield prefix, tree


def state_dict_from_flax(
    variables, module: nn.Module, skip: Iterable[str] = ()
) -> Dict[str, torch.Tensor]:
    """The port ``module``'s state_dict from a Flax ``variables`` tree.

    ``skip`` lists Flax subtree prefixes (below the collection, joined with
    ``/``) to ignore.  Raises on any other leaf the port has no tensor for,
    on a shape mismatch, and on any port tensor left unfilled."""
    layout = _flax_layout(module)
    own = module.state_dict()
    skip = tuple(skip)
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables):
        sub = "/".join(path[1:])
        if path not in layout:
            if any(sub.startswith(s) for s in skip):
                continue
            raise KeyError(f"unknown Flax leaf {'/'.join(path)}")
        key, fn = layout[path]
        if key in sd:
            raise KeyError(f"{key} filled twice (second from {'/'.join(path)})")
        value = torch.from_numpy(np.array(fn(np.asarray(leaf)), copy=True))
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(
                f"{'/'.join(path)} -> {key}: shape {tuple(value.shape)}, "
                f"port expects {tuple(own[key].shape)}"
            )
        sd[key] = value.to(torch.float32)
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"port tensors not filled from Flax: {missing}")
    return sd


def nvae_state_dict(variables, model: nn.Module) -> Dict[str, torch.Tensor]:
    """:func:`state_dict_from_flax` for a whole ``NVAE``, skipping the
    subtrees sampling never reads."""
    return state_dict_from_flax(variables, model, skip=SAMPLING_UNUSED)
