"""Move weights between the JAX package's Flax trees and the port.

:func:`state_dict_from_flax` takes a Flax variables tree as nested dicts of
numpy arrays, ``{"params": ..., "batch_stats": ..., "spectral": ...}``
(``spectral`` only in forward spectral mode), for the whole ``NVAE`` or for
one block, and gives the port module's ``state_dict``, every tensor filled
exactly once from exactly one Flax leaf.  :func:`flax_tree_from_state_dict`
is its inverse: tensors keyed like the ``state_dict`` (the weights, or their
gradients) back to nested numpy dicts keyed like the Flax tree.

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
to no port tensor raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn as nn

from nvae_torch.models.nvae import Decoder
from nvae_torch.nn.blocks import BatchNorm
from nvae_torch.nn.spectral import DepthwiseConv, SNConv

FlaxPath = Tuple[str, ...]  # (collection, module..., leaf)
# A layout change and its inverse, Flax -> port and port -> Flax.
Transform = Tuple[Callable[[np.ndarray], np.ndarray],
                  Callable[[np.ndarray], np.ndarray]]

_identity: Transform = (lambda a: a, lambda a: a)
_hwio_to_oihw: Transform = (lambda a: a.transpose(3, 2, 0, 1),
                            lambda a: a.transpose(2, 3, 1, 0))
_transpose: Transform = (lambda a: a.T, lambda a: a.T)
_hwc_to_chw: Transform = (lambda a: a.transpose(2, 0, 1),
                          lambda a: a.transpose(1, 2, 0))


def _leaves(module: nn.Module) -> Iterable[Tuple[str, str, FlaxPath, Transform]]:
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


def _flax_layout(module: nn.Module) -> Dict[FlaxPath, Tuple[str, Transform]]:
    """Map every Flax leaf path (collection first) to the port
    ``state_dict`` key it fills and the transform it needs."""
    out: Dict[FlaxPath, Tuple[str, Transform]] = {}

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


def state_dict_from_flax(variables, module: nn.Module) -> Dict[str, torch.Tensor]:
    """The port ``module``'s state_dict from a Flax ``variables`` tree.

    Raises on any Flax leaf the port has no tensor for, on a shape mismatch,
    and on any port tensor left unfilled."""
    layout = _flax_layout(module)
    own = module.state_dict()
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables):
        if path not in layout:
            raise KeyError(f"unknown Flax leaf {'/'.join(path)}")
        key, (fn, _) = layout[path]
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


def flax_tree_from_state_dict(state_dict, module: nn.Module) -> dict:
    """Nested numpy dicts keyed like the Flax variables tree (collection
    first) from tensors keyed like ``module.state_dict()``: the inverse of
    :func:`state_dict_from_flax`.  ``state_dict`` may hold a subset of the
    keys (for example the gradients of the parameters alone); a key the
    module has no Flax leaf for raises."""
    by_key = {key: (path, inv) for path, (key, (_, inv))
              in _flax_layout(module).items()}
    tree: dict = {}
    for key, value in state_dict.items():
        if key not in by_key:
            raise KeyError(f"{key} has no Flax leaf")
        path, inv = by_key[key]
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        # A copy: ``.numpy()`` of a CPU tensor shares its memory.
        node[path[-1]] = np.array(inv(value.detach().cpu().numpy()),
                                  order="C", copy=True)
    return tree
