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

Serving trees convert too: a bf16 leaf stays bf16, and a quantized leaf
(``q``, ``scale``, ``orig_dtype``: the JAX package's ``QuantizedLeaf``)
becomes the port's :class:`nvae_torch.serving.QuantizedLeaf`, ``q`` and
``scale`` moved through the same layout change.  :func:`channel_axes` says
which port axis is the Flax leaf's last one, the axis JAX quantizes per.

:func:`backbone_state_dict_from_flax` does the same for the metric suite's
feature backbones, whose port modules carry the Flax layer names: a Flax
path joined by ``.`` is the port key, ``kernel`` (HWIO) becoming
``weight`` (OIHW).
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


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A tensor owning a copy of ``a``; a bf16 array (``ml_dtypes``, which
    ``torch.from_numpy`` does not take) keeps its bits as bf16, any other
    float becomes fp32, and integers keep their type."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(a)
    return t.to(torch.float32) if t.is_floating_point() else t


def state_dict_from_flax(variables, module: nn.Module) -> Dict[str, torch.Tensor]:
    """The port ``module``'s state_dict from a Flax ``variables`` tree.

    Raises on any Flax leaf the port has no tensor for, on a shape mismatch,
    and on any port tensor left unfilled."""
    from nvae_torch.serving import QuantizedLeaf

    layout = _flax_layout(module)
    own = module.state_dict()
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables):
        if path not in layout:
            raise KeyError(f"unknown Flax leaf {'/'.join(path)}")
        key, (fn, _) = layout[path]
        if key in sd:
            raise KeyError(f"{key} filled twice (second from {'/'.join(path)})")
        if hasattr(leaf, "q") and hasattr(leaf, "scale"):
            value = QuantizedLeaf(
                _tensor(fn(np.asarray(leaf.q))),
                _tensor(fn(np.asarray(leaf.scale))),
                getattr(torch, str(leaf.orig_dtype)))
            shape = value.q.shape
        else:
            value = _tensor(fn(np.asarray(leaf)))
            shape = value.shape
        if tuple(shape) != tuple(own[key].shape):
            raise ValueError(
                f"{'/'.join(path)} -> {key}: shape {tuple(shape)}, "
                f"port expects {tuple(own[key].shape)}"
            )
        sd[key] = value
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"port tensors not filled from Flax: {missing}")
    return sd


def channel_axes(module: nn.Module) -> Dict[str, int]:
    """For each port tensor with a Flax leaf, the port axis that is the
    Flax leaf's last axis (the output channel of an HWIO kernel, of a Dense
    ``(in, out)`` kernel and of ``h``'s ``(H, W, C)``).  Read off each
    layout change by moving a tensor whose axes have distinct sizes."""
    own = module.state_dict()
    primes = (2, 3, 5, 7, 11, 13)
    out = {}
    for key, (_, inv) in _flax_layout(module).values():
        d = own[key].dim()
        if d:
            last = inv(np.empty(primes[:d], np.int8)).shape[-1]
            out[key] = primes.index(last)
    return out


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


def backbone_state_dict_from_flax(name: str, params) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the metric backbone ``name`` (``random_conv``,
    ``vgg16``, ``inception`` or an alias) from its Flax parameter tree of
    numpy arrays (``{"params": tree}`` or the tree itself).

    Raises on a Flax leaf the port has no tensor for, on a shape mismatch,
    and on any port tensor left unfilled."""
    from nvae_torch.eval.features import backbone_module

    if isinstance(params, dict) and set(params) == {"params"}:
        params = params["params"]
    own = backbone_module(name).state_dict()
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        *parents, kind = path
        a = np.asarray(leaf)
        if kind == "kernel":
            kind, a = "weight", _hwio_to_oihw[0](a)
        key = ".".join((*parents, kind))
        if key not in own:
            raise KeyError(f"unknown Flax leaf {'/'.join(path)}")
        if key in sd:
            raise KeyError(f"{key} filled twice (second from {'/'.join(path)})")
        if tuple(a.shape) != tuple(own[key].shape):
            raise ValueError(f"{'/'.join(path)} -> {key}: shape {a.shape}, "
                             f"port expects {tuple(own[key].shape)}")
        sd[key] = _tensor(a)
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"port tensors not filled from Flax: {missing}")
    return sd
