"""Atomic full-state checkpoints (counterpart of
``nvae_tpu/train/checkpoint.py``, which writes through orbax).

A checkpoint is ``<ckpt_dir>/<step>/state.pt``: one ``torch.save`` of a flat
dict of tensors and numbers, with no pickled class, so
``torch.load(path, weights_only=True)`` reads it.  Its keys:

- ``step``, ``epoch``, ``seed``;
- ``model/<name>``: every entry of the model's ``state_dict`` (parameters,
  BatchNorm running statistics, forward-mode spectral ``u``);
- ``opt/<path>``: every leaf of the optimizer state (``train/optim.py``: a
  tuple tree of dataclasses and dicts), its path joined by ``/``; an update
  count (an integer tensor on the device) as the integer it holds.

:func:`restore_checkpoint` loads a checkpoint into the structure of a
template state, as the JAX package restores into a template tree, and
raises when the two differ (a checkpoint written with an EMA slot into a run
without one, say).  A write goes to a temporary directory beside the step's
and is renamed into place, so a step directory is whole or absent.

A state in the FSDP or the TP layout (``parallel.mesh.shard_state_fsdp``,
``shard_state_tp``) is written whole: :func:`flatten_state` gathers every
shard over its axis (a collective, which every rank calls), so the file is
the replicated layout's, and :func:`load_flat_state` copies each rank's
block of a whole tensor into its shard.  A checkpoint restores into any
layout at any world size (under TP, any model axis).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from nvae_torch.parallel.mesh import shard_of, whole
from nvae_torch.parallel.multihost import is_primary
from nvae_torch.train.state import TrainState

FILE = "state.pt"
_COUNTERS = ("step", "epoch", "seed")


def _flatten(tree: Any, path: Tuple[str, ...], out: Dict[str, Any]) -> None:
    if isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, path + (str(i),), out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), path + (f.name,), out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, path + (str(k),), out)
    else:
        out["/".join(path)] = tree


def _unflatten(template: Any, path: Tuple[str, ...], flat: Dict[str, Any]):
    if isinstance(template, (tuple, list)):
        items = [_unflatten(v, path + (str(i),), flat)
                 for i, v in enumerate(template)]
        if hasattr(template, "_fields"):  # a NamedTuple
            return type(template)(*items)
        return type(template)(items)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), path + (f.name,),
                               flat)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _unflatten(v, path + (str(k),), flat)
                for k, v in template.items()}
    key = "/".join(path)
    value = flat[key]
    if isinstance(template, torch.Tensor):
        # Into the live tensor: a captured CUDA graph replays its address.
        if _is_counter(template) and isinstance(value, int):
            return template.fill_(value)
        value = _block(template, value)
        if not isinstance(value, torch.Tensor) or value.shape != template.shape:
            raise ValueError(f"optimizer leaf {key}: checkpoint has "
                             f"{getattr(value, 'shape', value)!r}, the "
                             f"template {tuple(template.shape)}")
        with torch.no_grad():
            return template.copy_(value)
    return value


def _is_counter(v: Any) -> bool:
    """An update count of the optimizer: an integer tensor of one element
    on the device, written to a checkpoint as the integer it holds."""
    return (isinstance(v, torch.Tensor) and v.dim() == 0
            and not v.is_floating_point())


def _block(template: torch.Tensor, value):
    """What a template tensor takes of a checkpoint's ``value``: the whole,
    or, where the template is an FSDP shard, its block of the whole."""
    spec = shard_of(template)
    if spec is None or not isinstance(value, torch.Tensor):
        return value
    return spec.of(value)


@torch.no_grad()
def flatten_state(state: TrainState) -> Dict[str, Any]:
    """The state as a checkpoint's flat dict: the live tensors, and, in
    the FSDP layout, each shard gathered whole (one all-gather that every
    rank must call)."""
    flat: Dict[str, Any] = {k: int(getattr(state, k)) for k in _COUNTERS}
    for k, v in state.model.state_dict(keep_vars=True).items():
        flat[f"model/{k}"] = v
    opt: Dict[str, Any] = {}
    _flatten(state.opt_state, (), opt)
    for k, v in opt.items():
        flat[f"opt/{k}"] = int(v) if _is_counter(v) else v
    keys = [k for k, v in flat.items() if isinstance(v, torch.Tensor)]
    for k, v in zip(keys, whole([flat[k] for k in keys])):
        flat[k] = v.detach()
    return flat


def load_flat_state(template: TrainState, flat: Dict[str, Any]) -> TrainState:
    """A state from a flat dict (a checkpoint's, or a device copy from
    :func:`flatten_state`) in the structure of ``template``.  Every tensor
    is copied in place into the template's (the model's into
    ``template.model``, the optimizer state's into its leaves, the update
    counts filled from their integers): the train step and a captured CUDA
    graph of it hold those tensors."""
    live = template.model.state_dict(keep_vars=True)
    sd = {k[len("model/"):]: v for k, v in flat.items()
          if k.startswith("model/")}
    template.model.load_state_dict(
        {k: _block(live[k], v) if k in live else v for k, v in sd.items()})
    opt = {k[len("opt/"):]: v for k, v in flat.items() if k.startswith("opt/")}
    want: Dict[str, Any] = {}
    _flatten(template.opt_state, (), want)
    if set(opt) != set(want):
        raise ValueError(
            "optimizer state differs from the template: missing "
            f"{sorted(set(want) - set(opt))[:5]}, unexpected "
            f"{sorted(set(opt) - set(want))[:5]}"
        )
    return TrainState(step=int(flat["step"]), epoch=int(flat["epoch"]),
                      model=template.model,
                      opt_state=_unflatten(template.opt_state, (), opt),
                      seed=int(flat["seed"]))


def host_snapshot(state: TrainState) -> Dict[str, Any]:
    """A host copy of the state's flat dict, finished when this returns:
    the tensors on each device are gathered into one buffer per dtype and
    copied to the host in one blocking transfer, so the train step may
    update the parameters in place right after."""
    flat = flatten_state(state)
    groups: Dict[Tuple[torch.device, torch.dtype], List[str]] = {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            groups.setdefault((v.device, v.dtype), []).append(k)
    for keys in groups.values():
        host = torch.cat([flat[k].reshape(-1) for k in keys]).cpu()
        offset = 0
        for k in keys:
            n = flat[k].numel()
            flat[k] = host[offset:offset + n].view(flat[k].shape)
            offset += n
    return flat


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, str(int(step)))


def _write(ckpt_dir: str, step: int, payload: Dict[str, Any]) -> None:
    """Write ``payload`` as checkpoint ``step``: into a temporary directory,
    then renamed into place (an older copy of the step is replaced)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tag = f"{os.getpid()}-{threading.get_ident()}"
    tmp = os.path.join(ckpt_dir, f".tmp-{step}-{tag}")
    os.makedirs(tmp)
    try:
        torch.save(payload, os.path.join(tmp, FILE))
        final = _step_dir(ckpt_dir, step)
        if os.path.exists(final):
            old = os.path.join(ckpt_dir, f".old-{step}-{tag}")
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState) -> None:
    """Write the full state as checkpoint ``step`` and return when it is
    on disk."""
    _write(os.path.abspath(ckpt_dir), step, host_snapshot(state))


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.exists(
                      os.path.join(ckpt_dir, d, FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_payload(ckpt_dir: str, step: int) -> Dict[str, Any]:
    """Checkpoint ``step``'s flat dict, on the host."""
    return torch.load(os.path.join(_step_dir(ckpt_dir, step), FILE),
                      map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir: str, state_template: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """Restore checkpoint ``step`` (default: the latest) into the structure
    of ``state_template`` (:func:`load_flat_state`: the template's model
    takes the weights in place)."""
    steps = all_steps(ckpt_dir)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        step = steps[-1]
    if step not in steps:
        raise FileNotFoundError(f"no checkpoint at step {step} under "
                                f"{ckpt_dir} (available: {steps})")
    return load_flat_state(state_template, load_payload(ckpt_dir, step))


class AsyncCheckpointWriter:
    """Checkpoint writer that overlaps the write with training.

    ``save`` takes a host snapshot of the state before it returns
    (:func:`host_snapshot`: the step updates the parameters in place, so
    the snapshot must be complete before the next step runs), then writes
    it in a background thread.  ``wait`` (or closing) blocks until every
    pending write is on disk and raises the first failure.

    A save for a step at or below the latest saved one (on disk when the
    writer was made, or saved since) is skipped, as orbax's default policy
    skips it, which makes the trainer's final save idempotent with the last
    periodic one.  ``timings`` lists ``(step, blocking_ms, total_ms)`` of
    each finished write: the time ``save`` held the caller, and the time
    until the write was on disk.

    With a data ``mesh`` (``parallel.mesh.DataMesh``) every rank calls
    ``save``: the ranks meet at a barrier and skip the same steps; in the
    FSDP or TP layout every rank then joins the snapshot's gather (under
    TP the mesh is the world's, over which rank 0 is data rank 0 of model
    rank 0); rank 0 alone writes (the whole state is the same on every
    rank) and the others return False.
    """

    def __init__(self, ckpt_dir: str, mesh=None):
        self.mesh = mesh
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self._latest = latest_step(self.ckpt_dir)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="checkpoint")
        self._pending: List[Future] = []
        self.timings: List[Tuple[int, float, float]] = []

    def save(self, step: int, state: TrainState) -> bool:
        step = int(step)
        if self.mesh is not None:
            self.mesh.barrier()
        if self._latest is not None and step <= self._latest:
            return False
        self._latest = step
        if self.mesh is not None and not is_primary():
            if any(shard_of(p) is not None
                   for p in state.model.parameters()):
                flatten_state(state)  # the gather, which rank 0 waits on
            return False
        t0 = time.perf_counter()
        payload = host_snapshot(state)
        blocking_ms = 1e3 * (time.perf_counter() - t0)

        def write():
            _write(self.ckpt_dir, step, payload)
            return step, blocking_ms, 1e3 * (time.perf_counter() - t0)

        self._pending.append(self._pool.submit(write))
        return True

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            self.timings.append(fut.result())

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
