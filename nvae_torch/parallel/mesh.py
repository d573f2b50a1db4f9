"""The data axis over ``torch.distributed`` (counterpart of the data-parallel
part of ``nvae_tpu/parallel/mesh.py``).

JAX declares a ``("data", "model")`` mesh and GSPMD inserts the gradient
``psum`` and the cross-replica BatchNorm sums.  Here the ranks of a process
group are the data axis, and the collectives are written out where the
training step needs them (``train/step.py``, ``nn/blocks.py``,
``train/losses.py``): they are :class:`DataMesh`'s methods.

- :func:`make_mesh` builds the data axis over the initialized group
  (``parallel.multihost.initialize``); a ``model`` axis waits for the
  tensor-parallel slice, ROADMAP.md Queue 1 #9b.
- :func:`shard_batch` gives a rank its rows of a global batch, in the
  microbatch-major layout a ``grad_accum`` step needs.
- :func:`shard_state` replicates a train state from rank 0 and checks it.

JAX's ``data_sharding`` and ``replicated`` are ``NamedSharding``s, a layout
that the compiler reads; a tensor here has no such layout, so they are not
kept.  The FSDP and TP layouts (``shard_state_fsdp``, ``shard_state_tp``)
are slice 9b's.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from nvae_torch.device import resolve_device
from nvae_torch.parallel.multihost import process_local_rows


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks, whose backward sums the gradients over ranks:
    each rank's loss reaches every rank's input through the sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.clone()), None


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The data axis: the ``size`` ranks of the world, this one ``rank``, its
    tensors on ``device``.  Every rank calls each collective in the same
    order."""

    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend()

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it.  Every rank gets
        the same bits."""
        dist.all_reduce(t)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks (a new tensor)."""
        return self.all_reduce_(t.clone()) / self.size

    def mean_with_grad(self, t: torch.Tensor) -> torch.Tensor:
        """:meth:`mean`, differentiable: the backward pass sums the
        gradients over the ranks."""
        return _AllReduceSum.apply(t, self) / self.size

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src)
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on all ranks), concatenated along
        the first axis in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        return torch.cat(parts)

    def barrier(self) -> None:
        dist.barrier()

    def rows(self, n_global: int) -> slice:
        """This rank's contiguous block of ``n_global`` rows
        (``multihost.process_local_rows``)."""
        return slice(*process_local_rows(n_global, self.rank, self.size))

    def map_rows(self, x: torch.Tensor, fn: Callable):
        """``fn`` of ``x``'s rows, split over the ranks: ``x`` is padded
        with zero rows to a multiple of the rank count, each rank applies
        ``fn`` to its block, the blocks are gathered and the padding is
        dropped.  ``fn`` must treat each row on its own; it may return one
        tensor or a tuple of them, each with a row per input row."""
        n = x.shape[0]
        pad = (-n) % self.size
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        out = fn(x[self.rows(x.shape[0])])
        outs = out if isinstance(out, tuple) else (out,)
        gathered = []
        for o in outs:
            dtype = o.dtype
            o = o.to(torch.uint8) if dtype == torch.bool else o
            gathered.append(self.all_gather_rows(o)[:n].to(dtype))
        return tuple(gathered) if isinstance(out, tuple) else gathered[0]


def make_mesh(n_data: int = 0, n_model: int = 1,
              device=None) -> Optional[DataMesh]:
    """The data axis over the initialized process group's world, on
    ``device`` (default: the rank's card, the one
    ``initialize`` bound; raises if there is no card).  ``n_data`` 0 means
    every rank; any other value must be the world size: each rank is a
    process of its own, started by a launcher, and none may sit idle.  A
    process with no group is a world of 1 without a data axis: None."""
    if n_model > 1:
        raise NotImplementedError(
            "a model axis waits for tensor parallelism, the parallel "
            "tiers' slice 9b (ROADMAP.md Queue 1 #9b)")
    size = dist.get_world_size() if dist.is_initialized() else 1
    if n_data not in (0, size):
        raise ValueError(
            f"a data axis of {n_data} needs {n_data} ranks, one process per "
            f"device: launch them with torchrun --nproc_per_node {n_data} -m "
            f"nvae_torch.cli ... --data_parallel {n_data} (this is a world "
            f"of {size}), or pass 0")
    if not dist.is_initialized():
        return None
    if device is None:
        resolve_device("cuda")  # raises without a card
        device = torch.device("cuda", torch.cuda.current_device())
    device = resolve_device(device)
    return DataMesh(dist.get_rank(), size, device)


def shard_batch(batch: torch.Tensor, mesh: DataMesh,
                grad_accum: int = 1) -> torch.Tensor:
    """This rank's rows of the global ``batch``.  With ``grad_accum`` M the
    step splits the batch into M microbatches of ``m = B / M`` rows, and
    microbatch i is global rows ``[i m, (i + 1) m)`` split over the ranks
    (JAX pins the ``(M, m)`` reshape to ``P(None, "data")``): rank r holds,
    for each i, rows ``[i m + r m / N, i m + (r + 1) m / N)``, microbatch
    after microbatch.  M = 1 is the contiguous block of
    ``process_local_rows``."""
    b = batch.shape[0]
    mb = batch.reshape(grad_accum, b // grad_accum, *batch.shape[1:])
    mine = mb[:, mesh.rows(b // grad_accum)]
    return mine.reshape(-1, *batch.shape[1:])


def state_tensors_named(state) -> Dict[str, torch.Tensor]:
    """Every tensor of a train state by name: the model's parameters and
    buffers, the optimizer state's leaves."""
    from nvae_torch.train.optim import state_tensors

    out = {f"model/{k}": v for k, v in state.model.state_dict(
        keep_vars=True).items()}
    for i, t in enumerate(state_tensors(state.opt_state)):
        out[f"opt/{i}"] = t
    return out


def checksums(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One int64 per tensor on the device: the sum of its 32-bit words (its
    bytes when its size is not a multiple of 4), which changes with any
    single changed value."""
    out = []
    for t in tensors:
        t = t.detach().contiguous().reshape(-1)
        words = (t.view(torch.int32) if t.element_size() * t.numel() % 4 == 0
                 and t.element_size() in (4, 8)
                 else t.view(torch.uint8))
        out.append(words.to(torch.int64).sum())
    return torch.stack(out) if out else torch.zeros(0, dtype=torch.int64)


def replica_mismatches(state, mesh: DataMesh) -> List[str]:
    """The names of the state's tensors and counters that are not the same
    on every rank (by :func:`checksums`); empty when the state is
    replicated."""
    named = state_tensors_named(state)
    names = list(named) + ["step", "epoch", "seed"]
    sums = checksums(list(named.values())).to(mesh.device)
    counters = torch.tensor([state.step, state.epoch, state.seed],
                            dtype=torch.int64, device=mesh.device)
    mine = torch.cat([sums, counters])
    every = mesh.all_gather_rows(mine[None]).cpu()
    differ = (every != every[0]).any(dim=0)
    return [n for n, d in zip(names, differ.tolist()) if d]


def assert_replicated(state, mesh: DataMesh) -> None:
    bad = replica_mismatches(state, mesh)
    if bad:
        raise AssertionError(f"the state differs across ranks in "
                             f"{len(bad)} tensors: {bad[:5]}")


def shard_state(state, mesh: DataMesh):
    """Replicate the train state over the ranks (the DP layout): rank 0's
    parameters, buffers and optimizer state are broadcast into every rank's
    tensors in place, and its counters and seed into the returned state,
    which is then checked to be the same on every rank.  The tensors go
    in one broadcast per dtype (a few thousand small collectives would each
    pay a round trip)."""
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in state_tensors_named(state).values():
        groups.setdefault(t.dtype, []).append(t.data)
    with torch.no_grad():
        for ts in groups.values():
            flat = mesh.broadcast_(torch.cat([t.reshape(-1) for t in ts]))
            torch._foreach_copy_(ts, [v.view_as(t) for v, t in zip(
                flat.split([t.numel() for t in ts]), ts)])
    counters = mesh.broadcast_(torch.tensor(
        [state.step, state.epoch, state.seed], dtype=torch.int64,
        device=mesh.device)).tolist()
    state = dataclasses.replace(state, step=counters[0], epoch=counters[1],
                                seed=counters[2])
    assert_replicated(state, mesh)
    return state


@contextlib.contextmanager
def batch_stats_over(model: torch.nn.Module, mesh: Optional[DataMesh]):
    """While it is open, every training-mode BatchNorm of ``model`` takes its
    batch statistics over the global batch (``nn/blocks.py``); it leaves
    none with a mesh when it closes, and refuses to open over a module
    that holds one already.  Without a mesh it does nothing."""
    if mesh is None:
        yield
        return
    from nvae_torch.nn.blocks import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    if any(m.mesh is not None for m in bns):
        raise RuntimeError("batch_stats_over is open already on a module "
                           "of this model")
    for m in bns:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in bns:
            m.mesh = None
