"""The data axis over ``torch.distributed`` and the layouts of a train state
over it (counterpart of ``nvae_tpu/parallel/mesh.py``).

JAX declares a ``("data", "model")`` mesh and GSPMD inserts the gradient
``psum``, the cross-replica BatchNorm sums and FSDP's all-gathers and
reduce-scatters.  Here the ranks of a process group are the data axis, and
the collectives are written out where the training step needs them
(``train/step.py``, ``nn/blocks.py``, ``train/losses.py``,
``train/optim.py``): they are :class:`DataMesh`'s methods.

- :func:`make_mesh` builds the data axis over the initialized group's
  world (``parallel.multihost.initialize``), and with ``n_model > 1`` the
  ``("data", "model")`` grid of JAX's ``make_mesh``: world rank r is data
  index ``r // n_model`` and model index ``r % n_model``, and the returned
  :class:`DataMesh` (the data axis, a process group of the ranks that share
  a model index) carries the model axis as its ``model``, a
  :class:`DataMesh` over the ranks that share a data index.
- :func:`make_stage_mesh` builds, in a world of S x N ranks, the data axis
  of this rank's pipeline stage: a process group of the N ranks that hold
  the stage (``parallel/pipeline.py``), over which :class:`DataMesh`'s
  collectives run.
- :func:`shard_batch` gives a rank its rows of a global batch, in the
  microbatch-major layout a ``grad_accum`` step needs.
- :func:`shard_state` replicates a train state from rank 0 and checks it
  (the DP layout).
- :func:`shard_state_fsdp` is the FSDP (ZeRO-3) layout: each parameter of
  at least ``min_size`` elements, its two Adamax moments and its EMA are
  held as this rank's 1/N block (:class:`Shard`, chosen by
  :func:`fsdp_sharding`); :func:`gathered_params` makes the model read them
  whole for a pass, through :func:`whole`'s one all-gather, whose backward
  reduce-scatters the gradients.
- :func:`shard_state_tp` is the tensor-parallel layout over a mesh with a
  model axis: each conv kernel that :func:`tp_param_sharding` selects (JAX's
  rule: a kernel of at least ``min_features`` output channels) is held as
  this rank's block of output channels, with its Adamax moments and EMA,
  and the modules that read it compute on this rank's slice of the
  channels (``parallel/tp.py`` has the collectives between the slices).

JAX's ``data_sharding`` and ``replicated`` are ``NamedSharding``s, a layout
that the compiler reads; a tensor here has no such layout, so they are not
kept.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

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
    """The data axis: the ``size`` ranks of ``group`` (None: the world),
    this one ``rank`` among them, its tensors on ``device``.  Every rank of
    the group calls each collective in the same order.  In a data x model
    world (:func:`make_mesh` with ``n_model > 1``) ``model`` is the model
    axis, a mesh of its own over the ranks that share this rank's data
    index; the methods here run over the data axis alone."""

    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    model: Optional["DataMesh"] = None

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it.  Every rank gets
        the same bits."""
        dist.all_reduce(t, group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks (a new tensor)."""
        return self.all_reduce_(t.clone()) / self.size

    def mean_with_grad(self, t: torch.Tensor) -> torch.Tensor:
        """:meth:`mean`, differentiable: the backward pass sums the
        gradients over the ranks."""
        return _AllReduceSum.apply(t, self) / self.size

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of the group's rank ``src`` on every rank, in place."""
        if self.group is not None:
            src = dist.get_global_rank(self.group, src)
        dist.broadcast(t, src, group=self.group)
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on all ranks), concatenated along
        the first axis in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def all_gather_into(self, out: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        """Every rank's 1-D ``t`` into ``out`` (``size * t.numel()``
        entries), in rank order; returns ``out``.  NCCL gathers into
        ``out`` in one call (which a CUDA graph can capture); gloo
        gathers into its rows as views."""
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, t, group=self.group)
        else:
            dist.all_gather(list(out.view(self.size, -1).unbind(0)), t,
                            group=self.group)
        return out

    def reduce_scatter_sum_(self, out: torch.Tensor,
                            t: torch.Tensor) -> torch.Tensor:
        """``out`` (1-D, ``t.numel() / size`` entries) becomes this rank's
        block of the sum of ``t`` over the ranks.  NCCL reduce-scatters;
        gloo all-reduces the whole of ``t`` (in place) and keeps this
        rank's block.  Returns ``out``."""
        if self.backend == "nccl":
            dist.reduce_scatter_tensor(out, t, group=self.group)
        else:
            dist.all_reduce(t, group=self.group)
            out.copy_(t.view(self.size, -1)[self.rank])
        return out

    def reduce_scatter_mean_(self, out: torch.Tensor,
                             t: torch.Tensor) -> torch.Tensor:
        """:meth:`reduce_scatter_sum_`, then divided by the rank count, as
        the data-parallel step's all-reduce takes its mean."""
        return self.reduce_scatter_sum_(out, t).div_(self.size)

    def barrier(self) -> None:
        dist.barrier(group=self.group)

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


def _rank_device(device) -> torch.device:
    """``device``, or the rank's card (the one ``initialize`` bound; raises
    if there is no card)."""
    if device is None:
        resolve_device("cuda")  # raises without a card
        device = torch.device("cuda", torch.cuda.current_device())
    return resolve_device(device)


def make_mesh(n_data: int = 0, n_model: int = 1,
              device=None) -> Optional[DataMesh]:
    """The data axis over the initialized process group's world, on
    ``device`` (default: the rank's card, the one
    ``initialize`` bound; raises if there is no card).  ``n_data`` 0 means
    every rank (over ``n_model``); any other value times ``n_model`` must be
    the world size: each rank is a process of its own, started by a
    launcher, and none may sit idle.  A process with no group is a world
    of 1 without a data axis: None.

    With ``n_model > 1`` the world is JAX's ``(n_data, n_model)`` grid,
    ``devices.reshape(n_data, n_model)``: world rank r is data index
    ``r // n_model`` and model index ``r % n_model``.  The returned mesh is
    the data axis, over a process group of the ranks of r's model index,
    and its ``model`` the model axis, over a group of the ranks of r's data
    index.  Every rank calls it, since every rank must create every group,
    in the same order.  The layout of such a mesh is
    :func:`shard_state_tp`'s."""
    if n_model < 1:
        raise ValueError(f"a model axis of {n_model}")
    size = dist.get_world_size() if dist.is_initialized() else 1
    if n_model == 1 and n_data not in (0, size):
        raise ValueError(
            f"a data axis of {n_data} needs {n_data} ranks, one process per "
            f"device: launch them with torchrun --nproc_per_node {n_data} -m "
            f"nvae_torch.cli ... --data_parallel {n_data} (this is a world "
            f"of {size}), or pass 0")
    if n_model > 1:
        n_data = n_data or max(size // n_model, 1)
        if n_data * n_model != size:
            n = n_data * n_model
            raise ValueError(
                f"a data axis of {n_data} x a model axis of {n_model} needs "
                f"{n} ranks, one process per device: launch them with "
                f"torchrun --nproc_per_node {n} (this is a world of {size})")
    if not dist.is_initialized():
        return None
    device = _rank_device(device)
    me = dist.get_rank()
    if n_model == 1:
        return DataMesh(me, size, device)
    data_groups = [dist.new_group(list(range(m, size, n_model)))
                   for m in range(n_model)]
    model_groups = [dist.new_group(list(range(d * n_model,
                                              (d + 1) * n_model)))
                    for d in range(n_data)]
    d, m = divmod(me, n_model)
    return DataMesh(d, n_data, device, data_groups[m],
                    model=DataMesh(m, n_model, device, model_groups[d]))


def make_stage_mesh(n_stages: int, n_data: int,
                    device=None) -> Tuple[int, DataMesh]:
    """This rank's pipeline stage and its data axis, in a world of
    ``n_stages * n_data`` ranks: stage s is held by world ranks
    ``[s n_data, (s + 1) n_data)``, stage-major as JAX slices its devices
    for stage s's submesh (``devices[s * dp:(s + 1) * dp]``), and the
    returned :class:`DataMesh` runs its collectives over a process group of
    those ranks.  Every rank calls it, since every rank must create every
    group, in the same order.  ``device`` as for :func:`make_mesh`."""
    world = dist.get_world_size()
    if world != n_stages * n_data:
        raise ValueError(f"{n_stages} stages x {n_data} ranks need a world "
                         f"of {n_stages * n_data}, not {world}")
    me = dist.get_rank()
    groups = [dist.new_group(list(range(s * n_data, (s + 1) * n_data)))
              for s in range(n_stages)]
    stage = me // n_data
    return stage, DataMesh(me % n_data, n_data, _rank_device(device),
                           groups[stage])


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


def _mismatches(named: Dict[str, torch.Tensor], state,
                mesh: DataMesh) -> List[str]:
    names = list(named) + ["step", "epoch", "seed"]
    sums = checksums(list(named.values())).to(mesh.device)
    counters = torch.tensor([state.step, state.epoch, state.seed],
                            dtype=torch.int64, device=mesh.device)
    mine = torch.cat([sums, counters])
    every = mesh.all_gather_rows(mine[None]).cpu()
    differ = (every != every[0]).any(dim=0)
    return [n for n, d in zip(names, differ.tolist()) if d]


def replica_mismatches(state, mesh: DataMesh) -> List[str]:
    """The names of the state's tensors and counters that are not the same
    on every rank (by :func:`checksums`); empty when the state is
    replicated.  A shard (:func:`shard_of`), a block of its own on each
    rank of its axis, is not compared over that axis: FSDP's over the data
    axis; a TP block over the model axis, while the ranks of a model index
    hold the same block and are compared.  Every rank of the world calls
    it."""
    named = state_tensors_named(state)
    bad = _mismatches({k: t for k, t in named.items()
                       if shard_axis(t) != "data"},
                      state, mesh)
    if mesh.model is not None:
        bad += [k for k in _mismatches(
            {k: t for k, t in named.items() if shard_of(t) is None},
            state, mesh.model) if k not in bad]
    return bad


def assert_replicated(state, mesh: DataMesh) -> None:
    bad = replica_mismatches(state, mesh)
    if bad:
        raise AssertionError(f"the state differs across ranks in "
                             f"{len(bad)} tensors: {bad[:5]}")


def _refuse_model_axis(mesh: DataMesh, layout: str) -> None:
    """JAX's ``shard_state`` and ``shard_state_fsdp`` refuse a mesh with a
    model axis, whose layout is ``shard_state_tp``'s; so do the port's."""
    if mesh.model is not None and mesh.model.size > 1:
        raise ValueError(
            f"{layout}; this mesh has a model axis of size "
            f"{mesh.model.size}. Use shard_state_tp")


def shard_state(state, mesh: DataMesh):
    """Replicate the train state over the ranks (the DP layout): rank 0's
    parameters, buffers and optimizer state are broadcast into every rank's
    tensors in place, and its counters and seed into the returned state,
    which is then checked to be the same on every rank.  The tensors go
    in one broadcast per dtype (a few thousand small collectives would each
    pay a round trip).  A mesh with a model axis raises, as in JAX."""
    _refuse_model_axis(mesh, "shard_state is the pure-DP layout")
    state = _replicate(state, mesh)
    assert_replicated(state, mesh)
    return state


def _replicate(state, mesh: DataMesh):
    """The state of the axis's rank 0 on each of its ranks (see
    :func:`shard_state`), unchecked."""
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
    return dataclasses.replace(state, step=counters[0], epoch=counters[1],
                               seed=counters[2])


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


# ---- FSDP: parameters, Adamax moments and EMA sharded over the ranks --------

FSDP_MIN_SIZE = 65536


def fsdp_dim(shape: Sequence[int], n_shard: int,
             min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The dimension along which FSDP splits a tensor of ``shape`` over
    ``n_shard`` ranks, or None where it stays replicated (JAX's
    ``_fsdp_spec``): a tensor of fewer than ``min_size`` elements stays
    whole (biases, BatchNorm scales, the spectral vectors: sharding them
    saves nothing and adds collectives), and so does one with no dimension
    that ``n_shard`` divides.  So the set of sharded tensors is JAX's, whose
    layouts hold the same dimensions in another order.

    The dimension differs from JAX's: dimension 0 where ``n_shard`` divides
    it, else, as JAX, the largest divisible one, ties to the trailing one.
    JAX's tie-break picks the lane dimension of its HWIO kernels; dimension
    0 of the port's OIHW kernels, (C, 1, 5, 5) taps and (C,) vectors makes a
    rank's block one contiguous run of memory (its output channels), which
    the gather writes without a transpose.  A pure function of the shape,
    so a parameter, its two Adamax moments and its EMA split alike."""
    shape = tuple(int(d) for d in shape)
    numel = 1
    for d in shape:
        numel *= d
    if not shape or numel < min_size:
        return None
    dims = [i for i, d in enumerate(shape)
            if d % n_shard == 0 and d >= n_shard]
    if not dims:
        return None
    return 0 if 0 in dims else max(dims, key=lambda i: (shape[i], i))


def fsdp_sharding(shapes: Mapping[str, Sequence[int]], n_shard: int,
                  min_size: int = FSDP_MIN_SIZE) -> Dict[str, int]:
    """The FSDP layout of named tensors (JAX's ``fsdp_sharding``): the
    tensors that split over ``n_shard`` ranks, each with its dimension
    (:func:`fsdp_dim`); the others stay replicated."""
    out = {}
    for name, shape in shapes.items():
        d = fsdp_dim(shape, n_shard, min_size)
        if d is not None:
            out[name] = d
    return out


@dataclasses.dataclass(frozen=True)
class Shard:
    """What a tensor of the FSDP or the TP layout holds: of the whole
    tensor of ``shape``, this rank's block of ``shape[dim] / mesh.size``
    entries along ``dim``, block ``mesh.rank``, over the ``axis``
    (``"data"``: FSDP's, ``mesh`` the data axis; ``"model"``: TP's, ``mesh``
    the model axis).  A sharded tensor carries it as its ``fsdp_shard``
    attribute (:func:`shard_of`)."""

    mesh: DataMesh
    dim: int
    shape: Tuple[int, ...]
    axis: str = "data"

    @property
    def block(self) -> int:
        return self.shape[self.dim] // self.mesh.size

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        s = list(self.shape)
        s[self.dim] = self.block
        return tuple(s)

    def of(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (of ``shape``), a contiguous
        copy."""
        if tuple(full.shape) != self.shape:
            raise ValueError(f"a shard of {self.shape} from a tensor of "
                             f"{tuple(full.shape)}")
        return full.narrow(self.dim, self.mesh.rank * self.block,
                           self.block).contiguous()


def shard_of(t) -> Optional[Shard]:
    """The :class:`Shard` a tensor of the FSDP or TP layout holds; None for
    a whole tensor."""
    return getattr(t, "fsdp_shard", None)


def shard_axis(t) -> str:
    """The axis a tensor's :class:`Shard` splits it over (``"data"``:
    FSDP, ``"model"``: TP); ``""`` for a whole tensor."""
    return getattr(shard_of(t), "axis", "")


def _shard_(t: torch.Tensor, spec: Shard) -> None:
    """``t`` becomes ``spec``'s block of itself, in place of the whole (the
    same tensor object, so that whatever holds it keeps it)."""
    t.data = spec.of(t.data)
    t.fsdp_shard = spec


def _gather(specs: Sequence[Shard], shards: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    """Each shard whole, in one all-gather of all of them: every rank's
    blocks, packed flat, land in one (N, total) buffer, from which each
    whole tensor is put together along its dimension."""
    mesh = specs[0].mesh
    flat = torch.cat([s.reshape(-1) for s in shards])
    every = mesh.all_gather_into(
        flat.new_empty(mesh.size * flat.numel()), flat).view(mesh.size, -1)
    out, offset = [], 0
    for spec, s in zip(specs, shards):
        n = s.numel()
        blocks = every[:, offset:offset + n].view(mesh.size, *spec.shard_shape)
        out.append(torch.cat(blocks.unbind(0), dim=spec.dim))
        offset += n
    return out


def _reduce_scatter(specs: Sequence[Shard], grads: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """The transpose of :func:`_gather`: the whole tensors' gradients,
    packed as the gather packed the shards, in one reduce-scatter whose
    blocks are the mean over the ranks (FSDP's: each data rank's gradient
    is of its rows) or the sum (TP's: each model rank's is its share of
    the one loss); each shard's gradient is a view of this rank's
    block."""
    mesh = specs[0].mesh
    packed = []
    for spec, g in zip(specs, grads):
        d = spec.dim
        split = (*spec.shape[:d], mesh.size, spec.block, *spec.shape[d + 1:])
        packed.append(g.reshape(split).movedim(d, 0).reshape(mesh.size, -1))
    packed = torch.cat(packed, dim=1)
    reduce = (mesh.reduce_scatter_mean_ if specs[0].axis == "data"
              else mesh.reduce_scatter_sum_)
    mine = reduce(packed.new_empty(packed.shape[1]), packed.view(-1))
    return [v.view(spec.shard_shape) for v, spec in zip(
        mine.split([math.prod(spec.shard_shape) for spec in specs]), specs)]


class _GatherShards(torch.autograd.Function):
    """Shards in, whole tensors out, by one all-gather; the backward
    reduce-scatters the whole tensors' gradients back to the shards
    (:func:`_reduce_scatter`: over the data axis the mean, as the
    data-parallel step's all-reduce takes it for the replicated
    parameters; over the model axis the sum)."""

    @staticmethod
    def forward(ctx, specs, *shards):
        ctx.specs = specs
        return tuple(_gather(specs, shards))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_reduce_scatter(ctx.specs, grads))


def whole(tensors: Sequence[torch.Tensor],
          specs: Optional[Sequence[Optional[Shard]]] = None
          ) -> List[torch.Tensor]:
    """Each tensor whole: a shard (its ``specs`` entry, by default its own
    :func:`shard_of`) gathered from every rank, any other as it is.  The
    shards of one dtype go in one all-gather, a collective that every rank
    must call with the same tensors.  With gradients enabled and a shard
    that requires them, the gather is differentiable (:class:`_GatherShards`:
    the backward reduce-scatters).  The shards of each axis are gathered
    over it, the data axis's first."""
    tensors = list(tensors)
    if specs is None:
        specs = [shard_of(t) for t in tensors]
    out = list(tensors)
    groups: Dict[Tuple[str, torch.dtype], List[int]] = {}
    for i, (t, spec) in enumerate(zip(tensors, specs)):
        if spec is not None:
            groups.setdefault((spec.axis, t.dtype), []).append(i)
    groups = dict(sorted(groups.items(), key=lambda kv: kv[0][0]))
    for idx in groups.values():
        ss = tuple(specs[i] for i in idx)
        ts = [tensors[i] for i in idx]
        if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            full = _GatherShards.apply(ss, *ts)
        else:
            full = _gather(ss, [t.detach() for t in ts])
        for i, f in zip(idx, full):
            out[i] = f
    return out


@contextlib.contextmanager
def gathered_params(model: torch.nn.Module
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """While it is open, every sharded parameter of ``model`` reads whole:
    one :func:`whole` gathers them all (a collective: every rank opens it
    at the same point), and each module's attribute is the whole tensor,
    so every read of it sees the whole (the forward, the power iteration
    of forward-mode spectral normalization, the depthwise kernels' taps,
    the penalties, and a rematerialized cell's second run in the backward
    pass).  Under autograd the backward pass reduce-scatters the gradients
    into the shards' ``.grad``.  Yields ``{name: whole tensor}``; with no
    shard it gathers nothing and yields ``{}``, and so does a nested
    opening (the attributes are whole already).  A TP block stays a block:
    its modules compute on it (:func:`shard_state_tp`)."""
    named = [(k, p) for k, p in model.named_parameters()
             if shard_axis(p) == "data"]
    if not named:
        yield {}
        return
    fulls = whole([p for _, p in named])
    swapped = []
    try:
        for (name, p), full in zip(named, fulls):
            owner, _, attr = name.rpartition(".")
            m = model.get_submodule(owner)
            m._parameters[attr] = full
            swapped.append((m, attr, p))
        yield {name: full for (name, _), full in zip(named, fulls)}
    finally:
        for m, attr, p in swapped:
            m._parameters[attr] = p


def _param_keyed(opt_state, names) -> Iterator[Tuple[dict, str]]:
    """(dict, key) of every leaf of an optimizer state held in a dict under
    a parameter's name (``train/optim.py``: Adamax's ``mu`` and ``nu``, the
    EMA, the spectral ``u`` and sigma)."""
    stack = [opt_state]
    while stack:
        s = stack.pop()
        if isinstance(s, dict):
            for k, v in s.items():
                if k in names and isinstance(v, torch.Tensor):
                    yield s, k
                else:
                    stack.append(v)
        elif isinstance(s, (tuple, list)):
            stack.extend(s)
        elif dataclasses.is_dataclass(s) and not isinstance(s, type):
            stack.extend(getattr(s, f.name) for f in dataclasses.fields(s))


def shard_state_fsdp(state, mesh: DataMesh, min_size: int = FSDP_MIN_SIZE):
    """The FSDP (ZeRO-3) layout of a train state (JAX's
    ``shard_state_fsdp``): the state is replicated from rank 0 first
    (:func:`shard_state`), then each parameter that :func:`fsdp_sharding`
    selects becomes this rank's block of itself (:class:`Shard`, the same
    tensor object), and so does every optimizer leaf held under its name
    with its shape: the two Adamax moments and the EMA, whose elementwise
    updates then run on the blocks unchanged.  The BatchNorm statistics,
    the spectral ``u`` vectors and sigmas (a power iteration reads ``u``
    whole; it has a kernel's output count of entries, under ``min_size``
    in every preset), the update counts and the counters stay replicated,
    which is checked as :func:`shard_state` checks the whole state.  Shard
    a state before its first step: the step's gradient buffers take the
    shapes of the parameters it first sees.  A mesh with a model axis
    raises, as in JAX."""
    _refuse_model_axis(mesh, "shard_state_fsdp shards over the data axis "
                             "only")
    state = shard_state(state, mesh)
    params = dict(state.model.named_parameters())
    specs = {k: Shard(mesh, d, tuple(params[k].shape)) for k, d in
             fsdp_sharding({k: p.shape for k, p in params.items()},
                           mesh.size, min_size).items()}
    with torch.no_grad():
        for k, spec in specs.items():
            _shard_(params[k], spec)
        for d, k in list(_param_keyed(state.opt_state, specs)):
            if tuple(d[k].shape) == specs[k].shape:
                _shard_(d[k], specs[k])
    assert_replicated(state, mesh)
    return state


def state_bytes(state) -> int:
    """The bytes a rank holds of a train state: its parameters, buffers and
    optimizer state (a shard's block, not the whole)."""
    return sum(t.numel() * t.element_size()
               for t in state_tensors_named(state).values())


# ---- TP: the wide kernels split over the model axis -------------------------

TP_MIN_FEATURES = 512


def tp_param_sharding(model: torch.nn.Module, n_model: int,
                      min_features: int = TP_MIN_FEATURES) -> Dict[str, int]:
    """The parameters of ``model`` (any device, ``meta`` too) that the TP
    layout splits over a model axis of ``n_model`` ranks, each with the
    dimension it splits along (JAX's ``tp_param_sharding``): JAX's rule
    applied to each parameter's Flax leaf, found through
    ``nvae_torch.convert``'s map: a 4-D leaf (a conv's HWIO kernel, a
    depthwise conv's (5, 5, 1, C) taps) whose last dimension, its output
    channels, is at least ``min_features`` and divisible by ``n_model``.
    That dimension is the port tensor's dimension 0 (OIHW, (C, 1, 5, 5))."""
    import numpy as np

    from nvae_torch.convert import _flax_layout

    if n_model <= 1:
        return {}
    own = model.state_dict()
    out = {}
    for path, (key, (_, to_flax)) in _flax_layout(model).items():
        shape = tuple(own[key].shape)
        if path[0] != "params" or len(shape) != 4:
            continue
        flax = to_flax(np.broadcast_to(np.float32(0), shape)).shape
        if flax[-1] >= min_features and flax[-1] % n_model == 0:
            assert shape[0] == flax[-1], (key, shape, flax)
            out[key] = 0
    return out


def _tp_roles(model: torch.nn.Module, specs: Mapping[str, Shard],
              tp: DataMesh) -> None:
    """Give each module that reads a TP block its part (``tp``: the model
    axis; an ``SNConv``'s ``tp_role``), and mark each whole parameter that
    a module reads in slices ``tp_partial`` (the model axis): this rank's
    gradient of it is its share, which the step sums over the model axis.

    (a) An expansion cell (``GenerativeResidualCell``, and
    ``PostprocessNode`` in its depthwise form) whose expansion kernel is
    split: the 1x1 expansion is column-parallel (``"column"``: this rank's
    output channels), the BatchNorms between it and the projection, and
    the fused swish -> depthwise 5x5 (#2-#4), run on this rank's slice of
    the hidden channels, and the projection is row-parallel (``"row"``:
    this rank's input channels, then one sum over the model axis, then the
    bias).  (b) Any other split conv is column-parallel with its output
    channels gathered (``"gather"``)."""
    from nvae_torch.nn.blocks import (BatchNorm, GenerativeResidualCell,
                                      PostprocessNode)
    from nvae_torch.nn.spectral import DepthwiseConv, SNConv

    roles: Dict[torch.nn.Module, Tuple[str, str]] = {}
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, GenerativeResidualCell):
            parts = (("expand", "column"), ("bn1", "slice"), ("dw", "slice"),
                     ("bn2", "slice"), ("project", "row"))
        elif isinstance(m, PostprocessNode) and m.dw is not None:
            parts = (("expand.conv", "column"), ("expand.bn", "slice"),
                     ("dw", "slice"), ("bn_mid", "slice"),
                     ("project", "row"))
        else:
            continue
        if f"{pre}{parts[0][0]}.weight" not in specs:
            continue
        if f"{pre}dw.weight" not in specs:
            raise ValueError(f"{pre}dw.weight is not split with its "
                             f"expansion")
        for sub, role in parts:
            roles[m.get_submodule(sub)] = (f"{pre}{sub}", role)
    for name, m in model.named_modules():
        if f"{name}.weight" in specs and m not in roles:
            if not isinstance(m, SNConv):
                raise ValueError(f"{name}.weight is split outside an "
                                 f"expansion cell")
            roles[m] = (name, "gather")

    def partial(p) -> None:
        if p is not None and shard_of(p) is None:
            p.tp_partial = tp

    for m, (name, role) in roles.items():
        m.tp = tp
        if isinstance(m, SNConv):
            m.tp_role = role
            partial(m.weight)
            if role != "row":
                partial(m.bias)
        elif isinstance(m, (BatchNorm, DepthwiseConv)):
            partial(m.weight)
            partial(m.bias)


def shard_state_tp(state, mesh: DataMesh,
                   min_features: int = TP_MIN_FEATURES):
    """The tensor-parallel layout of a train state over a data x model mesh
    (JAX's ``shard_state_tp``): the state is replicated from world rank 0
    first (over the model axis, then the data axis), then each parameter
    that :func:`tp_param_sharding` selects becomes this rank's block of its
    output channels on the model axis (:class:`Shard` with ``axis="model"``,
    the same tensor object), and so do its two Adamax moments and its EMA,
    whose elementwise updates then run on the blocks.  JAX places the
    moments replicated and lets GSPMD re-shard them; here they follow their
    parameter.  The modules that read a block compute on this rank's
    channels (:func:`_tp_roles`), so a pass over the model calls the model
    axis's collectives (``parallel/tp.py``) on every rank in one order.

    The BatchNorm statistics, the spectral ``u`` vectors and sigmas, the
    update counts and every other parameter stay whole, the same on all
    ranks, which is checked (:func:`assert_replicated`).  Shard a state
    before its first step."""
    if mesh is None or mesh.model is None:
        raise ValueError("shard_state_tp needs a mesh with a model axis: "
                         "make_mesh(n_data, n_model) with n_model > 1")
    tp = mesh.model
    state = _replicate(_replicate(state, tp), mesh)
    params = dict(state.model.named_parameters())
    specs = {k: Shard(tp, d, tuple(params[k].shape), axis="model")
             for k, d in tp_param_sharding(state.model, tp.size,
                                           min_features).items()}
    with torch.no_grad():
        for k, spec in specs.items():
            _shard_(params[k], spec)
        for d, k in list(_param_keyed(state.opt_state, specs)):
            if tuple(d[k].shape) == specs[k].shape:
                _shard_(d[k], specs[k])
    _tp_roles(state.model, specs, tp)
    assert_replicated(state, mesh)
    return state
