"""Multi-process execution over ``torch.distributed`` (counterpart of
``nvae_tpu/parallel/multihost.py``).

JAX runs one controller per host and stitches the hosts' devices into one
SPMD program.  PyTorch runs one process per device instead: a launcher
(``torchrun --nproc_per_node N -m nvae_torch.cli ...``) starts N ranks, each
drives its own card, and the collectives of ``parallel/mesh.py`` join them.
Every rank runs the same program over its rows of the global batch; the
state is replicated, so whatever one rank holds every rank holds, bit for
bit.

As in JAX, each rank owns only its rows of the input: :func:`global_batch`
puts them on the rank's device, and no data crosses ranks to build a batch.

A pipeline of S stages with N ranks a stage (``parallel/pipeline.py``) is a
world of S x N ranks, ``torchrun --nproc_per_node S*N``, stage-major: ranks
``[s N, (s + 1) N)`` hold stage s (``parallel.mesh.make_stage_mesh``).
There the state is replicated within a stage, and each stage's ranks hold
only its share of it.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nvae_torch.device import DeviceLike, resolve_device

# How long a collective may wait for the other ranks before it raises.
TIMEOUT = timedelta(minutes=10)


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_rank: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> None:
    """``torch.distributed.init_process_group`` with environment fallbacks.

    The coordinator is ``host:port`` (``NVAE_TORCH_COORDINATOR``, or
    torchrun's ``MASTER_ADDR`` and ``MASTER_PORT``), the world size
    ``NVAE_TORCH_NUM_PROCESSES`` or ``WORLD_SIZE``, the rank
    ``NVAE_TORCH_PROCESS_ID`` or ``RANK``, the local rank ``LOCAL_RANK``
    (default: the rank).  The backend is ``NVAE_TORCH_DIST_BACKEND`` when
    set, else NCCL on the card and gloo on the CPU.  A world of 1 with no
    coordinator is a no-op, as in JAX; so is a second call.

    On the card each rank is bound to ``cuda:LOCAL_RANK``.  NCCL refuses
    two ranks on one card, so ranks share a card only under gloo (local
    rank modulo the card count), which sums on the host: a check of the
    cross-rank sums, not a measurement of scaling.  Call it before anything
    touches the card."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("NVAE_TORCH_COORDINATOR")
        if coordinator_address is None and "MASTER_ADDR" in os.environ:
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', 29500)}")
    if num_processes is None:
        num_processes = _env_int("NVAE_TORCH_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("NVAE_TORCH_PROCESS_ID", "RANK")
    if coordinator_address is None and (num_processes or 1) == 1:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a multi-process run needs a coordinator, a world size and a "
            "rank (torchrun sets them; else NVAE_TORCH_COORDINATOR, "
            "NVAE_TORCH_NUM_PROCESSES and NVAE_TORCH_PROCESS_ID)")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
        local_rank = process_id if local_rank is None else local_rank
    dev = resolve_device(device)
    backend = backend or os.environ.get("NVAE_TORCH_DIST_BACKEND") or (
        "nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if local_rank >= count and backend != "gloo":
            raise ValueError(
                f"local rank {local_rank} has no card of its own ({count} "
                f"cards); {backend} runs one rank per card")
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=TIMEOUT, **kw)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that writes logs, images, checkpoints and
    ``evaluation.json`` (rank 0)."""
    return process_index() == 0


def process_local_rows(n_global: int, index: Optional[int] = None,
                       count: Optional[int] = None) -> Tuple[int, int]:
    """Half-open row range ``[lo, hi)`` of a global batch or dataset owned
    by this rank (or by rank ``index`` of ``count``): contiguous blocks,
    which needs ``n_global`` divisible by the world size."""
    p = process_index() if index is None else index
    n = process_count() if count is None else count
    if n_global % n:
        raise ValueError(
            f"global size {n_global} not divisible by {n} processes")
    per = n_global // n
    return p * per, (p + 1) * per


def global_batch(local_rows, mesh) -> torch.Tensor:
    """This rank's rows (the block :func:`process_local_rows` names) on its
    device: the port's form of JAX's global, data-sharded array, of which
    each rank holds only its own shard."""
    if not isinstance(local_rows, torch.Tensor):
        local_rows = torch.from_numpy(np.ascontiguousarray(local_rows))
    return local_rows.to(mesh.device)
