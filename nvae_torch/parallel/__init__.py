"""Data parallelism and the FSDP layout over ``torch.distributed``
(counterpart of ``nvae_tpu/parallel``'s data axis: ``mesh.py`` and
``multihost.py``).  The pipeline waits for ROADMAP.md Queue 1 #9c, the
tensor-parallel layout for #9d."""

from nvae_torch.parallel.mesh import (
    DataMesh,
    assert_replicated,
    fsdp_sharding,
    gathered_params,
    make_mesh,
    shard_batch,
    shard_state,
    shard_state_fsdp,
)
from nvae_torch.parallel.multihost import (
    global_batch,
    initialize,
    is_primary,
    process_count,
    process_index,
    process_local_rows,
)

__all__ = ["DataMesh", "assert_replicated", "fsdp_sharding",
           "gathered_params", "global_batch", "initialize", "is_primary",
           "make_mesh", "process_count", "process_index",
           "process_local_rows", "shard_batch", "shard_state",
           "shard_state_fsdp"]
