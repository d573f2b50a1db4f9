"""Data parallelism over ``torch.distributed`` (counterpart of
``nvae_tpu/parallel``'s data axis: ``mesh.py`` and ``multihost.py``).  The
FSDP and tensor-parallel layouts wait for ROADMAP.md Queue 1 #9b, the
pipeline for #9c."""

from nvae_torch.parallel.mesh import (
    DataMesh,
    assert_replicated,
    make_mesh,
    shard_batch,
    shard_state,
)
from nvae_torch.parallel.multihost import (
    global_batch,
    initialize,
    is_primary,
    process_count,
    process_index,
    process_local_rows,
)

__all__ = ["DataMesh", "assert_replicated", "global_batch", "initialize",
           "is_primary", "make_mesh", "process_count",
           "process_index", "process_local_rows", "shard_batch",
           "shard_state"]
