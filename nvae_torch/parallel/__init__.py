"""Data parallelism and the FSDP layout over ``torch.distributed``
(counterpart of ``nvae_tpu/parallel``'s data axis: ``mesh.py`` and
``multihost.py``), and pipeline training over the stage modules
(``pipeline.py``), in one process or over a world of stages x data ranks.
The tensor-parallel layout waits for ROADMAP.md Queue 1 #9d."""

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

__all__ = ["DataMesh", "PipelineTrainer", "assert_replicated",
           "fsdp_sharding", "gathered_params", "global_batch", "initialize",
           "is_primary", "make_mesh", "process_count", "process_index",
           "process_local_rows", "shard_batch", "shard_state",
           "shard_state_fsdp", "stage_names"]


def __getattr__(name):
    # The pipeline imports the train step, which imports this package's
    # mesh module: load it on first use, not with the package.
    if name in ("PipelineTrainer", "stage_names"):
        from nvae_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
