"""Data parallelism, the FSDP and the tensor-parallel layouts over
``torch.distributed`` (counterpart of ``nvae_tpu/parallel``'s
``mesh.py`` and ``multihost.py``; the TP collectives in ``tp.py``), and
pipeline training over the stage modules (``pipeline.py``), in one process
or over a world of stages x data ranks."""

from nvae_torch.parallel.mesh import (
    DataMesh,
    assert_replicated,
    fsdp_sharding,
    gathered_params,
    make_mesh,
    shard_batch,
    shard_state,
    shard_state_fsdp,
    shard_state_tp,
    tp_param_sharding,
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
           "shard_state_fsdp", "shard_state_tp", "stage_names",
           "tp_param_sharding"]


def __getattr__(name):
    # The pipeline imports the train step, which imports this package's
    # mesh module: load it on first use, not with the package.
    if name in ("PipelineTrainer", "stage_names"):
        from nvae_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
