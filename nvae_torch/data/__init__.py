"""Datasets (numpy, from local files or synthetic) and the device-side
input pipeline (counterpart of ``nvae_tpu/data``)."""

from nvae_torch.data.datasets import (
    DataBundle,
    DatasetUnavailable,
    load_dataset,
    synthetic_dataset,
)
from nvae_torch.data.pipeline import BatchIterator, make_iterators, prepare_batch

__all__ = [
    "BatchIterator",
    "DataBundle",
    "DatasetUnavailable",
    "load_dataset",
    "make_iterators",
    "prepare_batch",
    "synthetic_dataset",
]
