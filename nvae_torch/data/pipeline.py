"""Input pipeline on the device (counterpart of ``nvae_tpu/data/pipeline.py``).

The host gathers uint8 rows of a shuffled batch into pinned memory and
copies them to the card without blocking; padding, scaling to [0, 1] and the
binarization run there (:func:`prepare_batch`), with a fresh Bernoulli draw
for every batch, or the reference's ``> 0`` threshold under
``parity_binarize_255``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nvae_torch.data.datasets import DataBundle
from nvae_torch.device import DeviceLike, resolve_device
from nvae_torch.parallel.mesh import shard_batch
from nvae_torch.utils.seeds import derive_seed

_INV_255 = float(np.float32(1.0 / 255.0))


def prepare_batch(
    batch_u8: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    target_size: int = 32,
    binarize: bool = True,
    parity_binarize_255: bool = False,
    *,
    uniform: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """uint8 (B, H, W, C) -> float32 (B, S, S, C) in [0, 1], on the batch's
    device: zero-pad (``pad // 2`` before) or centre-crop to ``target_size``,
    scale to [0, 1], then binarize: ``u < x / 255`` with ``u`` uniform, drawn
    from ``generator`` or injected as ``uniform`` (B, S, S, C), or
    ``x > 0`` under ``parity_binarize_255``."""
    x = batch_u8.to(torch.float32)
    h = x.shape[1]
    if h < target_size:
        pad = target_size - h
        lo, hi = pad // 2, pad - pad // 2
        x = F.pad(x, (0, 0, lo, hi, lo, hi))
    elif h > target_size:
        crop = (h - target_size) // 2
        x = x[:, crop:crop + target_size, crop:crop + target_size, :]
    if parity_binarize_255 and binarize:
        # Reference defect parity: Bernoulli(probs in [0, 255]) == every
        # nonzero pixel -> 1 (reference datasets.py:13-15).
        return (x > 0).to(torch.float32)
    # x times the float32 reciprocal of 255: what the jitted JAX pipeline
    # computes for x / 255 (XLA rewrites the division), bit for bit.
    probs = x * _INV_255
    if not binarize:
        return probs
    if uniform is None:
        uniform = torch.rand(probs.shape, generator=generator,
                             device=probs.device)
    elif tuple(uniform.shape) != tuple(probs.shape):
        raise ValueError(f"uniform has shape {tuple(uniform.shape)}, the "
                         f"batch {tuple(probs.shape)}")
    return (uniform.to(probs.device) < probs).to(torch.float32)


def batch_seed(seed: int, epoch: int, batch: int) -> int:
    """Generator seed of the binarization noise of batch ``batch`` of epoch
    ``epoch`` (the JAX pipeline folds ``epoch * 100003 + batch`` into its
    key): ``derive_seed(seed, "data", epoch, batch)``."""
    return derive_seed(seed, "data", epoch, batch)


class BatchIterator:
    """Shuffled, epoch-aware batch stream, prepared on the device.

    Yields float batches on ``device``.  The host's share is a gather of
    uint8 rows into one of two pinned buffers and a non-blocking copy to the
    card; batch k + 1 is gathered, copied and prepared before batch k is
    handed out, so its host work overlaps the work the card runs for batch
    k.  An epoch's order is JAX's, ``np.random.RandomState(hash((e,
    0x5EED)) % 2**31).shuffle`` (a tuple of ints hashes the same in every
    process), so both packages see the same batches.

    Over a data ``mesh`` every rank takes the same order and the same
    binarization draws, prepares the global batch and yields its rows of
    it (``parallel.mesh.shard_batch``, microbatch-major under
    ``grad_accum``); ``batch_size`` and ``len()`` stay the global batch's
    and the global batch count.
    """

    def __init__(
        self,
        images: np.ndarray,
        batch_size: int,
        *,
        target_size: int = 32,
        binarize: bool = True,
        parity_binarize_255: bool = False,
        shuffle: bool = True,
        drop_remainder: bool = True,
        seed: int = 0,
        device: DeviceLike = "cuda",
        max_batches: Optional[int] = None,
        mesh=None,
        grad_accum: int = 1,
    ):
        self.mesh = mesh
        self.grad_accum = grad_accum
        self.images = images
        self.batch_size = batch_size
        self.target_size = target_size
        self.binarize = binarize
        self.parity_binarize_255 = parity_binarize_255
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.seed = seed
        self.device = resolve_device(device)
        n = (len(images) // batch_size if drop_remainder
             else -(-len(images) // batch_size))
        self.batches_per_epoch = min(n, max_batches) if max_batches else n
        self._epoch = 0
        self._source = torch.from_numpy(np.ascontiguousarray(images))
        # Two pinned staging buffers and the copy event of each: a buffer is
        # refilled only after the copy out of it has finished.
        self._pinned = [None, None]
        self._copied = [None, None]
        self._slot = 0

    def __len__(self) -> int:
        return self.batches_per_epoch

    def _to_device(self, idx: np.ndarray) -> torch.Tensor:
        index = torch.from_numpy(idx)
        if self.device.type != "cuda":
            return self._source.index_select(0, index)
        k = self._slot
        self._slot = 1 - k
        shape = (len(idx), *self._source.shape[1:])
        if self._pinned[k] is None or self._pinned[k].shape != shape:
            self._pinned[k] = torch.empty(shape, dtype=self._source.dtype,
                                          pin_memory=True)
        elif self._copied[k] is not None:
            self._copied[k].synchronize()
        torch.index_select(self._source, 0, index, out=self._pinned[k])
        dev = self._pinned[k].to(self.device, non_blocking=True)
        self._copied[k] = torch.cuda.Event()
        self._copied[k].record()
        return dev

    def _make_batch(self, order: np.ndarray, e: int, b: int):
        idx = order[b * self.batch_size:(b + 1) * self.batch_size]
        if len(idx) < self.batch_size and self.drop_remainder:
            return None
        gen = torch.Generator(device=self.device).manual_seed(
            batch_seed(self.seed, e, b))
        batch = prepare_batch(
            self._to_device(idx), gen, target_size=self.target_size,
            binarize=self.binarize,
            parity_binarize_255=self.parity_binarize_255,
        )
        if self.mesh is None:
            return batch
        return shard_batch(batch, self.mesh, self.grad_accum)

    def epoch(self, epoch_idx: Optional[int] = None) -> Iterator[torch.Tensor]:
        """One pass over the data: one shuffle, fresh binarization noise."""
        e = self._epoch if epoch_idx is None else epoch_idx
        self._epoch = e + 1
        order = np.arange(len(self.images))
        if self.shuffle:
            np.random.RandomState(hash((e, 0x5EED)) % (2**31)).shuffle(order)
        pending = None
        for b in range(self.batches_per_epoch):
            nxt = self._make_batch(order, e, b)
            if nxt is None:
                break
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending

    def __iter__(self):
        return self.epoch()


def make_iterators(
    bundle: DataBundle,
    batch_size: int,
    *,
    target_size: int = 32,
    binarize: bool = True,
    parity_binarize_255: bool = False,
    seed: int = 0,
    device: DeviceLike = "cuda",
    debug: bool = False,
    mesh=None,
    grad_accum: int = 1,
) -> Tuple[BatchIterator, BatchIterator]:
    """(train, test) iterators on ``device``; ``debug`` truncates both to 4
    batches, the reference's smoke-test fixture (``train.py:103-105``).
    Over a data ``mesh`` each yields this rank's rows of every global batch
    (the training set's microbatch-major under ``grad_accum``)."""
    max_batches = 4 if debug else None
    kw = dict(target_size=target_size, binarize=binarize,
              parity_binarize_255=parity_binarize_255, device=device,
              max_batches=max_batches, mesh=mesh)
    train = BatchIterator(bundle.train_x, batch_size, shuffle=True, seed=seed,
                          grad_accum=grad_accum, **kw)
    test = BatchIterator(bundle.test_x, batch_size, shuffle=False,
                         seed=seed + 1, **kw)
    return train, test
