"""Metrics logging (counterpart of ``nvae_tpu/utils/logging.py``).

Every scalar lands in an append-only ``metrics.jsonl`` and every image batch
in PNG files under ``<log_dir>/images/<tag>_step<step>/``.  When
``torch.utils.tensorboard`` can be imported the same scalars and images are
mirrored to TensorBoard event files, as the JAX package mirrors them when
TensorFlow is there.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

import numpy as np

from nvae_torch.utils.images import save_images_to_dir


class MetricsLogger:
    def __init__(self, log_dir: str, tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb_writer = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb_writer = SummaryWriter(log_dir)

    def scalars(self, step: int, values: Mapping[str, float], prefix: str = ""):
        floats = {prefix + k: float(v) for k, v in values.items()}
        rec = {"step": int(step), "time": time.time(), **floats}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb_writer is not None:
            for k, v in floats.items():
                self._tb_writer.add_scalar(k, v, int(step))

    def images(self, step: int, tag: str, images: np.ndarray):
        """(N, H, W, C) floats in [0, 1]: PNGs under
        ``<log_dir>/images/<tag>_step<step>/``, and TensorBoard when there."""
        images = np.asarray(images)
        save_images_to_dir(images, os.path.join(self.log_dir, "images",
                                                f"{tag}_step{step}"))
        if self._tb_writer is not None:
            self._tb_writer.add_images(tag, images[:4], int(step),
                                       dataformats="NHWC")

    def close(self):
        self._jsonl.close()
        if self._tb_writer is not None:
            self._tb_writer.close()
