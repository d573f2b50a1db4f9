"""Serving: a hot-swappable prior sampler on the device (counterpart of
``nvae_tpu/serving.py``'s ``quantize_output`` and ``ReloadableSampler``).

:class:`Sampler` keeps one ``NVAE`` with its weights on the device and is
called as ``(seed, temperature) -> images``; a temperature vector's length
sets the batch size, so one sampler backs several batch shapes.  PyTorch runs
eagerly, so there is no per-shape compile to warm, and a :meth:`Sampler.swap`
copies new weights into the same device tensors.  Work is enqueued on the
current CUDA stream in order, so a dispatch enqueued before a swap still
computes with the old weights: the swap boundary is a dispatch boundary, as
in the JAX sampler.

fp32 serving runs with TF32 off and deterministic cuDNN algorithms
(:func:`nvae_torch.device.fp32_math`).  bf16 and int8 weight serving come
with a later slice.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from nvae_torch.config import ModelConfig
from nvae_torch.device import DeviceLike, fp32_math
from nvae_torch.models.nvae import NVAE


def quantize_output(images: torch.Tensor, output_dtype: str) -> torch.Tensor:
    """Device-side output quantization: ``"uint8"`` gives
    ``round(clip(p, 0, 1) * 255)`` (round half to even, as ``jnp.round``), so
    the device-to-host copy carries one byte per pixel.  ``""`` and
    ``"float32"`` are the identity."""
    if output_dtype in ("", "float32"):
        return images
    if output_dtype == "uint8":
        x = torch.clamp(images.to(torch.float32), 0.0, 1.0)
        return torch.round(x * 255.0).to(torch.uint8)
    raise ValueError(f"unknown output_dtype {output_dtype!r}")


class Sampler:
    """Hot-swappable ``(seed, temperature) -> images`` prior sampler.

    ``seed`` seeds a fresh ``torch.Generator`` on the device for the call, so
    the same ``(seed, temperature)`` gives the same images bitwise on one
    device.  ``temperature`` is a float (``n_samples`` images) or a
    per-sample vector whose length is the batch size; a vector on the CPU
    reaches the card by a non-blocking copy, so a call only enqueues work.  ``scale_temperatures``
    fixes per-scale temperatures for every call (they override
    ``temperature``, as in the JAX sampler).  ``output_dtype="uint8"``
    quantizes the images on the device (:func:`quantize_output`).

    ``device`` defaults to the card and raises if there is none.  The
    weights come from ``state_dict`` (for example
    :func:`nvae_torch.convert.state_dict_from_flax` of a JAX checkpoint), or
    from a Flax-style initialisation seeded by ``init_seed``.
    """

    def __init__(self, cfg: ModelConfig, state_dict: Optional[dict] = None,
                 n_samples: int = 16,
                 scale_temperatures: Optional[Sequence[float]] = None,
                 output_dtype: str = "", device: DeviceLike = "cuda",
                 init_seed: int = 0):
        quantize_output(torch.zeros(1), output_dtype)  # validate early
        self.model = NVAE(cfg, device=device, seed=init_seed)
        self.device = self.model.decoder.h.device
        self.n_samples = int(n_samples)
        self._st = (tuple(float(t) for t in scale_temperatures)
                    if scale_temperatures else None)
        self.output_dtype = output_dtype
        self.generation = 0
        self.step = -1  # checkpoint step served; -1 = constructor weights
        self._lock = threading.Lock()
        if state_dict is not None:
            self.model.load_state_dict(state_dict)

    def __call__(self, seed: int, temperature) -> torch.Tensor:
        n = self.n_samples
        if not isinstance(temperature, (int, float)):
            if not isinstance(temperature, torch.Tensor):
                temperature = np.asarray(temperature, np.float32)
            if temperature.ndim:
                n = temperature.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        with (self._lock, torch.inference_mode(),
              fp32_math(deterministic=True)):
            images, _, _, _ = self.model.sample(
                n, temperature, True, self._st, generator=gen
            )
            return quantize_output(images, self.output_dtype)

    def swap(self, state_dict: dict, step: Optional[int] = None) -> None:
        """Copy ``state_dict`` into the device weights; dispatches enqueued
        after this call use them."""
        with self._lock:
            self.model.load_state_dict(state_dict)
            self.generation += 1
            if step is not None:
                self.step = int(step)

    @property
    def info(self) -> dict:
        with self._lock:
            return {
                "step": self.step,
                "generation": self.generation,
                "serve_dtype": "float32",
                "output_dtype": self.output_dtype or "float32",
                "device": str(self.device),
            }
