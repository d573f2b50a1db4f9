"""Named experiment presets (counterpart of ``nvae_tpu/presets.py``):
``get_preset(name) -> (ModelConfig, TrainConfig)``.

- ``mnist_step_sn``: spectral normalization (projection) and step-based KL
  warm-up; ``mnist_step_sn_parity``: per-forward power iteration and the
  reference's ``> 0`` binarization; ``mnist_step_sr``: spectral
  regularization (penalty); ``mnist_epoch_sn``: epoch-based warm-up.
- ``omniglot_deep`` / ``fashion_mnist_deep``: the deeper hierarchy, three
  latent scales (4, 8, 12 groups).
- ``cifar10_dml``: 32x32 RGB, a 10-component mixture of discretized
  logistics, groups (8, 16), two cells a group, batch 128;
  ``celeba64``: 64x64 RGB, the same head, groups (4, 8, 16) and
  rematerialized cells, batch 64.
"""

from __future__ import annotations

from typing import Tuple

from nvae_torch.config import ModelConfig, TrainConfig

PRESETS = (
    "mnist_step_sn",
    "mnist_step_sn_parity",
    "mnist_step_sr",
    "mnist_epoch_sn",
    "omniglot_deep",
    "fashion_mnist_deep",
    "cifar10_dml",
    "celeba64",
)


def get_preset(name: str) -> Tuple[ModelConfig, TrainConfig]:
    name = name.lower()
    if name == "mnist_step_sn":
        return (ModelConfig(spectral_mode="projection"),
                TrainConfig(dataset="mnist", step_based_warmup=True))
    if name == "mnist_step_sn_parity":
        return (ModelConfig(spectral_mode="forward"),
                TrainConfig(dataset="mnist", step_based_warmup=True,
                            parity_binarize_255=True))
    if name == "mnist_step_sr":
        return (ModelConfig(spectral_mode="penalty"),
                TrainConfig(dataset="mnist", step_based_warmup=True))
    if name == "mnist_epoch_sn":
        return (ModelConfig(spectral_mode="projection"),
                TrainConfig(dataset="mnist", step_based_warmup=False))
    if name in ("omniglot_deep", "fashion_mnist_deep"):
        dataset = "omniglot" if name.startswith("omni") else "fashion_mnist"
        return (ModelConfig(n_groups_per_scale=(4, 8, 12),
                            n_latent_per_group=20),
                TrainConfig(dataset=dataset, step_based_warmup=True))
    if name == "cifar10_dml":
        return (ModelConfig(image_size=32, in_channels=3, likelihood="dml",
                            n_mix=10, n_encoder_channels=48,
                            n_decoder_channels=48, n_groups_per_scale=(8, 16),
                            res_cells_per_group=2),
                TrainConfig(dataset="cifar10", binary=False,
                            step_based_warmup=True, batch_size=128))
    if name == "celeba64":
        return (ModelConfig(image_size=64, in_channels=3, likelihood="dml",
                            n_mix=10, n_encoder_channels=48,
                            n_decoder_channels=48,
                            n_groups_per_scale=(4, 8, 16),
                            res_cells_per_group=2, remat=True),
                TrainConfig(dataset="celeba", binary=False,
                            step_based_warmup=True, batch_size=64,
                            data_parallel=0))
    raise ValueError(f"unknown preset {name!r}; available: "
                     f"{', '.join(PRESETS)}")
