"""Named experiment presets (counterpart of ``nvae_tpu/presets.py``):
``get_preset(name) -> (ModelConfig, TrainConfig)``.

- ``mnist_step_sn``: spectral normalization (projection) and step-based KL
  warm-up; ``mnist_step_sn_parity``: per-forward power iteration and the
  reference's ``> 0`` binarization; ``mnist_step_sr``: spectral
  regularization (penalty); ``mnist_epoch_sn``: epoch-based warm-up.
- ``omniglot_deep`` / ``fashion_mnist_deep``: the deeper hierarchy, three
  latent scales (4, 8, 12 groups).
- ``cifar10_dml`` and ``celeba64`` need the mixture-of-logistics head
  (and ``celeba64`` rematerialization), which the port does not run yet:
  they raise, pointing at ROADMAP.md Queue 1 #4.
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
WAITING = ("cifar10_dml", "celeba64")


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
    if name in WAITING:
        raise NotImplementedError(
            f"preset {name!r} needs the mixture-of-logistics (DML) head"
            + (" and rematerialization" if name == "celeba64" else "")
            + ", not ported yet (ROADMAP.md Queue 1 #4)"
        )
    raise ValueError(f"unknown preset {name!r}; available: "
                     f"{', '.join(PRESETS)}")
