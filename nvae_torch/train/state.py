"""Train state (counterpart of ``nvae_tpu/train/state.py``): the step and
epoch counters, the model (its parameters, BatchNorm running statistics and
forward-mode spectral ``u`` vectors), the optimizer state, and the seed the
step's noise is drawn from."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from nvae_torch.config import ModelConfig, TrainConfig
from nvae_torch.device import DeviceLike
from nvae_torch.models.nvae import NVAE
from nvae_torch.nn.spectral import sn_kernel_names
from nvae_torch.train.optim import GradientTransformation, make_optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    epoch: int
    model: NVAE
    opt_state: Any
    seed: int

    def params(self):
        """The model's parameters by name, as the optimizer takes them."""
        return dict(self.model.named_parameters())


def create_train_state(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    total_steps: int,
    *,
    device: DeviceLike = "cuda",
    seed: Optional[int] = None,
    tx: Optional[GradientTransformation] = None,
) -> Tuple[NVAE, TrainState, GradientTransformation]:
    """Build the model on ``device`` (the card unless ``"cpu"`` is asked
    for; raises if there is no card) in training mode, initialised from
    ``seed`` (default ``train_cfg.seed``), and the optimizer and its state."""
    seed = train_cfg.seed if seed is None else int(seed)
    model = NVAE(model_cfg, device=device, seed=seed)
    model.train()
    if tx is None:
        tx = make_optimizer(train_cfg, total_steps, model_cfg.spectral_mode,
                            sn_kernel_names(model))
    state = TrainState(0, 0, model, None, seed)
    state.opt_state = tx.init(state.params())
    return model, state, tx
