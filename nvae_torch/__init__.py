"""nvae_torch: the PyTorch/CUDA port of nvae_tpu, for one NVIDIA H100.

This package imports torch and numpy, never JAX or ``nvae_tpu``.  It mirrors
``nvae_tpu``'s layout so each module's counterpart is easy to find.  The
first slice ported the prior sampler and its serving path
(``config`` -> ``nn`` -> ``models.nvae`` -> ``serving`` -> ``serving_runtime``),
the second one training step (``train``: losses, optimizer, state, step),
with the fused swish->depthwise-5x5 CUDA kernels (forward, dx, dW/db) in
``kernels``, the third the training entry point (``cli`` -> ``presets``,
``data``, ``train.trainer``, ``train.checkpoint``, the eval step,
``eval.nll``, ``utils``) and the squeeze-excitation gate kernel
(``kernels.se_gate``).
"""

from nvae_torch.config import (
    MNIST_CONFIG,
    ModelConfig,
    TrainConfig,
    debug_config,
)
from nvae_torch.presets import get_preset

__all__ = ["MNIST_CONFIG", "ModelConfig", "TrainConfig", "debug_config",
           "get_preset"]
