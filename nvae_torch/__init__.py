"""nvae_torch: the PyTorch/CUDA port of nvae_tpu, for one NVIDIA H100.

This package imports torch and numpy, never JAX or ``nvae_tpu``.  It mirrors
``nvae_tpu``'s layout so each module's counterpart is easy to find.  The
first slice ports the prior sampler and its serving path:
``config`` -> ``nn`` -> ``models.nvae`` -> ``serving`` -> ``serving_runtime``,
with the fused swish->depthwise-5x5 CUDA kernel in ``kernels``.
"""

from nvae_torch.config import MNIST_CONFIG, ModelConfig, debug_config, get_preset

__all__ = ["MNIST_CONFIG", "ModelConfig", "debug_config", "get_preset"]
