from nvae_torch.ops.math import (
    bernoulli_log_prob,
    diagonal_gaussian_kl,
    gaussian_log_prob,
    softclamp5,
)

__all__ = [
    "bernoulli_log_prob",
    "diagonal_gaussian_kl",
    "gaussian_log_prob",
    "softclamp5",
]
