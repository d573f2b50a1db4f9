from nvae_torch.ops.math import (
    bernoulli_log_prob,
    diagonal_gaussian_kl,
    dml_log_prob,
    dml_mean,
    dml_sample,
    gaussian_log_prob,
    normalize_l2,
    slerp,
    softclamp5,
)

__all__ = [
    "bernoulli_log_prob",
    "diagonal_gaussian_kl",
    "dml_log_prob",
    "dml_mean",
    "dml_sample",
    "gaussian_log_prob",
    "normalize_l2",
    "slerp",
    "softclamp5",
]
