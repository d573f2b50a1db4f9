from nvae_torch.ops.math import gaussian_log_prob, softclamp5

__all__ = ["gaussian_log_prob", "softclamp5"]
