from nvae_torch.models.nvae import NVAE

__all__ = ["NVAE"]
