"""One training step of the port (counterpart of ``nvae_tpu/train``):
``losses`` (ELBO, KL balancing and warm-up, penalties), ``optim`` (Adamax,
cosine decay, spectral strategies, EMA), ``state`` and ``step``."""
