"""Training in the port (counterpart of ``nvae_tpu/train``): ``losses``
(ELBO, KL balancing and warm-up, penalties), ``optim`` (Adamax, cosine
decay, spectral strategies, EMA), ``state``, ``step`` (the train and eval
steps), ``checkpoint`` and ``trainer`` (the epoch loop)."""
