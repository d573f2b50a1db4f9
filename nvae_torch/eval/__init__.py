"""Evaluation of the port (counterpart of ``nvae_tpu/eval``): the IWAE
NLL so far; the metric suite comes with a later slice."""
