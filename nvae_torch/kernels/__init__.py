"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Nothing is compiled at import: a wrapper builds its library the first time it
launches on a CUDA tensor (see ``_build.py``).  The squeeze-excitation gate
is ``nvae_torch.kernels.se_gate.se_gate``.
"""

from nvae_torch.kernels.depthwise import (
    depthwise_conv5x5,
    fused_swish_depthwise5x5,
    fused_swish_depthwise5x5_plain,
)

__all__ = [
    "depthwise_conv5x5",
    "fused_swish_depthwise5x5",
    "fused_swish_depthwise5x5_plain",
]
