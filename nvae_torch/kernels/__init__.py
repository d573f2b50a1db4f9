"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Nothing is compiled at import: a wrapper builds its library the first time it
launches on a CUDA tensor (see ``_build.py``).  The squeeze-excitation gate
is ``nvae_torch.kernels.se_gate.se_gate``.  Importing this package registers
the forward (#2) as the op ``nvae_torch::fused_swish_dw5x5`` (``ops.py``),
which is all an exported sampler program needs of the port.
"""

from nvae_torch.kernels.depthwise import (
    depthwise_conv5x5,
    fused_swish_depthwise5x5,
    fused_swish_depthwise5x5_plain,
)
from nvae_torch.kernels.ops import fused_swish_dw5x5

__all__ = [
    "depthwise_conv5x5",
    "fused_swish_depthwise5x5",
    "fused_swish_depthwise5x5_plain",
    "fused_swish_dw5x5",
]
