"""The port's squeeze-excitation gate on the CPU (its plain version) against
the JAX package's ``se_gate`` in Pallas interpret mode and its
``se_gate_reference``, and against the port's ``SqueezeExcitation`` module
with the same weights, at atol 1e-5 (``tests/test_kernels.py``'s limit):
the same float32 formula in other summation orders.  The kernel itself runs
on the card only (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch.kernels.se_gate import se_gate, se_gate_reference
from nvae_torch.nn.blocks import SqueezeExcitation
from nvae_tpu.kernels import se_gate as jax_se_gate
from nvae_tpu.kernels import se_gate_reference as jax_se_gate_reference

ATOL = 1e-5


def _inputs(b, h, w, c, hd, seed=0):
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(b, h, w, c), 0.1 * rng.randn(c, hd),
              0.1 * rng.randn(hd), 0.1 * rng.randn(hd, c), 0.1 * rng.randn(c))
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("shape", [
    (4, 8, 8, 128, 8),  # tests/test_kernels.py's shape
    (3, 4, 4, 256, 16),  # the model's 4x4 SE
    (2, 16, 16, 64, 4),  # the model's 16x16 SE
])
def test_se_gate_matches_jax(shape):
    arrays = _inputs(*shape)
    before = se_gate.launches
    got = se_gate(*map(torch.from_numpy, arrays))
    assert se_gate.launches == before  # the CPU takes the plain version
    want = jax_se_gate(*map(jnp.asarray, arrays), interpret=True)
    ref = jax_se_gate_reference(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_array_equal(
        got.numpy(),
        se_gate_reference(*map(torch.from_numpy, arrays)).numpy())


@pytest.mark.parametrize("c", [32, 128])
def test_se_gate_matches_the_port_module(c):
    """The gate with the weights of a ``SqueezeExcitation`` (hidden width
    ``max(C // 16, 4)``) equals the module on the same map, which the model
    keeps as NCHW in channels_last memory (NHWC bytes)."""
    se = SqueezeExcitation(c)
    with torch.no_grad():
        for p in se.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    x = torch.randn(3, 8, 8, c, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = se(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = se_gate(x, se.fc1.weight.t(), se.fc1.bias, se.fc2.weight.t(),
                      se.fc2.bias)
    assert se.fc1.out_features == max(c // 16, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
