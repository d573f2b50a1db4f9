"""The two uint8 quantizations of the port against the JAX package's, on
the same values: the serving tier's ``quantize_output`` rounds
(``round(clip(p, 0, 1) * 255)``, ties to even), the PNG path's
``to_uint8`` truncates (``clip(p * 255, 0, 255)`` cast down).  The JAX
package does both (``nvae_tpu/serving.py`` ``quantize_output``,
``nvae_tpu/utils/images.py`` ``to_uint8``), so the two disagree by one
level on about half of the values in both packages; each port function
equals its JAX twin exactly.
"""

import jax.numpy as jnp
import numpy as np
import torch

from nvae_torch.serving import quantize_output
from nvae_torch.utils.images import to_uint8
from nvae_tpu.serving import quantize_output as jax_quantize_output
from nvae_tpu.utils.images import to_uint8 as jax_to_uint8


def _values() -> np.ndarray:
    """Probabilities across [0, 1] and past it, every exact level k / 255,
    the half-way points (k + 0.5) / 255 where rounding ties, and their
    float32 neighbours."""
    levels = np.arange(256, dtype=np.float64)
    exact = (levels / 255.0).astype(np.float32)
    half = ((levels[:-1] + 0.5) / 255.0).astype(np.float32)
    near = np.concatenate([np.nextafter(half, np.float32(0)),
                           np.nextafter(half, np.float32(1))])
    rng = np.random.RandomState(0).rand(4096).astype(np.float32)
    outside = np.array([-1.0, -1e-7, 1.0 + 1e-6, 2.0, np.inf, -np.inf],
                       np.float32)
    return np.concatenate([exact, half, near, rng, outside]).reshape(-1, 1, 1,
                                                                     1)


def test_quantize_output_rounds_as_jax():
    x = _values()
    want = np.asarray(jax_quantize_output(jnp.asarray(x), "uint8"))
    got = quantize_output(torch.from_numpy(x), "uint8")
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    # It rounds: a value just past a half-way point takes the level above.
    assert int(quantize_output(torch.tensor([0.6 / 255]), "uint8")) == 1
    assert quantize_output(torch.from_numpy(x), "") is not None


def test_to_uint8_truncates_as_jax():
    x = _values()
    finite = x[np.isfinite(x)].reshape(-1, 1, 1, 1)
    want = jax_to_uint8(finite)
    got = to_uint8(finite)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # It truncates: the same value stays on the level below.
    assert int(to_uint8(np.array([0.6 / 255], np.float32))[0]) == 0
    # The two paths differ by at most one level, and on many values.
    rounded = quantize_output(torch.from_numpy(finite), "uint8").numpy()
    diff = rounded.astype(int) - got.astype(int)
    assert set(np.unique(diff)) == {0, 1}
    assert (diff == 1).mean() > 0.3
