"""The port's squeeze-excitation gate on the CPU (its plain version) against
the JAX package's ``se_gate`` in Pallas interpret mode and its
``se_gate_reference``, and against the port's ``SqueezeExcitation`` module
with the same weights, at atol 1e-5 (``tests/test_kernels.py``'s limit):
the same float32 formula in other summation orders.  The kernel itself runs
on the card only (``tests/test_torch_cuda.py``, ``chip_smoke.py``); its
launch geometry, computed on the host from the shape alone, is checked
here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch.kernels import se_gate as se_module
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
    (2, 8, 8, 128, 8),  # the model's 8x8 SE
    (2, 16, 16, 64, 4),  # the model's 16x16 SE
    (2, 32, 32, 32, 4),  # the model's 32x32 SE
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


# (H * W, C, hidden): the model's SE shapes, JAX's test shape, pixel counts
# that are not multiples of the cluster size (1, 7, 25, 63), C % 4 != 0,
# C < the cluster size, and wide maps.
GEOMETRY_SHAPES = [
    (16, 256, 16), (64, 128, 8), (256, 64, 4), (1024, 32, 4),
    (1, 5, 4), (1, 512, 32), (2, 3, 4), (7, 40, 4), (25, 64, 4),
    (63, 40, 4), (63, 7, 3), (100, 1, 1), (1024, 5, 4), (4096, 32, 4),
    (9, 200, 12), (12, 8, 4), (17, 4, 4), (64, 16, 1),
]


@pytest.mark.parametrize("hw,c,hd", GEOMETRY_SHAPES)
def test_geometry_tiles_pixels(hw, c, hd):
    """Each cluster's blocks own contiguous pixel ranges that tile [0, H*W)
    exactly, in rank order; every block has a pixel; the cluster is at most
    8 (the portable size) and at most H*W blocks, and the fewest (up to 2)
    that keep a block's slice within 32 KB of x; a block alone in its
    cluster has 256 threads, else 128; the shared bytes fit one Hopper
    block."""
    g = se_module.geometry(3, hw, c, hd)
    assert 1 <= g.cluster <= min(8, hw)
    assert g.blocks == 3 * g.cluster
    pixels = [g.pixels(r) for r in range(g.cluster)]
    assert [p for r in pixels for p in r] == list(range(hw))
    assert all(len(r) >= 1 for r in pixels)
    assert max(map(len, pixels)) - min(map(len, pixels)) <= 1
    fewest = max(1, min(2, hw, -(-hw * c // 8192)))
    assert g.cluster >= fewest
    assert g.cluster == fewest or se_module._smem_bytes(
        hw, c, hd, g.cluster - 1, 256 if g.cluster == 2 else 128) > 232_448
    assert g.threads == (256 if g.cluster == 1 else 128)
    assert g.smem_bytes <= 232_448
    assert g.smem_bytes % 16 == 0
    assert g.c_array()[:] == [g.cluster, g.threads, g.smem_bytes]


def test_geometry_needs_no_device_and_fits_one_wave(monkeypatch):
    """The geometry is a function of the shape alone: computed with every
    device query broken, it equals the cached one.  At the model's four SE
    shapes at B=144 it gives one block of 256 threads per row at 4x4 and
    8x8, clusters of 2 blocks of 128 at 16x16 and 32x32, and the
    blocks fit one wave of an H100 (132 SMs) at the occupancy their shared
    memory allows (the kernel asks for 1,280 threads per SM)."""
    def refuse(*args, **kwargs):
        raise AssertionError("geometry queried a device")

    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for hw, c, hd in GEOMETRY_SHAPES:
        assert se_module.geometry.__wrapped__(5, hw, c, hd) == \
            se_module.geometry(5, hw, c, hd)
    for (hw, c, hd), k in zip(GEOMETRY_SHAPES[:4], (1, 1, 2, 2)):
        g = se_module.geometry(144, hw, c, hd)
        assert g.cluster == k and g.blocks == 144 * k
        assert g.threads == (256 if k == 1 else 128)
        per_sm = min(1280 // g.threads, 233_472 // (g.smem_bytes + 1024))
        assert g.blocks <= 132 * per_sm
    with pytest.raises(ValueError, match="empty"):
        se_module.geometry(0, 16, 32, 4)


def _largest_c(hw, hd):
    c = 1
    while True:
        try:
            se_module.geometry(1, hw, c + 1, hd)
        except ValueError:
            return c
        c += 1


@pytest.mark.parametrize("h,w,hd", [(1, 1, 4), (8, 8, 4), (32, 32, 4),
                                    (7, 9, 16)])
def test_check_refuses_what_geometry_refuses(h, w, hd):
    """``_check`` (what the wrapper runs before a launch) takes the largest
    C the geometry takes and refuses the next one, naming the limit."""
    c = _largest_c(h * w, hd)
    if (h, w) == (8, 8):
        assert c == 2896  # chip_smoke.SE_MAX_C, tested on the card
    args = [torch.zeros(s) for s in ((1, h, w, c), (c, hd), (hd,), (hd, c),
                                     (c,))]
    assert se_module._check(*args) == se_module.geometry(1, h * w, c, hd)
    args = [torch.zeros(s) for s in ((1, h, w, c + 1), (c + 1, hd), (hd,),
                                     (hd, c + 1), (c + 1,))]
    with pytest.raises(ValueError, match="232448 B a Hopper block"):
        se_module._check(*args)
