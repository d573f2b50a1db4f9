"""The port's depthwise 5x5 kernels: the plain PyTorch versions against the
JAX package's Pallas kernels (interpret mode on the CPU), and the wrappers'
routing and checks.  The CUDA kernels themselves are held against the plain
versions in ``tests/test_torch_cuda.py``, on a card.

Tolerances: the forward at atol 2e-5, as in ``tests/test_kernels.py`` (fp32
sums of 25 products in another order); the gradients of the autograd
Function (dx, dW, db) against ``jax.vjp`` of the Pallas op at atol 3e-5
after dividing by the largest |JAX gradient|, as ``tests/test_kernels.py``
does (dW and db sum B*H*W products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch.kernels import depthwise as tdw
from nvae_tpu.kernels.depthwise import depthwise_conv5x5, fused_swish_depthwise5x5

ATOL = 2e-5
SHAPES = [(2, 4, 4, 256), (2, 8, 8, 128), (2, 16, 16, 192)]


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(5, 5, 1, c) * 0.1).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fuse_swish", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_fused_matches_pallas(shape, fuse_swish, with_bias):
    x, k, b = _inputs(shape)
    want = fused_swish_depthwise5x5(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b) if with_bias else None,
        fuse_swish=fuse_swish, interpret=True,
    )
    got = tdw.fused_swish_depthwise5x5_plain(
        torch.from_numpy(x), torch.from_numpy(k),
        torch.from_numpy(b) if with_bias else None, fuse_swish=fuse_swish,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_thin_entry_matches_pallas_dw_kernel(shape):
    x, k, _ = _inputs(shape, seed=1)
    # c_block 64 divides every test width (the Pallas kernel asserts it).
    want = depthwise_conv5x5(jnp.asarray(x), jnp.asarray(k), interpret=True,
                             c_block=64)
    before = tdw.depthwise_conv5x5.launches
    got = tdw.depthwise_conv5x5(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert tdw.depthwise_conv5x5.launches == before  # CPU: plain version


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fuse_swish", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_function_backward_matches_pallas_vjp(shape, fuse_swish, with_bias):
    """The Function's CPU backward (the plain dx and dW/db formulas) against
    the Pallas op's custom VJP under the same ``dy``."""
    x, k, b = _inputs(shape, seed=2)
    dy = np.random.RandomState(7).randn(*shape).astype(np.float32)
    args = (x, k, b) if with_bias else (x, k)

    def pallas(x_, k_, *b_):
        return fused_swish_depthwise5x5(x_, k_, b_[0] if b_ else None,
                                        fuse_swish=fuse_swish, interpret=True)

    _, vjp = jax.vjp(pallas, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    tensors = [torch.from_numpy(a).requires_grad_() for a in args]
    counts = (tdw.fused_swish_depthwise5x5_dx.launches,
              tdw.fused_swish_depthwise5x5_dw.launches)
    y = tdw.fused_swish_depthwise5x5(*tensors, *(() if with_bias else (None,)),
                                     fuse_swish=fuse_swish)
    y.backward(torch.from_numpy(dy))
    assert counts == (tdw.fused_swish_depthwise5x5_dx.launches,
                      tdw.fused_swish_depthwise5x5_dw.launches)
    for t, w in zip(tensors, want):
        denom = float(jnp.abs(w).max()) + 1e-9
        np.testing.assert_allclose(t.grad.numpy() / denom,
                                   np.asarray(w) / denom, atol=3e-5)


@pytest.mark.parametrize("fuse_swish,with_bias", [(True, True), (False, False)])
def test_function_gradcheck_float64(fuse_swish, with_bias):
    rng = np.random.RandomState(3)
    inputs = [torch.from_numpy(rng.randn(2, 5, 6, 3)),
              torch.from_numpy(0.3 * rng.randn(5, 5, 1, 3))]
    if with_bias:
        inputs.append(torch.from_numpy(0.1 * rng.randn(3)))
    for t in inputs:
        t.requires_grad_()

    def fn(x, k, *b):
        return tdw.fused_swish_depthwise5x5(x, k, b[0] if b else None,
                                            fuse_swish=fuse_swish)

    # Hundreds of tiny convolutions: one thread each, or they wait on
    # thread pools that other test workers keep busy.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert torch.autograd.gradcheck(fn, inputs)
    finally:
        torch.set_num_threads(threads)


def test_cpu_tensor_takes_plain_version_without_counting():
    x, k, b = _inputs((2, 4, 4, 64))
    xt, kt, bt = map(torch.from_numpy, (x, k, b))
    before = tdw.fused_swish_depthwise5x5.launches
    got = tdw.fused_swish_depthwise5x5(xt, kt, bt)
    want = tdw.fused_swish_depthwise5x5_plain(xt, kt, bt)
    assert torch.equal(got, want)
    assert tdw.fused_swish_depthwise5x5.launches == before


def test_non_cpu_tensor_never_falls_back():
    """Anything not on the CPU goes to the kernel path, which raises for a
    device it cannot launch on instead of running the plain version."""
    x = torch.empty(2, 4, 4, 32, device="meta")
    k = torch.empty(5, 5, 1, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdw.fused_swish_depthwise5x5(x, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdw.depthwise_conv5x5(x, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdw.fused_swish_depthwise5x5_dx(x, k, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdw.fused_swish_depthwise5x5_dw(x, x)


@pytest.mark.parametrize("case,exc,match", [
    ("kernel_shape", ValueError, "kernel must be"),
    ("bias_shape", ValueError, "bias must be"),
    ("dtype", TypeError, "float32"),
    ("strided_x", ValueError, "contiguous"),
    ("plane", ValueError, "shared memory"),
    ("operand_shape", ValueError, "operand 0 has shape"),
    ("operand_strided", ValueError, "operand 0 must be contiguous"),
])
def test_wrapper_checks(case, exc, match):
    x = torch.zeros(2, 8, 8, 32)
    k = torch.zeros(5, 5, 1, 32)
    b = None
    others = ()
    if case == "kernel_shape":
        k = torch.zeros(3, 3, 1, 32)
    elif case == "bias_shape":
        b = torch.zeros(16)
    elif case == "dtype":
        x = x.double()
    elif case == "strided_x":
        x = torch.zeros(2, 32, 8, 8).permute(0, 2, 3, 1)
    elif case == "plane":  # the first width whose dW/db ring does not fit
        x = torch.zeros(1, 8, 149, 32)
    elif case == "operand_shape":
        others = (torch.zeros(2, 8, 4, 32),)
    elif case == "operand_strided":
        others = (torch.zeros(2, 32, 8, 8).permute(0, 2, 3, 1),)
    with pytest.raises(exc, match=match):
        tdw._check(x, k, b, *others)


def test_path_shapes_fit_one_block():
    """Every shape of the sampling and training path fits the kernels'
    shared memory (the rings of the geometry), and dW/db's stage 1 has
    between 1 and one block per batch row along its batch axis."""
    for h, c in ((4, 1536), (8, 768), (16, 384), (32, 192)):
        x = torch.empty(144, h, h, c, device="meta")
        tdw._check(x, torch.empty(5, 5, 1, c, device="meta"), None, x)
        for kind in ("fwd", "dx", "dw"):
            geo = tdw.geometry(kind, tuple(x.shape))
            assert geo.smem_bytes == tdw._smem_bytes(
                kind, h, geo.slots_per_pass, geo.ahead) <= tdw._MAX_SMEM
        assert 1 <= tdw.dw_parts(x.shape) <= 144
    # The widest plane every kind takes: 148 columns (dW/db's two rings of
    # 2 slots per pass, 1 pass ahead).
    tdw._check(torch.empty(1, 8, 148, 32, device="meta"), None, None)
    with pytest.raises(ValueError, match="shared memory"):
        tdw._check(torch.empty(1, 8, 149, 32, device="meta"), None, None)


# The path shapes at every batch the paths give the kernels, and ragged ones
# (channel chunk, W not a multiple of the run, C % 4 != 0, H and W < 5).
GEOMETRY_SHAPES = [
    (n, h, h, c) for h, c in ((4, 1536), (8, 768), (16, 384), (32, 192))
    for n in (144, 576, 12, 4, 3)
] + [(3, 6, 10, 40), (2, 21, 9, 32), (1, 3, 7, 6), (2, 9, 3, 36),
     (3, 2, 2, 70), (3, 13, 14, 40), (1, 8, 148, 32)]


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
@pytest.mark.parametrize("kind", ["fwd", "dx", "dw"])
def test_geometry_covers_every_row_once(shape, kind):
    """The grid's blocks cover each (batch row, channel chunk) exactly once,
    each block its rows in increasing order; the ring fits a block and the
    grid is at most one wave at the occupancy its shared memory allows
    (unless the chunks alone need more)."""
    geo = tdw.geometry(kind, shape)
    b, _, _, c = shape
    # Grid block i: chunk i // blocks_per_chunk, part i % blocks_per_chunk.
    work = [(i // geo.blocks_per_chunk,
             geo.batch_rows(i % geo.blocks_per_chunk))
            for i in range(geo.blocks)]
    pairs = [(chunk, row) for chunk, rows in work for row in rows]
    assert sorted(pairs) == [(k, r) for k in range(-(-c // 32))
                             for r in range(b)]
    assert len(set(pairs)) == len(pairs)
    assert all(list(rows) == sorted(rows) and len(rows) > 0
               for _, rows in work)
    assert geo.smem_bytes < 232_448
    assert geo.threads == 256 and 1 <= geo.ahead <= 8
    assert geo.slots_per_pass >= 2 and geo.slots_per_pass % 2 == 0
    per_sm = min(4, 233_472 // (geo.smem_bytes + 1024))
    assert geo.blocks <= max(132 * per_sm, geo.chunks)
    assert tdw.geometry.__wrapped__(kind, shape) == geo


def test_geometry_needs_no_device(monkeypatch):
    """The schedule is a function of the shape alone: computed with every
    device query broken, it equals the cached one."""
    def refuse(*args, **kwargs):
        raise AssertionError("geometry queried a device")

    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for shape in GEOMETRY_SHAPES:
        for kind in ("fwd", "dx", "dw"):
            assert tdw.geometry.__wrapped__(kind, shape) == tdw.geometry(
                kind, shape)
    with pytest.raises(ValueError, match="kind"):
        tdw.geometry("dy", (1, 4, 4, 32))


# The bf16 kernels' sliding-row geometry: the path shapes at
# every batch the paths give them, the RGB presets' shapes at theirs
# (cifar10_dml at 128, celeba64 at 64, the sample call's 144, the CLI's
# sweep of 4 x the batch, the P&R halves, the hooks' 12 and 3, the card vs
# CPU checks' 4), and ragged ones (W % 4 != 0, C % 8 != 0, H and W < 5,
# more than 8 strips).
SLIDE_SHAPES = sorted(set(
    [(n, h, h, c) for h, c in ((4, 1536), (8, 768), (16, 384), (32, 192))
     for n in (576, 144, 72, 12, 8, 4, 3)]
    + [(n, h, h, c) for shapes, b in (
        (((4, 2304), (8, 1152), (16, 576), (32, 288)), 128),
        (((4, 4608), (8, 2304), (16, 1152), (32, 576), (64, 288)), 64))
       for h, c in shapes for n in {b, 144, 4 * b, b // 2, 12, 4, 3}]
    + [(3, 6, 10, 40), (2, 21, 9, 32), (1, 3, 7, 6), (2, 9, 3, 36),
       (3, 2, 2, 70), (3, 13, 14, 40), (1, 8, 88, 32), (2, 5, 36, 64)]))


@pytest.mark.parametrize("shape", SLIDE_SHAPES)
@pytest.mark.parametrize("kind", ["fwd", "dx", "dw"])
def test_bf16_sliding_geometry_covers_every_row_once(shape, kind):
    """The grid's blocks cover each (batch row, channel chunk) exactly once,
    each block a power of two of chunks and its rows in increasing order;
    a warp per chunk and 4 columns; 5 slots a pass or a multiple (the
    kernel's register rotation); the shared bytes by the kernel's formula,
    within a block's; a block fits an SM with the build's registers; the
    forward an image a block (24 // (H + 4) short ones), dx two images a
    block up to H = 16 and one past it, dW/db at least two blocks an SM
    where the batch has them; the same when computed again."""
    b, _, w, c = shape
    geo = tdw.geometry(kind, shape, "bfloat16")
    k = geo.chunks_per_block
    pairs = [(chunk, row) for i in range(geo.blocks)
             for chunk in geo.block_chunks(i)
             for row in geo.batch_rows(i % geo.blocks_per_chunk)]
    assert sorted(pairs) == [(j, r) for j in range(-(-c // 32))
                             for r in range(b)]
    assert len(set(pairs)) == len(pairs)
    assert all(list(geo.batch_rows(p)) == sorted(geo.batch_rows(p))
               and len(geo.batch_rows(p)) > 0
               for p in range(geo.blocks_per_chunk))
    assert k >= 1 and k & (k - 1) == 0 and k <= geo.chunks
    strips = -(-w // 4)
    assert geo.threads == 32 * strips * k <= 1024
    assert strips * k <= 8 or k == 1
    assert geo.slots_per_pass % 5 == 0 and 1 <= geo.ahead <= 8
    assert geo.smem_bytes == tdw._bf16_smem_bytes(
        kind, w, geo.slots_per_pass, geo.ahead, k) <= tdw._MAX_SMEM
    regs = {"fwd": {256: 80, 512: 128, 1024: 64},
            "dx": {256: 128, 512: 128, 1024: 64},
            "dw": {256: 128, 512: 128, 1024: 64}}[kind][
        256 if geo.threads <= 256 else 512 if geo.threads <= 512 else 1024]
    per_sm = min(65_536 // (regs * geo.threads), 2048 // geo.threads, 32,
                 233_472 // (geo.smem_bytes + 1024))
    assert per_sm >= 1
    if kind == "fwd":  # an image a block, or 24 // (H + 4) short ones
        rows = max(1, 24 // (shape[1] + 4))
        assert geo.blocks_per_chunk == -(-b // rows)
    elif kind == "dx":  # two images a block up to H = 16, then one
        rows = 2 if shape[1] <= 16 else 1
        assert geo.blocks_per_chunk == -(-b // rows)
    else:  # two blocks an SM at least, where the batch has them
        assert geo.blocks_per_chunk >= min(b, -(-132 * min(per_sm, 2)
                                                // geo.groups))
    assert tdw.geometry.__wrapped__(kind, shape, "bfloat16") == geo


def test_bf16_sliding_geometry_needs_no_device(monkeypatch):
    """The sliding-row schedule is a function of the shape alone: computed
    with every device query broken, it equals the cached one."""
    def refuse(*args, **kwargs):
        raise AssertionError("geometry queried a device")

    want = {(kind, s): tdw.geometry(kind, s, "bfloat16")
            for kind in ("fwd", "dx", "dw") for s in SLIDE_SHAPES}
    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for (kind, s), geo in want.items():
        assert tdw.geometry.__wrapped__(kind, s, "bfloat16") == geo


@pytest.mark.parametrize("kind", ["fwd", "dx", "dw"])
def test_bf16_sliding_geometry_refuses_what_it_cannot_take(kind):
    """Past 128 columns (32 strips: 1024 threads) the bf16 kernels raise,
    naming the shape, and so does the wrappers' check; dW/db's rings fit a
    block up to 88 columns, dx's up to 100, the forward's up to 128
    (``BF16_WIDEST``), and one column past it raises, naming the shape;
    the row ring still takes 129 columns in fp32."""
    widest = {"fwd": 128, "dx": 100, "dw": 88}[kind]
    assert tdw.BF16_WIDEST[kind] == widest
    assert tdw.geometry(kind, (1, 8, widest, 32), "bfloat16").threads == (
        -(-widest // 4) * 32)
    if kind != "fwd":
        with pytest.raises(ValueError,
                           match=rf"shared memory.*\(1, 8, {widest + 1}, 32\)"):
            tdw.geometry(kind, (1, 8, widest + 1, 32), "bfloat16")
    with pytest.raises(ValueError, match=r"\(1, 8, 129, 32\)"):
        tdw.geometry(kind, (1, 8, 129, 32), "bfloat16")
    with pytest.raises(ValueError, match=r"\(1, 8, 129, 32\)"):
        tdw._check(torch.empty(1, 8, 129, 32, device="meta",
                               dtype=torch.bfloat16), None, None)
    assert tdw.geometry(kind, (1, 8, 129, 32)).threads == 256


def test_ring_probe_variants_find_their_source_text():
    """Every variant of ``chip_ring_probe.py`` (the depthwise kernels'
    builds without copies, compute, widening, stores, barriers, and the
    parent tree's bf16 ring's) names text that the source it edits holds
    exactly once, so a probe on the card builds what it says.  The parent's
    bf16 ring (a tree from before the sliding-row dx) shares its copies and
    compute with this tree's fp32 ring; its staged rows' widening is gone
    here with the ring's bf16 instance, so that text must be absent."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "chip_ring_probe", root / "chip_ring_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    csrc = root / "nvae_torch" / "kernels" / "csrc"
    depthwise = (csrc / "depthwise5x5.cu").read_text()
    for name, subs in probe.VARIANTS.items():
        for old, _ in subs:
            assert depthwise.count(old) == 1, (name, old)
    gate = (csrc / "se_gate.cu").read_text()
    for name, subs in probe.SE_VARIANTS.items():
        for old, _ in subs:
            assert gate.count(old) == 1, (name, old)
    # The parent's ring: its bf16 instances were the row ring's, which this
    # tree keeps for fp32 alone.
    for name, subs in probe.PARENT_VARIANTS.items():
        for old, _ in subs:
            want = 0 if name == "no_widen" else 1
            assert depthwise.count(old) == want, (name, old)
    assert "__nv_bfloat16>" not in depthwise  # no bf16 instance of the ring


def test_profile_counts_both_depthwise_kernels_by_name():
    """``chip_smoke.py``'s profile phase counts the depthwise launches of a
    traced replay by kernel name, through the package's profiler tool
    (``nvae_torch.tools.profile_step``): the row ring's (fp32) and the
    sliding-row kernel's (bf16 forward, dx and dW/db), each under its
    wrapper's name, the dW/db reduction not counted again."""
    from nvae_torch.tools.profile_step import depthwise_launches

    ns = "void (anonymous namespace)::"
    rows = [(0.0, 20, ns + "dw5x5_bf16<0, true, true, 256>(Args)"),
            (0.0, 20, ns + "dw5x5_bf16<2, true, false, 256>(Args)"),
            (0.0, 20, ns + "dw5x5_bf16<1, true, false, 256>(Args)"),
            (0.0, 7, ns + "dw5x5_ring<0, true, true, false>(Args)"),
            (0.0, 3, ns + "dw5x5_ring<2, true, false, false>(Args)"),
            (0.0, 23, "dw5x5_dw_reduce(float const*, float*, float*, int, "
                      "int)")]
    assert depthwise_launches(rows) == {
        "fused_swish_depthwise5x5": 7, "depthwise_conv5x5": 0,
        "fused_swish_depthwise5x5_dx": 0, "fused_swish_depthwise5x5_dw": 3,
        "fused_swish_depthwise5x5_bf16": 20,
        "fused_swish_depthwise5x5_dx_bf16": 20,
        "fused_swish_depthwise5x5_dw_bf16": 20}
