"""The port's prior sampler, serving sampler and batching runtime against the
JAX package, on the CPU at debug size.

Both sides run the same weights (random, from numpy, in the Flax tree and
converted by ``nvae_torch.convert``) and the same noise: the JAX
model runs un-jitted under a monkeypatch of ``jax.random.normal`` /
``jax.random.uniform`` that calls the real function and keeps its result, and
the recorded draws are injected into the port.

Tolerance: atol 1e-4 on probabilities, logits, ``last_s`` and ``z`` (fp32 on
both sides, different summation order in the convolutions).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch import config as tcfg
from nvae_torch.convert import state_dict_from_flax
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.models.nvae import decoder_noise_shapes
from nvae_torch.serving import Sampler, quantize_output
from nvae_torch.serving_runtime import PAD_TEMPERATURE, BatchingSampler, dispatch_seed
from nvae_tpu import config as jcfg
from nvae_tpu.models import NVAE as JaxNVAE

ATOL = 1e-4

CONFIGS = {
    "default": dict(use_pallas_kernels=True),
    "depthwise": dict(use_pallas_kernels=True, postprocess_5x5_depthwise=True),
    "forward_sn": dict(use_pallas_kernels=True, spectral_mode="forward"),
    "all_groups": dict(use_pallas_kernels=True, temperature_all_groups=True),
}

_CACHE = {}


def random_flax_variables(model, seed=0):
    """The model's Flax variables tree (from ``jax.eval_shape``, no JAX
    init run) filled from ``np.random.RandomState(seed)``: glorot-uniform
    kernels, small random biases, BatchNorm scales near 1 and random running
    statistics, ``h ~ U[0, 1)``, unit spectral ``u``."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 1)), True,
    ))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name in ("sn_kernel", "dw_kernel", "kernel"):
            rf = int(np.prod(shape[:-2]))
            lim = np.sqrt(6.0 / (rf * shape[-2] + rf * shape[-1]))
            a = rng.uniform(-lim, lim, shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "h":
            a = rng.uniform(0.0, 1.0, shape)
        elif name == "u":
            a = rng.randn(*shape)
            a = a / np.linalg.norm(a)
        else:  # biases, running means
            a = 0.1 * rng.randn(*shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _models(name):
    """(jax model, flax variables as numpy, port model on the CPU)."""
    if name not in _CACHE:
        overrides = CONFIGS[name]
        jm = JaxNVAE(jcfg.debug_config(**overrides))
        variables = random_flax_variables(jm)
        tm = TorchNVAE(tcfg.debug_config(**overrides), device="cpu")
        tm.load_state_dict(state_dict_from_flax(variables, tm))
        _CACHE[name] = (jm, variables, tm)
    return _CACHE[name]


def _record(monkeypatch, fn):
    """Run ``fn()`` with jax.random.normal/uniform recorded."""
    normals, uniforms = [], []
    real_normal, real_uniform = jax.random.normal, jax.random.uniform

    def normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        normals.append(np.asarray(out))
        return out

    def uniform(*args, **kwargs):
        out = real_uniform(*args, **kwargs)
        uniforms.append(np.asarray(out))
        return out

    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal", normal)
        m.setattr(jax.random, "uniform", uniform)
        out = fn()
    return out, normals, uniforms


def _jax_sample(monkeypatch, name, n, temperature, greyscale=True, st=None):
    jm, variables, _ = _models(name)
    return _record(monkeypatch, lambda: jm.apply(
        variables, n, temperature, greyscale, st, method=JaxNVAE.sample,
        rngs={"sample": jax.random.PRNGKey(5)},
    ))


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("name,temperature,st", [
    ("default", 0.7, None),
    ("depthwise", 0.7, None),
    ("forward_sn", 1.0, None),
    ("default", np.array([0.5, 0.8, 1.1], np.float32), None),
    ("depthwise", 1.0, (0.6, 0.9)),
    ("default", 1.0, np.array([[0.4, 0.9, 1.0], [0.7, 1.0, 1.2]], np.float32)),
])
def test_sample_matches_jax(monkeypatch, name, temperature, st):
    (images, last_s, z1, z2), normals, uniforms = _jax_sample(
        monkeypatch, name, 3, temperature, True, st
    )
    _, _, tm = _models(name)
    assert not uniforms
    assert [e.shape for e in normals] == decoder_noise_shapes(tm.cfg, 3)
    got = tm.sample(3, temperature, True, st, eps=normals)
    for want, have in zip((images, last_s, z1, z2), got):
        assert have.shape == want.shape
        np.testing.assert_allclose(have.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", ["default", "depthwise"])
def test_logits_match_jax(monkeypatch, name):
    """The postprocess logits before the sigmoid (probabilities saturate)."""
    jm, variables, tm = _models(name)

    def jax_logits(mdl):
        feats = mdl.decoder.generate(2, 0.8)
        return mdl.postprocess(feats, False)

    logits, normals, _ = _record(monkeypatch, lambda: jm.apply(
        variables, method=jax_logits, rngs={"sample": jax.random.PRNGKey(2)},
    ))
    with torch.no_grad():
        feats, *_ = tm.decoder.generate(2, 0.8, eps=normals)
        got = tm.postprocess(feats).permute(0, 2, 3, 1)
    diff = _max_diff(got, logits)
    assert diff < ATOL, diff


def test_temperature_zero_all_groups_draws_no_noise(monkeypatch):
    (images, *_), normals, _ = _jax_sample(monkeypatch, "all_groups", 2, 0.0)
    _, _, tm = _models("all_groups")
    a, *_ = tm.sample(2, 0.0, eps=normals)
    # T=0 on every group: z = mu, whatever the noise.
    b, *_ = tm.sample(2, 0.0, generator=torch.Generator().manual_seed(9))
    np.testing.assert_allclose(a.numpy(), np.asarray(images), atol=ATOL)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_bernoulli_draws_match_jax(monkeypatch):
    (images, *_), normals, uniforms = _jax_sample(
        monkeypatch, "default", 3, 1.0, greyscale=False
    )
    assert len(uniforms) == 1
    _, _, tm = _models("default")
    got, *_ = tm.sample(3, 1.0, False, eps=normals, uniform=uniforms[0])
    probs, *_ = tm.sample(3, 1.0, True, eps=normals)
    got, want = got.numpy(), np.asarray(images)
    assert set(np.unique(got)) <= {0.0, 1.0}
    # Identical draws except where u sits within tolerance of p.
    near = np.abs(uniforms[0] - probs.numpy()) < ATOL
    assert np.all((got == want) | near)


def test_sample_with_z_matches_jax():
    jm, variables, tm = _models("default")
    rng = np.random.RandomState(3)
    shapes = decoder_noise_shapes(tm.cfg, 2)
    z = rng.randn(*shapes[-1]).astype(np.float32)
    s = rng.randn(2, 16, 16, 16).astype(np.float32)
    want = jm.apply(variables, z, s, method=JaxNVAE.sample_with_z)
    got = tm.sample_with_z(torch.from_numpy(z), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_sampler_uint8_matches_jax_quantize_output():
    from nvae_tpu.serving import quantize_output as jax_quantize

    _, variables, tm = _models("default")
    sd = tm.state_dict()
    cfg = tm.cfg
    s8 = Sampler(cfg, sd, n_samples=4, output_dtype="uint8", device="cpu")
    s32 = Sampler(cfg, sd, n_samples=4, device="cpu")
    t = torch.tensor([0.6, 0.8, 1.0, 1.2])
    u8 = s8(11, t)
    f32 = s32(11, t)
    assert u8.dtype == torch.uint8 and u8.shape == (4, 32, 32, 1)
    want = np.asarray(jax_quantize(jnp.asarray(f32.numpy()), "uint8"))
    np.testing.assert_array_equal(u8.numpy(), want)
    np.testing.assert_array_equal(
        quantize_output(f32, "uint8").numpy(), want
    )
    # A scalar temperature samples n_samples; the same seed replays bitwise.
    np.testing.assert_array_equal(s32(11, 1.0).numpy(), s32(11, 1.0).numpy())
    assert s32(11, 1.0).shape[0] == 4


def test_sampler_swap_and_info():
    _, _, tm = _models("default")
    sampler = Sampler(tm.cfg, tm.state_dict(), device="cpu")
    before = sampler(3, torch.ones(2))
    other = TorchNVAE(tm.cfg, device="cpu", seed=7).state_dict()
    sampler.swap(other, step=12)
    after = sampler(3, torch.ones(2))
    assert not torch.equal(before, after)
    assert sampler.info == {
        "step": 12, "generation": 1, "serve_dtype": "float32",
        "output_dtype": "float32", "device": "cpu",
    }
    with pytest.raises(ValueError):
        Sampler(tm.cfg, device="cpu", output_dtype="int4")


# ---- converter ------------------------------------------------------------


def test_converter_fills_every_tensor_and_counts_match():
    _, variables, tm = _models("forward_sn")
    sd = state_dict_from_flax(variables, tm)
    assert set(sd) == set(tm.state_dict())
    assert any(k.endswith(".u") for k in sd)
    # Every JAX parameter of the full model has a port counterpart.
    n_jax = sum(leaf.size for leaf in jax.tree_util.tree_leaves(variables["params"]))
    assert n_jax == sum(p.numel() for p in tm.parameters())


def test_converter_rejects_unknown_leaf():
    _, variables, tm = _models("default")
    bad = jax.tree_util.tree_map(lambda a: a, variables)
    bad["params"]["decoder"]["cells_1_0"]["mystery"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unknown Flax leaf"):
        state_dict_from_flax(bad, tm)
    # A forward-mode tree's spectral ``u`` vectors are unknown to a
    # projection-mode model.
    _, other, _ = _models("forward_sn")
    with pytest.raises(KeyError, match="unknown Flax leaf"):
        state_dict_from_flax(other, tm)
    short = jax.tree_util.tree_map(lambda a: a, variables)
    del short["params"]["decoder"]["h"]
    with pytest.raises(KeyError, match="not filled"):
        state_dict_from_flax(short, tm)


# ---- batching runtime -------------------------------------------------------


def _fake_sampler(batch):
    """A pure (seed, t_vec) -> images stand-in: row i encodes its temperature
    and the dispatch seed, so routing is verifiable bitwise."""

    def call(seed, t_vec):
        assert tuple(t_vec.shape) == (batch,)
        k = np.float32(seed % 1000) * np.float32(1e-6)
        rows = t_vec.numpy().astype(np.float32) + k
        return torch.from_numpy(np.tile(rows[:, None, None, None], (1, 2, 2, 1)))

    return call


def _expected(batch, dispatch_idx, temps, seed=0):
    t_vec = np.asarray(
        temps + [PAD_TEMPERATURE] * (batch - len(temps)), np.float32
    )
    out = _fake_sampler(batch)(dispatch_seed(seed, dispatch_idx),
                               torch.from_numpy(t_vec))
    return out.numpy()


def test_dispatch_seed_is_documented_and_distinct():
    seeds = {dispatch_seed(s, d) for s in range(4) for d in range(64)}
    assert len(seeds) == 256
    assert all(0 <= s < 2**63 for s in seeds)
    assert dispatch_seed(7, 3) == dispatch_seed(7, 3)


def test_batching_packs_pads_and_spans():
    with BatchingSampler(_fake_sampler(4), 4, max_delay_ms=0) as srv:
        f1 = srv.submit(5, 0.7)
        f2 = srv.submit(2, 0.9)
        srv.flush()
        a, b = f1.result(timeout=10), f2.result(timeout=10)
    # Dispatch 0: rows 0-3 of request 1.  Dispatch 1: row 4 of request 1,
    # both rows of request 2, one padding row.
    d0 = _expected(4, 0, [0.7] * 4)
    d1 = _expected(4, 1, [0.7, 0.9, 0.9])
    np.testing.assert_array_equal(a, np.concatenate([d0, d1[:1]]))
    np.testing.assert_array_equal(b, d1[1:3])
    assert srv.stats.dispatches == 2
    assert srv.stats.rows_padded == 1 and srv.stats.rows_served == 7


def test_batching_max_delay_and_multi_shape():
    shapes = []

    def call(seed, t_vec):
        shapes.append(int(t_vec.shape[0]))
        return np.full((int(t_vec.shape[0]), 1), float(t_vec.shape[0]),
                       np.float32)

    srv = BatchingSampler(call, [2, 8], max_delay_ms=5.0)
    try:
        t0 = time.monotonic()
        out = srv.submit(2, 1.0).result(timeout=10)
        assert time.monotonic() - t0 < 5.0  # the delay timer fired
        assert out.shape == (2, 1) and out[0, 0] == 2.0
        out = srv.submit(9, 1.0).result(timeout=10)  # spans 8 + 1 -> 8, 2
        assert list(out[:, 0]) == [8.0] * 8 + [2.0]
        assert srv.stats.dispatch_shapes == {2: 2, 8: 1}
    finally:
        srv.close()
    with pytest.raises(RuntimeError):
        srv.submit(1, 1.0)


def test_batching_partial_throttle_releases_failed_dispatch():
    calls = {"n": 0}

    class Failing:
        def numpy(self):
            raise RuntimeError("transfer died")

        def __array__(self, dtype=None, copy=None):
            raise RuntimeError("transfer died")

    def flaky(seed, t_vec):
        calls["n"] += 1
        if calls["n"] == 1:
            return Failing()
        return np.full((int(t_vec.shape[0]), 1), 7.0, np.float32)

    srv = BatchingSampler(flaky, 4, max_delay_ms=1.0, partial_max_inflight=1)
    try:
        with pytest.raises(RuntimeError, match="transfer died"):
            srv.submit(1, 0.7).result(timeout=10)
        out = srv.submit(1, 0.7).result(timeout=10)
        assert float(out[0, 0]) == 7.0
        assert srv._inflight_count() == 0
    finally:
        srv.close()


def test_batching_over_cpu_sampler_replays_bitwise():
    """Served rows are bitwise a direct Sampler call with the replayed
    dispatch seed and packed temperature vector."""
    _, _, tm = _models("default")
    sampler = Sampler(tm.cfg, tm.state_dict(), device="cpu")
    B = 4
    with BatchingSampler(sampler, B, max_delay_ms=0, seed=7) as srv:
        f1 = srv.submit(3, 0.6)
        f2 = srv.submit(1, 1.2)
        a, b = f1.result(timeout=60), f2.result(timeout=60)
    direct = sampler(dispatch_seed(7, 0),
                     torch.tensor([0.6, 0.6, 0.6, 1.2])).numpy()
    np.testing.assert_array_equal(a, direct[:3])
    np.testing.assert_array_equal(b, direct[3:])
    assert a.base is None, "a single-span result owns its memory"
