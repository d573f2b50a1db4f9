"""The port's serving dtypes, hot swap, checkpoint reloads and artifact,
against the JAX package's ``nvae_tpu/serving.py`` where it has one, on the
CPU at debug size.

- int8: the port's ``q`` and ``scale`` equal JAX's ``quantize_params_int8``
  bitwise, through the converter, on the same set of leaves; bf16: the
  port's cast equals JAX's ``cast_params`` bitwise.  Samples with either at
  fp32 compute match JAX on injected noise at atol 1e-4, as
  ``tests/test_torch_sampler.py`` (fp32 on both sides, other summation
  orders).
- The sampler lock: ``info`` answers while a call is held inside
  ``NVAE.sample``; a swap issued during that call leaves its output bitwise
  the old weights', and the next call is bitwise the new weights'.
- The cases of ``tests/test_serving_reload.py`` on the port's checkpoints
  (bitwise on one program, where JAX's closure and argument programs are
  held to 1e-5), and the artifact's round trip.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch import config as tcfg
from nvae_torch.config import TrainConfig
from nvae_torch.convert import channel_axes, state_dict_from_flax
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.serving import (
    QuantizedLeaf,
    Sampler,
    cast_params,
    export_sampler,
    load_artifact,
    make_checkpoint_reloader,
    quantize_params_int8,
    sampler_keys,
    variables_from_state,
)
from nvae_torch.train import checkpoint as ckpt
from nvae_torch.train.state import create_train_state
from nvae_tpu import serving as jserving
from nvae_tpu.models import NVAE as JaxNVAE
from tests.test_torch_sampler import _models, _record
from tests.test_torch_trainer import single_torch_thread


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_module():
    """One intra-op thread for the module's tests and its module-scoped
    fixtures (``tests/test_torch_trainer.py``'s ``single_torch_thread``)."""
    with single_torch_thread():
        yield


ATOL = 1e-4
B = 4
TINY = dict(n_encoder_channels=8, n_decoder_channels=8,
            n_groups_per_scale=(1, 1), n_latent_per_group=2)


def _port_params(tm, sd):
    return {k: sd[k] for k, _ in tm.named_parameters()}


def test_int8_matches_jax_bitwise_through_the_converter():
    _, variables, tm = _models("default")
    jq = jserving.quantize_params_int8(variables["params"])
    from_jax = state_dict_from_flax({**variables, "params": jq}, tm)
    sd = state_dict_from_flax(variables, tm)
    ours = quantize_params_int8(_port_params(tm, sd), channel_axes(tm))
    n_quantized = 0
    for k, v in ours.items():
        want = from_jax[k]
        assert isinstance(v, QuantizedLeaf) == isinstance(want, QuantizedLeaf), k
        if isinstance(v, QuantizedLeaf):
            n_quantized += 1
            assert v.q.dtype == torch.int8 and v.scale.dtype == torch.float32
            assert torch.equal(v.q, want.q), k
            assert torch.equal(v.scale, want.scale), k
            assert v.orig_dtype == want.orig_dtype == torch.float32
            assert v.scale.shape[0] == v.q.shape[0]  # per output channel
        else:
            assert torch.equal(v, want), k
    assert n_quantized > 10
    # Buffers (BatchNorm statistics) are not parameters: never quantized.
    assert from_jax["decoder.cells.1.0.bn0.running_var"].dtype == torch.float32


def test_bf16_cast_matches_jax_bitwise():
    _, variables, tm = _models("default")
    jc = jserving.cast_params(variables["params"], jnp.bfloat16)
    from_jax = state_dict_from_flax({**variables, "params": jc}, tm)
    sd = state_dict_from_flax(variables, tm)
    ours = cast_params(_port_params(tm, sd), torch.bfloat16)
    for k, v in ours.items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, from_jax[k]), k
    assert from_jax["decoder.cells.1.0.bn0.running_mean"].dtype == torch.float32


@pytest.mark.parametrize("serve_dtype", ["int8", "bfloat16"])
def test_served_samples_match_jax(monkeypatch, serve_dtype):
    jm, variables, tm = _models("default")
    if serve_dtype == "int8":
        served = jserving.quantize_params_int8(variables["params"])
        jax_params = jserving.dequantize_params(served)
    else:
        served = jax_params = jserving.cast_params(variables["params"],
                                                   jnp.bfloat16)
    t = np.array([0.6, 0.9, 1.2], np.float32)
    (want, *_), normals, _ = _record(monkeypatch, lambda: jm.apply(
        {**variables, "params": jax_params}, 3, t, True, None,
        method=JaxNVAE.sample, rngs={"sample": jax.random.PRNGKey(5)}))
    # The JAX tree (quantized or cast) through the converter, and the
    # port's own cast of the fp32 weights, serve the same tensors.
    sampler = Sampler(tm.cfg, state_dict_from_flax(
        {**variables, "params": served}, tm), n_samples=3,
        serve_dtype=serve_dtype, device="cpu")
    own = Sampler(tm.cfg, state_dict_from_flax(variables, tm), n_samples=3,
                  serve_dtype=serve_dtype, device="cpu")
    for k, v in own._weights.items():
        other = sampler._weights[k]
        if isinstance(v, QuantizedLeaf):
            assert torch.equal(v.q, other.q) and torch.equal(v.scale,
                                                             other.scale)
        else:
            assert v.dtype == other.dtype and torch.equal(v, other), k
    got = sampler.apply(lambda m: m.sample(3, t, True, eps=normals)[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert sampler.info["serve_dtype"] == serve_dtype


# ---- the sampler lock (F1) ---------------------------------------------------


@pytest.fixture(scope="module")
def two_weights():
    cfg = tcfg.debug_config(use_pallas_kernels=True, **TINY)
    old = TorchNVAE(cfg, device="cpu", seed=1).state_dict()
    new = TorchNVAE(cfg, device="cpu", seed=2).state_dict()
    t = torch.tensor([0.7, 0.8, 0.9, 1.0])
    want_old = Sampler(cfg, old, device="cpu")(3, t)
    want_new = Sampler(cfg, new, device="cpu")(3, t)
    assert not torch.equal(want_old, want_new)
    return cfg, old, new, t, want_old, want_new


class _Held:
    """``NVAE.sample`` held at its start until ``release`` is set."""

    def __init__(self, monkeypatch):
        self.entered, self.release = threading.Event(), threading.Event()
        real = TorchNVAE.sample

        def held(model, *args, **kwargs):
            self.entered.set()
            assert self.release.wait(30)
            return real(model, *args, **kwargs)

        monkeypatch.setattr(TorchNVAE, "sample", held)

    def call(self, sampler, *args):
        out = []
        thread = threading.Thread(target=lambda: out.append(sampler(*args)))
        thread.start()
        assert self.entered.wait(30)
        return thread, out


def test_info_answers_while_a_call_is_held(monkeypatch, two_weights):
    cfg, old, _, t, want_old, _ = two_weights
    sampler = Sampler(cfg, old, device="cpu")
    held = _Held(monkeypatch)
    thread, out = held.call(sampler, 3, t)
    try:
        t0 = time.monotonic()
        info = sampler.info
        assert time.monotonic() - t0 < 0.5
        assert info["generation"] == 0 and info["serve_dtype"] == "float32"
        # One dispatch thread: a second concurrent call is refused.
        with pytest.raises(RuntimeError, match="one thread at a time"):
            sampler(4, t)
    finally:
        held.release.set()
        thread.join(30)
    assert torch.equal(out[0], want_old)


def test_swap_during_a_call_keeps_that_call_on_the_old_weights(
        monkeypatch, two_weights):
    cfg, old, new, t, want_old, want_new = two_weights
    sampler = Sampler(cfg, old, device="cpu")
    held = _Held(monkeypatch)
    thread, out = held.call(sampler, 3, t)
    try:
        t0 = time.monotonic()
        sampler.swap(new, step=5)  # lands between the call's layers
        assert time.monotonic() - t0 < 5.0
        assert sampler.info["generation"] == 1 and sampler.info["step"] == 5
    finally:
        held.release.set()
        thread.join(30)
    assert torch.equal(out[0], want_old)


def test_the_call_after_a_swap_uses_the_new_weights(monkeypatch, two_weights):
    cfg, old, new, t, want_old, want_new = two_weights
    sampler = Sampler(cfg, old, device="cpu")
    held = _Held(monkeypatch)
    thread, _ = held.call(sampler, 3, t)
    sampler.swap(new, step=5)
    held.release.set()
    thread.join(30)
    assert torch.equal(sampler(3, t), want_new)
    # The staged tensors are new ones: the caller's dict is not aliased.
    k = "decoder.h"
    assert sampler._weights[k].data_ptr() != new[k].data_ptr()


def test_swaps_racing_calls_never_mix_weights(two_weights):
    """A thread swapping the two weight sets back and forth as fast as it
    can, with a short interpreter switch interval, while calls run: every
    call's output is bitwise one set's, never a mix."""
    import sys

    cfg, old, new, t, want_old, want_new = two_weights
    sampler = Sampler(cfg, old, device="cpu")
    stop = threading.Event()

    def swapper():
        i = 0
        while not stop.is_set():
            sampler.swap(new if i % 2 == 0 else old)
            i += 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    thread = threading.Thread(target=swapper)
    try:
        thread.start()
        outs = [sampler(3, t) for _ in range(12)]
    finally:
        stop.set()
        thread.join(30)
        sys.setswitchinterval(interval)
    assert not thread.is_alive()
    assert sampler.info["generation"] >= 2
    for out in outs:
        assert torch.equal(out, want_old) or torch.equal(out, want_new)


# ---- reloads (the cases of tests/test_serving_reload.py) ---------------------


@pytest.fixture(scope="module")
def setup():
    cfg = tcfg.debug_config(**TINY)
    model, state, _ = create_train_state(
        cfg, TrainConfig(epochs=1, batch_size=B, ema_decay=0.99),
        total_steps=4, device="cpu")
    return model, state


def _save_two(state, d):
    """Checkpoint 1 holds the state's weights, checkpoint 2 them + 0.05;
    the state's model is left on its own weights."""
    params = dict(state.model.named_parameters())
    orig = {k: p.detach().clone() for k, p in params.items()}
    state.step = 1
    ckpt.save_checkpoint(d, 1, state)
    with torch.no_grad():
        for p in params.values():
            p.add_(0.05)
    shifted = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    state.step = 2
    ckpt.save_checkpoint(d, 2, state)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(orig[k])
    state.step = 0
    return shifted


def test_reload_from_checkpoints_bitwise(setup, tmp_path):
    model, state = setup
    d = str(tmp_path / "c")
    shifted = _save_two(state, d)
    t = torch.full((B,), 0.8)
    sampler = Sampler(model.cfg, variables_from_state(state), B, device="cpu")
    out_init = sampler(3, t)

    reload = make_checkpoint_reloader(sampler, d, state)
    info = reload({})  # default: the latest step
    assert info["step"] == 2 and info["generation"] == 1
    out2 = sampler(3, t)
    assert torch.equal(out2, Sampler(model.cfg, shifted, B, device="cpu")(3, t))
    assert float((out2 - out_init).abs().max()) > 1e-3

    info = reload({"step": 1})  # roll back to an explicit step
    assert info["step"] == 1 and info["generation"] == 2
    assert torch.equal(sampler(3, t), out_init)

    # The EMA of a chain that took no update is the initial parameters.
    info = reload({"step": 2, "use_ema": True})
    assert info["use_ema"] is True
    assert torch.equal(sampler(3, t), out_init)

    with pytest.raises(ValueError):
        reload({"step": "latest"})
    with pytest.raises(ValueError):
        reload({"use_ema": 1})
    with pytest.raises(FileNotFoundError, match="step 99"):
        reload({"step": 99})


def test_if_newer_follow_semantics(setup, tmp_path):
    model, state = setup
    d = str(tmp_path / "c")
    state.step = 1
    ckpt.save_checkpoint(d, 1, state)
    state.step = 0
    sampler = Sampler(model.cfg, variables_from_state(state), B, device="cpu")
    reload = make_checkpoint_reloader(sampler, d, state)
    assert reload({"if_newer": True})["step"] == 1  # first poll: -1 -> 1
    info = reload({"if_newer": True})
    assert info.get("skipped") is True and info["step"] == 1
    _save_two(state, d)
    info = reload({"if_newer": True})
    assert "skipped" not in info and info["step"] == 2
    # An explicit step wins over if_newer.
    assert reload({"if_newer": True, "step": 1})["step"] == 1


def test_reload_applies_serve_dtype(setup, tmp_path):
    model, state = setup
    d = str(tmp_path / "c")
    state.step = 1
    ckpt.save_checkpoint(d, 1, state)
    state.step = 0
    sampler = Sampler(model.cfg, variables_from_state(state), B,
                      serve_dtype="bfloat16", device="cpu")
    make_checkpoint_reloader(sampler, d, state)({})
    params = {k for k, _ in model.named_parameters()}
    dtypes = {v.dtype for k, v in sampler._weights.items() if k in params}
    assert dtypes == {torch.bfloat16}
    assert {v.dtype for k, v in sampler._weights.items()
            if k not in params} == {torch.float32}  # BatchNorm statistics
    assert sampler.info["serve_dtype"] == "bfloat16"
    assert torch.isfinite(sampler(3, torch.full((B,), 0.8))).all()


def test_unknown_serve_dtype_rejected(setup):
    model, state = setup
    with pytest.raises(ValueError, match="serve_dtype"):
        Sampler(model.cfg, variables_from_state(state), B,
                serve_dtype="fp8", device="cpu")


def test_output_dtype_uint8_survives_swap():
    # Random weights and statistics: a fresh init's probabilities sit near
    # 1 and round to 255 whatever the weights.
    _, _, tm = _models("default")
    sd = tm.state_dict()
    t = torch.full((B,), 0.9)
    f32 = Sampler(tm.cfg, sd, B, device="cpu")
    u8 = Sampler(tm.cfg, sd, B, output_dtype="uint8", device="cpu")
    assert u8.info["output_dtype"] == "uint8"
    got = u8(5, t)
    assert got.dtype == torch.uint8
    want = torch.round(torch.clamp(f32(5, t), 0, 1) * 255).to(torch.uint8)
    assert torch.equal(got, want)
    bumped = {k: v + 0.01 if v.is_floating_point() else v
              for k, v in sd.items()}
    u8.swap(bumped)
    f32.swap(bumped)
    got2 = u8(5, t)
    assert got2.dtype == torch.uint8
    assert torch.equal(got2, torch.round(torch.clamp(
        f32(5, t), 0, 1) * 255).to(torch.uint8))
    assert not torch.equal(got2, got)


def test_sampler_is_shape_polymorphic():
    _, _, tm = _models("default")
    sd = tm.state_dict()
    s = Sampler(tm.cfg, sd, B, device="cpu")
    small, big = s(2, torch.full((2,), 0.8)), s(2, torch.full((B,), 0.8))
    assert small.shape[0] == 2 and big.shape[0] == B
    assert s(2, 0.8).shape[0] == B  # a scalar keeps the constructor batch
    s.swap({k: v + 0.05 if v.is_floating_point() else v
            for k, v in sd.items()})
    assert not torch.equal(s(2, torch.full((2,), 0.8)), small)
    assert not torch.equal(s(2, torch.full((B,), 0.8)), big)


def test_variables_from_state_needs_an_ema():
    cfg = tcfg.debug_config(**TINY)
    _, state, _ = create_train_state(cfg, TrainConfig(), 4, device="cpu")
    with pytest.raises(ValueError, match="ema_decay"):
        variables_from_state(state, use_ema=True)


# ---- the serving artifact ---------------------------------------------------


def test_artifact_round_trip(setup, tmp_path):
    model, state = setup
    sd = variables_from_state(state)
    t = torch.linspace(0.6, 1.0, B)
    sizes = {}
    for dtype in ("", "bfloat16", "int8"):
        path = str(tmp_path / f"s{dtype}.pt")
        sizes[dtype] = export_sampler(path, model.cfg, sd, B,
                                      per_sample_temperature=True,
                                      serve_dtype=dtype, step=7)
        payload = torch.load(path, weights_only=True)  # plain data only
        keys = set(payload["tensors"]) | set(payload["quantized"])
        assert keys == set(sampler_keys(sd))  # the encoder is left out
        served = load_artifact(path, "cpu")
        live = Sampler(model.cfg, sd, B, serve_dtype=dtype, device="cpu")
        assert torch.equal(served(3, t), live(3, t))
        assert served.artifact["batch"] == B and served.step == 7
        assert served.artifact["per_sample_temperature"]
        assert served.info["serve_dtype"] == (dtype or "float32")
    assert sizes["int8"] < sizes["bfloat16"] < sizes[""]


def test_export_tool_writes_checks_and_runs(tmp_path, capsys):
    from nvae_torch import export_serving

    out = str(tmp_path / "a.pt")
    meta = export_serving.main(["--out", out, "--debug", "--batch", "2",
                                "--format", "weights",
                                "--per_sample_temperature", "--cpu",
                                "--weights_dtype", "int8", "--check"])
    assert meta["bytes"] == os.path.getsize(out)
    assert os.path.exists(out + ".json")
    assert "check OK" in capsys.readouterr().out
    images = export_serving.main(["--load", out, "--run", "--cpu",
                                  "--save_png", str(tmp_path / "png")])
    assert images.shape == (2, 32, 32, 1)
    assert len(os.listdir(tmp_path / "png")) == 2
