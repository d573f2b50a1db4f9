"""bf16 compute in the port against the JAX package, on the CPU.

- Kernel #2's bf16 instance, as its plain version (x and taps bf16, swish
  and the 25 taps in fp32, the fp32 bias in fp32, y rounded once), against
  JAX's ``fused_swish_depthwise5x5`` in interpret mode on the same bf16
  inputs: at most 1 bf16 ulp apart (the Pallas kernel adds product by
  product, PyTorch's fp32 arithmetic may round one step differently before
  the single bf16 rounding), compared as bit patterns.
- Its launch geometry fits every path shape at every batch the serving
  paths give it, and the wrapper's dtype rules.
- ``SNConv``, eval BatchNorm with ``bn_apply_dtype`` bf16, squeeze-
  excitation and a generative cell in bf16 against the Flax modules with
  ``dtype``/``bn_dtype`` bf16, on the same weights.  The BatchNorm apply
  rounds exactly as JAX (bitwise); a convolution rounds its fp32 sum to bf16
  once on both sides but sums in another order, so one output may sit one
  bf16 ulp apart, and a chain of them a few: modules within 2 ulps of the
  output's scale (2^-7 of max |y|), the cell (five roundings deep) within
  2^-5 of max |y|.
- The whole bf16 sample path (compute and BatchNorm apply bf16, debug size,
  injected noise) against JAX: probabilities within atol 3e-2, and no
  further from JAX in fp32 than 1.5 times JAX in bf16 is.
- bf16 training through the entry points at a tiny size: ``Trainer.fit``,
  a bitwise resume, the sampling hooks and ``serving.Sampler`` over its
  checkpoint; the CLI's ``--mode train`` (and a resumed epoch) and
  ``--mode sample`` with ``--compute_dtype bfloat16``, with and without
  ``--bn_apply_dtype bfloat16``.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvae_torch import cli
from nvae_torch import config as tcfg
from nvae_torch.convert import state_dict_from_flax
from nvae_torch.kernels import depthwise as tdw
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.nn import blocks as tb
from nvae_torch.nn import spectral as ts
from nvae_torch.train import checkpoint as ckpt
from nvae_tpu import config as jcfg
from nvae_tpu.kernels.depthwise import fused_swish_depthwise5x5 as jax_fused
from nvae_tpu.models import NVAE as JaxNVAE
from nvae_tpu.nn import blocks as jb
from nvae_tpu.nn import spectral as js
from tests.test_torch_blocks import _variables, _x
from tests.test_torch_sampler import _record, random_flax_variables
from tests.test_torch_trainer import (  # noqa: F401  (fixtures)
    _cli_argv,
    _jsonl,
    no_tensorboard,
    one_torch_thread,
    single_torch_thread,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_module():
    """One intra-op thread for the module's tests and its module-scoped
    fixtures (``tests/test_torch_trainer.py``'s ``single_torch_thread``)."""
    with single_torch_thread():
        yield


BF16 = torch.bfloat16
MODULE_RTOL = 2.0 ** -7
CELL_RTOL = 2.0 ** -5
PROB_ATOL = 3e-2
VS_F32_RATIO = 1.5
# The path shapes of kernel #2 (H, C) and the batches the serving paths give
# it: the sampler matrix's CPU check, the server's two shapes.
PATH_SHAPES = [(4, 1536), (8, 768), (16, 384), (32, 192)]
SERVE_BATCHES = (8, 144, 576)


def _bf16_tensor(a) -> torch.Tensor:
    """A torch bf16 tensor with the bits of a JAX or ml_dtypes bf16 array."""
    return torch.from_numpy(np.array(a).view(np.int16)).view(BF16)


def _to_port(x) -> torch.Tensor:
    t = _bf16_tensor(x) if x.dtype.name == "bfloat16" else torch.from_numpy(x)
    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _ordered(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) mapped to integers in value order."""
    b = bits.astype(np.int32)
    return np.where(b & 0x8000, 0x8000 - (b & 0x7FFF), b + 0x8000)


def bf16_ulps(a, b) -> np.ndarray:
    """How many bf16 steps apart two bf16 arrays are, element by element."""
    def bits(t):
        if isinstance(t, torch.Tensor):
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return np.asarray(t).view(np.uint16)
    return np.abs(_ordered(bits(a)) - _ordered(bits(b)))


@pytest.mark.parametrize("shape,bias,fuse", [
    ((2, 4, 4, 64), True, True),
    ((2, 8, 8, 32), False, True),
    ((1, 5, 7, 16), True, False),
    ((3, 6, 6, 8), False, False),
])
def test_plain_bf16_kernel_within_one_ulp_of_pallas(shape, bias, fuse):
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jnp.bfloat16)
    k = jnp.asarray((0.2 * rng.randn(5, 5, 1, c)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    b = (0.1 * rng.randn(c)).astype(np.float32) if bias else None
    want = jax_fused(x, k, None if b is None else jnp.asarray(b),
                     fuse_swish=fuse, interpret=True)
    assert want.dtype == jnp.bfloat16

    got = tdw.fused_swish_depthwise5x5(
        _bf16_tensor(x), _bf16_tensor(k), None if b is None else torch.from_numpy(b),
        fuse_swish=fuse)
    assert got.dtype == BF16 and got.shape == shape
    ulps = bf16_ulps(got, want)
    assert ulps.max() <= 1, (ulps.max(), (ulps == 0).mean())
    assert (ulps == 0).mean() > 0.99


def _stencil_reversed(s: torch.Tensor, taps: torch.Tensor, bias) -> torch.Tensor:
    """The 25 products of the plain version summed in fp32 in the reverse
    order: another rounding of the same sum."""
    _, h, w, c = s.shape
    sp = torch.nn.functional.pad(s, (0, 0, 2, 2, 2, 2))
    taps = taps.float().reshape(5, 5, c)
    acc = torch.zeros_like(s)
    for i in reversed(range(5)):
        for j in reversed(range(5)):
            acc = acc + sp[:, i:i + h, j:j + w, :] * taps[i, j]
    return acc if bias is None else acc + bias


@pytest.mark.parametrize("h,c", PATH_SHAPES)
def test_bf16_limit_takes_another_sum_order_and_refuses_double_rounding(h, c):
    """The card's check of bf16 #2 against its plain version (at most
    ``BF16_SUM_ULPS`` fp32 ulps of the products' sum past one bf16 ulp, at
    least ``BF16_MIN_EQUAL_SHARE`` bitwise equal) passes the same products
    summed in another fp32 order with another swish, and fails swish(x)
    rounded to bf16 before the taps on both counts."""
    g = torch.Generator().manual_seed(h)
    x = torch.randn(2, h, h, c, generator=g).to(BF16)
    k = (0.2 * torch.randn(5, 5, 1, c, generator=g)).to(BF16)
    b = 0.1 * torch.randn(c, generator=g) if h <= 8 else None
    want = tdw.fused_swish_depthwise5x5_plain(x, k, b)
    scale = tdw.bf16_sum_scale(x, k, b)
    xf = x.float()
    other = _stencil_reversed(xf * (1.0 / (1.0 + torch.exp(-xf))), k, b)
    double = _stencil_reversed(
        torch.nn.functional.silu(xf).to(BF16).float(), k, b)
    for got, ok in ((other.to(BF16), True), (double.to(BF16), False)):
        sum_ulps = float(tdw.bf16_sum_ulps(got, want, scale).max())
        equal = float((bf16_ulps(got, want) == 0).mean())
        assert (sum_ulps <= tdw.BF16_SUM_ULPS) is ok, sum_ulps
        assert (equal >= tdw.BF16_MIN_EQUAL_SHARE) is ok, equal


def test_bf16_geometry_fits_every_path_shape():
    """Every bf16 kernel's geometry fits at every path shape and every batch
    its paths give it (the forward: the serving batches; dx and dW/db: the
    training step's 144 and the card-vs-CPU step's 4).  All three take the
    sliding-row kernel: 5 slots a pass or a multiple, a warp per 4 columns
    of each of a power of two of chunks, at most 8 warps, its shared bytes
    by its own formula, two blocks to an SM at least."""
    for kind, batches in (("fwd", SERVE_BATCHES), ("dx", (144, 4)),
                          ("dw", (144, 4))):
        for h, c in PATH_SHAPES:
            for b in batches:
                g = tdw.geometry(kind, (b, h, h, c), "bfloat16")
                assert g.smem_bytes <= tdw._MAX_SMEM
                assert g.blocks_per_chunk <= b
                k = g.chunks_per_block
                assert g.slots_per_pass % 5 == 0 and 1 <= g.ahead <= 8
                assert k & (k - 1) == 0 and k <= g.chunks
                assert g.threads == 32 * -(-h // 4) * k <= 256
                assert g.smem_bytes == tdw._bf16_smem_bytes(
                    kind, h, g.slots_per_pass, g.ahead, k)
                assert 233_472 // (g.smem_bytes + 1024) >= 2
    with pytest.raises(ValueError, match="no dx kernel for float16"):
        tdw.geometry("dx", (2, 8, 8, 32), "float16")


def test_wrapper_dtype_rules():
    x = torch.zeros(2, 4, 4, 32)
    k = torch.zeros(5, 5, 1, 32)
    b = torch.zeros(32)
    tdw._check(x.to(BF16), k.to(BF16), b)  # the bf16 forward is taken
    with pytest.raises(TypeError, match="float32"):
        tdw._check(x.half(), k.half(), None)
    with pytest.raises(TypeError, match="float32"):
        tdw._check(x.double(), k.double(), None)
    with pytest.raises(TypeError, match="float32"):
        tdw._check(x.to(BF16), k.to(BF16), b.to(BF16))  # bias stays fp32
    # dx and dW/db take bf16 operands too, all of one dtype.
    tdw._check(x.to(BF16), k.to(BF16), None, x.to(BF16), kind="dx")
    tdw._check(x.to(BF16), None, None, x.to(BF16), kind="dw")
    with pytest.raises(TypeError, match="operand 0 must be torch.bfloat16"):
        tdw._check(x.to(BF16), k.to(BF16), None, x, kind="dx")
    with pytest.raises(TypeError, match="kernel must be torch.bfloat16"):
        tdw._check(x.to(BF16), k, None, x.to(BF16), kind="dx")
    with pytest.raises(ValueError, match="4-byte aligned"):
        buf = torch.zeros(x.numel() + 1, dtype=BF16)
        tdw._check(x.to(BF16), None, None, buf[1:].view(x.shape), kind="dw")
    with pytest.raises(ValueError, match="even channel count"):
        tdw._check(torch.zeros(1, 4, 4, 33, dtype=BF16),
                   torch.zeros(5, 5, 1, 33, dtype=BF16), None)


def _check_bf16(flax_mod, port_mod, x, rtol, *extra):
    variables = _variables(flax_mod, jnp.asarray(x), *extra)
    port_mod.load_state_dict(state_dict_from_flax(variables, port_mod))
    port_mod.eval()
    want = np.asarray(flax_mod.apply(variables, jnp.asarray(x), *extra)
                      .astype(jnp.float32))
    with torch.no_grad():
        got = port_mod(_to_port(x)).permute(0, 2, 3, 1).float().numpy()
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), err
    return got, want


@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (3, 2)])
def test_snconv_bf16(k, stride):
    got, _ = _check_bf16(
        js.SNConv(24, (k, k), strides=(stride, stride), dtype=jnp.bfloat16),
        ts.SNConv(16, 24, k, stride=stride, dtype=BF16),
        _x((2, 8, 8, 16)), MODULE_RTOL, False)


def test_batchnorm_apply_bf16_bitwise():
    x = _x((3, 4, 4, 12)).astype(jnp.bfloat16)
    flax_mod = jb.BatchNorm(jnp.bfloat16)
    variables = _variables(flax_mod, jnp.asarray(x), False)
    port = tb.BatchNorm(12, apply_dtype=BF16)
    port.load_state_dict(state_dict_from_flax(variables, port))
    port.eval()
    want = flax_mod.apply(variables, jnp.asarray(x), False)
    assert want.dtype == jnp.bfloat16
    with torch.no_grad():
        got = port(_to_port(x)).permute(0, 2, 3, 1)
    assert got.dtype == BF16
    assert bf16_ulps(got, want).max() == 0


@pytest.mark.parametrize("c", [32, 128])
def test_squeeze_excitation_bf16(c):
    _check_bf16(jb.SqueezeExcitation(16, dtype=jnp.bfloat16),
                tb.SqueezeExcitation(c, 16, dtype=BF16),
                _x((2, 4, 4, c)).astype(jnp.bfloat16), MODULE_RTOL)


def _cell_dtypes(port):
    for m in port.modules():
        if isinstance(m, (ts.SNConv, ts.DepthwiseConv, tb.SqueezeExcitation)):
            m.dtype = BF16
        elif isinstance(m, tb.BatchNorm):
            m.apply_dtype = BF16
    return port


@pytest.mark.parametrize("use_pallas", [True, False])
def test_generative_cell_bf16(use_pallas):
    _check_bf16(
        jb.GenerativeResidualCell(16, use_pallas=use_pallas,
                                  bn_dtype=jnp.bfloat16, dtype=jnp.bfloat16),
        _cell_dtypes(tb.GenerativeResidualCell(16, use_pallas=use_pallas)),
        _x((2, 8, 8, 16)).astype(jnp.bfloat16), CELL_RTOL, False)


_MODELS = {}


def _bf16_models(depthwise):
    """(JAX fp32, JAX bf16, port bf16 on the CPU) on one Flax tree."""
    if depthwise not in _MODELS:
        over = dict(use_pallas_kernels=True,
                    postprocess_5x5_depthwise=depthwise)
        bf = dict(compute_dtype="bfloat16", bn_apply_dtype="bfloat16")
        j32 = JaxNVAE(jcfg.debug_config(**over))
        j16 = JaxNVAE(jcfg.debug_config(**over, **bf))
        variables = random_flax_variables(j32)
        port = TorchNVAE(tcfg.debug_config(**over, **bf), device="cpu")
        port.load_state_dict(state_dict_from_flax(variables, port))
        _MODELS[depthwise] = (j32, j16, variables, port)
    return _MODELS[depthwise]


@pytest.mark.parametrize("depthwise", [False, True])
def test_bf16_sample_path_matches_jax(monkeypatch, depthwise):
    j32, j16, variables, port = _bf16_models(depthwise)
    t = np.array([0.6, 0.9, 1.2], np.float32)

    def sample(model):
        return model.apply(variables, 3, t, True, None,
                           method=JaxNVAE.sample,
                           rngs={"sample": jax.random.PRNGKey(4)})

    (want32, *_), normals, _ = _record(monkeypatch, lambda: sample(j32))
    (want16, *_), normals16, _ = _record(monkeypatch, lambda: sample(j16))
    for a, b in zip(normals, normals16):  # the noise is drawn in fp32
        np.testing.assert_array_equal(a, b)
    got, *_ = port.sample(3, t, True, eps=normals)
    assert got.dtype == torch.float32
    got, want16, want32 = (np.asarray(a, np.float64)
                           for a in (got, want16, want32))
    err = np.abs(got - want16).max()
    assert err <= PROB_ATOL, err
    port_vs_32 = np.abs(got - want32).max()
    jax_vs_32 = np.abs(want16 - want32).max()
    assert port_vs_32 <= VS_F32_RATIO * jax_vs_32, (port_vs_32, jax_vs_32)


def test_bf16_trainer_fits_resumes_and_serves(tmp_path, one_torch_thread):
    """``Trainer.fit`` in bf16 compute and BatchNorm apply (tiny model, CPU,
    with EMA): finite metrics with fp32 parameters, statistics, ``u`` and
    EMA; a resume from its checkpoint ends in the same state bit for bit;
    eval mode reconstructs and samples in fp32; the IWAE NLL is finite; and
    ``serving.Sampler`` serves the checkpoint, with its EMA weights too."""
    from nvae_torch.config import TrainConfig
    from nvae_torch.data import make_iterators, synthetic_dataset
    from nvae_torch.eval.nll import make_nll_fn
    from nvae_torch.serving import Sampler, variables_from_state
    from nvae_torch.train import checkpoint as ckpt
    from nvae_torch.train.trainer import Trainer

    cfg = tcfg.debug_config(n_groups_per_scale=(1, 1), n_latent_per_group=2,
                            use_pallas_kernels=True,
                            postprocess_5x5_depthwise=True,
                            compute_dtype="bfloat16",
                            bn_apply_dtype="bfloat16", spectral_mode="forward")
    tc = TrainConfig(batch_size=8, epochs=2, step_based_warmup=True,
                     ema_decay=0.9, evaluate_frequency=1,
                     sample_frequency=1000,
                     model_save_frequency=1,
                     model_save_dir=str(tmp_path / "models"),
                     tensorboard_log_dir=str(tmp_path / "logs"))

    def iters():
        bundle = synthetic_dataset(n_train=16, n_test=8, seed=0)
        return make_iterators(bundle, 8, seed=0, device="cpu")

    train_iter, test_iter = iters()
    trainer = Trainer(cfg, tc, len(train_iter), device="cpu")
    result = trainer.fit(train_iter, test_iter)
    assert trainer.state.step == 4 and np.isfinite(result.best_loss)
    assert len(result.history) == 2 and all(
        np.isfinite(float(v)) for h in result.history for v in h.values())
    state = ckpt.flatten_state(trainer.state)
    assert all(v.dtype == torch.float32 for v in state.values()
               if isinstance(v, torch.Tensor) and v.is_floating_point())
    assert ckpt.all_steps(trainer.ckpt_dir) == [2, 4]
    shutil.rmtree(tmp_path / "models" / "4")
    again = Trainer(cfg, tc, len(train_iter), device="cpu")
    assert again.maybe_resume() == 1
    again.fit(*iters())
    for k, v in ckpt.flatten_state(again.state).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, state[k]), k
        else:
            assert v == state[k], k
    assert trainer.reconstruct_images(torch.rand(3, 32, 32, 1)).dtype == (
        torch.float32)
    assert trainer.sample_images(2, 1.0)[0].dtype == torch.float32
    nll = make_nll_fn(trainer.model, 2)(torch.rand(2, 32, 32, 1) > 0.5)
    assert nll.dtype == torch.float32 and torch.isfinite(nll)
    for ema in (False, True):
        sampler = Sampler(cfg, variables_from_state(trainer.state, ema),
                          n_samples=4, device="cpu")
        images = sampler(0, 0.8)
        assert images.shape == (4, 32, 32, 1)
        assert torch.isfinite(images).all()


@pytest.mark.parametrize("dtypes", [
    ["--compute_dtype", "bfloat16", "--bn_apply_dtype", "bfloat16",
     "--postprocess_depthwise"],
    ["--compute_dtype", "bfloat16"],
])
def test_cli_trains_and_samples_in_bf16_on_the_cpu(tmp_path, capsys,
                                                   no_tensorboard, dtypes,
                                                   one_torch_thread):
    """``--mode train`` in bf16 compute (with bf16 or fp32 BatchNorm apply):
    trains with finite metrics, checkpoints, resumes for another epoch, and
    ``--mode sample`` draws from the bf16-trained checkpoint."""
    argv = [*_cli_argv(tmp_path), *dtypes, "--evaluate_frequency", "1",
            "--sample_frequency", "1000", "--model_save_frequency", "1"]
    cli.main(["--mode", "train", "--epochs", "1", *argv])
    assert "Training done: best_loss=" in capsys.readouterr().out
    cli.main(["--mode", "train", "--epochs", "2", *argv])
    assert ckpt.all_steps(str(tmp_path / "models")) == [4, 8]
    lines = _jsonl(tmp_path / "logs" / "metrics.jsonl")
    train = [r for r in lines if "train/loss" in r]
    assert [r["step"] for r in train] == [0, 1]
    assert all(np.isfinite(v) for r in lines for v in r.values())
    payload = ckpt.load_payload(str(tmp_path / "models"), 8)
    assert all(v.dtype == torch.float32 for v in payload.values()
               if isinstance(v, torch.Tensor) and v.is_floating_point())
    capsys.readouterr()
    cli.main(["--mode", "sample", "--n_samples", "4", *argv])
    assert "(step 8)" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "results" / "t_0.8")) == 4
