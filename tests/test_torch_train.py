"""The training slice's pieces against the JAX package on the CPU at debug
size: the posterior pass, the losses, the optimizer and the converter.  The
whole step is in ``tests/test_torch_train_step.py``.

Weights are random, from numpy, in the Flax tree, converted by
``nvae_torch.convert``.  The posterior noise is JAX's own: the JAX pass runs
jitted with ``jax.random.normal`` patched to hand each draw to the host
through an ordered ``jax.debug.callback``, and the draws are injected into
the port.

Tolerances: the posterior pass at atol 1e-4 of ``max(1, max |JAX value|)``
per tensor (fp32 through ~40 layers in other summation orders; ``log_p`` and
``log_q`` are sums of ~1,000 terms of magnitude ~4); the losses and the
optimizer at rtol 1e-6 (the same float32 formulas).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvae_torch import config as tcfg
from nvae_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.models.nvae import LatentParams as TorchLatents
from nvae_torch.models.nvae import ForwardOutput as TorchOutput
from nvae_torch.models.nvae import posterior_noise_shapes
from nvae_torch.train import losses as tl
from nvae_torch.train import optim as topt
from nvae_tpu import config as jcfg
from nvae_tpu.models import NVAE as JaxNVAE
from nvae_tpu.models.nvae import ForwardOutput as JaxOutput
from nvae_tpu.models.nvae import LatentParams as JaxLatents
from nvae_tpu.train import losses as jl
from nvae_tpu.train import optim as jopt
from tests.test_torch_sampler import random_flax_variables

ATOL = 1e-4
RTOL = 1e-6

CONFIGS = {
    "default": dict(use_pallas_kernels=True),
    "depthwise": dict(use_pallas_kernels=True, postprocess_5x5_depthwise=True),
    "forward_sn": dict(use_pallas_kernels=True, spectral_mode="forward"),
}


def _models(name, seed=0):
    overrides = CONFIGS[name]
    jm = JaxNVAE(jcfg.debug_config(**overrides))
    variables = random_flax_variables(jm, seed=seed)
    tm = TorchNVAE(tcfg.debug_config(**overrides), device="cpu")
    tm.load_state_dict(state_dict_from_flax(variables, tm))
    return jm, variables, tm


def _close(have, want, what):
    want = np.asarray(want)
    have = have.detach().numpy() if isinstance(have, torch.Tensor) else have
    denom = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(have / denom, want / denom, atol=ATOL,
                               err_msg=what)


# ---- posterior pass ---------------------------------------------------------


@pytest.mark.parametrize("name", ["default", "depthwise"])
def test_posterior_pass_matches_jax(monkeypatch, name):
    jm, variables, tm = _models(name)
    x = (np.random.RandomState(1).rand(3, 32, 32, 1) > 0.5).astype(np.float32)
    draws, real_normal = [], jax.random.normal

    def normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        jax.debug.callback(lambda v: draws.append(np.array(v, copy=True)),
                           out, ordered=True)
        return out

    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal", normal)
        out, mut = jax.jit(lambda v, x_: jm.apply(
            v, x_, True, nll=True, rngs={"sample": jax.random.PRNGKey(3)},
            mutable=["batch_stats"],
        ))(variables, x)
        jax.effects_barrier()
    assert [d.shape for d in draws] == posterior_noise_shapes(tm.cfg, 3)

    tm.train()
    got = tm(torch.from_numpy(x), nll=True, eps=draws)
    assert isinstance(got, TorchOutput) and got.logits.shape == (3, 32, 32, 1)
    _close(got.logits, out.logits, "logits")
    assert len(got.latents) == len(out.latents) == tm.cfg.n_total_groups
    for g, (a, b) in enumerate(zip(got.latents, out.latents)):
        for field in ("enc_mu", "enc_sigma", "dec_mu", "dec_sigma"):
            _close(getattr(a, field), getattr(b, field), f"group {g} {field}")
    _close(got.log_p, out.log_p, "log_p")
    _close(got.log_q, out.log_q, "log_q")
    stats = flax_tree_from_state_dict(tm.state_dict(), tm)["batch_stats"]
    for path, want in jax.tree_util.tree_flatten_with_path(
            dict(mut)["batch_stats"])[0]:
        have = stats
        for k in path:
            have = have[k.key]
        _close(have, want, jax.tree_util.keystr(path))

    # Without nll the log densities are zeros; noise from a generator.
    again = tm(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert not again.log_p.any() and not again.log_q.any()


def test_posterior_pass_checks_injected_noise():
    _, _, tm = _models("default")
    x = np.zeros((2, 32, 32, 1), np.float32)
    shapes = posterior_noise_shapes(tm.cfg, 2)
    with pytest.raises(ValueError, match="injected"):
        tm(x, eps=[np.zeros(s, np.float32) for s in shapes[:-1]])
    with pytest.raises(ValueError, match="has shape"):
        tm(x, eps=[np.zeros((2, 1, 1, 1), np.float32)] * len(shapes))


def test_remat_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="remat"):
        TorchNVAE(tcfg.debug_config(remat=True), device="cpu")


# ---- losses -----------------------------------------------------------------


def _latents(n_groups=3, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for g in range(n_groups):
        shape = (4, 2 * (g + 1), 2 * (g + 1), 3)
        arrs = [rng.randn(*shape), np.exp(0.3 * rng.randn(*shape)),
                rng.randn(*shape), np.exp(0.3 * rng.randn(*shape))]
        out.append([a.astype(np.float32) for a in arrs])
    return ([TorchLatents(*map(torch.from_numpy, a)) for a in out],
            [JaxLatents(*map(jnp.asarray, a)) for a in out])


def _allclose(have, want):
    np.testing.assert_allclose(np.asarray(have), np.asarray(want), rtol=RTOL,
                               atol=1e-6)


def test_kl_per_group_and_kl_losses_match_jax():
    t_lat, j_lat = _latents()
    kl_t, kl_j = tl.kl_per_group(t_lat), jl.kl_per_group(j_lat)
    _allclose(kl_t, kl_j)
    _allclose(tl.unbalanced_kl_loss(kl_t), jl.unbalanced_kl_loss(kl_j))
    alphas = (2, 1)
    a_t = tl.kl_alphas(2, alphas)
    a_j = jl.kl_alphas(2, alphas)
    _allclose(a_t, a_j)
    for n_scales, gps in ((2, (5, 10)), (3, (2, 3, 4)), (1, (7,))):
        _allclose(tl.kl_alphas(n_scales, gps), jl.kl_alphas(n_scales, gps))

    # Balanced KL: the value, and the gradient with the coefficients held
    # constant (JAX's stop_gradient).
    kl = torch.from_numpy(np.array(kl_j)).requires_grad_()
    loss_t, coeff_t = tl.balanced_kl_loss(kl, a_t)
    loss_j, coeff_j = jl.balanced_kl_loss(kl_j, a_j)
    _allclose(loss_t.detach(), loss_j)
    _allclose(coeff_t, coeff_j)
    (loss_t * torch.arange(1.0, 5.0)).sum().backward()
    grad_j = jax.grad(lambda k: jnp.sum(
        jl.balanced_kl_loss(k, a_j)[0] * jnp.arange(1.0, 5.0)))(kl_j)
    _allclose(kl.grad, grad_j)


@pytest.mark.parametrize("crop", [0, 2])
def test_recon_loss_matches_jax(crop):
    rng = np.random.RandomState(1)
    logits = (5 * rng.randn(3, 8, 8, 1)).astype(np.float32)
    x = (rng.rand(3, 8, 8, 1) > 0.5).astype(np.float32)
    _allclose(tl.recon_loss(torch.from_numpy(logits), torch.from_numpy(x),
                            crop=crop),
              jl.recon_loss(jnp.asarray(logits), jnp.asarray(x), crop=crop))
    with pytest.raises(NotImplementedError, match="dml"):
        tl.recon_loss(torch.from_numpy(logits), torch.from_numpy(x), "dml")


def test_bn_gamma_penalty_scope_matches_jax():
    """Encoder and decoder BatchNorm scales only: a change to a preprocess
    or postprocess scale moves neither side."""
    _, variables, tm = _models("default", seed=2)
    _allclose(tl.bn_gamma_penalty(tm, 0.01).detach(),
              jl.bn_gamma_penalty(variables["params"], 0.01))
    with torch.no_grad():
        for m in (tm.preprocess, tm.postprocess):
            for name, p in m.named_parameters():
                if name.endswith("bn.weight") or ".bns." in name:
                    p.mul_(100.0)
    _allclose(tl.bn_gamma_penalty(tm, 0.01).detach(),
              jl.bn_gamma_penalty(variables["params"], 0.01))


@pytest.mark.parametrize("mode", ["step", "epoch", "epoch_parity"])
def test_beta_schedule_matches_jax(mode):
    kw = dict(step_based_warmup=mode == "step",
              parity_epoch_warmup_in_steps=mode == "epoch_parity")
    tc_t, tc_j = tcfg.TrainConfig(**kw), jcfg.TrainConfig(**kw)
    for step, epoch in ((0, 0), (1, 0), (7, 3), (29, 9), (30, 10), (99, 40)):
        args = dict(total_steps=100, total_epochs=33)
        b_t = tl.beta_schedule(step, epoch, train_cfg=tc_t, **args)
        b_j = jl.beta_schedule(jnp.int32(step), jnp.int32(epoch),
                               train_cfg=tc_j, **args)
        assert b_t.dtype == torch.float32
        assert float(b_t) == float(b_j), (step, epoch, float(b_t), float(b_j))


@pytest.mark.parametrize("beta", [0.25, 1.0])
def test_elbo_loss_matches_jax(beta):
    t_lat, j_lat = _latents(n_groups=3, seed=3)
    rng = np.random.RandomState(4)
    logits = (3 * rng.randn(4, 8, 8, 1)).astype(np.float32)
    x = (rng.rand(4, 8, 8, 1) > 0.5).astype(np.float32)
    cfg_t = tcfg.debug_config(n_groups_per_scale=(2, 1))
    cfg_j = jcfg.debug_config(n_groups_per_scale=(2, 1))
    zeros = np.zeros(4, np.float32)
    loss_t, m_t = tl.elbo_loss(
        TorchOutput(torch.from_numpy(logits), t_lat, torch.from_numpy(zeros),
                    torch.from_numpy(zeros)),
        torch.from_numpy(x), torch.tensor(beta, dtype=torch.float32), cfg_t)
    loss_j, m_j = jl.elbo_loss(
        JaxOutput(jnp.asarray(logits), j_lat, jnp.asarray(zeros),
                  jnp.asarray(zeros)),
        jnp.asarray(x), jnp.float32(beta), cfg_j)
    _allclose(loss_t, loss_j)
    assert set(m_t) == set(m_j)
    for k in m_j:
        _allclose(m_t[k], m_j[k])


# ---- optimizer --------------------------------------------------------------


def _opt_params(seed=0):
    """The same parameters keyed the port's way (OIHW kernels) and the JAX
    way (HWIO ``sn_kernel`` leaves)."""
    rng = np.random.RandomState(seed)
    kernels = {"conv": (6, 4, 3, 3), "head": (5, 6, 1, 1)}
    port, tree = {}, {}
    for name, shape in kernels.items():
        w = (0.3 * rng.randn(*shape)).astype(np.float32)
        port[f"{name}.weight"] = torch.from_numpy(w)
        tree[name] = {"sn_kernel": jnp.asarray(w.transpose(2, 3, 1, 0))}
    b = (0.1 * rng.randn(6)).astype(np.float32)
    port["conv.bias"] = torch.from_numpy(b)
    tree["conv"]["bias"] = jnp.asarray(b)
    return port, tree


def _as_tree(port):
    return {
        "conv": {"sn_kernel": port["conv.weight"].numpy().transpose(2, 3, 1, 0),
                 "bias": port["conv.bias"].numpy()},
        "head": {"sn_kernel": port["head.weight"].numpy().transpose(2, 3, 1, 0)},
    }


@pytest.mark.parametrize("mode", ["projection", "penalty"])
def test_make_optimizer_matches_optax(mode):
    tc_t = tcfg.TrainConfig(learning_rate=2e-2, ema_decay=0.9)
    tc_j = jcfg.TrainConfig(learning_rate=2e-2, ema_decay=0.9)
    port, tree = _opt_params()
    keys = ("conv.weight", "head.weight")
    tx_t = topt.make_optimizer(tc_t, 5, mode, keys)
    tx_j = jopt.make_optimizer(tc_j, 5, mode)
    s_t, s_j = tx_t.init(port), tx_j.init(tree)
    rng = np.random.RandomState(1)
    for _ in range(3):
        grads = {k: torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                 for k, p in port.items()}
        g_tree = _as_tree(grads)
        upd_t, s_t = tx_t.update(grads, s_t, port)
        port = {k: p + upd_t[k] for k, p in port.items()}
        upd_j, s_j = tx_j.update(g_tree, s_j, tree)
        tree = optax.apply_updates(tree, upd_j)
        jax.tree.map(_allclose, _as_tree(port), tree)
        sn_t, sn_j = topt.find_spectral_state(s_t), jopt.find_spectral_state(s_j)
        for name in ("conv", "head"):
            _allclose(sn_t.u[f"{name}.weight"], sn_j.u[name]["sn_kernel"])
            _allclose(sn_t.sigma[f"{name}.weight"],
                      sn_j.sigma[name]["sn_kernel"])
        jax.tree.map(_allclose, _as_tree(topt.find_ema_params(s_t)),
                     jopt.find_ema_params(s_j))
    if mode == "penalty":
        p_t = {k: v.clone().requires_grad_() for k, v in port.items()}
        pen_t = topt.spectral_penalty(p_t, sn_t.u, 0.01)
        pen_t.backward()
        pen_j, g_j = jax.value_and_grad(
            lambda t: jopt.spectral_penalty(t, sn_j.u, 0.01))(tree)
        _allclose(pen_t.detach(), pen_j)
        jax.tree.map(_allclose,
                     _as_tree({k: v.grad if v.grad is not None
                               else torch.zeros_like(v)
                               for k, v in p_t.items()}), g_j)


def test_cosine_schedule_and_adamax_pieces_match_optax():
    sched_t = topt.cosine_decay_schedule(1e-3, 40)
    sched_j = optax.cosine_decay_schedule(1e-3, 40)
    # Within 1e-7 of the initial value: near t = T the schedule is
    # 1 + cos(~pi), where one ulp of float32 cos (XLA's and PyTorch's
    # differ) is a large share of the result.
    for count in (0, 1, 13, 39, 40, 57):
        np.testing.assert_allclose(float(sched_t(count)),
                                   float(sched_j(jnp.int32(count))),
                                   rtol=RTOL, atol=1e-7 * 1e-3)
    with pytest.raises(ValueError):
        topt.cosine_decay_schedule(1e-3, 0)
    with pytest.raises(ValueError):
        topt.track_ema(1.0)
    tensors = {"a": np.full((2, 2), 3.0, np.float32),
               "b": np.arange(3, dtype=np.float32)}
    _allclose(topt.global_norm({k: torch.from_numpy(v)
                                for k, v in tensors.items()}),
              optax.global_norm(tensors))


# ---- converter --------------------------------------------------------------


def test_converter_round_trips_the_full_model():
    """Every Flax leaf of the full model fills exactly one port tensor, and
    flax_tree_from_state_dict gives the tree back bitwise."""
    _, variables, tm = _models("forward_sn", seed=1)
    sd = state_dict_from_flax(variables, tm)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == len(tm.state_dict()) == n_leaves
    back = flax_tree_from_state_dict(sd, tm)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        dict(variables))
    jax.tree.map(np.testing.assert_array_equal, back, dict(variables))
    # The copy owns its memory: training the port leaves it as it was.
    tm.load_state_dict(sd)
    snap = flax_tree_from_state_dict(tm.state_dict(), tm)
    with torch.no_grad():
        tm.decoder.h.add_(1.0)
    np.testing.assert_array_equal(snap["params"]["decoder"]["h"],
                                  variables["params"]["decoder"]["h"])
    with pytest.raises(KeyError, match="no Flax leaf"):
        flax_tree_from_state_dict({"nope": torch.zeros(1)}, tm)
