"""The port's tensor-parallel layout (``nvae_torch.parallel``: ``make_mesh``
with a model axis, ``tp_param_sharding``, ``shard_state_tp``) on the CPU:
twins of ``tests/test_parallel.py``'s TP tests.

Two gloo worlds run beside this process (``tests/test_torch_dist_worker.py``,
task ``tp``): 2 data x 2 model ranks and 1 x 2, on the debug model of JAX's
TP tests at their ``min_features`` 48, where both compute patterns run (the
generative cell's expansion, depthwise and projection on slices of its 96
hidden channels; the postprocess cells' 1x1 and 5x5 convs column-parallel
with their outputs gathered).  This process runs JAX's side meanwhile:
``make_train_step`` on ``shard_state_tp`` over ``make_mesh(n_data, n_model)``
of 4 (and 2) CPU devices, whose weights and posterior noise the worlds take.

Limits.  Against JAX (3 SGD steps at lr 1e-5), JAX's lockstep limits
(``test_sgd_lockstep_every_step_tight``): loss and the other metrics at
rtol 1e-5, ``grad_norm`` at rtol 1e-4 (a projection bias added on each
model rank, or a penalty counted on each, moves it far more), parameters
within 1e-5, BatchNorm statistics within 1e-4.  Against the port's
single-device step, the same for the SGD variants (``grad_accum=2``, the
``forward`` and ``penalty`` spectral modes, the RGB debug model with DML
and remat, and at ``min_features`` 8, where 26 kernels split, the
projection mode and the forward mode); the production Adamax (EMA on)
within ``3 lr`` a step of parameters and EMA, its moments after the first
step (functions of the gradient alone) within 1e-4 of their scale
(MOMENT_RTOL), the loss at rtol 1e-5 on the first step and 2e-3 on the
next (JAX's trajectory limits), the BatchNorm statistics after the first
step within 1e-4; the bf16 step no farther from the fp32 step than
BF16_ROUNDING times the bf16 single step is (measured here: 0.80x the
single step's loss error, 0.95x its largest parameter error).  After
every step a data index's model ranks hold the same
replicated tensors, and its data ranks the same blocks, bit for bit.
The JAX side runs its plain depthwise path (``use_pallas_kernels=False``);
the port's runs its kernel wrappers' CPU path.

The two worlds and JAX's two TP compiles take ~45 s together here; the
file ~80 s alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvae_torch import config as tcfg
from nvae_torch.convert import (
    _flax_layout,
    flax_tree_from_state_dict,
    state_dict_from_flax,
)
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.models.nvae import posterior_noise_shapes
from nvae_torch.parallel import tp_param_sharding
from nvae_torch.presets import get_preset
from nvae_tpu import config as jcfg
from nvae_tpu.models import NVAE as JaxNVAE
from nvae_tpu.parallel import make_mesh as jax_make_mesh
from nvae_tpu.parallel import shard_batch as jax_shard_batch
from nvae_tpu.parallel import shard_state_tp as jax_shard_state_tp
from nvae_tpu.parallel import tp_param_sharding as jax_tp_param_sharding
from nvae_tpu.presets import get_preset as jax_get_preset
from nvae_tpu.train.state import TrainState as JaxState
from nvae_tpu.train.step import make_train_step as jax_train_step
from tests.test_torch_dist_worker import (
    BATCH,
    SGD_LR,
    TINY,
    TP_MIN,
    TP_RUNS,
    batches,
    spawn_world,
)
from tests.test_torch_sampler import random_flax_variables

LOSS_RTOL, GRAD_NORM_RTOL, PARAMS_ATOL, BN_ATOL = 1e-5, 1e-4, 1e-5, 1e-4
ADAMAX_LOSS_RTOL = 2e-3  # after the first step: JAX's trajectory limit
# Adamax's moments after its first step are functions of that step's
# gradient alone (mu = (1 - b1) g, nu = |g|), on the same start in both
# layouts: each leaf's within MOMENT_RTOL of its largest |value|, or of
# MOMENT_FLOOR times the moment's largest over all leaves where that is
# more (a bias ahead of a BatchNorm has a gradient of rounding noise,
# ~1e-8, which the reordered sums change wholly; measured here: 1.5e-5 of
# that scale at most, 1.1e-5 of their own on the leaves above 1e-3 of
# it).  The parameters' 3 lr hold the update only loosely (Adamax moves
# every element by about lr whatever its gradient); the SGD variants
# hold it.
MOMENT_RTOL, MOMENT_FLOOR = GRAD_NORM_RTOL, 1e-2
# The bf16 step against the port's bf16 single step: the projection's
# partial outputs are rounded to bf16 on each model rank before their sum
# (one rounding on one device), so the two differ by bf16 rounding.  Each
# is held by its distance from the fp32 step: the TP step's within
# BF16_ROUNDING times the single step's (chip_smoke.py's
# RGB_CARD_VS_CPU_ROUNDING for another reordering of bf16 sums).
BF16_ROUNDING = 2.0
JAX_STEPS = 3
WORLDS = ((2, 2), (1, 2))  # (n_data, n_model)


def _jax_tp_run(directory, n_data: int, n_model: int):
    """JAX's side of a world, written to ``directory/jax_inputs.pt`` for
    its ranks: the same random weights in both packages, and the noise of
    JAX's TP run, recorded as it runs (whole, unordered; put in the
    posterior pass's order by shape, as ``tests/test_torch_parallel.py``
    does).  Returns each step's (metrics, params, batch_stats)."""
    cfg = jcfg.debug_config(**{**TINY, "use_pallas_kernels": False})
    jm = JaxNVAE(cfg)
    variables = random_flax_variables(jm, seed=4)
    tm = TorchNVAE(tcfg.debug_config(**TINY), device="meta")
    tx = optax.sgd(SGD_LR)
    mesh = jax_make_mesh(n_data=n_data, n_model=n_model,
                         devices=jax.devices()[:n_data * n_model])
    draws, real_normal = [], jax.random.normal

    def normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        jax.debug.callback(lambda v: draws.append(np.array(v, copy=True)),
                           out)
        return out

    order = [s[1:] for s in posterior_noise_shapes(tm.cfg, 1)]
    tc = jcfg.TrainConfig(batch_size=BATCH, step_based_warmup=True)
    step = jax_train_step(jm, tx, tc, 100, 50, donate=False, mesh=mesh)
    js = JaxState(
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
        params=variables["params"], batch_stats=variables["batch_stats"],
        spectral=variables.get("spectral", {}),
        opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(7))
    js = jax_shard_state_tp(js, mesh, min_features=TP_MIN)
    eps, run = [], []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.random, "normal", normal)
        for b in batches(JAX_STEPS):
            js, met = step(js, jax_shard_batch(jnp.asarray(b), mesh))
            jax.effects_barrier()
            assert len(draws) == len(order)
            eps.append([sorted(draws, key=lambda e: order.index(
                e.shape[1:]))])
            draws.clear()
            run.append(({k: float(v) for k, v in met.items()},
                        jax.device_get(js.params),
                        jax.device_get(js.batch_stats)))
    tmp = directory / "jax_inputs.tmp"
    torch.save({"state_dict": state_dict_from_flax(
        variables, TorchNVAE(tcfg.debug_config(**TINY), device="cpu")),
        "eps": eps}, tmp)
    tmp.rename(directory / "jax_inputs.pt")
    return run


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's ranks' results and JAX's run for it, by (n_data,
    n_model); the 2 x 2 world also runs the variants against the port's
    single step."""
    spawned = {}
    for n_data, n_model in WORLDS:
        d = tmp_path_factory.mktemp(f"tp_{n_data}x{n_model}")
        (d / "ckpt").mkdir()
        spawned[n_data, n_model] = (d, spawn_world(
            d, ["tp"], {"n_model": n_model, "variants": n_data == 2},
            world=n_data * n_model))
    try:
        jax_runs = {k: _jax_tp_run(d, *k) for k, (d, _) in spawned.items()}
    except BaseException:
        for _, w in spawned.values():
            w.kill()
        raise
    return {k: (w.results(), jax_runs[k]) for k, (_, w) in spawned.items()}


def _max_diff(a: dict, b: dict, keys) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in keys)


def _params(sd: dict) -> list:
    return [k for k in sd if "running_" not in k and not k.endswith(".u")]


@pytest.mark.parametrize("shape", WORLDS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_grid_is_jax_s(worlds, shape):
    """World rank r is data index ``r // n_model`` and model index
    ``r % n_model``: JAX's ``devices.reshape(n_data, n_model)``."""
    n_data, n_model = shape
    ranks, _ = worlds[shape]
    for r, rec in enumerate(ranks):
        assert rec["tp"]["grid"] == (r, r // n_model, n_data, r % n_model,
                                     n_model)


@pytest.mark.parametrize("shape", WORLDS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_step_matches_jax_tp_step(worlds, shape):
    """3 SGD steps of the port's TP step against JAX's ``make_train_step``
    on ``shard_state_tp`` over the same grid, from the same weights,
    batches and noise: JAX's lockstep limits at every step.  Every rank
    reports the same metrics, and the replicas agree bit for bit."""
    ranks, jax_run = worlds[shape]
    port = ranks[0]["tp"]["jax"]
    tm = TorchNVAE(tcfg.debug_config(**TINY), device="meta")
    for i, (jmet, jparams, jstats) in enumerate(jax_run):
        tmet = port["metrics"][i]
        assert set(tmet) == set(jmet)
        for k in jmet:
            rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(tmet[k], jmet[k], rtol=rtol,
                                       err_msg=f"{shape} step {i} {k}")
        tree = flax_tree_from_state_dict(port["states"][i], tm)
        for coll, want, limit in (("params", jparams, PARAMS_ATOL),
                                  ("batch_stats", jstats, BN_ATOL)):
            err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                      for a, b in zip(jax.tree_util.tree_leaves(tree[coll]),
                                      jax.tree_util.tree_leaves(want)))
            assert err < limit, (shape, i, coll, err)
    for rec in ranks:
        assert rec["tp"]["jax"]["metrics"] == port["metrics"]
        assert all(m == [] for m in rec["tp"]["jax"]["mismatches"])


@pytest.mark.parametrize("name", list(TP_RUNS))
def test_tp_variant_matches_single_step(worlds, name):
    """Each variant of TP_RUNS in the 2 x 2 layout against the port's
    single-device run of it, at every step (limits in the module
    docstring)."""
    ranks, _ = worlds[2, 2]
    tp = ranks[0]["tp"][name]
    single = ranks[list(TP_RUNS).index(name) % 4]["tp"][f"single/{name}"]
    if name.startswith("split8"):
        assert len(tp["dims"]) == 26
    opt = TP_RUNS[name][0]
    lr = tcfg.TrainConfig().learning_rate
    if name == "bf16":
        return _check_bf16(tp, single, [r["tp"]["single/bf16_fp32"]
                                        for r in ranks
                                        if "single/bf16_fp32" in r["tp"]][0])
    for i, (tmet, smet) in enumerate(zip(tp["metrics"], single["metrics"])):
        assert tmet.keys() == smet.keys()
        for k in tmet:
            rtol = (GRAD_NORM_RTOL if k == "grad_norm" else ADAMAX_LOSS_RTOL
                    if opt == "adamax" and i else LOSS_RTOL)
            np.testing.assert_allclose(tmet[k], smet[k], rtol=rtol,
                                       err_msg=f"{name} step {i} {k}")
        ts, ss = tp["states"][i], single["states"][i]
        limit = 3 * lr * (i + 1) if opt == "adamax" else PARAMS_ATOL
        assert _max_diff(ts, ss, _params(ss)) < limit, (name, i)
        # Adamax: JAX's trajectory test holds the statistics at its first
        # step; after it the parameters differ by the sign noise.
        if opt != "adamax" or i == 0:
            bn = [k for k in ss if "running_" in k]
            assert _max_diff(ts, ss, bn) < BN_ATOL, (name, i)
    for rec in ranks:
        assert rec["tp"][name]["metrics"] == tp["metrics"]
        assert all(m == [] for m in rec["tp"][name]["mismatches"])
    if opt == "adamax":
        n = len(tp["metrics"])
        assert _max_diff(tp["ema"], single["ema"], single["ema"]) < \
            3 * lr * n
        _check_first_moments(ranks, name, single["moments"][0])


def _check_first_moments(ranks, name: str, single: dict) -> None:
    """Each rank's Adamax moments after the first step (a TP block where
    the parameter is split: the rank's model index's slice of the single
    device's) within MOMENT_RTOL of each leaf's scale (its largest
    |value|, at least MOMENT_FLOOR of the moment's largest)."""
    for rec in ranks:
        *_, m_rank, n_model = rec["tp"]["grid"]
        run = rec["tp"][name]
        for kind, want_all in single.items():
            floor = MOMENT_FLOOR * max(float(v.abs().max())
                                       for v in want_all.values())
            for k, want in want_all.items():
                if k in run["dims"]:
                    want = want.chunk(n_model, run["dims"][k])[m_rank]
                got = run["moments"][0][kind][k]
                err = float((got - want).abs().max())
                scale = max(float(want.abs().max()), floor)
                assert err <= MOMENT_RTOL * scale, (rec["tp"]["grid"], kind,
                                                    k, err, scale)


def _check_bf16(tp: dict, single: dict, fp32: dict) -> None:
    """The bf16 TP step's distance from the fp32 step within
    BF16_ROUNDING times the bf16 single step's: each metric, the largest
    parameter error and the largest BatchNorm statistics error."""
    got, want = {}, {}
    for k, f in fp32["metrics"][0].items():
        got[k] = abs(tp["metrics"][0][k] - f)
        want[k] = abs(single["metrics"][0][k] - f)
    f, t, s = fp32["states"][0], tp["states"][0], single["states"][0]
    for kind, keys in (("params", _params(f)),
                       ("bn", [k for k in f if "running_" in k])):
        got[kind], want[kind] = _max_diff(t, f, keys), _max_diff(s, f, keys)
    bad = {k: (got[k], want[k]) for k in got
           if got[k] > BF16_ROUNDING * want[k]}
    assert not bad, bad


def test_tp_kernels_run_on_hidden_slices(worlds):
    """#2 (forward), #3 (dx) and #4 (dW/db) ran in the TP runs on the
    rank's 96 / 2 hidden channels of the generative cell, and never on
    the whole; a split kernel's Adamax moments are blocks too."""
    for rec in worlds[2, 2][0]:
        seen = rec["tp"]["channels"]
        assert all(seen[k] and set(seen[k]) == {96 // 2}
                   for k in ("fwd", "dx", "dw")), seen
        dims = rec["tp"]["adamax"]["dims"]
        assert len(dims) == 6 and set(dims.values()) == {0}
        mu = rec["tp"]["adamax"]["moments"][0]["mu"]
        assert all(mu[k].shape[0] * 2 == rec["tp"]["adamax"]["states"][0][
            k].shape[0] for k in dims)


def test_tp_eval_step_matches_single(worlds):
    """The eval step in the TP layout equals the single device's on the
    same batch and noise."""
    for rec in worlds[2, 2][0]:
        ev = rec["tp"]["eval"]
        for k, v in ev["single"].items():
            np.testing.assert_allclose(ev["tp"][k], v, rtol=LOSS_RTOL,
                                       err_msg=k)


@pytest.mark.parametrize("trip", ["tp_file", "tp_to_one", "one_to_tp"])
def test_tp_checkpoint_round_trips(worlds, trip):
    """A TP state is written whole (by the primary, after one gather) and
    restores into one device; one device's checkpoint restores into the
    TP layout; each bit for bit."""
    ranks, _ = worlds[2, 2]
    got = [rec["tp"]["ckpt"].get(trip) for rec in ranks]
    assert got[0] is True
    assert all(g in (True, None) for g in got)


# ---- selection: no world -----------------------------------------------------


def _configs():
    return {
        "default": (tcfg.ModelConfig(), jcfg.ModelConfig(), 512, 28),
        "depthwise": (tcfg.ModelConfig(postprocess_5x5_depthwise=True),
                      jcfg.ModelConfig(postprocess_5x5_depthwise=True), 512,
                      28),
        "cifar10_dml": (get_preset("cifar10_dml")[0],
                        jax_get_preset("cifar10_dml")[0], 512, 98),
        "celeba64": (get_preset("celeba64")[0],
                     jax_get_preset("celeba64")[0], 512, 241),
        "tiny48": (tcfg.debug_config(**TINY), jcfg.debug_config(**TINY),
                   TP_MIN, 6),
    }


@pytest.mark.parametrize("name", list(_configs()))
def test_tp_selection_matches_jax(name):
    """The parameters the port's ``tp_param_sharding`` splits over a model
    axis of 2 are the leaves JAX's splits over ``make_mesh(1, 2)``, on the
    Flax tree of ``jax.eval_shape`` (no init run), matched through
    ``nvae_torch.convert``'s names, each along the port's dimension 0."""
    tcfg_, jcfg_, min_features, count = _configs()[name]
    jm = JaxNVAE(jcfg_)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((1, jcfg_.image_size, jcfg_.image_size,
                   jcfg_.in_channels)), True))["params"]
    mesh = jax_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    specs = jax.tree_util.tree_flatten_with_path(
        jax_tp_param_sharding(shapes, mesh, min_features))[0]
    tm = TorchNVAE(tcfg_, device="meta")
    names = {path: key for path, (key, _) in _flax_layout(tm).items()}
    jax_split = {names[("params", *(k.key for k in path))]
                 for path, sh in specs if "model" in tuple(sh.spec)}
    port = tp_param_sharding(tm, 2, min_features)
    assert len(jax_split) == count
    assert set(port) == jax_split and set(port.values()) == {0}
