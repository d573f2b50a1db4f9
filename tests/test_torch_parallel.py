"""The port's data parallelism and FSDP layout (``nvae_torch.parallel``,
``--data_parallel``, ``--fsdp``) on the CPU: twins of
``tests/test_parallel.py``'s DP and FSDP tests, ``tests/test_multihost.py``
and ``tests/test_ckpt_topology.py``.

One world of two gloo ranks per module (``tests/test_torch_dist_worker.py``)
runs every check that needs ranks, while this process runs JAX's side: the
units of ``parallel/multihost.py`` and ``parallel/mesh.py``, the world-2
step (replicated and FSDP) against the port's single-device step and
against JAX's ``make_train_step`` over a 2-device data mesh (``shard_state``
and ``shard_state_fsdp``), the scan runner at world 2 in both layouts, the
FSDP units (bytes a rank holds, sigma of the whole kernel, checkpoints
across layouts and world sizes) and the CLI's ``--data_parallel 2``, with
and without ``--fsdp``.  The FSDP runs take JAX's tests' ``min_size`` 64,
so that every conv kernel of the debug model shards.

The central property, as in JAX: a data-parallel step equals the single
device's step on the global batch.  Tolerances (JAX's SGD lockstep,
``test_sgd_lockstep_every_step_tight``): SGD at lr 1e-5, loss and the other
metrics at rtol 1e-5, ``grad_norm`` at rtol 1e-4, parameters within 1e-5,
BatchNorm running statistics within 1e-4 (against JAX, 3e-5 of
``max(1, |value|)``, ``tests/test_torch_train_step.py``'s limit across the
two frameworks).  Adamax, one step: each parameter within ``2 lr`` of the
single run (Adamax moves a coordinate by about ``lr``, whatever the
gradient's size, so a near-zero gradient whose sign differs moves it the
other way); four FSDP steps: JAX's trajectory limits (loss rtol 1e-6 at
step 0, 2e-3 after, BatchNorm within 1e-4 at step 0, parameters within
``3 lr 4`` at the end).  After every step the ranks' replicated tensors
are equal bit for bit.
The JAX side runs its plain depthwise path (``use_pallas_kernels=False``:
a Pallas compile in interpret mode would double this file's time); the
port's runs its kernel wrappers' CPU path, held against the Pallas kernels
by ``tests/test_torch_train_step.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvae_torch import config as tcfg
from nvae_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.models.nvae import posterior_noise_shapes
from nvae_torch.parallel import (
    DataMesh,
    initialize,
    make_mesh,
    process_count,
    process_local_rows,
    shard_batch,
)
from nvae_torch.presets import PRESETS, get_preset
from nvae_tpu import config as jcfg
from nvae_tpu.models import NVAE as JaxNVAE
from nvae_tpu.parallel import make_mesh as jax_make_mesh
from nvae_tpu.parallel import shard_batch as jax_shard_batch
from nvae_tpu.parallel import fsdp_sharding as jax_fsdp_sharding
from nvae_tpu.parallel import shard_state as jax_shard_state
from nvae_tpu.parallel import shard_state_fsdp as jax_shard_state_fsdp
from nvae_tpu.train.state import TrainState as JaxState
from nvae_tpu.train.step import make_train_step as jax_train_step
from tests.test_torch_dist_worker import (
    BATCH,
    FSDP_MIN,
    FSDP_RUNS,
    SGD_LR,
    STEP_RUNS,
    TINY,
    batches,
    spawn_world,
)
from tests.test_torch_sampler import random_flax_variables

LOSS_RTOL, GRAD_NORM_RTOL, PARAMS_ATOL, BN_ATOL = 1e-5, 1e-4, 1e-5, 1e-4
BN_STATS_TOL = 3e-5  # across the frameworks, of max(1, |value|)
JAX_STEPS = 3


def _jax_mesh_runs(directory):
    """JAX's side, written to ``directory/jax_inputs.pt`` for the ranks:
    the same random weights in both packages, and the noise of JAX's
    2-device mesh runs (grad_accum 1 and 2 replicated, 1 in the FSDP
    layout: key ``"fsdp"``), recorded as they run.  An ordered callback
    cannot run on two devices, so the draws come unordered: whole
    (gathered), one microbatch's after the other's (the scan's iterations
    run in turn), in any order within one.  Within a microbatch each
    group's draw has a shape of its own, which puts them back in the
    posterior pass's order.
    Returns each run's per-step (metrics, params, batch_stats)."""
    cfg = jcfg.debug_config(**{**TINY, "use_pallas_kernels": False})
    jm = JaxNVAE(cfg)
    variables = random_flax_variables(jm, seed=4)
    tm = TorchNVAE(tcfg.debug_config(**TINY), device="cpu")
    tx = optax.sgd(SGD_LR)
    mesh = jax_make_mesh(n_data=2, devices=jax.devices()[:2])
    draws, real_normal = [], jax.random.normal

    def normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        jax.debug.callback(lambda v: draws.append(np.array(v, copy=True)),
                           out)
        return out

    eps, runs = {}, {}
    for key in (1, 2, "fsdp"):
        accum = 1 if key == "fsdp" else key
        order = [s[1:] for s in posterior_noise_shapes(tm.cfg, 1)]
        assert len(set(order)) == len(order)
        tc = jcfg.TrainConfig(batch_size=BATCH, step_based_warmup=True,
                              grad_accum=accum)
        step = jax_train_step(jm, tx, tc, 100, 50, donate=False, mesh=mesh)
        js = JaxState(
            step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
            params=variables["params"],
            batch_stats=variables["batch_stats"],
            spectral=variables.get("spectral", {}),
            opt_state=tx.init(variables["params"]),
            rng=jax.random.PRNGKey(7))
        js = (jax_shard_state_fsdp(js, mesh, min_size=FSDP_MIN)
              if key == "fsdp" else jax_shard_state(js, mesh))
        eps[key], runs[key] = [], []
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax.random, "normal", normal)
            for b in batches(JAX_STEPS):
                js, met = step(js, jax_shard_batch(jnp.asarray(b), mesh))
                jax.effects_barrier()
                assert len(draws) == accum * len(order)
                mbs = [draws[i * len(order):(i + 1) * len(order)]
                       for i in range(accum)]
                eps[key].append([sorted(mb, key=lambda e: order.index(
                    e.shape[1:])) for mb in mbs])
                draws.clear()
                runs[key].append((
                    {k: float(v) for k, v in met.items()},
                    jax.device_get(js.params),
                    jax.device_get(js.batch_stats)))
    tmp = directory / "jax_inputs.tmp"
    torch.save({"state_dict": state_dict_from_flax(variables, tm),
                "eps": eps}, tmp)
    tmp.rename(directory / "jax_inputs.pt")
    return runs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results, JAX's mesh runs (made while the ranks run
    their other tasks), and the world's directory."""
    d = tmp_path_factory.mktemp("dp_world")
    (d / "cli").mkdir()
    ranks = spawn_world(d, ["units", "steps", "scan", "fsdp", "cli",
                            "jax_steps"])
    try:
        jax_mesh = _jax_mesh_runs(d)
    except BaseException:
        ranks.kill()
        raise
    return ranks.results(), jax_mesh, d


def _max_diff(a: dict, b: dict, keys=None) -> float:
    keys = a.keys() if keys is None else keys
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in keys)


def _params(sd: dict) -> list:
    return [k for k in sd if "running_" not in k and not k.endswith(".u")]


# ---- units, in this process ------------------------------------------------


def test_initialize_single_process_is_noop():
    initialize(num_processes=1, device="cpu")
    assert not torch.distributed.is_initialized() and process_count() == 1
    assert process_local_rows(144) == (0, 144)


def test_make_mesh_refuses_what_waits_and_needs_a_group():
    """A model axis of 2 needs a launcher's 2 ranks (``make_mesh(0, 2)``
    lays N ranks out as N / 2 x 2); a process with no group has no data
    axis, and a data axis of 2 needs a launcher's 2 ranks."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        make_mesh(0, 2, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh(2, 2, device="cpu")
    assert make_mesh(device="cpu") is None and make_mesh(1) is None
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        make_mesh(2, device="cpu")


def test_shard_batch_is_microbatch_major():
    """Rank r holds, for each microbatch i of m rows, global rows
    ``[i m + r m / N, i m + (r + 1) m / N)`` (JAX's ``P(None, "data")``
    pin); with one microbatch, the contiguous block."""
    mesh = DataMesh(rank=1, size=2, device=torch.device("cpu"))
    x = torch.arange(16)
    assert shard_batch(x, mesh).tolist() == list(range(8, 16))
    assert shard_batch(x, mesh, 2).tolist() == [4, 5, 6, 7, 12, 13, 14, 15]
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(torch.arange(6), mesh, 2)


def test_batch_stats_over_leaves_no_mesh_behind():
    """While ``batch_stats_over`` is open every BatchNorm holds the mesh;
    it refuses to open over a model that holds one, and leaves none behind
    when its block raises."""
    from nvae_torch.nn.blocks import BatchNorm
    from nvae_torch.parallel.mesh import batch_stats_over

    model = TorchNVAE(tcfg.debug_config(**TINY), device="cpu")
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    mesh = DataMesh(rank=0, size=1, device=torch.device("cpu"))
    with pytest.raises(KeyError):
        with batch_stats_over(model, mesh):
            assert bns and all(m.mesh is mesh for m in bns)
            with pytest.raises(RuntimeError, match="open already"):
                with batch_stats_over(model.decoder, mesh):
                    pass
            raise KeyError("out of the block")
    assert all(m.mesh is None for m in bns)


def test_data_parallel_settings_are_checked():
    """``--data_parallel 2`` in a world of 1 stops the CLI naming the
    launcher (``make_mesh``'s check); ``param_sharding="fsdp"`` without a
    mesh is the replicated layout, as in JAX; ``model_parallel > 1`` waits
    for the API (the trainer runs no TP layout, as JAX's runs none);
    ``--pp_stages 2 --fsdp`` stops with JAX's message."""
    from nvae_torch import cli
    from nvae_torch.parallel.mesh import shard_of
    from nvae_torch.train.trainer import Trainer

    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        cli.main(["--mode", "train", "--cpu", "--data_parallel", "2"])
    cfg = tcfg.debug_config(**TINY)
    t = Trainer(cfg, tcfg.TrainConfig(), 4, device="cpu",
                param_sharding="fsdp")
    assert not t.fsdp and all(shard_of(p) is None
                              for p in t.model.parameters())
    with pytest.raises(NotImplementedError,
                       match=r"make_mesh\(n_model=\.\.\.\) -> shard_state_tp"):
        Trainer(cfg, tcfg.TrainConfig(model_parallel=2), 4, device="cpu")
    with pytest.raises(SystemExit, match=r"^--pp_stages excludes --fsdp"):
        cli.main(["--mode", "train", "--cpu", "--fsdp", "--pp_stages", "2"])


# ---- at world 2 ------------------------------------------------------------


def test_world2_multihost_and_mesh_units(world):
    (r0, r1), _, _ = world
    u0, u1 = r0["units"], r1["units"]
    assert (u0["rows"], u1["rows"]) == ((0, 72), (72, 144))
    assert u0["primary"] and not u1["primary"]
    assert "not divisible by 2" in u0["odd_rows"]
    assert "needs 3 ranks" in u0["n_data_3"]
    # A model axis of 2 is the world of 2 as 1 x 2, which the data axis's
    # layouts refuse, as JAX's do; 2 x 2 needs 4 ranks.
    assert "needs 4 ranks" in u0["n_data_2_n_model_2"]
    assert (u0["n_model_2"], u1["n_model_2"]) == ((0, 1, 0, 2), (0, 1, 1, 2))
    for u in (u0, u1):
        assert "Use shard_state_tp" in u["shard_state_tp"]
        assert "Use shard_state_tp" in u["shard_state_fsdp_tp"]
    assert u1["global_batch"].tolist() == [[1, 1]] * 3
    # Ranks that start apart are replicated from rank 0, and a changed
    # value on one rank is found.
    assert u0["before"] and u0["after"] == [] == u1["after"]
    assert _max_diff(u0["weights"], u1["weights"]) == 0.0
    assert u0["perturbed"] == ["model/decoder.h"] == u1["perturbed"]
    assert u0["iterator"] and u1["iterator"]
    want = [2.0 * i for i in range(7)]
    assert u0["map_rows"][:, 0].tolist() == [w + (i >= 4)
                                             for i, w in enumerate(want)]


@pytest.mark.parametrize("name", list(STEP_RUNS))
def test_dp_step_matches_single_step(world, name):
    """The world-2 step against the single-device step on the global
    batch: every step's metrics, parameters and BatchNorm statistics."""
    (r0, r1), _, _ = world
    single = (r0 if list(STEP_RUNS).index(name) % 2 == 0 else r1)[
        "steps"][f"single/{name}"]
    mesh = r0["steps"][name]
    adamax = STEP_RUNS[name][0] == "adamax"
    for i, (mm, sm) in enumerate(zip(mesh["metrics"], single["metrics"])):
        assert mm.keys() == sm.keys()
        for k in mm:
            rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(mm[k], sm[k], rtol=rtol,
                                       err_msg=f"{name} step {i} {k}")
        ms, ss = mesh["states"][i], single["states"][i]
        keys = _params(ss)
        limit = 2 * tcfg.TrainConfig().learning_rate if adamax else PARAMS_ATOL
        assert _max_diff(ms, ss, keys) < limit, (name, i)
        bn = [k for k in ss if "running_" in k]
        assert bn and _max_diff(ms, ss, bn) < BN_ATOL, (name, i)


def test_dp_state_is_replicated_bitwise_every_step(world):
    """Parameters, BatchNorm statistics, spectral state, optimizer state
    and counters are the same on both ranks after every step."""
    (r0, r1), _, _ = world
    for name in STEP_RUNS:
        a, b = r0["steps"][name], r1["steps"][name]
        assert all(m == [] for m in a["mismatches"] + b["mismatches"])
        for sa, sb in zip(a["states"], b["states"]):
            assert all(torch.equal(sa[k], sb[k]) for k in sa), name
        assert a["metrics"] == b["metrics"]


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_step_matches_jax_mesh_step(world, accum):
    """The port's world-2 step against JAX's ``make_train_step`` over a
    2-device data mesh (``shard_state``, ``shard_batch``), from the same
    weights, batches and noise, at every step."""
    (r0, r1), jax_mesh, _ = world
    port = r0["jax_steps"][accum]
    tm = TorchNVAE(tcfg.debug_config(**TINY), device="meta")
    for i, (jmet, jparams, jstats) in enumerate(jax_mesh[accum]):
        tmet = port["metrics"][i]
        assert set(tmet) == set(jmet)
        for k in jmet:
            rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(tmet[k], jmet[k], rtol=rtol,
                                       err_msg=f"accum {accum} step {i} {k}")
        tree = flax_tree_from_state_dict(port["states"][i], tm)
        p_err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                    for a, b in zip(jax.tree_util.tree_leaves(tree["params"]),
                                    jax.tree_util.tree_leaves(jparams)))
        assert p_err < PARAMS_ATOL, (accum, i, p_err)
        s_err = max(float((np.abs(np.asarray(a) - np.asarray(b))
                           / np.maximum(1.0, np.abs(np.asarray(b)))).max())
                    for a, b in zip(
                        jax.tree_util.tree_leaves(tree["batch_stats"]),
                        jax.tree_util.tree_leaves(jstats)))
        assert s_err < BN_STATS_TOL, (accum, i, s_err)
    assert r1["jax_steps"][accum]["metrics"] == port["metrics"]


def test_scan_runner_world2_matches_single(world):
    """The epoch runner over the mesh (each rank its rows of each global
    batch) against the single-device runner: the epoch's means and the
    state after it, SGD at lr 1e-5."""
    (r0, r1), _, _ = world
    mesh, single = r0["scan"]["mesh"], r0["scan"]["single"]
    assert mesh["step"] == single["step"] == 2
    for k, v in single["means"].items():
        rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(mesh["means"][k], v, rtol=rtol, err_msg=k)
    ss = single["state"]
    assert _max_diff(mesh["state"], ss, _params(ss)) < PARAMS_ATOL
    assert all(torch.equal(mesh["state"][k], r1["scan"]["mesh"]["state"][k])
               for k in ss)


def test_cli_data_parallel_trains_resumes_and_tests(world):
    """``--mode train --data_parallel 2`` writes one checkpoint per epoch
    (rank 0 alone), resumes on both ranks, and ``--mode test`` writes
    ``evaluation.json`` once."""
    (r0, r1), _, d = world
    c0, c1 = r0["cli"], r1["cli"]
    assert c0["steps_1"] == [4] and c0["steps_2"] == [4, 8]
    assert c1["steps_2"] == [4, 8]
    assert torch.equal(c0["ckpt_sums"], c1["ckpt_sums"])
    with open(d / "cli" / "logs" / "metrics.jsonl") as f:
        lines = [json.loads(x) for x in f]
    # One line per epoch: rank 1 wrote none.
    assert [r["step"] for r in lines if "train/loss" in r] == [0, 1]
    assert sum("test/elbo" in r for r in lines) == 2
    with open(d / "cli" / "logs" / "evaluation.json") as f:
        assert "nll" in json.load(f)


# ---- FSDP ------------------------------------------------------------------


def _jax_shapes(model) -> dict:
    """The Flax ``params`` tree of ``model``'s shapes, in JAX's layouts
    (``nvae_torch.convert``'s map), as zero-stride arrays, and each Flax
    leaf path's port name."""
    from nvae_torch.convert import _flax_layout

    sd = model.state_dict()
    tree, names = {}, {}
    for path, (key, (_, to_flax)) in _flax_layout(model).items():
        if path[0] != "params":
            continue
        node = tree
        for p in path[1:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = to_flax(np.broadcast_to(np.float32(0),
                                                 tuple(sd[key].shape)))
        names[path[1:]] = key
    return tree, names


@pytest.mark.parametrize("preset", PRESETS)
def test_fsdp_selection_matches_jax(preset):
    """The tensors the port's ``fsdp_sharding`` splits over 2 ranks are
    those JAX's ``fsdp_sharding`` splits over a 2-device mesh, on every
    preset's shapes at full width, at the default ``min_size`` and at the
    tests' 64, matched through ``nvae_torch.convert``'s names; each split
    dimension divides by 2.  No world."""
    from nvae_torch.parallel import fsdp_sharding

    model = TorchNVAE(get_preset(preset)[0], device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    tree, names = _jax_shapes(model)
    mesh = jax_make_mesh(n_data=2, devices=jax.devices()[:2])
    for min_size in (65536, FSDP_MIN):
        port = fsdp_sharding(shapes, 2, min_size)
        specs = jax.tree_util.tree_flatten_with_path(
            jax_fsdp_sharding(tree, mesh, min_size))[0]
        jax_split = {names[tuple(k.key for k in path)] for path, sh in specs
                     if "data" in tuple(sh.spec)}
        assert jax_split and set(port) == jax_split, (preset, min_size)
        assert all(shapes[k][d] % 2 == 0 for k, d in port.items())


def test_fsdp_dim_is_a_pure_function_of_the_shape():
    """JAX's ``test_fsdp_sharding_selects_large_leaves``, in the port's
    layouts: a large tensor splits (dimension 0 where it divides, else the
    largest divisible one), a small one and one with no divisible
    dimension stay whole, and the moments, of the parameters' shapes, split
    alike."""
    from nvae_torch.parallel import fsdp_sharding
    from nvae_torch.parallel.mesh import fsdp_dim

    shapes = {"wide": (96, 16, 1, 1), "odd_first": (3, 96, 5, 5),
              "tiny": (48,), "odd": (7, 5, 3, 3)}
    split = fsdp_sharding(shapes, 8, min_size=64)
    assert split == {"wide": 0, "odd_first": 1}
    assert fsdp_dim((5, 5, 16, 16), 8, 64) == 3  # ties to the trailing one
    moments = {f"mu/{k}": v for k, v in shapes.items()}
    assert fsdp_sharding(moments, 8, 64) == {f"mu/{k}": d
                                             for k, d in split.items()}


def test_world2_fsdp_state_bytes(world):
    """A rank holds 1/2 of each sharded tensor: the parameters, both Adamax
    moments and the EMA of every parameter ``fsdp_sharding`` selects, and
    nothing else; its bytes are the replicated layout's less half of
    theirs."""
    from nvae_torch.parallel import fsdp_sharding

    (r0, r1), _, _ = world
    f = r0["fsdp"]
    shapes = {k: tuple(v.shape) for k, v in TorchNVAE(
        tcfg.debug_config(**TINY), device="meta").named_parameters()}
    want = fsdp_sharding(shapes, 2, FSDP_MIN)
    by_param = {}
    for name, (full, dim, held) in f["sharded"].items():
        param = name.split("/")[-1] if name.startswith("opt/") else name[
            len("model/"):]
        assert want[param] == dim and full == shapes[param]
        assert held[dim] * 2 == full[dim]
        by_param.setdefault(param, []).append(name)
    # The parameter, mu, nu and the EMA: four copies of each.
    assert set(by_param) == set(want)
    assert all(len(v) == 4 for v in by_param.values())
    half = sum(int(np.prod(full)) * 4 // 2
               for full, _, _ in f["sharded"].values())
    assert f["bytes"]["fsdp"] == f["bytes"]["replicated"] - half
    assert r1["fsdp"]["bytes"] == f["bytes"]


def _single(ranks, name: str) -> dict:
    """The single-device run ``name``: the ranks took them in turn."""
    return ranks[list({**STEP_RUNS, **FSDP_RUNS}).index(name) % 2][
        "steps"][f"single/{name}"]


@pytest.mark.parametrize("name", list(FSDP_RUNS))
def test_fsdp_step_matches_single_step(world, name):
    """The world-2 step in the FSDP layout against the single-device step
    on the global batch, every step: SGD with the spectral projection
    (sigma is the whole kernel's) at JAX's lockstep limits (grad_accum 1 and
    2, and with remat: the backward pass runs each cell again on the
    gathered weights), Adamax at JAX's trajectory limits; the replicated
    tensors equal on both ranks bit for bit."""
    (r0, r1), _, _ = world
    single = _single((r0, r1), name)
    mesh = r0["steps"][f"fsdp/{name}"]
    assert mesh["dims"]
    adamax = FSDP_RUNS[name][0] == "adamax"
    for i, (mm, sm) in enumerate(zip(mesh["metrics"], single["metrics"])):
        assert mm.keys() == sm.keys()
        for k in mm:
            if adamax:
                rtol = 1e-6 if i == 0 else 2e-3
                if k not in ("loss", "grad_norm"):
                    continue
            else:
                rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(mm[k], sm[k], rtol=rtol,
                                       err_msg=f"{name} step {i} {k}")
        ms, ss = mesh["states"][i], single["states"][i]
        bn = [k for k in ss if "running_" in k]
        if not adamax:
            assert _max_diff(ms, ss, _params(ss)) < PARAMS_ATOL, (name, i)
        if not adamax or i == 0:
            assert bn and _max_diff(ms, ss, bn) < BN_ATOL, (name, i)
    if adamax:
        lr = tcfg.TrainConfig().learning_rate
        ss = single["states"][-1]
        assert _max_diff(mesh["states"][-1], ss, _params(ss)) < 3 * lr * 4
    for r in (r0, r1):
        assert all(m == [] for m in r["steps"][f"fsdp/{name}"]["mismatches"])
    for a, b in zip(mesh["states"], r1["steps"][f"fsdp/{name}"]["states"]):
        assert all(torch.equal(a[k], b[k]) for k in a), name


def test_fsdp_moments_are_the_single_runs_blocks(world):
    """Note (a): each rank's Adamax moments of a sharded parameter cover
    the elements its parameter block covers: after the first and the last
    of four steps they are the single run's moments sliced by the same
    dimension and block, within 1e-3 of the block's largest entry (plus
    1e-5 of the moment's largest over the model: the biases before a
    BatchNorm have gradients of rounding noise)."""
    (r0, r1), _, _ = world
    single = _single((r0, r1), "adamax4")
    for rank, r in enumerate((r0, r1)):
        run = r["steps"]["fsdp/adamax4"]
        for mine, theirs in zip(run["moments"], single["moments"]):
            for kind in ("mu", "nu"):
                scale = max(float(v.abs().max())
                            for v in theirs[kind].values())
                for k, v in mine[kind].items():
                    want = theirs[kind][k]
                    if k in run["dims"]:
                        d = run["dims"][k]
                        b = want.shape[d] // 2
                        want = want.narrow(d, rank * b, b)
                    assert v.shape == want.shape, k
                    err = float((v - want).abs().max())
                    assert err <= (1e-3 * float(want.abs().max())
                                   + 1e-5 * scale), (rank, kind, k, err)


def test_fsdp_step_matches_jax_fsdp_mesh_step(world):
    """The port's world-2 FSDP step against JAX's ``make_train_step`` over
    a 2-device mesh in JAX's ``shard_state_fsdp`` layout (``min_size`` 64),
    from the same weights, batches and noise, at every step."""
    (r0, r1), jax_mesh, _ = world
    port = r0["jax_steps"]["fsdp"]
    tm = TorchNVAE(tcfg.debug_config(**TINY), device="meta")
    assert port["dims"]
    for i, (jmet, jparams, jstats) in enumerate(jax_mesh["fsdp"]):
        tmet = port["metrics"][i]
        assert set(tmet) == set(jmet)
        for k in jmet:
            rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(tmet[k], jmet[k], rtol=rtol,
                                       err_msg=f"fsdp step {i} {k}")
        tree = flax_tree_from_state_dict(port["states"][i], tm)
        p_err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                    for a, b in zip(jax.tree_util.tree_leaves(tree["params"]),
                                    jax.tree_util.tree_leaves(jparams)))
        assert p_err < PARAMS_ATOL, (i, p_err)
        s_err = max(float((np.abs(np.asarray(a) - np.asarray(b))
                           / np.maximum(1.0, np.abs(np.asarray(b)))).max())
                    for a, b in zip(
                        jax.tree_util.tree_leaves(tree["batch_stats"]),
                        jax.tree_util.tree_leaves(jstats)))
        assert s_err < BN_STATS_TOL, (i, s_err)
    assert r1["jax_steps"]["fsdp"]["metrics"] == port["metrics"]


def test_fsdp_scan_runner_matches_single(world):
    """The epoch runner over an FSDP state against the single-device
    runner: the epoch's means and the state after it, SGD at lr 1e-5, at
    JAX's lockstep limits."""
    (r0, r1), _, _ = world
    fsdp, single = r0["scan"]["fsdp"], r0["scan"]["single"]
    assert fsdp["step"] == single["step"] == 2
    for k, v in single["means"].items():
        rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(fsdp["means"][k], v, rtol=rtol, err_msg=k)
    ss = single["state"]
    assert _max_diff(fsdp["state"], ss, _params(ss)) < PARAMS_ATOL
    bn = [k for k in ss if "running_" in k]
    assert _max_diff(fsdp["state"], ss, bn) < BN_ATOL
    assert all(torch.equal(fsdp["state"][k], r1["scan"]["fsdp"]["state"][k])
               for k in ss)


def test_fsdp_spectral_projection_takes_sigma_of_the_whole_kernel(world):
    """Note (b): the spectral projection on a kernel's blocks gives each
    rank the block of the projection on the whole kernel, bit for bit, and
    the same ``u`` and sigma; sigma of one rank's block alone is another
    (the fault the gather prevents), by more than 1%."""
    (r0, r1), _, _ = world
    for r in (r0, r1):
        p = r["fsdp"]["projection"]
        assert p["update"] and p["u"] and p["sigma"]
        assert p["local_sigma_rel"] > 1e-2


@pytest.mark.parametrize("trip", ["world1_to_fsdp2", "fsdp2_file",
                                  "fsdp2_to_world1", "fsdp2_to_replicated2"])
def test_fsdp_checkpoints_restore_across_layouts(world, trip):
    """Twins of ``tests/test_ckpt_topology.py``: a world-1 checkpoint
    restores into FSDP-2, an FSDP-2 state writes the replicated layout's
    file (its tensors whole), and that file restores into world 1 (on
    rank 0) and into replicated-2, each value for value, bit for bit."""
    (r0, r1), _, _ = world
    assert r0["fsdp"]["trips"][trip]
    if trip != "fsdp2_to_world1":
        assert r1["fsdp"]["trips"][trip]


def test_cli_fsdp_trains_and_resumes(world):
    """``--mode train --data_parallel 2 --fsdp`` (at ``min_size`` 64)
    trains an epoch, resumes for a second, with eval and image hooks, and
    writes checkpoints of the replicated layout's keys and shapes.  Over
    two gloo ranks a reduce-scatter's sums are the all-reduce's (a + b in
    either order) and every other update is elementwise or reads the
    whole kernel, so the run equals the replicated ``--data_parallel 2``
    run bit for bit."""
    (r0, r1), _, d = world
    c = r0["cli"]
    assert c["fsdp_steps"] == [4, 8] == r1["cli"]["fsdp_steps"]
    assert c["fsdp_sharded"] and c["fsdp_sharded"][0] > 0
    assert c["fsdp_vs_dp"] is not None
    assert all(v == 0.0 if isinstance(v, float) else v
               for v in c["fsdp_vs_dp"].values())
    with open(d / "cli_fsdp" / "logs" / "metrics.jsonl") as f:
        lines = [json.loads(x) for x in f]
    assert [r["step"] for r in lines if "train/loss" in r] == [0, 1]
    assert sum("test/elbo" in r for r in lines) == 2
