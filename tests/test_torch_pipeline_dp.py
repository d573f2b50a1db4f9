"""The pipeline's data-parallel stages (``nvae_torch/parallel/pipeline.py``
in a world of stages x ranks) on the CPU: one spawned gloo world of 4 ranks
(``tests/test_torch_dist_worker.py``, task ``pipeline``) runs both layouts
in turn, 2 stages x 2 ranks and 4 stages x 1 rank (every boundary, the
decoder's ``LatentParams`` to the postprocess among them), on the worker's
TINY debug model at global batch 16 and 2 microbatches.

Each layout is held against the port's ``grad_accum=2`` step on the global
batch and against the JAX package's ``PipelineTrainer`` of the same layout
(``dp=2`` over 4 of the test's virtual devices, and ``dp=1``), which runs
in this process while the ranks run: 3 SGD steps from the same weights
(random, from numpy, in the Flax tree, converted by ``nvae_torch.convert``)
with the same posterior noise.  The noise is recorded from JAX's ``dp=1``
run at 4 stages, every stage on one device, through an ordered
``jax.debug.callback`` (as ``tests/test_torch_pipeline_jax.py`` records
it; JAX's decoder recompute there draws each microbatch's noise twice, and
the first draw is kept); ``jax.random``'s draws do not depend on the
sharding or the stage count, so the one record serves ``dp=2`` at 2
stages, and the port's ranks take their rows of each global draw.

The limits are JAX's own (``tests/test_pipeline.py``): the loss within
1e-4 relative, parameters and BatchNorm statistics within 2e-6 absolute
after each step; every other metric within 1e-4 relative.  Against JAX
the BatchNorm statistics are held where the port's other comparisons with
JAX hold them (``tests/test_torch_train_step.py``'s ``BN_STATS_TOL``: 3e-5
of ``max(1, |value|)``): the 4 x 1 layout, which is the port's one-process
pipeline bit for bit, lies 3.3e-6 from JAX's on a running variance.  With the
production optimizer (Adamax, cosine decay, the spectral projection, the
EMA, at lr 1e-5), 2 steps against the ``grad_accum=2`` step: the loss
within 1e-4, parameters and the EMA within JAX's production bound (3 lr a
step), spectral ``u`` and sigma within 2e-6 and the BatchNorm statistics
after the first step (those of the second are the statistics of
parameters up to that bound apart), the
Adamax moments (gradient statistics) within 1e-4 of ``max(1, |moment|)``
of each tensor, the update counts equal.  Bit for bit: a
stage's ranks hold the same state after every step, every rank returns the
same metrics, and gpipe equals 1f1b.  The 2 x 2 layout's merged checkpoint
restores bit for bit into one device and into the one-process pipeline,
which then takes the next step as the world does; ``--mode train`` over the
world through the CLI, then a resume, ``--mode sample`` and ``--mode
test``, write checkpoints that restore the same ways, samples equal to a
single process's and one evaluation.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvae_torch import cli
from nvae_torch import config as tcfg
from nvae_torch.convert import flax_tree_from_state_dict, state_dict_from_flax
from nvae_torch.models.nvae import NVAE as TorchNVAE
from nvae_torch.parallel import PipelineTrainer
from nvae_torch.train import checkpoint as ckpt
from nvae_torch.train import optim as topt
from nvae_torch.train.state import create_train_state
from nvae_torch.train.step import make_train_step
from nvae_tpu import config as jcfg
from nvae_tpu.models import NVAE as JaxNVAE
from nvae_tpu.parallel import PipelineTrainer as JaxPipelineTrainer
from nvae_tpu.train.state import TrainState as JaxState
from tests.test_torch_dist_worker import (
    BATCH,
    PP_M,
    SGD_LR,
    TINY,
    _cli_argv,
    batches,
    pp_setup,
    spawn_world,
)
from tests.test_torch_sampler import random_flax_variables
from tests.test_torch_train_step import BN_STATS_TOL, _max_err
from tests.test_torch_trainer import (
    no_tensorboard,  # noqa: F401  (a fixture)
    single_torch_thread,
)

LOSS_RTOL = 1e-4
STATE_ATOL = 2e-6
TOTAL_STEPS, STEPS_PER_EPOCH = 100, 50  # the worker's
SGD_STEPS = 3
LAYOUTS = ("2x2", "4x1")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_module():
    with single_torch_thread():
        yield


def _jax_runs(directory) -> dict:
    """JAX's pipeline at 4 stages x dp=1 (recording its noise, which goes
    to the ranks with the weights) and at 2 stages x dp=2: each step's
    metrics and merged parameters and BatchNorm statistics."""
    jm = JaxNVAE(jcfg.debug_config(**TINY))
    variables = random_flax_variables(jm, seed=4)
    tm = TorchNVAE(tcfg.debug_config(**TINY), device="cpu")
    state_dict = state_dict_from_flax(variables, tm)
    tc = jcfg.TrainConfig(batch_size=BATCH, step_based_warmup=True)

    def trainer(S, dp):
        params = variables["params"]
        js = JaxState(
            step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
            params=params, batch_stats=variables["batch_stats"],
            spectral=variables.get("spectral", {}),
            opt_state=optax.sgd(SGD_LR).init(params),
            rng=jax.random.PRNGKey(7))
        devices = ([jax.devices()[0]] * S if dp == 1
                   else jax.devices()[:S * dp])
        return JaxPipelineTrainer(
            jm, tc, TOTAL_STEPS, STEPS_PER_EPOCH, n_stages=S,
            n_microbatches=PP_M, devices=devices, dp=dp, state=js,
            tx_factory=lambda: optax.sgd(SGD_LR))

    def record(pp, m):
        merged = pp.merged_state()
        return {"metrics": {k: float(v) for k, v in m.items()},
                "params": jax.device_get(merged.params),
                "batch_stats": jax.device_get(merged.batch_stats)}

    draws, real_normal = [], jax.random.normal

    def normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        jax.debug.callback(lambda v: draws.append(np.array(v, copy=True)),
                           out, ordered=True)
        return out

    per_mb = sum(TINY["n_groups_per_scale"])
    out = {"4x1": [], "2x2": []}
    eps = []
    pp = trainer(4, 1)
    for b in batches(SGD_STEPS):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "normal", normal)
            m = pp.step(b)
            jax.effects_barrier()
        # The decoder's forward and its recompute: each draw twice.
        assert len(draws) == 2 * PP_M * per_mb
        first, again = draws[:PP_M * per_mb], draws[PP_M * per_mb:]
        assert all(np.array_equal(a, c) for a, c in zip(first, again))
        eps.append([first[i * per_mb:(i + 1) * per_mb] for i in range(PP_M)])
        draws.clear()
        out["4x1"].append(record(pp, m))
    path = os.path.join(str(directory), "jax_inputs.pt")
    torch.save({"state_dict": state_dict, "eps": eps}, path + ".tmp")
    os.replace(path + ".tmp", path)
    pp = trainer(2, 2)
    for b in batches(SGD_STEPS):
        out["2x2"].append(record(pp, pp.step(b)))
    out["state_dict"], out["eps"], out["model"] = state_dict, eps, tm
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's records (rank by rank) and JAX's runs."""
    d = tmp_path_factory.mktemp("pp_world")
    w = spawn_world(d, ["pipeline"], world=4)
    try:
        with single_torch_thread():
            jax_runs = _jax_runs(d)
        ranks = [r["pipeline"] for r in w.results(timeout=900)]
    except BaseException:
        w.kill()
        raise
    return {"dir": str(d), "ranks": ranks, "jax": jax_runs}


def _model_sd(flat: dict) -> dict:
    return {k[len("model/"):]: v for k, v in flat.items()
            if k.startswith("model/")}


def _max_delta(a: dict, b: dict) -> float:
    assert list(a) == list(b)
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in a)


def _single_run(tc, state, tx, n_steps, eps=None):
    """The ``grad_accum=2`` step on the global batches: each step's
    metrics and flat state."""
    step = make_train_step(state.model, tx, tc, TOTAL_STEPS, STEPS_PER_EPOCH)
    out = []
    for i, b in enumerate(batches(n_steps)):
        state, m = step(state, torch.from_numpy(b),
                        eps=None if eps is None else eps[i])
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.clone() if isinstance(v, torch.Tensor) else v
                     for k, v in ckpt.flatten_state(state).items()}))
    return out


def _assert_metrics(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * max(
        abs(want["loss"]), 1.0)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   err_msg=k)


def _params_and_stats(model_sd: dict, params: set):
    p = {k: v for k, v in model_sd.items() if k in params}
    s = {k: v for k, v in model_sd.items() if k not in params}
    return p, s


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_matches_grad_accum_step(world, layout):
    """3 SGD steps of the layout, from JAX's weights with its noise,
    against the ``grad_accum=2`` step on the global batch: every metric,
    parameter and BatchNorm statistic after each step.  4 stages x 1 rank
    is the one-process pipeline of 4 stages bit for bit."""
    j = world["jax"]
    tc, state, tx, factory = pp_setup("sgd", j["state_dict"])
    run = world["ranks"][0][f"sgd/{layout}/1f1b"]
    if layout == "4x1":
        pp = _pipeline(copy.deepcopy(state), tc, 4, factory)
        for i, b in enumerate(batches(SGD_STEPS)):
            m = pp.step(b, eps=j["eps"][i])
            assert {k: float(v) for k, v in m.items()} == run["metrics"][i]
            assert _same_flat(ckpt.flatten_state(pp.merged_state()),
                              run["states"][i])
    ref = _single_run(tc, state, tx, SGD_STEPS, j["eps"])
    params = {k for k, _ in state.model.named_parameters()}
    for (m_r, flat_r), m_p, flat_p in zip(ref, run["metrics"],
                                          run["states"]):
        _assert_metrics(m_p, m_r)
        p_r, s_r = _params_and_stats(_model_sd(flat_r), params)
        p_p, s_p = _params_and_stats(_model_sd(flat_p), params)
        assert _max_delta(p_p, p_r) <= STATE_ATOL
        assert _max_delta(s_p, s_r) <= STATE_ATOL


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_matches_jax(world, layout):
    """The layout against JAX's ``PipelineTrainer`` of the same stages and
    ``dp`` (2 x 2: ``dp=2`` over 4 devices; 4 x 1: ``dp=1``), step by
    step: every metric, the merged parameters and BatchNorm statistics."""
    j = world["jax"]
    run = world["ranks"][0][f"sgd/{layout}/1f1b"]
    for m_p, flat_p, rec in zip(run["metrics"], run["states"], j[layout]):
        _assert_metrics(m_p, rec["metrics"])
        port = flax_tree_from_state_dict(_model_sd(flat_p), j["model"])
        err, where = _max_err(port["params"], rec["params"])
        assert err <= STATE_ATOL, ("params", err, where)
        err, where = _max_err(port["batch_stats"], rec["batch_stats"],
                              scale=True)
        assert err <= BN_STATS_TOL, ("batch_stats", err, where)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_production_optimizer(world, layout):
    """Adamax with cosine decay, the spectral projection and the EMA, per
    stage of the world, for 2 steps against the ``grad_accum=2`` step, in
    the whole model's layout: the loss, the parameters and the EMA within
    JAX's production bound, ``u``, sigma and the first step's statistics
    within 2e-6, the moments within 1e-4 of their scale, the counts
    equal."""
    tc, state, tx, _ = pp_setup("adamax", ema_decay=0.9)
    ref = _single_run(tc, state, tx, 2)
    run = world["ranks"][0][f"adamax/{layout}"]
    params = {k for k, _ in state.model.named_parameters()}
    for i, ((m_r, flat_r), m_p, flat_p) in enumerate(
            zip(ref, run["metrics"], run["states"])):
        bound = 3 * tc.learning_rate * (i + 1)
        assert abs(m_p["loss"] - m_r["loss"]) <= LOSS_RTOL * max(
            abs(m_r["loss"]), 1.0)
        assert flat_p.keys() == flat_r.keys()
        p_r, s_r = _params_and_stats(_model_sd(flat_r), params)
        p_p, s_p = _params_and_stats(_model_sd(flat_p), params)
        assert _max_delta(p_p, p_r) <= bound
        if i == 0:
            assert _max_delta(s_p, s_r) <= STATE_ATOL
        kinds = {"ema": [], "u": [], "sigma": [], "mu": [], "nu": []}
        for k, v in flat_r.items():
            if not k.startswith("opt/"):
                continue
            if not isinstance(v, torch.Tensor):
                assert flat_p[k] == v, k  # a count
                continue
            kind = next(n for n in kinds if f"/{n}/" in k)
            kinds[kind].append(k)
        assert all(kinds.values()), {n: len(v) for n, v in kinds.items()}
        err = {n: max(float((flat_p[k].double() - flat_r[k].double()
                             ).abs().max()) / (max(1.0, float(
                                 flat_r[k].abs().max()))
                            if n in ("mu", "nu") else 1.0) for k in keys)
               for n, keys in kinds.items()}
        assert err["ema"] <= bound, err
        assert err["u"] <= STATE_ATOL and err["sigma"] <= STATE_ATOL, err
        assert err["mu"] <= LOSS_RTOL and err["nu"] <= LOSS_RTOL, err


def test_replicas_and_ranks_agree_bitwise(world):
    """In every run, the ranks of a stage hold the same parameters,
    buffers and optimizer state after each step, bit for bit, and every
    rank returns the same metrics and merged state."""
    ranks = world["ranks"]
    runs = [k for k in ranks[0] if k != "cli"]
    assert len(runs) == 5
    for name in runs:
        recs = [r[name] for r in ranks]
        layout = name.split("/")[1]
        n = int(layout.split("x")[1])
        assert [(r["stage"], r["index"]) for r in recs] == [
            (i // n, i % n) for i in range(4)], name
        for r in recs:
            assert r["metrics"] == recs[0]["metrics"], name
            for a, b in zip(r["states"], recs[0]["states"]):
                assert a.keys() == b.keys()
                assert all(torch.equal(a[k], b[k])
                           if isinstance(a[k], torch.Tensor)
                           else a[k] == b[k] for k in a), name
            first = recs[r["stage"] * n]
            assert r["sums"] == first["sums"], name


def test_gpipe_equals_1f1b_bitwise(world):
    """At 2 stages x 2 ranks the two schedules give the same metrics and
    merged states bit for bit; each stashes at most its microbatches."""
    for r in world["ranks"]:
        f, g = r["sgd/2x2/1f1b"], r["sgd/2x2/gpipe"]
        assert f["metrics"] == g["metrics"]
        for a, b in zip(f["states"], g["states"]):
            assert all(torch.equal(a[k], b[k]) if isinstance(a[k],
                                                             torch.Tensor)
                       else a[k] == b[k] for k in a)
        assert g["peak_stash"] == (PP_M if g["stage"] == 0 else 0)
        assert f["peak_stash"] <= 2


def _pipeline(state, tc, S, tx_factory=None):
    return PipelineTrainer(
        state.model, dataclasses.replace(tc, grad_accum=1), TOTAL_STEPS,
        STEPS_PER_EPOCH, n_stages=S, n_microbatches=PP_M,
        devices=["cpu"] * S, state=state, tx_factory=tx_factory)


def _same_flat(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k] for k in a)


def test_checkpoint_restores_on_one_device_and_one_process(world):
    """The merged state the world's primary wrote after the 2 x 2
    layout's first production step restores bit for bit into a single
    device's template and, with the optimizer state, into the one-process
    pipeline, whose next step on the next batch is the world's second
    step within the production bound."""
    run = world["ranks"][0]["adamax/2x2"]
    d = os.path.join(world["dir"], "pp_ckpt")
    assert ckpt.all_steps(d) == [1]
    tc, template, _, _ = pp_setup("adamax", ema_decay=0.9)
    fresh = copy.deepcopy(template)
    restored = ckpt.restore_checkpoint(d, template)
    assert _same_flat(ckpt.flatten_state(restored), run["states"][0])
    pp = _pipeline(fresh, tc, 2)
    pp.load_state(restored, restore_opt=True)
    assert _same_flat(ckpt.flatten_state(pp.merged_state()),
                      run["states"][0])
    m = pp.step(batches(2)[1])
    assert abs(float(m["loss"]) - run["metrics"][1]["loss"]) <= LOSS_RTOL \
        * max(abs(run["metrics"][1]["loss"]), 1.0)
    got = _model_sd(ckpt.flatten_state(pp.merged_state()))
    assert _max_delta(got, _model_sd(run["states"][1])) \
        <= 3 * tc.learning_rate * 2


def test_cli_trains_resumes_and_samples_over_the_world(
        world, tmp_path, no_tensorboard):  # noqa: F811
    """``--mode train --pp_stages 2 --data_parallel 2`` in the world of 4
    (1 epoch, then a resume to 2), then ``--mode sample`` and ``--mode
    test`` over it: the layout printed by the primary alone, a whole-model
    checkpoint an epoch that restores into one device and into the
    one-process pipeline bit for bit, samples equal to a single process's
    from the same checkpoint, and one ``evaluation.json`` with a finite
    NLL."""
    rec = world["ranks"][0]["cli"]
    d = rec["dir"]
    assert "Pipeline: 2 stages x dp=2, 1f1b over 2 microbatches" \
        in rec["stdout"]
    assert rec["stdout"].count("Training done: best_loss=") == 2
    assert rec["stdout"].count("Negative log likelihood:") == 1
    with open(os.path.join(d, "logs", "evaluation.json")) as f:
        assert np.isfinite(json.load(f)["nll"]["mean"])
    for r in world["ranks"][1:]:
        assert not any(line in r["cli"]["stdout"] for line in (
            "Args:", "Pipeline:", "Training done", "Negative log"))
    models = os.path.join(d, "models")
    assert ckpt.all_steps(models) == [4, 8]
    payload = ckpt.load_payload(models, 8)
    counts = [v for k, v in payload.items() if k.endswith("/count")]
    assert payload["step"] == 8 and counts and all(v == 8 for v in counts)
    argv = _cli_argv(d)
    model_cfg, tc, _ = cli.configs_from_args(cli.parse_args(
        ["--mode", "train", "--epochs", "2", *argv]))
    _, template, _ = create_train_state(model_cfg, tc, 8, device="cpu")
    fresh = copy.deepcopy(template)
    restored = ckpt.restore_checkpoint(models, template)
    assert _same_flat(ckpt.flatten_state(restored), payload)
    pp = PipelineTrainer(fresh.model, tc, 8, 4, n_stages=2,
                         n_microbatches=2, devices=["cpu"] * 2, state=fresh)
    pp.load_state(restored, restore_opt=True)
    assert _same_flat(ckpt.flatten_state(pp.merged_state()), payload)
    assert topt.find_spectral_state(pp.merged_state().opt_state).u
    # A single process samples the same images from that checkpoint.
    argv[argv.index(os.path.join(d, "results"))] = str(tmp_path / "results")
    cli.main(["--mode", "sample", "--n_samples", "4", "--pp_stages", "2",
              *argv])
    def pngs(root, t):
        out = []
        for f in os.listdir(os.path.join(root, t)):
            with open(os.path.join(root, t, f), "rb") as fh:
                out.append(fh.read())
        return sorted(out)

    for t in ("t_0.7", "t_1.0"):
        mine = pngs(os.path.join(d, "results"), t)
        assert len(mine) == 8  # a batch of 8 holds the 4 asked for
        assert mine == pngs(tmp_path / "results", t)
