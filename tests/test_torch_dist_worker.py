"""Ranks of the small gloo worlds that the port's data-parallel tests spawn
on the CPU (``tests/test_torch_parallel*.py``, ``test_torch_serving_mesh.py``).

Run as ``python -m tests.test_torch_dist_worker DIR RANK WORLD TASK...`` from
the repository's root: the rank joins a gloo group over ``file://DIR/store``
with one torch thread, runs each task on the inputs in ``DIR/inputs.pt``
and writes ``{task: result}`` to ``DIR/rank{RANK}.pt``.  It imports no JAX:
the tests compute JAX's side in their own process.  :func:`spawn_world`
starts the ranks; the tests do their JAX work while the ranks run.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
# The debug model of tests/test_parallel.py: small enough for a quick step.
TINY = dict(n_encoder_channels=8, n_decoder_channels=8,
            n_groups_per_scale=(1, 1), n_latent_per_group=2,
            use_pallas_kernels=True)
BATCH = 16
SGD_LR = 1e-5


class World:
    """Ranks started by :func:`spawn_world`; :meth:`results` waits for
    them."""

    def __init__(self, procs, directory):
        self.procs, self.dir = procs, directory

    def kill(self) -> None:
        for p in self.procs:
            p.kill()
            p.communicate()

    def results(self, timeout: float = 600.0) -> list:
        logs = []
        for p in self.procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out)
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            if p.returncode:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n{log}")
        return [torch.load(os.path.join(self.dir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(len(self.procs))]


def spawn_world(directory, tasks, inputs=None, world: int = 2) -> World:
    """Start ``world`` ranks running ``tasks`` on ``inputs`` (anything
    ``torch.save`` takes) in ``directory``."""
    directory = str(directory)
    torch.save({**(inputs or {}), "dir": directory},
               os.path.join(directory, "inputs.pt"))
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_", "NVAE_TORCH_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_dist_worker", directory,
         str(r), str(world), *tasks],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    return World(procs, directory)


# ---- what the ranks run ---------------------------------------------------


def sgd(lr):
    """Plain SGD for the port: ``update = -lr * g`` (a linear update, so
    the parameters track the gradients)."""
    from nvae_torch.train import optim as topt

    return topt.GradientTransformation(
        lambda params: None,
        lambda updates, state, params=None: (
            {k: -lr * g for k, g in updates.items()}, None))


def batches(n_steps: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(BATCH, 32, 32, 1) > 0.5).astype(np.float32)
            for _ in range(n_steps)]


def _snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def train_run(mesh, optimizer: str, accum: int, n_steps: int,
              state_dict=None, eps=None, seed: int = 0) -> dict:
    """``n_steps`` of the debug model from ``state_dict`` (else its seeded
    init) on :func:`batches`; with a mesh each rank steps on its rows.
    ``eps`` injects each step's global noise (one list per microbatch).
    Returns each step's metrics, the state after each step, and with a
    mesh the tensors that differ across ranks after each step."""
    from nvae_torch import TrainConfig, debug_config
    from nvae_torch.parallel import shard_batch
    from nvae_torch.parallel.mesh import replica_mismatches
    from nvae_torch.train.state import create_train_state
    from nvae_torch.train.step import make_train_step

    cfg = debug_config(**TINY)
    tc = TrainConfig(batch_size=BATCH, step_based_warmup=True,
                     grad_accum=accum)
    tx = sgd(SGD_LR) if optimizer == "sgd" else None
    model, state, tx = create_train_state(cfg, tc, 100, device=CPU, tx=tx,
                                          seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    step = make_train_step(model, tx, tc, 100, 50, mesh=mesh)
    out = {"metrics": [], "states": [], "mismatches": []}
    for i, b in enumerate(batches(n_steps)):
        b = torch.from_numpy(b)
        if mesh is not None:
            b = shard_batch(b, mesh, accum)
        state, m = step(state, b, eps=None if eps is None else eps[i])
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(_snapshot(model))
        if mesh is not None:
            out["mismatches"].append(replica_mismatches(state, mesh))
    return out


STEP_RUNS = {  # name: (optimizer, grad_accum, steps)
    "sgd_accum1": ("sgd", 1, 3),
    "sgd_accum2": ("sgd", 2, 3),
    "adamax": ("adamax", 1, 1),
}


def task_steps(mesh, inputs):
    """Each of ``STEP_RUNS`` over the mesh, and on one device (the runs
    split between the ranks, which need no collective for them)."""
    out = {}
    for i, (name, (opt, accum, n)) in enumerate(STEP_RUNS.items()):
        out[name] = train_run(mesh, opt, accum, n)
    for i, (name, (opt, accum, n)) in enumerate(STEP_RUNS.items()):
        if i % mesh.size == mesh.rank:
            out[f"single/{name}"] = train_run(None, opt, accum, n)
    return out


def task_jax_steps(mesh, inputs):
    """The SGD runs from the JAX package's weights with its recorded
    noise, over the mesh: the other side of the comparison with JAX's
    2-device mesh step.  The test writes them to ``DIR/jax_inputs.pt``
    while the ranks run the other tasks."""
    path = os.path.join(inputs["dir"], "jax_inputs.pt")
    deadline = time.monotonic() + 600
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.2)
    jax_inputs = torch.load(path, weights_only=False)
    eps = jax_inputs["eps"]
    return {accum: train_run(mesh, "sgd", accum, len(eps[accum]),
                             state_dict=jax_inputs["state_dict"],
                             eps=eps[accum])
            for accum in eps}


def task_scan(mesh, inputs):
    """Two SGD steps of the epoch runner (eagerly, on the CPU) over the
    mesh, and on one device on rank 0."""
    from nvae_torch import TrainConfig, debug_config
    from nvae_torch.train.epoch_runner import make_epoch_runner, stage_dataset
    from nvae_torch.train.state import create_train_state

    data = (np.random.RandomState(0).rand(2 * BATCH, 28, 28, 1) > 0.5
            ).astype(np.uint8) * np.uint8(255)
    out = {}
    for name, m in (("mesh", mesh), ("single", None)):
        if m is None and mesh.rank != 0:
            continue
        tc = TrainConfig(batch_size=BATCH, step_based_warmup=True)
        model, state, tx = create_train_state(debug_config(**TINY), tc, 2,
                                              device=CPU, tx=sgd(SGD_LR))
        runner = make_epoch_runner(model, tx, tc, 2, 2, mesh=m)
        state, means = runner(state, stage_dataset(data, CPU), 0)
        out[name] = {"means": means, "state": _snapshot(model),
                     "step": state.step}
    return out


def task_units(mesh, inputs):
    """What the multihost and mesh functions do at world 2."""
    from nvae_torch import TrainConfig, debug_config
    from nvae_torch.parallel import (
        global_batch,
        is_primary,
        make_mesh,
        process_local_rows,
        shard_state,
    )
    from nvae_torch.parallel.mesh import replica_mismatches
    from nvae_torch.train.state import create_train_state

    out = {"rows": process_local_rows(144), "primary": is_primary()}
    for name, fn in (("odd_rows", lambda: process_local_rows(143)),
                     ("n_data_3", lambda: make_mesh(3, device=CPU)),
                     ("n_model_2", lambda: make_mesh(0, 2, device=CPU))):
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    out["global_batch"] = global_batch(np.full((3, 2), mesh.rank), mesh)
    # Each rank inits from its own seed; shard_state makes rank 0's win.
    _, state, _ = create_train_state(debug_config(**TINY),
                                     TrainConfig(batch_size=BATCH), 4,
                                     device=CPU, seed=mesh.rank)
    out["before"] = replica_mismatches(state, mesh)
    state = shard_state(state, mesh)
    out["after"] = replica_mismatches(state, mesh)
    out["weights"] = _snapshot(state.model)
    if mesh.rank == 1:
        with torch.no_grad():
            state.model.decoder.h.view(-1)[3] += 1.0
    out["perturbed"] = replica_mismatches(state, mesh)
    out["map_rows"] = mesh.map_rows(torch.arange(7.0)[:, None],
                                    lambda x: x * 2 + mesh.rank)
    # The iterator's rows: the global batch's (same order, same draws),
    # microbatch-major under grad_accum.
    from nvae_torch.data.pipeline import BatchIterator
    from nvae_torch.parallel import shard_batch

    images = np.random.RandomState(3).randint(0, 256, (40, 28, 28, 1),
                                              dtype=np.uint8)
    whole = BatchIterator(images, BATCH, seed=5, device=CPU)
    mine = BatchIterator(images, BATCH, seed=5, device=CPU, mesh=mesh,
                         grad_accum=2)
    out["iterator"] = (len(mine) == len(whole) == 2 and all(
        torch.equal(a, shard_batch(b, mesh, 2))
        for a, b in zip(mine.epoch(1), whole.epoch(1))))
    return out


def task_cli(mesh, inputs):
    """``--mode train --data_parallel 2`` at debug size (one epoch, then a
    resume to two), then ``--mode test --data_parallel 2``."""
    from nvae_torch import cli
    from nvae_torch.parallel.mesh import checksums
    from nvae_torch.train import checkpoint as ckpt

    sys.modules["torch.utils.tensorboard"] = None  # no TensorBoard mirror
    d = os.path.join(inputs["dir"], "cli")
    argv = ["--dataset", "synthetic", "--debug", "--cpu", "--batch_size",
            "8", "--seed", "0", "--n_encoder_channels", "8",
            "--n_decoder_channels", "8", "--n_groups_per_scale", "1", "1",
            "--n_latent_per_group", "2", "--n_preprocess_blocks", "1",
            "--n_preprocess_cells", "2", "--n_postprocess_blocks", "1",
            "--n_postprocess_cells", "2", "--use_pallas",
            "--step_based_warmup", "--data_parallel", "2",
            "--evaluate_frequency", "1", "--sample_frequency", "1",
            "--model_save_frequency", "1",
            "--model_save_dir", os.path.join(d, "models"),
            "--sample_dir", os.path.join(d, "results"),
            "--tensorboard_log_dir", os.path.join(d, "logs")]
    cli.main(["--mode", "train", "--epochs", "1", *argv])
    steps_1 = ckpt.all_steps(os.path.join(d, "models"))
    cli.main(["--mode", "train", "--epochs", "2", *argv])
    steps_2 = ckpt.all_steps(os.path.join(d, "models"))
    payload = ckpt.load_payload(os.path.join(d, "models"), steps_2[-1])
    model_sums = checksums([v for k, v in sorted(payload.items())
                            if k.startswith("model/")])
    cli.main(["--mode", "test", "--eval_attempts", "1",
              "--eval_temperatures", "1.0", "--fid_sample_size", "8",
              "--feature_backbone", "random_conv", "--fid_backbone",
              "random_conv", "--epochs", "2", *argv])
    return {"steps_1": steps_1, "steps_2": steps_2, "ckpt_sums": model_sums}


SERVE_BATCH = 8


def task_serve(mesh, inputs):
    """The mesh sampler of the debug model at batch 8: a scalar and a
    per-sample temperature, then the batching server over it on rank 0
    (two requests, one dispatch) and a direct call of that dispatch; then
    the single-device sampler on rank 0 for each."""
    from nvae_torch import debug_config
    from nvae_torch.models.nvae import NVAE
    from nvae_torch.parallel import is_primary
    from nvae_torch.serving import Sampler, build_mesh_sampler
    from nvae_torch.serving_runtime import BatchingSampler, dispatch_seed

    cfg = debug_config()
    sd = NVAE(cfg, device=CPU, seed=0).state_dict()
    ms = build_mesh_sampler(cfg, sd, SERVE_BATCH, mesh)
    if not is_primary():
        return {"followed": ms.follow()}
    t_vec = torch.linspace(0.5, 1.2, SERVE_BATCH)
    t_mix = torch.tensor([0.7] * 5 + [1.0] * 3)
    calls = {"scalar": (3, 0.8), "vector": (5, t_vec),
             "direct": (dispatch_seed(11, 0), t_mix)}
    out = {k: ms(*a) for k, a in calls.items() if k != "direct"}
    with BatchingSampler(ms, SERVE_BATCH, max_delay_ms=0, seed=11) as srv:
        f1, f2 = srv.submit(5, 0.7), srv.submit(3, 1.0)
        out["served"] = (f1.result(timeout=120), f2.result(timeout=120))
        out["stats"] = (srv.stats.dispatches, srv.stats.occupancy)
    out["direct"] = ms(*calls["direct"])
    out["info"] = ms.info
    ms.close()
    single = Sampler(cfg, sd, SERVE_BATCH, device=CPU)
    out["single"] = {k: single(*a) for k, a in calls.items()}
    return out


def task_eval(mesh, inputs):
    """``extract_features`` and P&R over the mesh, and on one device on
    rank 0."""
    from nvae_torch.eval import features as tfeat
    from nvae_torch.eval.precision_recall import knn_precision_recall_features
    from nvae_torch.parallel import is_primary

    net = tfeat.backbone_module("random_conv")
    net.load_state_dict(inputs["random_conv"])
    ex = tfeat.Extractor("random_conv", net.eval(), 64, "bilinear", "pm1",
                         torch.device(CPU), "fixed-seed")
    out = {}
    for name, m in (("mesh", mesh), ("single", None)):
        if m is None and not is_primary():
            continue
        r = {"features": tfeat.extract_features(
            inputs["images"], ex, batch_size=inputs["feature_batch"],
            mesh=m)}
        for case, kw in inputs["pr_cases"].items():
            r[case] = knn_precision_recall_features(
                inputs["real"], inputs["gen"], device=CPU, mesh=m, **kw)
        out[name] = r
    return out


TASKS = {"units": task_units, "steps": task_steps,
         "jax_steps": task_jax_steps, "scan": task_scan, "cli": task_cli,
         "serve": task_serve, "eval": task_eval}


def main(argv) -> None:
    directory, rank, world, *tasks = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store",
                            world_size=world, rank=rank)
    from nvae_torch.parallel import make_mesh

    mesh = make_mesh(world, device=CPU)
    inputs = torch.load(os.path.join(directory, "inputs.pt"),
                        weights_only=False)
    results = {}
    try:
        for t in tasks:
            results[t] = TASKS[t](mesh, inputs)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        torch.save(results, os.path.join(directory, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
