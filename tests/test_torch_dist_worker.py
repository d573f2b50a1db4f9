"""Ranks of the small gloo worlds that the port's data-parallel, FSDP,
pipeline and tensor-parallel tests spawn on the CPU
(``tests/test_torch_parallel*.py``, ``test_torch_serving_mesh.py``,
``test_torch_pipeline_dp.py``, ``test_torch_tp.py``).

Run as ``python -m tests.test_torch_dist_worker DIR RANK WORLD TASK...`` from
the repository's root: the rank joins a gloo group over ``file://DIR/store``
with one torch thread, runs each task on the inputs in ``DIR/inputs.pt``
and writes ``{task: result}`` to ``DIR/rank{RANK}.pt``.  It imports no JAX:
the tests compute JAX's side in their own process.  :func:`spawn_world`
starts the ranks; the tests do their JAX work while the ranks run.
"""

from __future__ import annotations

import contextlib
import io
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
# JAX's FSDP tests' min_size: every conv kernel of the debug model shards,
# the depthwise taps, BatchNorm scales and the decoder's h among them.
FSDP_MIN = 64


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


def sgd_sn(lr, cfg):
    """:func:`sgd`, then the default spectral projection of every spectral
    kernel (``train/optim.py``): the FSDP runs' SGD, so that sigma, a
    property of the whole kernel, is on their path."""
    from nvae_torch.models.nvae import NVAE
    from nvae_torch.nn.spectral import sn_kernel_names
    from nvae_torch.train import optim as topt

    return topt.chain(sgd(lr), topt.spectral_projection(
        sn_kernel_names(NVAE(cfg, device="meta"))))


def sgd_track(lr, cfg):
    """:func:`sgd`, then the spectral tracking of every spectral kernel:
    penalty mode's SGD, whose loss then holds the spectral penalty."""
    from nvae_torch.models.nvae import NVAE
    from nvae_torch.nn.spectral import sn_kernel_names
    from nvae_torch.train import optim as topt

    return topt.chain(sgd(lr), topt.spectral_tracking(
        sn_kernel_names(NVAE(cfg, device="meta"))))


def batches(n_steps: int, seed: int = 0, channels: int = 1):
    """Binarized greyscale batches; with 3 channels, RGB ones on the 256
    levels the data pipeline gives."""
    rng = np.random.RandomState(seed)
    if channels == 3:
        return [(rng.randint(0, 256, (BATCH, 32, 32, 3)) / 255.0).astype(
            np.float32) for _ in range(n_steps)]
    return [(rng.rand(BATCH, 32, 32, 1) > 0.5).astype(np.float32)
            for _ in range(n_steps)]


def _snapshot(model) -> dict:
    """The model's tensors whole (an FSDP shard gathered: a collective)."""
    from nvae_torch.parallel.mesh import whole

    sd = model.state_dict(keep_vars=True)
    with torch.no_grad():
        return {k: v.clone() for k, v in zip(sd, whole(sd.values()))}


def _moments(state) -> dict:
    """Adamax's moments as this rank holds them, by parameter name."""
    from nvae_torch.train.optim import AdamaxState, _find

    a = _find(state.opt_state, AdamaxState)
    return {"mu": {k: v.clone() for k, v in a.mu.items()},
            "nu": {k: v.clone() for k, v in a.nu.items()}}


def train_run(mesh, optimizer: str, accum: int, n_steps: int,
              state_dict=None, eps=None, seed: int = 0,
              fsdp: bool = False, remat: bool = False,
              overrides=None, tp: int = 0, ema_decay: float = 0.0) -> dict:
    """``n_steps`` of the debug model (with ``remat``, its rematerialized
    form; ``overrides`` of its config) from ``state_dict`` (else its seeded
    init) on :func:`batches`; with a mesh each rank steps on its rows, in
    the FSDP layout (``min_size`` FSDP_MIN) if ``fsdp``, in the TP layout
    (``min_features`` ``tp``) if ``tp``.  ``eps`` injects
    each step's global noise (one list per microbatch).  Returns each
    step's metrics, the state after each step (whole), and with a mesh the
    tensors that differ across ranks after each step; with Adamax, the
    moments after the first and the last step as this rank holds them,
    and the dimension of each sharded parameter; with ``ema_decay``, the
    EMA after the last step (whole)."""
    from nvae_torch import TrainConfig, debug_config
    from nvae_torch.parallel import (shard_batch, shard_state_fsdp,
                                     shard_state_tp)
    from nvae_torch.parallel.mesh import replica_mismatches, shard_of, whole
    from nvae_torch.train.optim import find_ema_params
    from nvae_torch.train.state import create_train_state
    from nvae_torch.train.step import make_train_step

    cfg = debug_config(**{**TINY, "remat": remat, **(overrides or {})})
    tc = TrainConfig(batch_size=BATCH, step_based_warmup=True,
                     grad_accum=accum, ema_decay=ema_decay)
    tx = {"sgd": lambda: sgd(SGD_LR), "sgd_sn": lambda: sgd_sn(SGD_LR, cfg),
          "sgd_track": lambda: sgd_track(SGD_LR, cfg),
          "adamax": lambda: None}[optimizer]()
    model, state, tx = create_train_state(cfg, tc, 100, device=CPU, tx=tx,
                                          seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    if fsdp:
        state = shard_state_fsdp(state, mesh, FSDP_MIN)
    if tp:
        state = shard_state_tp(state, mesh, tp)
    step = make_train_step(model, tx, tc, 100, 50, mesh=mesh)
    out = {"metrics": [], "states": [], "mismatches": [], "moments": [],
           "dims": {k: shard_of(p).dim for k, p in model.named_parameters()
                    if shard_of(p) is not None}}
    for i, b in enumerate(batches(n_steps, channels=cfg.in_channels)):
        b = torch.from_numpy(b)
        if mesh is not None:
            b = shard_batch(b, mesh, accum)
        state, m = step(state, b, eps=None if eps is None else eps[i])
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(_snapshot(model))
        if mesh is not None:
            out["mismatches"].append(replica_mismatches(state, mesh))
        if optimizer == "adamax" and i in (0, n_steps - 1):
            out["moments"].append(_moments(state))
    if ema_decay:
        ema = find_ema_params(state.opt_state)
        with torch.no_grad():
            out["ema"] = {k: v.clone() for k, v in zip(
                ema, whole(list(ema.values())))}
    return out


STEP_RUNS = {  # name: (optimizer, grad_accum, steps, remat)
    "sgd_accum1": ("sgd", 1, 4, False),
    "sgd_accum2": ("sgd", 2, 4, False),
    "adamax": ("adamax", 1, 1, False),
}
# The FSDP runs, JAX's FSDP tests' steps: SGD lockstep (with the spectral
# projection) under grad_accum 1 and 2, and with remat (the cells' second
# run in the backward pass reads the gathered weights), and the Adamax
# trajectory.
FSDP_RUNS = {
    "sgd_sn_accum1": ("sgd_sn", 1, 4, False),
    "sgd_sn_accum2": ("sgd_sn", 2, 4, False),
    "sgd_sn_remat": ("sgd_sn", 1, 2, True),
    "adamax4": ("adamax", 1, 4, False),
}


def task_steps(mesh, inputs):
    """Each of ``STEP_RUNS`` over the mesh, each of ``FSDP_RUNS`` over the
    mesh in the FSDP layout, and each on one device (the single runs
    split between the ranks, which need no collective for them)."""
    out = {}
    for name, (opt, accum, n, remat) in STEP_RUNS.items():
        out[name] = train_run(mesh, opt, accum, n, remat=remat)
    for name, (opt, accum, n, remat) in FSDP_RUNS.items():
        out[f"fsdp/{name}"] = train_run(mesh, opt, accum, n, fsdp=True,
                                        remat=remat)
    singles = {**STEP_RUNS, **FSDP_RUNS}
    for i, (name, (opt, accum, n, remat)) in enumerate(singles.items()):
        if i % mesh.size == mesh.rank:
            out[f"single/{name}"] = train_run(None, opt, accum, n,
                                              remat=remat)
    return out


def task_jax_steps(mesh, inputs):
    """The SGD runs from the JAX package's weights with its recorded
    noise, over the mesh: the other side of the comparison with JAX's
    2-device mesh step, under grad_accum 1 and 2 in the replicated layout
    and 1 in the FSDP layout (key ``"fsdp"``).  The test writes them to
    ``DIR/jax_inputs.pt`` while the ranks run the other tasks."""
    path = os.path.join(inputs["dir"], "jax_inputs.pt")
    deadline = time.monotonic() + 600
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.2)
    jax_inputs = torch.load(path, weights_only=False)
    eps = jax_inputs["eps"]
    return {key: train_run(mesh, "sgd", 1 if key == "fsdp" else key,
                           len(eps[key]), state_dict=jax_inputs["state_dict"],
                           eps=eps[key], fsdp=key == "fsdp")
            for key in eps}


def task_scan(mesh, inputs):
    """Two SGD steps of the epoch runner (eagerly, on the CPU) over the
    mesh, in the replicated and the FSDP layout, and on one device on
    rank 0."""
    from nvae_torch import TrainConfig, debug_config
    from nvae_torch.parallel import shard_state_fsdp
    from nvae_torch.train.epoch_runner import make_epoch_runner, stage_dataset
    from nvae_torch.train.state import create_train_state

    data = (np.random.RandomState(0).rand(2 * BATCH, 28, 28, 1) > 0.5
            ).astype(np.uint8) * np.uint8(255)
    out = {}
    for name, m in (("mesh", mesh), ("fsdp", mesh), ("single", None)):
        if m is None and mesh.rank != 0:
            continue
        tc = TrainConfig(batch_size=BATCH, step_based_warmup=True)
        model, state, tx = create_train_state(debug_config(**TINY), tc, 2,
                                              device=CPU, tx=sgd(SGD_LR))
        if name == "fsdp":
            state = shard_state_fsdp(state, mesh, FSDP_MIN)
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
                     ("n_data_2_n_model_2",
                      lambda: make_mesh(2, 2, device=CPU))):
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    # A model axis of 2 over the world of 2: one data index, and the
    # layouts of the data axis refuse it, as JAX's do.
    tp = make_mesh(0, 2, device=CPU)
    out["n_model_2"] = (tp.rank, tp.size, tp.model.rank, tp.model.size)
    _, st, _ = create_train_state(debug_config(**TINY),
                                  TrainConfig(batch_size=BATCH), 4,
                                  device=CPU)
    from nvae_torch.parallel import shard_state_fsdp

    for name, fn in (("shard_state", shard_state),
                     ("shard_state_fsdp", shard_state_fsdp)):
        try:
            fn(st, tp)
            out[f"{name}_tp"] = None
        except ValueError as e:
            out[f"{name}_tp"] = str(e)
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


def task_fsdp(mesh, inputs):
    """The FSDP layout's units at world 2: the bytes a rank holds against
    the replicated layout, the spectral projection on shards against the
    projection on the whole kernel (and sigma from the local shard, the
    fault it must not have), and checkpoints across layouts and world
    sizes: world 1 -> FSDP-2, FSDP-2 -> world 1 (on rank 0) and FSDP-2 ->
    replicated-2, each read back whole and compared bit for bit."""
    from nvae_torch import TrainConfig, debug_config
    from nvae_torch.nn.spectral import power_iteration
    from nvae_torch.parallel import shard_state, shard_state_fsdp
    from nvae_torch.parallel.mesh import (
        Shard,
        _shard_,
        assert_replicated,
        shard_of,
        state_bytes,
    )
    from nvae_torch.train import checkpoint as ckpt
    from nvae_torch.train import optim as topt
    from nvae_torch.train.state import create_train_state
    from nvae_torch.train.step import make_train_step

    cfg = debug_config(**TINY)
    tc = TrainConfig(batch_size=BATCH, step_based_warmup=True,
                     ema_decay=0.9)

    def state(layout, seed=0):
        model, st, tx = create_train_state(cfg, tc, 4, device=CPU, seed=seed)
        if layout == "fsdp":
            st = shard_state_fsdp(st, mesh, FSDP_MIN)
        elif layout == "replicated":
            st = shard_state(st, mesh)
        return st, tx

    out = {}
    rep, _ = state("replicated")
    st, tx = state("fsdp")
    out["bytes"] = {"replicated": state_bytes(rep), "fsdp": state_bytes(st)}
    named = {f"model/{k}": v
             for k, v in st.model.state_dict(keep_vars=True).items()}
    opt = {}
    ckpt._flatten(st.opt_state, (), opt)  # a leaf's path ends in its name
    named.update({f"opt/{k}": v for k, v in opt.items()})
    out["sharded"] = {k: (shard_of(t).shape, shard_of(t).dim, tuple(t.shape))
                      for k, t in named.items() if shard_of(t) is not None}
    del rep

    # Note (b): sigma is the whole kernel's.
    g = torch.Generator().manual_seed(3)
    w = torch.randn(32, 16, 3, 3, generator=g)
    upd = 1e-2 * torch.randn(w.shape, generator=g)
    proj = topt.spectral_projection(["k"])
    whole_out, whole_st = proj.update({"k": upd}, proj.init({"k": w}),
                                      {"k": w})
    spec = Shard(mesh, 0, tuple(w.shape))
    ws = w.clone()
    _shard_(ws, spec)
    sh_out, sh_st = proj.update({"k": spec.of(upd)}, proj.init({"k": w}),
                                {"k": ws})
    local = spec.of(w + upd)
    u_block = Shard(mesh, 0, (32,)).of(proj.init({"k": w}).u["k"])
    sigma_local, _ = power_iteration(local.reshape(local.shape[0], -1).t(),
                                     u_block)
    out["projection"] = {
        "update": torch.equal(sh_out["k"], spec.of(whole_out["k"])),
        "u": torch.equal(sh_st.u["k"], whole_st.u["k"]),
        "sigma": torch.equal(sh_st.sigma["k"], whole_st.sigma["k"]),
        "local_sigma_rel": float(abs(sigma_local - whole_st.sigma["k"])
                                 / whole_st.sigma["k"])}

    # One Adamax step, so that the moments and the EMA hold values.
    step = make_train_step(st.model, tx, tc, 4, 4, mesh=mesh)
    st, _ = step(st, torch.from_numpy(batches(1)[0][mesh.rows(BATCH)]))
    d = os.path.join(inputs["dir"], "ckpt")
    trips = {}
    # world 1 -> FSDP-2: a single state's checkpoint, written by rank 0.
    if mesh.rank == 0:
        single, _ = state(None, seed=5)
        ckpt.save_checkpoint(os.path.join(d, "single"), 1, single)
    mesh.barrier()
    payload = ckpt.load_payload(os.path.join(d, "single"), 1)
    got = ckpt.restore_checkpoint(os.path.join(d, "single"),
                                  state("fsdp", seed=mesh.rank)[0])
    trips["world1_to_fsdp2"] = _same(ckpt.flatten_state(got), payload)
    # FSDP-2 -> world 1 and -> replicated-2, from the stepped state.
    with ckpt.AsyncCheckpointWriter(os.path.join(d, "fsdp"), mesh) as w_:
        w_.save(1, st)
    mesh.barrier()
    written = ckpt.flatten_state(st)
    trips["fsdp2_file"] = _same(
        ckpt.load_payload(os.path.join(d, "fsdp"), 1), written)
    if mesh.rank == 0:
        got = ckpt.restore_checkpoint(os.path.join(d, "fsdp"),
                                      state(None, seed=7)[0])
        trips["fsdp2_to_world1"] = _same(ckpt.flatten_state(got), written)
    got = ckpt.restore_checkpoint(os.path.join(d, "fsdp"),
                                  state("replicated", seed=7)[0])
    assert_replicated(got, mesh)
    trips["fsdp2_to_replicated2"] = _same(ckpt.flatten_state(got), written)
    out["trips"] = trips
    return out


def _same(a: dict, b: dict) -> bool:
    """Two flat states with the same keys, every value bit for bit."""
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k] for k in a)


def _cli_argv(d: str) -> list:
    return ["--dataset", "synthetic", "--debug", "--cpu", "--batch_size",
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


def task_cli(mesh, inputs):
    """``--mode train --data_parallel 2`` at debug size (one epoch, then a
    resume to two), then ``--mode test --data_parallel 2``; then the same
    training with ``--fsdp`` (its layout at ``min_size`` FSDP_MIN, so that
    the debug model shards) in a directory of its own."""
    from nvae_torch import cli
    from nvae_torch.parallel import shard_state_fsdp
    from nvae_torch.parallel.mesh import checksums, shard_of
    from nvae_torch.train import checkpoint as ckpt
    from nvae_torch.train import trainer

    sys.modules["torch.utils.tensorboard"] = None  # no TensorBoard mirror
    d = os.path.join(inputs["dir"], "cli")
    argv = _cli_argv(d)
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
    f = os.path.join(inputs["dir"], "cli_fsdp")
    argv = [*_cli_argv(f), "--fsdp"]
    real, sharded = trainer.shard_state_fsdp, []

    def shard_debug_model(state, mesh):
        state = shard_state_fsdp(state, mesh, min_size=FSDP_MIN)
        sharded.append(sum(shard_of(p) is not None
                           for p in state.model.parameters()))
        return state

    trainer.shard_state_fsdp = shard_debug_model
    try:
        cli.main(["--mode", "train", "--epochs", "1", *argv])
        cli.main(["--mode", "train", "--epochs", "2", *argv])
    finally:
        trainer.shard_state_fsdp = real
    fsdp_steps = ckpt.all_steps(os.path.join(f, "models"))
    fsdp_payload = ckpt.load_payload(os.path.join(f, "models"),
                                     fsdp_steps[-1])
    return {"steps_1": steps_1, "steps_2": steps_2, "ckpt_sums": model_sums,
            "fsdp_steps": fsdp_steps, "fsdp_sharded": sharded,
            "fsdp_vs_dp": {k: float((v.double() - payload[k].double()
                                     ).abs().max()) if isinstance(
                                v, torch.Tensor) else v == payload[k]
                           for k, v in fsdp_payload.items()}
            if fsdp_payload.keys() == payload.keys() else None}


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


# ---- the pipeline's data-parallel stages (a world of 4) ---------------------

PP_LAYOUTS = ((2, 2), (4, 1))  # (stages, ranks a stage)
PP_M = 2
PP_SEED = 3


def pp_setup(optimizer: str, state_dict=None, ema_decay: float = 0.0):
    """The TINY model's state on the CPU (seed PP_SEED, or ``state_dict``),
    the ``grad_accum=PP_M`` training config (the production optimizer at
    JAX's stable learning rate, SGD_LR), the whole model's optimizer
    and the stage optimizer factory (None: ``make_optimizer``'s production
    chain): ``(tc, state, tx, factory)``."""
    from nvae_torch import TrainConfig, debug_config
    from nvae_torch.train.state import create_train_state

    tc = TrainConfig(batch_size=BATCH, step_based_warmup=True,
                     grad_accum=PP_M, ema_decay=ema_decay,
                     learning_rate=SGD_LR)
    tx = sgd(SGD_LR) if optimizer == "sgd" else None
    _, state, tx = create_train_state(debug_config(**TINY), tc, 100,
                                      device=CPU, tx=tx, seed=PP_SEED)
    if state_dict is not None:
        state.model.load_state_dict(state_dict)
    factory = (lambda keys: sgd(SGD_LR)) if optimizer == "sgd" else None
    return tc, state, tx, factory


def pp_world_run(S: int, N: int, optimizer: str, n_steps: int,
                 schedule: str = "1f1b", state_dict=None, eps=None,
                 ema_decay: float = 0.0, checkpoint: str = "") -> dict:
    """``n_steps`` of the pipeline over the world as S stages x N ranks
    (every rank calls it) on :func:`batches`, with each step's global
    noise from ``eps`` if given.  Returns each step's metrics, the merged
    whole state (``model/...`` and ``opt/...`` as the checkpoint flattens
    them), and this rank's stage, data index and its stage's checksums
    after each step; ``checkpoint``, if given, is a directory where the
    primary writes the merged state after the first step (through the
    trainer's writer, over the world)."""
    import dataclasses

    from nvae_torch.parallel import PipelineTrainer
    from nvae_torch.parallel.mesh import DataMesh, checksums
    from nvae_torch.train import checkpoint as ckpt
    from nvae_torch.train.optim import state_tensors

    tc, state, _, factory = pp_setup(optimizer, state_dict, ema_decay)
    pp = PipelineTrainer(state.model, dataclasses.replace(tc, grad_accum=1),
                         100, 50, n_stages=S, n_microbatches=PP_M,
                         devices=[CPU] * (S * N), dp=N, state=state,
                         tx_factory=factory, schedule=schedule)
    out = {"stage": pp.stage, "index": pp.stage_mesh.rank, "metrics": [],
           "states": [], "sums": []}
    for i, b in enumerate(batches(n_steps)):
        m = pp.step(torch.from_numpy(b), eps=None if eps is None else eps[i])
        out["metrics"].append({k: float(v) for k, v in m.items()})
        s = pp.stage
        out["sums"].append(checksums(
            list(pp.stages[s].state_dict().values())
            + state_tensors(pp.opt[s])).tolist())
        merged = pp.merged_state()
        out["states"].append({k: v.clone() if isinstance(v, torch.Tensor)
                              else v for k, v in
                              ckpt.flatten_state(merged).items()})
        if checkpoint and i == 0:
            world = DataMesh(dist.get_rank(), dist.get_world_size(),
                             torch.device(CPU))
            with ckpt.AsyncCheckpointWriter(checkpoint, world) as w:
                w.save(merged.step, merged)
            world.barrier()
    out["peak_stash"] = pp.peak_stash
    return out


def task_pipeline(mesh, inputs):
    """The pipeline's data-parallel stages in a world of 4: each layout of
    PP_LAYOUTS with the production optimizer (EMA on) for 2 steps, the
    2 x 2 layout's merged state after its first step written as a
    checkpoint; ``--mode train`` over torchrun's world layout through the
    CLI (1 epoch, then a resume to 2, then ``--mode sample`` and ``--mode
    test`` over the world); then, from
    the JAX package's weights with its recorded noise (``DIR/jax_inputs.pt``,
    written by the test while the ranks run), 3 SGD steps of each layout
    under 1f1b and of 2 x 2 under gpipe."""
    from nvae_torch import cli

    out = {}
    for S, N in PP_LAYOUTS:
        out[f"adamax/{S}x{N}"] = pp_world_run(
            S, N, "adamax", 2, ema_decay=0.9,
            checkpoint=os.path.join(inputs["dir"], "pp_ckpt")
            if (S, N) == (2, 2) else "")
    sys.modules["torch.utils.tensorboard"] = None  # no TensorBoard mirror
    d = os.path.join(inputs["dir"], "pp_cli")
    argv = [*_cli_argv(d), "--pp_stages", "2", "--pp_microbatches", "2"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(["--mode", "train", "--epochs", "1", *argv])
        cli.main(["--mode", "train", "--epochs", "2", *argv])
        cli.main(["--mode", "sample", "--n_samples", "4", *argv])
        cli.main(["--mode", "test", "--eval_attempts", "1",
                  "--eval_temperatures", "1.0", "--fid_sample_size", "8",
                  "--feature_backbone", "random_conv", "--fid_backbone",
                  "random_conv", *argv])
    out["cli"] = {"dir": d, "stdout": printed.getvalue()}
    path = os.path.join(inputs["dir"], "jax_inputs.pt")
    deadline = time.monotonic() + 600
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.2)
    jax_inputs = torch.load(path, weights_only=False)
    for S, N in PP_LAYOUTS:
        for schedule in ("1f1b", "gpipe") if N > 1 else ("1f1b",):
            out[f"sgd/{S}x{N}/{schedule}"] = pp_world_run(
                S, N, "sgd", len(jax_inputs["eps"]), schedule,
                state_dict=jax_inputs["state_dict"], eps=jax_inputs["eps"])
    return out


# ---- the tensor-parallel layout ---------------------------------------------

# JAX's TP tests' min_features: the debug model's one generative cell
# (hidden 96) splits, and so do its postprocess cells' 1x1 and 5x5 convs
# (48 features), the layout's two compute patterns.  At 8, 26 kernels
# split: the projections too (read whole, gathered), the combiners, the
# stem, the encoder's and the rescalers' convs, strided ones among them.
TP_MIN = 48
TP_RUNS = {  # name: (optimizer, grad_accum, steps, overrides, ema_decay,
    #               min_features)
    "adamax": ("adamax", 1, 2, {}, 0.9, TP_MIN),
    "accum2": ("sgd_sn", 2, 1, {}, 0.0, TP_MIN),
    "forward": ("sgd", 1, 1, {"spectral_mode": "forward"}, 0.0, TP_MIN),
    "penalty": ("sgd_track", 1, 1, {"spectral_mode": "penalty"}, 0.0,
                TP_MIN),
    "bf16": ("sgd_sn", 1, 1, {"compute_dtype": "bfloat16",
                              "bn_apply_dtype": "bfloat16"}, 0.0, TP_MIN),
    "rgb_dml_remat": ("sgd_sn", 1, 1, {"likelihood": "dml", "in_channels": 3,
                                       "n_mix": 4, "remat": True}, 0.0,
                      TP_MIN),
    "split8": ("sgd_sn", 1, 1, {}, 0.0, 8),
    "split8_forward": ("sgd", 1, 1, {"spectral_mode": "forward"}, 0.0, 8),
}


@contextlib.contextmanager
def kernel_channels():
    """While open, the channel count of every call of the plain versions
    of #2 (forward), #3 (dx) and #4 (dW/db), by kernel: what the wrappers
    hand the kernels on a CUDA tensor."""
    from nvae_torch.kernels import depthwise as dw

    seen = {"fwd": [], "dx": [], "dw": []}
    names = {"fwd": "fused_swish_depthwise5x5_plain",
             "dx": "fused_swish_depthwise5x5_dx_plain",
             "dw": "fused_swish_depthwise5x5_dw_plain"}
    real = {k: getattr(dw, n) for k, n in names.items()}

    def counting(kind):
        def fn(x, *args, **kwargs):
            seen[kind].append(int(x.shape[-1]))
            return real[kind](x, *args, **kwargs)
        return fn

    for k, n in names.items():
        setattr(dw, n, counting(k))
    try:
        yield seen
    finally:
        for k, n in names.items():
            setattr(dw, n, real[k])


def _wait_for(path: str):
    deadline = time.monotonic() + 600
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.2)
    return torch.load(path, weights_only=False)


def tp_eval(tp) -> dict:
    """The eval step of the TINY model's seeded state on a batch, in the TP
    layout over ``tp`` and on one device, the noise from one seeded
    generator each."""
    from nvae_torch import TrainConfig, debug_config
    from nvae_torch.parallel import shard_batch, shard_state_tp
    from nvae_torch.train.state import create_train_state
    from nvae_torch.train.step import make_eval_step

    tc = TrainConfig(batch_size=BATCH, step_based_warmup=True)
    b = torch.from_numpy(batches(1, seed=9)[0])
    out = {}
    for name, mesh in (("tp", tp), ("single", None)):
        model, st, _ = create_train_state(debug_config(**TINY), tc, 4,
                                          device=CPU)
        rows = b
        if mesh is not None:
            st = shard_state_tp(st, mesh, TP_MIN)
            rows = shard_batch(b, mesh)
        m = make_eval_step(model, tc, mesh=mesh)(
            st, rows, generator=torch.Generator().manual_seed(3))
        out[name] = {k: float(v) for k, v in m.items()}
    return out


def tp_checkpoints(world, tp, directory: str) -> dict:
    """Checkpoints across layouts: a TP state after one Adamax step (EMA
    on), written whole by the primary alone (every rank joins the gather),
    then restored into one device; and one device's state restored into
    the TP layout.  Each read back whole and compared bit for bit."""
    from nvae_torch import TrainConfig, debug_config
    from nvae_torch.parallel import shard_batch, shard_state_tp
    from nvae_torch.train import checkpoint as ckpt
    from nvae_torch.train.state import create_train_state
    from nvae_torch.train.step import make_train_step

    tc = TrainConfig(batch_size=BATCH, step_based_warmup=True,
                     ema_decay=0.9)

    def state(layout, seed=0):
        model, st, tx = create_train_state(debug_config(**TINY), tc, 4,
                                           device=CPU, seed=seed)
        if layout == "tp":
            st = shard_state_tp(st, tp, TP_MIN)
        return st, tx

    st, tx = state("tp")
    step = make_train_step(st.model, tx, tc, 4, 4, mesh=tp)
    st, _ = step(st, shard_batch(torch.from_numpy(batches(1)[0]), tp))
    trips = {}
    with ckpt.AsyncCheckpointWriter(os.path.join(directory, "tp"),
                                    world) as w:
        w.save(1, st)
    world.barrier()
    written = ckpt.flatten_state(st)
    trips["tp_file"] = _same(ckpt.load_payload(
        os.path.join(directory, "tp"), 1), written)
    if world.rank == 0:
        got = ckpt.restore_checkpoint(os.path.join(directory, "tp"),
                                      state(None, seed=7)[0])
        trips["tp_to_one"] = _same(ckpt.flatten_state(got), written)
        single, _ = state(None, seed=5)
        ckpt.save_checkpoint(os.path.join(directory, "one"), 1, single)
    world.barrier()
    got = ckpt.restore_checkpoint(os.path.join(directory, "one"),
                                  state("tp", seed=world.rank)[0])
    trips["one_to_tp"] = _same(ckpt.flatten_state(got), ckpt.load_payload(
        os.path.join(directory, "one"), 1))
    return trips


def task_tp(mesh, inputs):
    """The tensor-parallel layout over ``make_mesh(0, inputs["n_model"])``
    in this world: its grid; with ``inputs["variants"]``, each of TP_RUNS
    in the layout (the kernels' channel counts recorded) and on one device
    (the single runs split between the ranks), the eval step and the
    checkpoint round trips; then, from the JAX package's weights with its
    recorded noise (``DIR/jax_inputs.pt``, written by the test while the
    ranks run), 3 SGD steps in the layout."""
    from nvae_torch.parallel import make_mesh

    tp = make_mesh(0, inputs["n_model"], device=CPU)
    out = {"grid": (dist.get_rank(), tp.rank, tp.size, tp.model.rank,
                    tp.model.size)}
    if inputs.get("variants"):
        with kernel_channels() as seen:
            for name, (opt, accum, n, ov, ema, mf) in TP_RUNS.items():
                out[name] = train_run(tp, opt, accum, n, overrides=ov,
                                      tp=mf, ema_decay=ema)
                if mf == TP_MIN:
                    out["channels"] = {k: list(v) for k, v in seen.items()}
        # The bf16 run's fp32 twin: how far bf16 puts a step.
        singles = {**TP_RUNS,
                   "bf16_fp32": ("sgd_sn", 1, 1, {}, 0.0, TP_MIN)}
        for i, (name, (opt, accum, n, ov, ema, _)) in enumerate(
                singles.items()):
            if i % mesh.size == mesh.rank:
                out[f"single/{name}"] = train_run(None, opt, accum, n,
                                                  overrides=ov,
                                                  ema_decay=ema)
        out["eval"] = tp_eval(tp)
        out["ckpt"] = tp_checkpoints(mesh, tp, os.path.join(inputs["dir"],
                                                            "ckpt"))
    jax_inputs = _wait_for(os.path.join(inputs["dir"], "jax_inputs.pt"))
    out["jax"] = train_run(tp, "sgd", 1, len(jax_inputs["eps"]),
                           state_dict=jax_inputs["state_dict"],
                           eps=jax_inputs["eps"], tp=TP_MIN)
    return out


TASKS = {"units": task_units, "steps": task_steps,
         "jax_steps": task_jax_steps, "scan": task_scan, "fsdp": task_fsdp,
         "cli": task_cli, "serve": task_serve, "eval": task_eval,
         "pipeline": task_pipeline, "tp": task_tp}


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
