"""Per-rank memory accounting for a training configuration of the port
(twin of ``tools/memory_report.py``).

- **State bytes (exact):** parameters, optimizer state (Adamax moments and
  counts, the EMA, the spectral projection's ``u`` and sigma), BatchNorm
  running statistics and the forward-mode spectral ``u`` vectors, counted
  per rank in the chosen layout: ``single`` (one rank), ``replicated``
  (every rank holds every byte), ``fsdp`` (each parameter that
  ``nvae_torch.parallel.mesh.fsdp_sharding`` selects at ``--min_size``,
  its two Adamax moments and its EMA as a 1/N block: what
  ``shard_state_fsdp`` leaves on a rank), ``tp`` (N ranks as JAX's tool
  lays them out, ``max(N / 2, 1)`` data x ``M`` model: each kernel that
  ``nvae_torch.parallel.mesh.tp_param_sharding`` selects (at least 512
  output channels), its two Adamax moments and its EMA as a 1/M block:
  what ``shard_state_tp`` leaves on a rank; beside it
  ``state_bytes_device0_jax_placement``, the bytes of JAX's placement, which
  splits the kernels alone and holds the optimizer state replicated).
- **Step working set:** ``torch.cuda.max_memory_allocated`` over one
  training step on the card (the state, gradients and activations at a
  rank's rows of the batch), in ``single`` and ``replicated``; null on the
  CPU, as the JAX tool reports null where XLA gives no analysis, and in
  ``fsdp`` and ``tp``, whose step runs over a world of N processes.

Usage::

    python -m nvae_torch.tools.memory_report --layout replicated \\
        --data_parallel 8
    ... --layout fsdp --data_parallel 8
    ... --layout tp --data_parallel 8    # 4 data x 2 model
    ... --preset celeba64 --batch_size 64 --layout single
    ... --debug --cpu --no_compile          # tiny model, state bytes only

Prints ONE JSON object, with the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from nvae_torch.tools.common import add_cpu_flag, device_info, tool_device


def state_bytes_by_kind(state, n_shard: int = 1, min_size: int = 65536,
                        tp: bool = False, opt_sharded: bool = True) -> dict:
    """``{"params", "opt_state", "batch_stats", "spectral"}`` bytes a rank
    holds of ``state`` when the tensors that FSDP shards over ``n_shard``
    ranks at ``min_size`` are 1/``n_shard`` blocks (``n_shard=1``: the
    whole state); with ``tp`` those that the TP layout splits over a model
    axis of ``n_shard`` ranks at ``min_features`` ``min_size``.
    ``opt_sharded`` False counts the optimizer state whole (JAX's TP
    placement)."""
    from nvae_torch.parallel.mesh import (_param_keyed, fsdp_sharding,
                                          tp_param_sharding)
    from nvae_torch.train.optim import state_tensors

    model = state.model
    params = dict(model.named_parameters())
    if n_shard <= 1:
        sharded = {}
    elif tp:
        sharded = tp_param_sharding(model, n_shard, min_size)
    else:
        sharded = fsdp_sharding({k: p.shape for k, p in params.items()},
                                n_shard, min_size)

    def nbytes(t, name=None):
        n = t.numel() * t.element_size()
        if name in sharded and tuple(t.shape) == tuple(params[name].shape):
            n //= n_shard
        return n

    out = {"params": sum(nbytes(p, k) for k, p in params.items()),
           "opt_state": 0, "batch_stats": 0, "spectral": 0}
    keyed = ({id(d[k]): k for d, k in _param_keyed(state.opt_state, params)}
             if opt_sharded else {})
    for t in state_tensors(state.opt_state):
        out["opt_state"] += nbytes(t, keyed.get(id(t)))
    for name, b in model.named_buffers():
        kind = "batch_stats" if name.endswith(("running_mean",
                                               "running_var")) else "spectral"
        out[kind] += nbytes(b)
    out["all"] = sum(out.values())
    return out


def int64_counters(state) -> int:
    """The optimizer's int64 scalars (its update counts): 8 bytes each in
    the port, where optax keeps 4-byte int32 counts."""
    import torch

    from nvae_torch.train.optim import state_tensors

    return sum(1 for t in state_tensors(state.opt_state)
               if t.dim() == 0 and t.dtype == torch.int64)


def step_memory(model, state, tx, train_cfg, rows: int, device) -> dict:
    """One training step at ``rows`` rows on the card: the bytes allocated
    at rest (the state) and the step's peak, from
    ``torch.cuda.max_memory_allocated``."""
    import torch

    from nvae_torch.train.step import make_train_step

    cfg = model.cfg
    step = make_train_step(model, tx, train_cfg, 100, 10)
    batch = torch.zeros((rows, cfg.image_size, cfg.image_size,
                         cfg.in_channels), device=device)
    torch.cuda.synchronize(device)
    rest = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    step(state, batch)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    return {"rows": rows, "at_rest_in_bytes": int(rest),
            "peak_in_bytes": int(peak),
            "step_working_set_in_bytes": int(peak - rest)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layout", default="replicated",
                   choices=["replicated", "fsdp", "tp", "single"],
                   help="Parameter layout: replicated DP, FSDP/ZeRO-3, "
                        "tensor-parallel wide kernels, or a single rank")
    p.add_argument("--preset", default="",
                   help="Named preset (nvae_torch/presets.py); default is "
                        "the reference MNIST config")
    p.add_argument("--batch_size", type=int, default=0,
                   help="Global batch (0 = config default)")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="Ranks N (0 = the cards on this host, 1 on the "
                        "CPU); N = 1 is the single layout (the JAX tool's "
                        "devices)")
    p.add_argument("--no_compile", action="store_true",
                   help="Skip the step on the card (state bytes only); "
                        "the JAX tool's flag")
    p.add_argument("--debug", action="store_true",
                   help="Tiny debug model (fast; for tests/smoke)")
    p.add_argument("--min_size", type=int, default=65536,
                   help="FSDP: tensors under this many elements stay "
                        "replicated (shard_state_fsdp default)")
    add_cpu_flag(p)
    args = p.parse_args(argv)

    import torch

    from nvae_torch.config import ModelConfig, TrainConfig
    from nvae_torch.parallel.mesh import TP_MIN_FEATURES
    from nvae_torch.train.state import create_train_state

    device = tool_device(args)
    if args.preset:
        from nvae_torch.presets import get_preset

        model_cfg, train_cfg = get_preset(args.preset)
    elif args.debug:
        from nvae_torch.config import debug_config

        model_cfg = debug_config(
            n_encoder_channels=8, n_decoder_channels=8,
            n_groups_per_scale=(1, 1), n_latent_per_group=2)
        train_cfg = TrainConfig(epochs=1, batch_size=16,
                                step_based_warmup=True)
    else:
        model_cfg, train_cfg = ModelConfig(), TrainConfig()
    model_cfg = dataclasses.replace(model_cfg, use_pallas_kernels=True)
    if args.batch_size:
        train_cfg = dataclasses.replace(train_cfg, batch_size=args.batch_size)
    if args.grad_accum > 1:
        train_cfg = dataclasses.replace(train_cfg, grad_accum=args.grad_accum)
    n = args.data_parallel or (torch.cuda.device_count()
                               if device.type == "cuda" else 1)
    layout = "single" if args.layout == "single" or n == 1 else args.layout

    model, state, tx = create_train_state(model_cfg, train_cfg,
                                          total_steps=100, device=device)
    total = state_bytes_by_kind(state)
    rank = (state_bytes_by_kind(state, n, args.min_size)
            if layout == "fsdp" else dict(total))
    extra = {}
    if layout == "tp":
        # The JAX tool's grid: max(N / 2, 1) data ranks, the rest model.
        n_data = max(n // 2, 1)
        m = n // n_data
        rank = state_bytes_by_kind(state, m, TP_MIN_FEATURES, tp=True)
        extra = {"n_data": n_data, "n_model": m,
                 "state_bytes_device0_jax_placement": state_bytes_by_kind(
                     state, m, TP_MIN_FEATURES, tp=True,
                     opt_sharded=False)}
    report = {
        "layout": layout,
        "n_devices": n,
        "preset": args.preset or "default_mnist",
        "batch_size": train_cfg.batch_size,
        "grad_accum": train_cfg.grad_accum,
        "state_bytes_total": total,
        "state_bytes_device0": rank,
        "int64_counters": int64_counters(state),
        **extra,
        "device": device_info(device),
    }
    if not args.no_compile:
        mem = None
        if device.type == "cuda" and layout not in ("fsdp", "tp"):
            rows = train_cfg.batch_size // (n if layout == "replicated"
                                            else 1)
            mem = step_memory(model, state, tx, train_cfg, rows, device)
        report["step_memory_analysis"] = mem
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
