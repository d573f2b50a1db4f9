"""The dynamic-batching serving runtime of the port under load (twin of
``tools/bench_serving_runtime.py``): ``nvae_torch.serving_runtime.
BatchingSampler`` over the per-sample-temperature ``nvae_torch.serving.
Sampler`` on the card.

- ``--workload closed``: a closed burst of small mixed-temperature
  requests, against the naive discipline (one dispatch a request, the rest
  of the batch wasted, estimated from the measured time of a dispatch): the
  gain is the occupancy and the pipelined dispatches.
- ``--workload poisson``: open-loop Poisson arrivals at ``--qps``; p50, p95
  and p99 request latency and the served throughput, the trade that
  ``--max_delay_ms`` sets.

Prints one JSON line per measurement.  ``--quick``: the debug model, few
requests (for tests); ``--cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

from nvae_torch.tools.common import (
    add_cpu_flag,
    device_info,
    log,
    sync,
    tool_device,
)


def build_call(args, device):
    """The sampler of ``--preset`` (or the debug model) at ``--batch`` on
    ``device``, seeded or from ``--ckpt``; returns ``(call, seconds a
    dispatch)``."""
    import dataclasses

    import torch

    from nvae_torch.serving import Sampler

    if args.preset:
        from nvae_torch.presets import get_preset

        model_cfg, _ = get_preset(args.preset)
        overrides = {}
        if args.compute_dtype:
            overrides["compute_dtype"] = args.compute_dtype
        if args.bn_apply_dtype:
            overrides["bn_apply_dtype"] = args.bn_apply_dtype
        if args.postprocess_depthwise:
            overrides["postprocess_5x5_depthwise"] = True
        model_cfg = dataclasses.replace(model_cfg, use_pallas_kernels=True,
                                        **overrides)
    else:
        from nvae_torch.config import debug_config

        model_cfg = debug_config(use_pallas_kernels=True)
    b = args.batch
    log(f"init model ({'preset ' + args.preset if args.preset else 'debug'})")
    state_dict = None
    if args.ckpt:
        import os

        from nvae_torch.config import TrainConfig
        from nvae_torch.serving import variables_from_state
        from nvae_torch.train.checkpoint import restore_checkpoint
        from nvae_torch.train.state import create_train_state

        _, template, _ = create_train_state(model_cfg, TrainConfig(), 1,
                                            device="cpu")
        state = restore_checkpoint(os.path.abspath(args.ckpt), template)
        state_dict = variables_from_state(state)
        log(f"restored {args.ckpt}")
    call = Sampler(model_cfg, state_dict, n_samples=b, device=device)
    tv = torch.full((b,), 0.8)
    t0 = time.monotonic()
    float(call(9, tv).float().mean())
    log(f"first dispatch: {time.monotonic() - t0:.1f}s")
    reps = 3
    t0 = time.monotonic()
    for _ in range(reps):
        out = call(9, tv)
    float(out.float().mean())
    sync(device)
    per_dispatch = (time.monotonic() - t0) / reps
    log(f"steady per-dispatch: {per_dispatch * 1e3:.1f} ms "
        f"({b / per_dispatch:.0f} img/s raw)")
    return call, per_dispatch


def run_closed(args, call, per_dispatch, device):
    import numpy as np

    from nvae_torch.serving_runtime import BatchingSampler

    rng = np.random.RandomState(0)
    temps = rng.choice([0.6, 0.7, 0.8, 0.9, 1.0], size=args.requests)
    sizes = rng.randint(1, args.max_request + 1, size=args.requests)
    total_rows = int(sizes.sum())
    with BatchingSampler(call, args.batch, max_delay_ms=0) as srv:
        t0 = time.monotonic()
        futs = [srv.submit(int(n), float(t)) for n, t in zip(sizes, temps)]
        srv.flush()
        for f in futs:
            f.result(timeout=600)
        dt_batched = time.monotonic() - t0
        stats = srv.stats
    log(f"batched: {total_rows} rows in {dt_batched:.2f}s, "
        f"{stats.dispatches} dispatches, occupancy {stats.occupancy:.2f}")
    # The naive discipline, one synchronous dispatch a request, estimated
    # from the measured time of a dispatch to keep the run bounded.
    dt_naive = args.requests * per_dispatch
    result = {
        "metric": "serving_runtime_closed_loop",
        "value": round(total_rows / dt_batched, 1),
        "unit": "images/sec",
        "batch": args.batch,
        "requests": args.requests,
        "rows": total_rows,
        "dispatches": stats.dispatches,
        "occupancy": round(stats.occupancy, 3),
        "naive_images_per_sec_est": round(total_rows / dt_naive, 1),
        "speedup_vs_naive": round(dt_naive / dt_batched, 2),
        "device": device_info(device),
    }
    print(json.dumps(result))
    return result


def run_poisson(args, call, per_dispatch, device):
    import numpy as np

    from nvae_torch.serving_runtime import BatchingSampler

    rng = np.random.RandomState(1)
    n_req = args.requests
    gaps = rng.exponential(1.0 / args.qps, size=n_req)
    temps = rng.choice([0.6, 0.8, 1.0], size=n_req)
    sizes = rng.randint(1, args.max_request + 1, size=n_req)
    # Latency stamped by a done-callback when the request completes.
    lat = []
    lat_lock = threading.Lock()
    with BatchingSampler(call, args.batch,
                         max_delay_ms=args.max_delay_ms) as srv:
        t_start = time.monotonic()
        pending = []
        for i in range(n_req):
            time.sleep(gaps[i])
            t0 = time.monotonic()
            f = srv.submit(int(sizes[i]), float(temps[i]))

            def _stamp(fut, t0=t0):
                dt = time.monotonic() - t0
                with lat_lock:
                    lat.append(dt)

            f.add_done_callback(_stamp)
            pending.append(f)
        for f in pending:
            f.result(timeout=600)
        dt = time.monotonic() - t_start
        stats = srv.stats
    lat = np.asarray(sorted(lat))
    result = {
        "metric": "serving_runtime_poisson",
        "value": round(float(np.percentile(lat, 99)) * 1e3, 1),
        "unit": "ms_p99_latency",
        "qps": args.qps,
        "max_delay_ms": args.max_delay_ms,
        "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 1),
        "p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 1),
        "throughput_images_per_sec": round(float(sizes.sum()) / dt, 1),
        "dispatches": stats.dispatches,
        "occupancy": round(stats.occupancy, 3),
        "device": device_info(device),
    }
    print(json.dumps(result))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=["closed", "poisson", "both"],
                    default="both")
    ap.add_argument("--preset", default="",
                    help="Model preset (default: the tiny debug model)")
    ap.add_argument("--ckpt", default="", help="Checkpoint to serve")
    ap.add_argument("--compute_dtype", default="")
    ap.add_argument("--bn_apply_dtype", default="")
    ap.add_argument("--postprocess_depthwise", action="store_true",
                    help="Serve the depthwise-postprocess form")
    ap.add_argument("--batch", type=int, default=144,
                    help="Static serving batch (the packing target)")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--max_request", type=int, default=16,
                    help="Request sizes are uniform in [1, max_request]")
    ap.add_argument("--qps", type=float, default=50.0,
                    help="Poisson arrival rate (requests/sec)")
    ap.add_argument("--max_delay_ms", type=float, default=20.0,
                    help="Batching window for the poisson workload")
    ap.add_argument("--quick", action="store_true",
                    help="Tiny smoke (debug model, few requests)")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    if args.quick:
        args.batch, args.requests, args.qps = 8, 12, 200.0
        args.max_request = 4
    device = tool_device(args)
    call, per_dispatch = build_call(args, device)
    out = []
    if args.workload in ("closed", "both"):
        out.append(run_closed(args, call, per_dispatch, device))
    if args.workload in ("poisson", "both"):
        out.append(run_poisson(args, call, per_dispatch, device))
    return out


if __name__ == "__main__":
    main()
