"""End-to-end HTTP serving benchmark of the port: concurrent clients over
the dynamic-batching runtime (twin of ``tools/bench_serving_http.py``;
``nvae_torch/serving_http.py`` over ``nvae_torch/serving_runtime.py``).

The path a request takes: HTTP POST, JSON parse, the ``BatchingSampler``
queue, a packed fixed-batch dispatch of ``nvae_torch.serving.Sampler`` on
the card, one device-to-host copy a dispatch, the row slice, the npy
response.  Mixed request sizes and temperatures exercise the packer, and
the occupancy says how full the launched batches were, per dispatch shape
when ``--batch`` gives several (a partial dispatch runs the smallest shape
that covers the backlog).

Weight values do not change the time, so the model is a seeded init
(``--ckpt`` serves trained weights).  The default model is the serving
ladder's best: ``ModelConfig()`` with the depthwise postprocess in bf16
compute and bf16 BatchNorm apply, on the hand-written kernels.

Prints one JSON line::

    {"metric": "serving_http", "batch": N, "clients": K, "img_per_s": ...,
     "req_per_s": ..., "p50_ms": ..., "p99_ms": ..., "occupancy": ...,
     "dispatches": ..., "dispatch_shapes": {...},
     "occupancy_by_shape": {...}}

Usage: ``python -m nvae_torch.tools.bench_serving_http [--batch 144 576]
[--clients 32] [--seconds 20] [--quick] [--cpu]``
"""

from __future__ import annotations

import argparse
import json
import threading
import time

from nvae_torch.tools.common import add_cpu_flag, device_info, log, tool_device


def _client_loop(httpd, deadline, max_n, rng, latencies, counts, stop):
    # One persistent HTTP/1.1 connection per client, as a client pool
    # holds them.
    import http.client

    host, port = httpd.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=120)
    temps = (0.6, 0.7, 0.8, 0.9, 1.0)
    try:
        while time.monotonic() < deadline and not stop.is_set():
            n = int(rng.integers(1, max_n + 1))
            t = float(temps[int(rng.integers(len(temps)))])
            body = json.dumps({"n": n, "temperature": t}).encode()
            t0 = time.monotonic()
            try:
                conn.request("POST", "/sample", body=body)
                r = conn.getresponse()
                payload = r.read()
                if r.status != 200:
                    raise RuntimeError(f"HTTP {r.status}: {payload[:120]!r}")
            except Exception as e:  # the server gone, a timeout
                log(f"client error: {type(e).__name__}: {e}")
                stop.set()
                return
            latencies.append((time.monotonic() - t0) * 1e3)
            counts.append((1, n, len(payload)))
    finally:
        conn.close()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, nargs="+", default=[144],
                   help="Server batch (the packing target); several values "
                        "= multi-shape serving (partial dispatches run the "
                        "smallest shape covering the backlog)")
    p.add_argument("--clients", type=int, default=32,
                   help="Concurrent HTTP clients")
    p.add_argument("--seconds", type=float, default=20.0,
                   help="Timed window after warm-up")
    p.add_argument("--max_n", type=int, default=16,
                   help="Requests draw n uniformly from [1, max_n]")
    p.add_argument("--max_delay_ms", type=float, default=10.0,
                   help="Batching window (0 = full batches only)")
    p.add_argument("--output_dtype", default="", choices=["", "uint8"],
                   help="uint8 pixels quantized on the device (4x less "
                        "device-to-host copy a dispatch)")
    p.add_argument("--fetch_workers", type=int, default=2,
                   help="Threads overlapping device-to-host result copies")
    p.add_argument("--ckpt", default="",
                   help="Optional checkpoint directory to serve")
    p.add_argument("--quick", action="store_true",
                   help="Tiny debug model, short window (for tests)")
    add_cpu_flag(p)
    args = p.parse_args(argv)

    import numpy as np

    from nvae_torch.config import ModelConfig, TrainConfig, debug_config
    from nvae_torch.models.nvae import NVAE
    from nvae_torch.serving import Sampler, variables_from_state
    from nvae_torch.serving_http import serve, warm

    device = tool_device(args)
    if args.quick:
        model_cfg = debug_config(use_pallas_kernels=True)
        args.batch = [min(b, 16) for b in args.batch]
        args.clients = min(args.clients, 4)
        args.seconds = min(args.seconds, 3.0)
        args.max_n = min(args.max_n, 6)
    else:
        model_cfg = ModelConfig(compute_dtype="bfloat16",
                                bn_apply_dtype="bfloat16",
                                postprocess_5x5_depthwise=True,
                                use_pallas_kernels=True)
    t0 = time.time()
    if args.ckpt:
        import os

        from nvae_torch.train.checkpoint import restore_checkpoint
        from nvae_torch.train.state import create_train_state

        _, template, _ = create_train_state(model_cfg, TrainConfig(), 1,
                                            device="cpu")
        state_dict = variables_from_state(
            restore_checkpoint(os.path.abspath(args.ckpt), template))
    else:
        state_dict = NVAE(model_cfg, device="cpu", seed=0).state_dict()
    batches = sorted(set(args.batch))
    by_batch = {b: Sampler(model_cfg, state_dict, n_samples=b,
                           output_dtype=args.output_dtype, device=device)
                for b in batches}

    def call(seed, t):
        return by_batch[int(t.shape[0])](seed, t)

    log(f"init: {time.time() - t0:.1f}s")
    t0 = time.time()
    warm(call, batches)
    log(f"first dispatch per shape: {time.time() - t0:.1f}s")

    httpd = serve(call, batches if len(batches) > 1 else batches[0], port=0,
                  max_delay_ms=args.max_delay_ms, block=False,
                  fulfill_workers=args.fetch_workers)
    latencies: list = []
    counts: list = []
    stop = threading.Event()
    try:
        # HTTP warm-up (connections, the first packed dispatches).
        warm_stop = threading.Event()
        w = threading.Thread(target=_client_loop, args=(
            httpd, time.monotonic() + 1.0, args.max_n,
            np.random.default_rng(99), [], [], warm_stop))
        w.start()
        w.join()
        stats = httpd.sampler.stats
        stats.dispatches = stats.rows_served = stats.rows_padded = 0
        stats.dispatch_shapes, stats.rows_by_shape = {}, {}

        deadline = time.monotonic() + args.seconds
        t_start = time.monotonic()
        threads = [
            threading.Thread(target=_client_loop, args=(
                httpd, deadline, args.max_n, np.random.default_rng(1000 + i),
                latencies, counts, stop))
            for i in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t_start
    finally:
        httpd.shutdown_and_close()
    if stop.is_set():
        raise SystemExit("bench aborted: client error (see stderr)")

    reqs = sum(c[0] for c in counts)
    imgs = sum(c[1] for c in counts)
    lat = np.sort(np.asarray(latencies))
    stats = httpd.sampler.stats
    report = {
        "metric": "serving_http",
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "batch": batches if len(batches) > 1 else batches[0],
        "clients": args.clients,
        "max_n": args.max_n,
        "max_delay_ms": args.max_delay_ms,
        "output_dtype": args.output_dtype or "float32",
        "fetch_workers": args.fetch_workers,
        "seconds": round(wall, 2),
        "requests": reqs,
        "req_per_s": round(reqs / wall, 1),
        "img_per_s": round(imgs / wall, 1),
        "p50_ms": round(float(lat[len(lat) // 2]), 1) if len(lat) else None,
        "p99_ms": (round(float(lat[int(len(lat) * 0.99)]), 1)
                   if len(lat) else None),
        "dispatches": stats.dispatches,
        "dispatch_shapes": {str(k): v for k, v in
                            sorted(stats.dispatch_shapes.items())},
        "occupancy": round(stats.occupancy, 3),
        "occupancy_by_shape": {str(k): round(v, 3) for k, v in
                               stats.occupancy_by_shape().items()},
        "device": device_info(device),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
