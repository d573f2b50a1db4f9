"""HTTP front end over the dynamic-batching sampler (counterpart of
``nvae_tpu/serving_http.py``, with its endpoints, status codes and wire
formats).

A stdlib ``ThreadingHTTPServer`` where every request handler thread blocks
on a :class:`~nvae_torch.serving_runtime.BatchingSampler` future, so
concurrency at the HTTP layer is the batching opportunity on the card.

Endpoints
---------
- ``POST /sample``: body ``{"n": 16, "temperature": 0.8, "format": "npy"}``.
  ``npy`` (default) answers the raw ``(n, H, W, C)`` array in the sampler's
  output dtype (float32 probabilities, or uint8 pixels under
  ``--output_dtype uint8``) as ``np.save`` bytes
  (``application/octet-stream``); ``png`` answers one tiled uint8 grid
  (``image/png``, the reference's ``tile_images`` layout).
- ``GET /healthz``: liveness and the serving batch shape(s).
- ``GET /stats``: dispatch and occupancy counters, and the sampler's
  weights record (checkpoint step, reload generation, serve dtype) when it
  has one.  It reads :attr:`nvae_torch.serving.Sampler.info`, which takes
  no lock a dispatch holds, so it answers while a dispatch runs.
- ``POST /reload``: hot-swap the weights (501 without a reload source).
  Optional body keys ``{"step": 1200, "use_ema": true}``; the default
  reloads the latest step of the checkpoint directory configured at
  startup, never a client-supplied path.  ``SIGHUP`` does the same default
  reload, and ``--follow_s`` polls for newer steps.  An artifact server
  re-reads its artifact files instead (a program's weights are in its
  file, as in JAX's artifact server).

Run on the card (``--cpu`` runs on the CPU; nothing falls back silently)::

    python -m nvae_torch.serving_http --preset mnist_step_sn --use_pallas \\
        --ckpt models --serve_dtype int8 --compute_dtype bfloat16 --port 8000
    python -m nvae_torch.export_serving --out sampler.pt2 --batch 144 \\
        --per_sample_temperature --ckpt models --weights_dtype int8
    python -m nvae_torch.serving_http --artifact sampler.pt2 --port 8000

``--artifact`` takes either form of the artifact: the program
(``torch.export``, the default of ``export_serving``), run without the model
code, or the weights file (``--format weights``).

Without ``--ckpt`` the server serves freshly initialized weights (load
testing only).  SIGTERM and SIGINT stop accepting connections and drain
every queued request before the process exits.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from nvae_torch.serving_runtime import BatchingSampler

MAX_REQUEST_ROWS = 4096  # one POST may span many dispatches, but not unbounded


class SamplerHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer owning a :class:`BatchingSampler`.

    ``daemon_threads`` so a hung client cannot block process exit; the
    sampler is closed by :meth:`shutdown_and_close` (which drains the
    backlog first, as ``BatchingSampler.close`` does).  The listen backlog
    is 512, not http.server's 5: a dynamic-batching server expects bursts
    of concurrent connections, and a backlog of 5 resets them."""

    daemon_threads = True
    request_queue_size = 512

    def __init__(self, address, sampler: BatchingSampler,
                 request_timeout_s: float = 600.0, reloader=None):
        super().__init__(address, _Handler)
        self.sampler = sampler
        self.request_timeout_s = float(request_timeout_s)
        # ``dict -> dict`` hot-reload hook (POST /reload, SIGHUP); None =
        # this server has no reload source (fixed weights).
        self.reloader = reloader
        self._reload_lock = threading.Lock()
        self._closing = threading.Event()

    def shutdown_and_close(self):
        self._closing.set()  # stop the checkpoint follower, if any
        self.shutdown()
        self.server_close()
        self.sampler.close()

    def start_follower(self, follow_seconds: float):
        """Poll the reload source every ``follow_seconds`` and hot-swap when
        a newer checkpoint step (or artifact file) appears; the poller
        stops with :meth:`shutdown_and_close`."""
        if self.reloader is None:
            raise ValueError("start_follower needs a reloader")

        def run():
            while not self._closing.wait(follow_seconds):
                try:
                    with self._reload_lock:
                        info = self.reloader({"if_newer": True})
                    if not info.get("skipped"):
                        print(f"follow reload: {info}", flush=True)
                except Exception as e:  # keep serving current weights
                    print(f"follow reload failed ({e}); retrying in "
                          f"{follow_seconds}s", flush=True)

        t = threading.Thread(target=run, daemon=True, name="ckpt-follower")
        t.start()
        return t


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 keep-alive: back-to-back requests reuse one connection (and
    # one handler thread).  Safe because every response sets
    # Content-Length.
    protocol_version = "HTTP/1.1"
    # An idle keep-alive connection is closed after this long, so a quiet
    # client does not pin its handler thread.
    timeout = 120.0
    server: SamplerHTTPServer

    def log_message(self, fmt, *args):  # quiet; /stats carries the load
        pass

    def _send(self, code: int, body: bytes, content_type: str):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _error(self, code: int, message: str):
        # A client error can leave an unread body on the socket, which a
        # kept-alive connection would read as the next request: close.
        if code >= 400:
            self.close_connection = True
        self._send_json(code, {"error": message})

    def _read_json(self):
        length = int(self.headers.get("Content-Length", 0))
        req = json.loads(self.rfile.read(length) or b"{}")
        if not isinstance(req, dict):
            raise ValueError("body must be a JSON object")
        return req

    def do_GET(self):
        sampler = self.server.sampler
        if self.path == "/healthz":
            health = {"status": "ok", "batch_size": sampler.batch_size,
                      "max_delay_ms": sampler.max_delay_ms}
            if len(sampler.batch_sizes) > 1:
                health["batch_sizes"] = list(sampler.batch_sizes)
            self._send_json(200, health)
        elif self.path == "/stats":
            s = sampler.stats
            body = {"dispatches": s.dispatches, "rows_served": s.rows_served,
                    "rows_padded": s.rows_padded, "requests": s.requests,
                    "occupancy": round(s.occupancy, 4)}
            if len(sampler.batch_sizes) > 1:
                body["dispatch_shapes"] = {
                    str(k): v for k, v in sorted(s.dispatch_shapes.items())}
            info = getattr(sampler.call_fn, "info", None)
            if info is not None:
                body["weights"] = info
            self._send_json(200, body)
        else:
            self._error(404, f"unknown path {self.path!r}")

    def _do_reload(self):
        reloader = self.server.reloader
        if reloader is None:
            return self._error(
                501, "this server has no reload source (fixed weights)")
        try:
            req = self._read_json()
        except ValueError:  # json.JSONDecodeError is a ValueError
            return self._error(400, "body must be a JSON object")
        try:
            # One reload at a time; /sample keeps serving the current
            # weights meanwhile.
            with self.server._reload_lock:
                info = reloader(req)
        except FileNotFoundError as e:
            return self._error(404, str(e))
        except ValueError as e:
            return self._error(400, str(e))
        except Exception as e:  # reload failed; old weights still serving
            return self._error(500, f"reload failed: {e}")
        self._send_json(200, info)

    def do_POST(self):
        if self.path == "/reload":
            return self._do_reload()
        if self.path != "/sample":
            return self._error(404, f"unknown path {self.path!r}")
        try:
            req = self._read_json()
        except ValueError:
            return self._error(400, "body must be a JSON object")
        n = req.get("n", 1)
        temperature = req.get("temperature", 1.0)
        fmt = req.get("format", "npy")
        if not isinstance(n, int) or not 1 <= n <= MAX_REQUEST_ROWS:
            return self._error(
                400, f"n must be an int in [1, {MAX_REQUEST_ROWS}], got {n!r}")
        if not isinstance(temperature, (int, float)) or not temperature > 0:
            return self._error(
                400, f"temperature must be > 0, got {temperature!r}")
        if fmt not in ("npy", "png"):
            return self._error(400, f"format must be npy or png, got {fmt!r}")
        try:
            fut = self.server.sampler.submit(n, float(temperature))
        except RuntimeError as e:  # server closed
            return self._error(503, str(e))
        try:
            images = fut.result(timeout=self.server.request_timeout_s)
        except TimeoutError:
            return self._error(504, "sampling timed out")
        except Exception as e:  # the sampler raised inside the dispatch
            return self._error(500, f"sampler failed: {e}")
        if fmt == "npy":
            # The sampler's dtype rides in the npy header.
            buf = io.BytesIO()
            np.save(buf, np.asarray(images))
            self._send(200, buf.getvalue(), "application/octet-stream")
        else:
            from nvae_torch.utils.images import encode_png, tile_images, to_uint8

            grid = to_uint8(tile_images(np.asarray(images)))
            self._send(200, encode_png(grid), "image/png")


def drain_on_signals(httpd: SamplerHTTPServer, signals=None):
    """On SIGTERM/SIGINT stop accepting connections and drain every queued
    request before exiting (no future is stranded).  Returns the handler,
    so a test can call it (handlers install from the main thread only)."""
    import signal as _signal

    def handler(signum=None, frame=None):
        # shutdown() blocks until serve_forever returns: drain on a side
        # thread; serve()'s own closing call then finds the work done.
        threading.Thread(target=httpd.shutdown_and_close).start()

    if signals is None:
        signals = (_signal.SIGTERM, _signal.SIGINT)
    for sig in signals:
        _signal.signal(sig, handler)
    return handler


def reload_on_sighup(httpd: SamplerHTTPServer):
    """SIGHUP: the default hot reload (the latest checkpoint step, or the
    artifact re-read), on a side thread; a failed reload logs and keeps the
    current weights.  Returns the handler, for tests."""
    import signal as _signal

    def handler(signum=None, frame=None):
        def _reload():
            try:
                with httpd._reload_lock:
                    info = httpd.reloader({})
                print(f"SIGHUP reload: {info}", flush=True)
            except Exception as e:
                print(f"SIGHUP reload failed ({e}); keeping current "
                      "weights", flush=True)

        threading.Thread(target=_reload, daemon=True).start()

    if httpd.reloader is not None and hasattr(_signal, "SIGHUP"):
        _signal.signal(_signal.SIGHUP, handler)
    return handler


def serve(call_fn, batch_size, host: str = "127.0.0.1", port: int = 8000,
          max_delay_ms: float = 10.0, seed: int = 0, block: bool = True,
          drain_signals: bool = False, reloader_factory=None,
          follow_seconds: float = 0.0,
          fulfill_workers: int = 2) -> SamplerHTTPServer:
    """Start the HTTP server over ``call_fn`` (a ``(seed, f32[B]) ->
    images`` sampler); ``batch_size`` may be a sequence for multi-shape
    serving.  ``block=False`` runs ``serve_forever`` on a daemon thread and
    returns the server (call ``shutdown_and_close``).  ``drain_signals``
    installs the SIGTERM/SIGINT drain and the SIGHUP reload (main thread
    only).  ``reloader_factory`` (``BatchingSampler -> (dict -> dict)``)
    enables ``POST /reload``; ``follow_seconds > 0`` also polls the reload
    source at that period.  ``fulfill_workers`` threads copy results to the
    host."""
    sampler = BatchingSampler(call_fn, batch_size, max_delay_ms=max_delay_ms,
                              seed=seed, fulfill_workers=fulfill_workers)
    httpd = SamplerHTTPServer(
        (host, port), sampler,
        reloader=reloader_factory(sampler) if reloader_factory else None)
    if follow_seconds > 0 and httpd.reloader is not None:
        httpd.start_follower(follow_seconds)
    if drain_signals:
        drain_on_signals(httpd)
        reload_on_sighup(httpd)
    if block:
        try:
            httpd.serve_forever()
        finally:
            httpd.shutdown_and_close()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def warm(call, batches) -> None:
    """One call at every served batch size, finished, before traffic."""
    for b in batches:
        float(torch.as_tensor(call(9, torch.ones(b))).float().mean())


def _build_call(args, device):
    """The live per-sample-temperature sampler of ``--preset``/``--ckpt``
    on ``device``.  Returns ``(call, reloader_factory)``; the factory is
    None without ``--ckpt`` (nothing to reload from)."""
    import dataclasses
    import os

    from nvae_torch.serving import (
        Sampler,
        make_checkpoint_reloader,
        variables_from_state,
    )

    if args.preset:
        from nvae_torch.presets import get_preset

        model_cfg, _ = get_preset(args.preset)
    else:
        from nvae_torch.config import debug_config

        model_cfg = debug_config()
    model_cfg = dataclasses.replace(
        model_cfg,
        compute_dtype=args.compute_dtype or model_cfg.compute_dtype,
        bn_apply_dtype=args.bn_apply_dtype or model_cfg.bn_apply_dtype,
        postprocess_5x5_depthwise=(model_cfg.postprocess_5x5_depthwise
                                   or args.postprocess_depthwise),
        use_pallas_kernels=model_cfg.use_pallas_kernels or args.use_pallas,
    )
    kw = dict(n_samples=args.batch, serve_dtype=args.serve_dtype,
              output_dtype=args.output_dtype, device=device)
    if not args.ckpt:
        return Sampler(model_cfg, **kw), None

    from nvae_torch.config import TrainConfig
    from nvae_torch.train.checkpoint import restore_checkpoint
    from nvae_torch.train.state import create_train_state

    # The restore template lives on the CPU; the sampler copies what it
    # serves to the card.  --use_ema needs the EMA-bearing optimizer chain,
    # as in the CLI.
    _, template, _ = create_train_state(
        model_cfg, TrainConfig(ema_decay=0.9999 if args.use_ema else 0.0), 1,
        device="cpu")
    ckpt_dir = os.path.abspath(args.ckpt)
    state = restore_checkpoint(ckpt_dir, template)
    call = Sampler(model_cfg, variables_from_state(state, args.use_ema), **kw)
    call.step = int(state.step)
    return call, lambda _sampler: make_checkpoint_reloader(
        call, ckpt_dir, template, use_ema=args.use_ema)


def _build_call_from_artifact(path: str, device):
    """A sampler from an exported artifact (a program or a weights file) and
    its batch: the artifact must take a per-sample temperature vector, which
    the batching runtime packs."""
    from nvae_torch.serving import load_artifact

    call = load_artifact(path, device)
    if not call.artifact["per_sample_temperature"]:
        raise SystemExit(
            f"{path}: the artifact takes a scalar temperature; the HTTP "
            "server needs a per-sample-temperature artifact (export with "
            "--per_sample_temperature)")
    return call, call.artifact["batch"]


def _build_calls_from_artifacts(paths, device):
    """One or more artifacts as one call: with several (different-batch
    exports of one model) the call routes on the temperature vector's
    length.  Returns ``(call, batch)``, ``batch`` an int for one artifact
    or the sorted list of batches."""
    pairs = [_build_call_from_artifact(p, device) for p in paths]
    if len(pairs) == 1:
        return pairs[0]
    by_batch = {}
    for (fn, b), path in zip(pairs, paths):
        if b in by_batch:
            raise SystemExit(f"duplicate artifact batch {b} ({path}); "
                             "multi-shape serving needs distinct batches")
        by_batch[b] = fn
    return _ByBatch(by_batch), sorted(by_batch)


class _ByBatch:
    """Several artifact samplers as one call, routed on the batch."""

    def __init__(self, by_batch: dict):
        self.by_batch = by_batch

    def __call__(self, seed, t_vec):
        return self.by_batch[int(t_vec.shape[0])](seed, t_vec)

    @property
    def info(self) -> dict:
        return next(iter(self.by_batch.values())).info


def _artifact_reloader_factory(paths, device):
    """Artifact reload: re-read the files at the startup paths (the deploy
    flow exports new bytes there) and swap the call; ``if_newer`` keys on
    the newest file's mtime."""
    import os

    def factory(sampler):
        def newest():
            return max(os.path.getmtime(p) for p in paths)

        seen = {"mtime": newest()}

        def reload(req: dict) -> dict:
            mtime = newest()
            if req.get("if_newer") and mtime <= seen["mtime"]:
                return {"artifact": paths, "skipped": True}
            call, batch = _build_calls_from_artifacts(paths, device)
            warm(call, batch if isinstance(batch, list) else [batch])
            if tuple(batch if isinstance(batch, list)
                     else [batch]) != sampler.batch_sizes:
                raise ValueError(
                    f"artifact batches changed ({sampler.batch_sizes} -> "
                    f"{batch}); restart the server to change the shapes")
            sampler.swap_call(call)
            seen["mtime"] = mtime
            return {"artifact": paths, "batch": batch}

        return reload

    return factory


def main(argv=None):
    import argparse

    from nvae_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--artifact", action="append", default=None,
                    help="Serve an exported sampler, a program or a "
                         "weights file (python -m nvae_torch.export_serving "
                         "--per_sample_temperature); the batch comes from "
                         "the artifact and --preset/"
                         "--ckpt/--batch are ignored.  Repeat with "
                         "different-batch exports for multi-shape serving")
    ap.add_argument("--preset", default="",
                    help="Model preset (default: the debug model)")
    ap.add_argument("--ckpt", default="",
                    help="Checkpoint directory to serve and reload from "
                         "(untrained weights otherwise)")
    ap.add_argument("--compute_dtype", default="",
                    choices=["", "float32", "bfloat16"])
    ap.add_argument("--bn_apply_dtype", default="",
                    choices=["", "float32", "bfloat16"])
    ap.add_argument("--postprocess_depthwise", action="store_true")
    ap.add_argument("--use_pallas", action="store_true",
                    help="The hand-written depthwise kernels (the JAX "
                         "flag's name)")
    ap.add_argument("--serve_dtype", default="",
                    choices=["", "bfloat16", "int8"],
                    help="Weight-only serving cast (applied on every reload)")
    ap.add_argument("--output_dtype", default="", choices=["", "uint8"],
                    help="Serve uint8 pixels quantized on the device")
    ap.add_argument("--use_ema", action="store_true",
                    help="Serve the EMA parameter average (the checkpoint "
                         "must be trained with --ema_decay)")
    ap.add_argument("--batch", type=int, default=144,
                    help="Serving batch (the packing target)")
    ap.add_argument("--max_delay_ms", type=float, default=10.0)
    ap.add_argument("--follow_s", type=float, default=0.0,
                    help="Poll the checkpoint dir / artifact files every N "
                         "seconds and hot-reload newer weights")
    ap.add_argument("--fetch_workers", type=int, default=2,
                    help="Threads copying results to the host")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="Run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else "cuda")
    if args.artifact:
        call, batch = _build_calls_from_artifacts(args.artifact, device)
        reloader_factory = _artifact_reloader_factory(args.artifact, device)
    else:
        call, reloader_factory = _build_call(args, device)
        batch = args.batch
    warm(call, batch if isinstance(batch, list) else [batch])
    print(f"serving on http://{args.host}:{args.port} (batch {batch}, "
          f"max_delay {args.max_delay_ms} ms"
          f"{', reloadable' if reloader_factory else ''})", flush=True)
    serve(call, batch, host=args.host, port=args.port,
          max_delay_ms=args.max_delay_ms, seed=args.seed, drain_signals=True,
          reloader_factory=reloader_factory, follow_seconds=args.follow_s,
          fulfill_workers=args.fetch_workers)


if __name__ == "__main__":
    main()
