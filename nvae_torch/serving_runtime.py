"""Dynamic-batching serving runtime (counterpart of
``nvae_tpu/serving_runtime.py``).

Requests arrive one at a time, each with its own ``n`` and temperature; the
sampler wants full per-sample-temperature batches.  :class:`BatchingSampler`
closes that gap:

- **Dynamic batching.** A worker thread packs queued requests into
  dispatches of ``B`` rows: a dispatch launches as soon as ``B`` rows wait,
  or once the oldest request has waited ``max_delay_ms``.  Short batches
  are padded (padding rows sample at T=1 and are dropped); requests larger
  than ``B`` span several dispatches.
- **Pipelined dispatch.** The worker only enqueues the sampler call (CUDA
  work is asynchronous) and hands each request a view of the dispatch's
  result; a fulfillment thread pays one device-to-host copy per dispatch and
  slices rows out in numpy.
- **Deterministic replay.** Dispatch ``d`` calls the sampler with
  ``dispatch_seed(seed, d)``; a test can rebuild any dispatch's seed and
  packed temperature vector and check the served rows bitwise.

Usage::

    server = BatchingSampler(Sampler(cfg), batch_size=144)
    fut = server.submit(n=16, temperature=0.8)   # non-blocking
    images = fut.result()                        # (16, H, W, C) numpy
    server.close()
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, List

import numpy as np
import torch

from nvae_torch.utils.seeds import derive_seed

PAD_TEMPERATURE = 1.0


def dispatch_seed(seed: int, dispatch_idx: int) -> int:
    """Generator seed of dispatch ``dispatch_idx`` of a server seeded with
    ``seed``: :func:`derive_seed` of the pair, the BLAKE2b digest of
    ``f"{seed}:{dispatch_idx}"``.  A pure function of the pair, so any
    dispatch can be replayed."""
    return derive_seed(seed, dispatch_idx)


def _to_numpy(images) -> np.ndarray:
    if isinstance(images, torch.Tensor):
        return images.cpu().numpy()
    return np.asarray(images)


class _DispatchResult:
    """One dispatch's device result, copied to the host exactly once.

    The first ``numpy()`` call (on a fulfillment thread) waits for the
    device and pays the copy for the whole batch; later riders of the same
    dispatch get the cached array."""

    __slots__ = ("_images", "_np", "_err", "_lock", "_on_done")

    def __init__(self, images, on_done=None):
        self._images = images
        self._np = None
        self._err = None
        self._lock = threading.Lock()
        self._on_done = on_done

    def numpy(self) -> np.ndarray:
        with self._lock:
            if self._err is not None:
                # A fresh exception per rider, chained to the original.
                raise RuntimeError(
                    f"dispatch transfer failed: {self._err}"
                ) from self._err
            if self._np is None:
                try:
                    self._np = _to_numpy(self._images)
                except BaseException as e:
                    # Remember the failure for later riders; on_done still
                    # runs below, so a dead dispatch frees its in-flight slot.
                    self._err = e
                    raise
                finally:
                    self._images = None  # free the device buffer
                    done, self._on_done = self._on_done, None
                    if done is not None:
                        done()
            return self._np


@dataclass
class _Pending:
    """One request's unserved remainder."""

    future: Future
    temperature: float
    rows_left: int
    t_enqueue: float = 0.0
    # (dispatch_result, row, take) spans, concatenated at fulfillment time.
    parts: List = field(default_factory=list)

    def fulfill(self):
        """Materialize the dispatch results and resolve the future (on a
        fulfillment thread: ``numpy()`` waits for the device)."""
        try:
            arrays = [
                d.numpy()[row : row + take] for d, row, take in self.parts
            ]
            if len(arrays) == 1:
                # A copy, so the caller's result does not pin the whole
                # dispatch batch; skipped when the span is the whole batch.
                d, row, take = self.parts[0]
                whole = row == 0 and take == arrays[0].shape[0] == len(
                    d.numpy()
                )
                self.future.set_result(
                    arrays[0] if whole else arrays[0].copy()
                )
            else:
                self.future.set_result(np.concatenate(arrays, axis=0))
        except BaseException as e:  # never strand a waiter
            self.future.set_exception(e)


@dataclass
class ServerStats:
    dispatches: int = 0
    rows_served: int = 0
    rows_padded: int = 0
    requests: int = 0
    # How many dispatches ran at each batch size, and the rows they served.
    dispatch_shapes: dict = field(default_factory=dict)
    rows_by_shape: dict = field(default_factory=dict)

    @property
    def occupancy(self) -> float:
        total = self.rows_served + self.rows_padded
        return self.rows_served / total if total else 0.0

    def occupancy_by_shape(self) -> dict:
        """Each batch size's served rows over the rows its dispatches ran."""
        return {b: self.rows_by_shape.get(b, 0) / (b * n)
                for b, n in sorted(self.dispatch_shapes.items())}


class BatchingSampler:
    """Dynamic-batching front end over a ``(seed, f32[B]) -> images``
    sampler, such as :class:`nvae_torch.serving.Sampler` or a program
    artifact's :class:`nvae_torch.serving_program.ProgramSampler`.

    Parameters
    ----------
    call_fn:
        The sampler.  Called as ``call_fn(seed: int, temperature:
        torch.Tensor f32[B])`` for every configured batch size; returns
        ``images[B, ...]`` as a tensor (on any device) or an array.
    batch_size:
        The packing target, or a sequence of batch sizes: full dispatches
        use the largest, while a partial dispatch (``max_delay_ms`` timeout
        or flush) runs the smallest size that covers the backlog, so light
        load pays small-batch compute instead of padding the big batch.
    max_delay_ms:
        Launch a partial batch once the oldest queued request has waited
        this long.  0 launches partial batches only on ``flush``/``close``.
    seed:
        Base seed; dispatch ``d`` samples with ``dispatch_seed(seed, d)``.
    partial_max_inflight:
        Launch a *partial* batch only while fewer than this many dispatches
        are in flight (launched but not yet copied to the host).  Every
        dispatch costs full-batch device time whatever its fill, so firing
        the timer while earlier dispatches still compute would flood the
        device with mostly-empty batches; meanwhile arriving rows coalesce.
        Full batches and ``flush``/``close`` drains are never throttled.
    fulfill_workers:
        Threads copying dispatch results to the host.  Each request's future
        still resolves exactly once, with its rows in order.
    """

    def __init__(
        self,
        call_fn: Callable,
        batch_size,
        max_delay_ms: float = 5.0,
        seed: int = 0,
        partial_max_inflight: int = 2,
        fulfill_workers: int = 2,
    ):
        self.call_fn = call_fn
        sizes = ([int(batch_size)] if isinstance(batch_size, (int, float))
                 else [int(b) for b in batch_size])
        if not sizes or any(b <= 0 for b in sizes):
            raise ValueError(f"bad batch sizes {sizes}")
        # Ascending; the largest is the packing target (`batch_size`).
        self.batch_sizes = tuple(sorted(set(sizes)))
        self.batch_size = self.batch_sizes[-1]
        self.max_delay_ms = float(max_delay_ms)
        self.partial_max_inflight = int(partial_max_inflight)
        self.seed = int(seed)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.stats = ServerStats()
        self._queue: "queue.Queue" = queue.Queue()
        self._flush = threading.Event()
        self._stop = threading.Event()
        self._fulfiller = ThreadPoolExecutor(
            max_workers=max(1, int(fulfill_workers)),
            thread_name_prefix="sampler-fulfill",
        )
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ---- client API ---------------------------------------------------------

    def submit(self, n: int, temperature: float) -> Future:
        """Enqueue a request for ``n`` images at ``temperature``; returns a
        Future resolving to an ``(n, H, W, C)`` numpy array."""
        if n <= 0:
            raise ValueError(f"n must be positive, got {n}")
        if self._stop.is_set():
            raise RuntimeError("server is closed")
        fut = Future()
        self._queue.put(
            _Pending(fut, float(temperature), int(n), time.monotonic())
        )
        self.stats.requests += 1
        return fut

    def sample(self, n: int, temperature: float) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(n, temperature).result()

    def flush(self) -> None:
        """Launch whatever is queued now without waiting for a full batch."""
        self._flush.set()

    def swap_call(self, call_fn: Callable) -> None:
        """Hot-swap the sampler (same ``(seed, f32[B]) -> images`` contract
        and batch sizes).  The worker reads the callable once per dispatch,
        so the assignment is the swap boundary: dispatches launched after it
        run the new sampler, launched ones finish on the old.  Queued
        requests never re-dispatch: a request spanning the swap gets rows
        from both (each row is served exactly once)."""
        self.call_fn = call_fn

    def close(self) -> None:
        """Serve everything queued, then stop the worker."""
        self._stop.set()
        self._flush.set()
        self._worker.join()
        self._fulfiller.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- worker -------------------------------------------------------------

    def _dispatch_done(self):
        """A dispatch's result reached the host: free its in-flight slot and
        wake the worker (None sentinel), so a throttled partial launches."""
        with self._inflight_lock:
            self._inflight -= 1
        self._queue.put(None)

    def _inflight_count(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def pack(self, pendings: List[_Pending], batch: int = 0) -> np.ndarray:
        """The packed f32[B] temperature vector for one dispatch: rows in
        queue order, the tail padded at ``PAD_TEMPERATURE``.  ``batch``
        defaults to the largest configured size."""
        B = batch or self.batch_size
        temps = []
        for p in pendings:
            take = min(p.rows_left, B - len(temps))
            temps.extend([p.temperature] * take)
        temps.extend([PAD_TEMPERATURE] * (B - len(temps)))
        return np.asarray(temps, np.float32)

    def _pick_batch(self, rows: int) -> int:
        """Smallest configured size covering ``rows`` (the largest if none
        does: the remainder rides the next dispatch)."""
        for b in self.batch_sizes:
            if b >= rows:
                return b
        return self.batch_size

    def _dispatch(self, pendings: List[_Pending]) -> None:
        """Launch one batch serving (prefixes of) ``pendings`` in order."""
        B = self._pick_batch(sum(p.rows_left for p in pendings))
        t_vec = self.pack(pendings, B)
        call_fn = self.call_fn
        try:
            images = call_fn(
                dispatch_seed(self.seed, self.stats.dispatches),
                torch.from_numpy(t_vec),
            )
        except Exception as e:  # fail every rider, keep the worker alive
            for p in pendings:
                if p.rows_left > 0 and not p.future.done():
                    p.future.set_exception(e)
                p.rows_left = 0
            self.stats.dispatches += 1
            return
        with self._inflight_lock:
            self._inflight += 1
        result = _DispatchResult(images, on_done=self._dispatch_done)
        # Stats first: a client whose future resolved sees this dispatch.
        filled = min(sum(p.rows_left for p in pendings), B)
        self.stats.dispatches += 1
        self.stats.rows_served += filled
        self.stats.rows_padded += B - filled
        self.stats.dispatch_shapes[B] = (
            self.stats.dispatch_shapes.get(B, 0) + 1
        )
        self.stats.rows_by_shape[B] = (
            self.stats.rows_by_shape.get(B, 0) + filled)
        row = 0
        for p in pendings:
            take = min(p.rows_left, B - row)
            if take <= 0:
                break
            p.parts.append((result, row, take))
            p.rows_left -= take
            row += take
            if p.rows_left == 0:
                self._fulfiller.submit(p.fulfill)

    def _run(self) -> None:
        B = self.batch_size
        backlog: List[_Pending] = []  # partially-served / waiting requests

        def rows_waiting():
            return sum(p.rows_left for p in backlog)

        def drain_nowait():
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    return
                if item is not None:  # None = dispatch-done wake sentinel
                    backlog.append(item)

        while True:
            # Block for the next request (bounded, so flush/close are seen),
            # then drain everything queued: a flush packs the whole queue.
            timeout = 0.05
            if (
                backlog
                and self.max_delay_ms > 0
                and not self._flush.is_set()
                and self._inflight_count() < self.partial_max_inflight
            ):
                deadline = backlog[0].t_enqueue + self.max_delay_ms / 1e3
                timeout = min(max(deadline - time.monotonic(), 0.0), 0.05)
            try:
                item = self._queue.get(timeout=timeout)
                if item is not None:
                    backlog.append(item)
            except queue.Empty:
                pass
            drain_nowait()

            flush = self._flush.is_set()
            # Every full batch launches; a partial one on flush, or on
            # timeout while fewer than partial_max_inflight are in flight.
            while rows_waiting() >= B or (backlog and flush) or (
                backlog
                and self.max_delay_ms > 0
                and self._inflight_count() < self.partial_max_inflight
                and (time.monotonic() - backlog[0].t_enqueue) * 1e3
                >= self.max_delay_ms
            ):
                self._dispatch(backlog)
                backlog = [p for p in backlog if p.rows_left > 0]
            if flush and not backlog and self._queue.empty():
                self._flush.clear()
                if self._stop.is_set():
                    return
