"""Request-level serving front-end: dynamic batching over the pipeline.

``InferencePipeline`` serves fixed host *batches*; production traffic
arrives as single requests. ``BatchingServer`` bridges the two the way
accelerator serving stacks do it: requests land on a queue, a batcher thread coalesces
them — dispatch when ``max_batch`` requests are waiting OR the oldest
request has waited ``max_wait_ms`` (the latency/throughput knob) — decodes
the JPEG payloads in one native multithreaded call, pushes ONE device
dispatch through the pipeline (whose fixed-batch padding keeps a single
compiled program for every fill level), and resolves each request's
``Future`` with its own logits row.

Design notes:
- Two threads: the batcher (queue-wait + GIL-free JPEG decode + async
  device dispatch) and a resolver (device->host pulls + future
  resolution). With the pull in the batcher, a single-threaded server's
  cycle becomes decode + device round trip; split, the batcher's cycle is
  decode-bound and consecutive pulls pipeline on the device queue;
  ``pipeline_depth`` bounds un-pulled in-flight batches (backpressure
  when the device falls behind).
- Errors are per-request: a corrupt JPEG fails its own future (decode is
  retried per-item to isolate the offender), and a pre-decoded array whose
  shape doesn't match the decoder's output fails its own future instead of
  breaking the batch stack; the server keeps serving.
- No dynamic shapes anywhere: every fill level pads to the pipeline's
  compiled batch, so the server never triggers a recompile.

The reference has no serving story at all (SURVEY.md §5).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Union

import numpy as np

from vitax.data import JpegDecoder


class BatchingServer:
    """Coalesce single classify requests into device batches.

    ``pipeline``: an ``InferencePipeline`` (quantized or float — anything
    with ``__call__(raw_uint8_batch) -> logits``). ``decoder`` turns JPEG
    bytes into the fixed ``[S, S, 3]`` uint8 the pipeline preprocesses;
    requests may also be pre-decoded ``[S, S, 3]`` uint8 arrays.
    """

    def __init__(
        self,
        pipeline,
        *,
        decoder: Optional[JpegDecoder] = None,
        max_batch: Optional[int] = None,
        max_wait_ms: float = 5.0,
        pipeline_depth: int = 2,
        warm: bool = True,
    ):
        self.pipeline = pipeline
        self.decoder = decoder or JpegDecoder(size=256)
        self.max_batch = max_batch or getattr(pipeline, "batch_size", 64)
        self.max_wait_s = max_wait_ms / 1e3
        # Bound on un-materialized in-flight device batches. Resolution
        # (device->host pull) runs in a dedicated thread so the batcher's
        # cycle is queue-wait + decode and round trips pipeline on the
        # device queue. ``pipeline_depth`` bounds the resolver queue; the
        # true in-flight count can exceed it by up to two (one batch being
        # dispatched by the blocked batcher, one popped mid-materialization
        # by the resolver) — size device/host headroom for depth+2 batches.
        self.pipeline_depth = max(1, int(pipeline_depth))
        # Compile every fill-level program BEFORE traffic: a first-seen
        # bucket would otherwise jit mid-traffic (tens of seconds for a
        # large model) while every queued request stalls.
        if warm and hasattr(pipeline, "warm"):
            pipeline.warm()
        self._q: "queue.Queue" = queue.Queue()
        self._rq: "queue.Queue" = queue.Queue(maxsize=self.pipeline_depth)
        self._closed = False
        # serializes submit vs close: guarantees no request is ever enqueued
        # AFTER the shutdown sentinel (which the batcher treats as
        # end-of-stream — a straggler behind it would strand its Future)
        self._lock = threading.Lock()
        self._resolver = threading.Thread(target=self._resolver_loop, daemon=True)
        self._resolver.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------

    def submit(self, item: Union[bytes, np.ndarray]) -> Future:
        """Enqueue one request (JPEG bytes or a decoded uint8 image);
        returns a ``Future`` resolving to that request's logits row."""
        f: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._q.put((item, f))
        return f

    def classify(self, item: Union[bytes, np.ndarray], timeout: float = None) -> np.ndarray:
        """Synchronous single-request convenience: submit + wait."""
        return self.submit(item).result(timeout=timeout)

    def close(self, timeout: float = 10.0) -> None:
        """Drain outstanding requests and stop both threads."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # wake the batcher; nothing can follow it
        self._thread.join(timeout=timeout)
        # the batcher pushes the resolver's sentinel as its last act; join
        # so every future is resolved when close() returns
        self._resolver.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- batcher ------------------------------------------------------------

    def _collect(self):
        """Gather until max_batch or the first request's deadline. Returns a
        list of (item, future), or None on the shutdown sentinel."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:  # shutdown sentinel: flush what we have
                break
            batch.append(nxt)
        return batch

    def _decode(self, items, futures):
        """Decode payloads to one [n, S, S, 3] uint8 array. A failing JPEG
        or a wrong-shape pre-decoded array fails only its own future
        (decode retried per-item to find the offender); returns
        (array, futures) for the survivors."""
        expected = (self.decoder.size, self.decoder.size, 3)
        jpeg_idx, decoded = [], list(items)
        for i, it in enumerate(items):
            if isinstance(it, (bytes, bytearray)):
                jpeg_idx.append(i)
            elif getattr(it, "shape", None) != expected:
                # pre-decoded arrays must match the decoder's output shape —
                # anything else would fail np.stack and take the whole
                # batch's futures down with it
                futures[i].set_exception(ValueError(
                    f"pre-decoded request has shape "
                    f"{getattr(it, 'shape', None)}, expected {expected} "
                    f"(the decoder's output; resize on the client or pass "
                    f"JPEG bytes)"
                ))
                decoded[i] = None
        if jpeg_idx:
            try:
                arrs = self.decoder([items[i] for i in jpeg_idx])
                for j, i in enumerate(jpeg_idx):
                    decoded[i] = arrs[j]
            except Exception:
                for i in jpeg_idx:  # isolate the corrupt item(s)
                    try:
                        decoded[i] = self.decoder([items[i]])[0]
                    except Exception as e:
                        futures[i].set_exception(e)
                        decoded[i] = None
        keep = [i for i, d in enumerate(decoded) if d is not None]
        if not keep:
            return None, []
        return np.stack([decoded[i] for i in keep]), [futures[i] for i in keep]

    def _resolve(self, pending):
        """Materialize an in-flight device batch and resolve its futures."""
        if pending is None:
            return
        handles, futures = pending
        try:
            logits = np.concatenate([np.asarray(h) for h in handles], axis=0)
            for i, f in enumerate(futures):
                f.set_result(logits[i])
        except Exception as e:  # device-side failure: fail that batch
            for f in futures:
                if not f.done():
                    f.set_exception(e)

    def _resolver_loop(self):
        """Materialize in-flight device batches and resolve their futures.

        Runs apart from the batcher so the device->host pull (the full
        device round trip) never stalls batch formation: the batcher's cycle is queue-wait + decode
        only, and consecutive pulls pipeline on the device queue."""
        while True:
            pending = self._rq.get()
            if pending is None:
                return
            self._resolve(pending)

    def _loop(self):
        # The batcher collects + decodes + dispatches; materialization
        # happens in _resolver_loop. _rq's maxsize bounds un-pulled
        # in-flight batches (backpressure when the device falls behind).
        dispatch = getattr(self.pipeline, "dispatch", None)
        try:
            while True:
                batch = self._collect()
                if batch is None:  # shutdown, queue drained
                    return
                items, futures = zip(*batch)
                raw, live = self._decode(list(items), list(futures))
                if raw is None:
                    # the shutdown sentinel may have been the flush that
                    # closed this (fully-failed) batch — without this check
                    # the loop would block forever in the next _collect and
                    # close() would never join the thread
                    if self._closed and self._q.empty():
                        return
                    continue
                try:
                    if dispatch is not None:
                        self._rq.put((dispatch(raw), live))
                    else:  # plain-callable pipeline: synchronous fallback
                        logits = self.pipeline(raw)
                        for i, f in enumerate(live):
                            f.set_result(logits[i])
                except Exception as e:
                    for f in live:
                        if not f.done():
                            f.set_exception(e)
                if self._closed and self._q.empty():
                    return
        finally:
            self._rq.put(None)  # resolver drains FIFO, then exits
