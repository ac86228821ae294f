"""Serving: dynamic micro-batching over the bucketed recognizer
(copied from ``doc2tex_tpu.serving``, which imports no JAX; the port keeps
its own copy).

- a bounded request queue and ONE dispatcher thread that coalesces the
  requests arriving within a latency window into one recognizer call (the
  recognizer groups them by bucket and decodes each group as a batch);
- backpressure (:class:`ServerOverloaded`) instead of unbounded growth;
- throughput, latency and batch-size accounting for operators.

Exactly one thread drives the card; transport threads (the HTTP handlers
of ``api/serve.py``) only block on futures.  With ``bucket_key`` the
dispatcher forms shape-pure batches, and with ``coalesce_ratio`` > 1 it
merges contained buckets as ``MathRecognition.coalesce_groups`` does.
Under ``quantize: int8`` a crop's string depends on its batch mates (the
activation scale is per batch), so server strings are comparable only with
a run that formed the same batches.

``PageServer`` runs detection page after page on its own thread and sends
each page's crops to a shared ``RecognitionServer`` without waiting.
"""

from __future__ import annotations

import statistics
import threading
import time
from collections import deque
from concurrent.futures import Future
from queue import Empty, Full, Queue
from typing import Callable, Optional, Sequence

import numpy as np


class ServerClosed(RuntimeError):
    """submit() after close(), or a future cancelled by shutdown."""


class ServerOverloaded(RuntimeError):
    """The bounded request queue is full (backpressure signal)."""


class _Request:
    __slots__ = ("image", "future", "t_submit", "key")

    def __init__(self, image: np.ndarray, key=None):
        self.image = image
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.key = key


class RecognitionServer:
    """Micro-batching front of a crop recognizer.

    Parameters
    ----------
    recognizer:
        ``images -> list[str]`` batch callable; normally a
        :class:`~doc2tex_tpu_torch.recognition.flow.MathRecognition` instance.
    max_batch:
        Coalescing cap per recognizer call.  The recognizer still splits
        the batch by bucket shape internally.
    batch_window_ms:
        How long the dispatcher holds a batch open after its first
        request, waiting for companions.  0 = dispatch whatever is
        immediately available (lowest latency, smallest batches).
    max_queue:
        Bound on queued (not yet dispatched) requests; ``submit`` raises
        :class:`ServerOverloaded` beyond it.
    bucket_key:
        Optional ``image -> hashable`` (e.g.
        :meth:`MathRecognition.bucket_key`, pure shape math).  When set,
        the dispatcher forms SHAPE-PURE batches: the oldest request's
        bucket, filled with same-bucket companions up to ``max_batch``;
        other buckets stay pending and keep accumulating.  Without it, a
        mixed-size batch fragments inside the recognizer into one decode
        invocation per bucket — and invocation cost is nearly flat in
        batch size (decode is latency-bound), so fragmentation, not batch
        size, is what caps throughput.  Oldest-first selection bounds
        every request's wait at ~(#live buckets) batch times — no
        starvation.
    """

    def __init__(
        self,
        recognizer: Callable[[Sequence[np.ndarray]], list],
        max_batch: int = 64,
        batch_window_ms: float = 5.0,
        max_queue: int = 512,
        bucket_key: Optional[Callable[[np.ndarray], object]] = None,
        coalesce_ratio: float = 0.0,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.recognizer = recognizer
        self.bucket_key = bucket_key
        # bucket coalescing (needs bucket_key returning (h, w) tuples):
        # a dispatch batch may mix a CONTAINED bucket into a containing
        # one when the containing bucket's area is <= ratio x the smaller
        # request's native bucket area — the recognizer pads the smaller
        # crops up (white, top-left = the train-time pad) and decodes the
        # whole batch in ONE invocation (invocation cost is ~flat in
        # batch size, so merging sparse per-bucket queues is the serving
        # throughput lever).  The recognizer must be constructed with the
        # same `coalesce_ratio`, else the mixed batch re-fragments
        # internally.  0/1 = strictly shape-pure (the round-3 behavior).
        self.coalesce_ratio = float(coalesce_ratio)
        self._pending: list = []  # dispatcher-thread only (stats read len)
        self.max_batch = int(max_batch)
        self.window_s = float(batch_window_ms) / 1e3
        self._queue: Queue = Queue(maxsize=max_queue)
        self._closed = False
        self._lock = threading.Lock()
        # rolling accounting (last 1024 requests / batches)
        self._lat_s: deque = deque(maxlen=1024)
        self._batch_sizes: deque = deque(maxlen=1024)
        self._n_requests = 0
        self._n_images_done = 0
        self._n_batches = 0
        self._n_errors = 0
        self._t_start = time.monotonic()
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="d2t-dispatch", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------- client

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one crop; returns a Future resolving to its LaTeX."""
        if self._closed:
            raise ServerClosed("server is closed")
        image = np.asarray(image)
        key = self.bucket_key(image) if self.bucket_key is not None else None
        req = _Request(image, key=key)
        # the documented max_queue bound covers UNDISPATCHED requests —
        # both the Queue and the dispatcher's _pending holdback (bucket-keyed
        # traffic parks non-matching requests there), else a multi-bucket mix
        # could accept ~2x max_queue before overload (approximate: len() of
        # _pending is read cross-thread, which CPython makes safe)
        cap = self._queue.maxsize
        if cap and self._queue.qsize() + len(self._pending) >= cap:
            raise ServerOverloaded(f"request queue full ({cap})")
        try:
            self._queue.put_nowait(req)
        except Full:
            raise ServerOverloaded(
                f"request queue full ({self._queue.maxsize})"
            ) from None
        with self._lock:
            self._n_requests += 1
        return req.future

    def recognize(self, image: np.ndarray, timeout: Optional[float] = None) -> str:
        """Synchronous single-crop helper."""
        return self.submit(image).result(timeout=timeout)

    def recognize_many(
        self, images: Sequence[np.ndarray], timeout: Optional[float] = None
    ) -> list:
        """Submit a burst and wait for all results (order preserved)."""
        futures = [self.submit(im) for im in images]
        return [f.result(timeout=timeout) for f in futures]

    # -------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._lat_s)
            done = self._n_images_done
            stats = {
                "requests": self._n_requests,
                "completed": done,
                "batches": self._n_batches,
                "errors": self._n_errors,
                "queue_depth": self._queue.qsize() + len(self._pending),
                "uptime_s": round(time.monotonic() - self._t_start, 3),
                "avg_batch": (
                    round(statistics.fmean(self._batch_sizes), 2)
                    if self._batch_sizes
                    else 0.0
                ),
                "latency_p50_ms": _pct_ms(lat, 0.50),
                "latency_p95_ms": _pct_ms(lat, 0.95),
                "latency_p99_ms": _pct_ms(lat, 0.99),
            }
        stats["throughput_rps"] = (
            round(done / stats["uptime_s"], 3) if stats["uptime_s"] > 0 else 0.0
        )
        return stats

    # ----------------------------------------------------------- shutdown

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting requests; by default let the queue drain first."""
        self._closed = True
        if drain:
            deadline = time.monotonic() + timeout
            while (
                not self._queue.empty() or self._pending
            ) and time.monotonic() < deadline:
                time.sleep(0.005)
        self._stop = True
        self._thread.join(timeout=timeout)
        # fail anything still queued or pending
        leftovers = list(self._pending)
        self._pending.clear()
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except Empty:
                break
        for req in leftovers:
            if not req.future.done():
                req.future.set_exception(ServerClosed("server shut down"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # --------------------------------------------------------- dispatcher

    _stop = False

    def _dispatch_loop(self) -> None:
        pending = self._pending
        while not self._stop:
            if not pending:
                try:
                    pending.append(self._queue.get(timeout=0.05))
                except Empty:
                    continue
                # hold the window open after a fresh first arrival
                deadline = time.monotonic() + self.window_s
            else:
                # backlog exists: no extra waiting, just drain arrivals
                deadline = time.monotonic()
            cap = self._queue.maxsize or 0
            while cap <= 0 or len(pending) < cap:
                remaining = deadline - time.monotonic()
                if remaining > 0:
                    try:
                        pending.append(self._queue.get(timeout=remaining))
                        continue
                    except Empty:
                        break
                try:
                    pending.append(self._queue.get_nowait())
                except Empty:
                    break
            self._run_batch(self._select_batch())

    def _select_batch(self) -> list:
        """Oldest request's bucket, filled up to max_batch (shape-pure
        when ``bucket_key`` is set; plain FIFO prefix otherwise).  With
        ``coalesce_ratio`` > 1, contained buckets within the area-ratio
        guard join the batch too (see ``__init__``)."""
        pending = self._pending
        if self.bucket_key is None:
            batch = pending[: self.max_batch]
            del pending[: len(batch)]
            return batch
        if self.coalesce_ratio > 1.0:
            return self._select_coalesced()
        key0 = pending[0].key
        batch, rest = [], []
        for r in pending:
            if r.key == key0 and len(batch) < self.max_batch:
                batch.append(r)
            else:
                rest.append(r)
        pending[:] = rest
        return batch

    def _select_coalesced(self) -> list:
        """Oldest-first greedy merge: grow a target bucket over pending
        requests whose buckets nest with it (one contains the other) while
        the target area stays <= ratio x every member's native bucket area.
        The target is always a member's own bucket, so the recognizer's
        ``coalesce_groups`` (same ratio) collapses the batch to exactly
        one decode invocation."""
        pending = self._pending
        ratio = self.coalesce_ratio
        target = pending[0].key
        min_area = target[0] * target[1]
        batch, rest = [pending[0]], []
        for r in pending[1:]:
            if len(batch) >= self.max_batch:
                rest.append(r)
                continue
            bh, bw = r.key
            th, tw = target
            if bh <= th and bw <= tw:
                cand = target
            elif bh >= th and bw >= tw:
                cand = r.key
            else:  # incomparable buckets never share a decode
                rest.append(r)
                continue
            area = bh * bw
            if cand[0] * cand[1] > ratio * min(min_area, area):
                rest.append(r)
                continue
            target = cand
            min_area = min(min_area, area)
            batch.append(r)
        pending[:] = rest
        return batch

    def _run_batch(self, batch: list) -> None:
        try:
            results = self.recognizer([r.image for r in batch])
        except Exception as exc:  # noqa: BLE001 — forwarded to callers
            with self._lock:
                self._n_errors += len(batch)
                self._n_batches += 1
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(exc)
            return
        t1 = time.monotonic()
        with self._lock:
            self._n_batches += 1
            self._n_images_done += len(batch)
            self._batch_sizes.append(len(batch))
            for r in batch:
                self._lat_s.append(t1 - r.t_submit)
        for r, out in zip(batch, results):
            if not r.future.done():
                r.future.set_result(out)


def _pct_ms(sorted_lat_s: list, q: float) -> float:
    if not sorted_lat_s:
        return 0.0
    idx = min(int(q * len(sorted_lat_s)), len(sorted_lat_s) - 1)
    return round(sorted_lat_s[idx] * 1e3, 2)


class PageServer:
    """Full-page pipeline serving: detection per page, crop recognition
    shared across pages.

    The page pipeline (:meth:`doc2tex_tpu_torch.app.App.__call__`) detects, then
    recognizes the page's crops, then moves on — the recognizer idles
    during detection and vice versa.  Here one page thread runs
    ``detect_and_crop`` page after page and submits each page's crops to a
    shared :class:`RecognitionServer` WITHOUT waiting: page N's crops
    decode while page N+1 is being detected, and crops from concurrent
    pages coalesce into the same decode batches.  Page futures resolve via
    crop-future callbacks, never blocking the page thread.

    Parameters
    ----------
    detect_and_crop:
        ``page -> (boxes, crops)`` aligned lists; normally
        :meth:`doc2tex_tpu_torch.app.App.detect_and_crop`.
    crop_server:
        The shared :class:`RecognitionServer` (not owned: ``close()``
        leaves it running, so plain ``/recognize`` traffic can share it).
    """

    def __init__(
        self,
        detect_and_crop: Callable[[np.ndarray], tuple],
        crop_server: RecognitionServer,
        max_queue: int = 32,
    ):
        self.detect_and_crop = detect_and_crop
        self.crop_server = crop_server
        self._queue: Queue = Queue(maxsize=max_queue)
        self._closed = False
        self._stop = False
        self._n_pages = 0
        self._n_regions = 0
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._page_loop, name="d2t-pages", daemon=True
        )
        self._thread.start()

    def submit_page(self, page: np.ndarray) -> Future:
        """Enqueue a page; Future resolves to ``[(box, latex), ...]``."""
        if self._closed:
            raise ServerClosed("page server is closed")
        req = _Request(np.asarray(page))
        try:
            self._queue.put_nowait(req)
        except Full:
            raise ServerOverloaded(
                f"page queue full ({self._queue.maxsize})"
            ) from None
        return req.future

    def recognize_page(
        self, page: np.ndarray, timeout: Optional[float] = None
    ) -> list:
        return self.submit_page(page).result(timeout=timeout)

    def stats(self) -> dict:
        with self._lock:
            return {
                "pages": self._n_pages,
                "regions": self._n_regions,
                "page_queue_depth": self._queue.qsize(),
                "crop_server": self.crop_server.stats(),
            }

    def close(self, timeout: float = 30.0) -> None:
        self._closed = True
        deadline = time.monotonic() + timeout
        while not self._queue.empty() and time.monotonic() < deadline:
            time.sleep(0.005)
        self._stop = True
        self._thread.join(timeout=timeout)
        # fail anything still queued (drain deadline hit) so callers blocked
        # in recognize_page().result() see ServerClosed instead of hanging
        while True:
            try:
                req = self._queue.get_nowait()
            except Empty:
                break
            if not req.future.done():
                req.future.set_exception(ServerClosed("page server shut down"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _page_loop(self) -> None:
        while not self._stop:
            try:
                req = self._queue.get(timeout=0.05)
            except Empty:
                continue
            try:
                boxes, crops = self.detect_and_crop(req.image)
            except Exception as exc:  # noqa: BLE001 — forwarded to caller
                if not req.future.done():
                    req.future.set_exception(exc)
                continue
            with self._lock:
                self._n_pages += 1
                self._n_regions += len(crops)
            if not crops:
                req.future.set_result([])
                continue
            self._gather(req.future, list(boxes), crops)

    def _gather(self, page_future: Future, boxes: list, crops: list) -> None:
        """Submit crops and resolve the page future from callbacks (the
        page thread moves on to the next page's detection immediately)."""
        results = [None] * len(crops)
        remaining = [len(crops)]
        lock = threading.Lock()

        def make_cb(i):
            def cb(fut: Future) -> None:
                err = fut.exception()
                with lock:
                    if page_future.done():
                        return
                    if err is not None:
                        page_future.set_exception(err)
                        return
                    results[i] = fut.result()
                    remaining[0] -= 1
                    done = remaining[0] == 0
                if done:
                    page_future.set_result(list(zip(boxes, results)))

            return cb

        try:
            for i, crop in enumerate(crops):
                self.crop_server.submit(crop).add_done_callback(make_cb(i))
        except (ServerOverloaded, ServerClosed) as exc:
            with lock:
                if not page_future.done():
                    page_future.set_exception(exc)
