"""Dynamic batching — the port's copy of ``gofr_tpu/serving/batcher.py``.

Coalesces concurrent requests into padded batch executions: a request
queue drained by a worker that flushes on **size** (``max_batch``
reached) or **deadline** (``max_wait_s`` elapsed since the oldest
pending request). The encoder and vision families pad each flush to a
bucket of ``pad_bucket`` so a small set of shapes recurs. One deliberate
difference: once the oldest request's deadline has passed, the requests
already queued still join its flush (the reference's flushes one request
at a time under a backlog), and ``start`` after ``stop`` starts a worker
again.

Thread-based (device calls block anyway): async callers get a
``concurrent.futures.Future`` they can await through
``asyncio.wrap_future``.

Overload: the queue is bounded and a full queue **sheds** — ``submit``
raises :class:`gofr_tpu_torch.errors.ErrorTooManyRequests`, which the
HTTP responder maps to 429 with a ``Retry-After`` that grows with the
backlog (queued flushes times the measured flush time).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from gofr_tpu_torch.errors import ErrorTooManyRequests


def pad_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n (last bucket caps)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class _Pending:
    payload: Any
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.time)


class DynamicBatcher:
    """Generic size/deadline batcher.

    ``execute(payloads) -> results`` runs on the worker thread; one result
    per payload, order-preserving. An exception fails the whole flush's
    futures.
    """

    def __init__(
        self,
        execute: Callable[[list], list],
        max_batch: int = 8,
        max_wait_s: float = 0.005,
        metrics: Any = None,
        name: str = "batcher",
        max_queue: int = 1024,
    ) -> None:
        self._execute = execute
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._metrics = metrics
        self._name = name
        self._queue: queue.Queue[_Pending] = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # EWMA of the flush (execute) wall time: the load-sensitive basis
        # of the queue-full Retry-After.
        self._flush_ewma_s = 0.0

    def start(self) -> None:
        """Start the worker; after a ``stop``, a new one (the reference's
        keeps its stop flag set, so its restarted worker exits at once)."""
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"batcher-{self._name}", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def submit(self, payload: Any) -> Future:
        """Enqueue; a full queue sheds with 429 and a Retry-After."""
        pending = _Pending(payload)
        try:
            self._queue.put_nowait(pending)
        except queue.Full:
            if self._metrics is not None:
                self._metrics.increment_counter(
                    "app_tpu_requests_shed_total",
                    "model", self._name, "reason", "queue_full",
                )
            raise ErrorTooManyRequests(
                f"{self._name} batch queue full "
                f"({self._queue.maxsize} pending)",
                retry_after_s=self._retry_after_s(),
            ) from None
        if self._metrics is not None:
            self._metrics.set_gauge(
                "app_tpu_queue_depth", self._queue.qsize(), "batcher", self._name
            )
        return pending.future

    def _retry_after_s(self) -> float:
        """The backlog in flushes times the measured flush time (the wait
        window floors it while the EWMA is cold); at least 1 s."""
        flushes = -(-self._queue.qsize() // max(1, self.max_batch))
        per_flush = max(self._flush_ewma_s, self.max_wait_s)
        return max(1.0, flushes * per_flush)

    # -- worker -----------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            if self._metrics is not None:
                self._metrics.record_histogram(
                    "app_tpu_batch_size", len(batch), "batcher", self._name
                )
                self._metrics.set_gauge(
                    "app_tpu_queue_depth", self._queue.qsize(), "batcher", self._name
                )
            t0 = time.monotonic()
            try:
                results = self._execute([p.payload for p in batch])
                for pending, result in zip(batch, results):
                    pending.future.set_result(result)
            except Exception as exc:  # the flush's boundary: every caller gets it
                for pending in batch:
                    if not pending.future.done():
                        pending.future.set_exception(exc)
            # A failed flush burns its time too.
            elapsed = time.monotonic() - t0
            self._flush_ewma_s = (
                elapsed if self._flush_ewma_s == 0.0
                else 0.8 * self._flush_ewma_s + 0.2 * elapsed
            )

    def _collect(self) -> list[_Pending]:
        """Block for the first request, then drain until size or deadline.
        Past the oldest request's deadline, what is queued already still
        joins the flush (up to ``max_batch``, without waiting): under a
        backlog, where each flush outlasts ``max_wait_s``, the reference's
        flushes hold one request each."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = first.enqueued_at + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.time()
            try:
                batch.append(self._queue.get(timeout=remaining) if remaining > 0
                             else self._queue.get_nowait())
            except queue.Empty:
                break
        return batch
