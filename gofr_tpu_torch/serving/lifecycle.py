"""Request-lifecycle primitives — the port's copies of the reference's
``gofr_tpu/serving/lifecycle.py`` (``Deadline``, ``CancelToken``,
``AggregateThroughput``, ``ClassPriorityQueue``, ``coalesce_deadline``)
and of the SLO-class rules of ``gofr_tpu/serving/brownout.py``
(``normalize_slo_class``, ``parse_tenant_class_map``).

A ``Deadline`` and a ``CancelToken`` travel with a request from
``submit_generate`` into the scheduler loop, which reaps a request whose
deadline expired or whose token tripped once per pass (host bookkeeping,
no device traffic). ``AggregateThroughput`` is the tokens/s estimate
behind projected-wait shedding, and ``ClassPriorityQueue`` the admission
queue with per-SLO-class priority dequeue. Every clock is injectable, so
tests state times instead of sleeping.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from typing import Any, Callable, Mapping, Optional

from gofr_tpu_torch.analysis import lockcheck


class Deadline:
    """An absolute expiry measured on ``clock`` (monotonic seconds).
    :meth:`after` is the "N seconds from now" form."""

    __slots__ = ("expires_at", "_clock")

    def __init__(
        self,
        expires_at: float,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.expires_at = expires_at
        self._clock = clock

    @classmethod
    def after(
        cls,
        seconds: float,
        clock: Callable[[], float] = time.monotonic,
    ) -> "Deadline":
        return cls(clock() + seconds, clock)

    def remaining(self) -> float:
        """Seconds until expiry (negative once expired)."""
        return self.expires_at - self._clock()

    def expired(self) -> bool:
        return self._clock() >= self.expires_at

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"


class CancelToken:
    """A one-way latch: once cancelled, stays cancelled. Any thread may
    trip it; the scheduler thread reads it without locking."""

    __slots__ = ("_evt",)

    def __init__(self) -> None:
        self._evt = threading.Event()

    def cancel(self) -> None:
        self._evt.set()

    @property
    def cancelled(self) -> bool:
        return self._evt.is_set()

    def __repr__(self) -> str:
        return f"CancelToken(cancelled={self.cancelled})"


#: Width (s) of one AggregateThroughput bucket.
_BUCKET_S = 0.05


class AggregateThroughput:
    """Sliding-window tokens/s across the whole batch: every emitted token
    of every slot, over ``window_s`` of wall clock. Notes within
    ``_BUCKET_S`` of each other share a bucket, so memory is O(window /
    bucket) whatever the token rate. Noted from the scheduler thread, read
    from submit paths (one lock)."""

    def __init__(
        self,
        window_s: float = 30.0,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = lockcheck.make_lock("AggregateThroughput._lock")
        # (bucket start time, tokens in bucket); _total mirrors the sum.
        self._buckets: deque[tuple[float, int]] = deque()
        self._total = 0

    def note(self, n_tokens: int = 1, now: Optional[float] = None) -> None:
        """Record ``n_tokens`` emissions at ``now`` (default: the clock)."""
        t = self._clock() if now is None else now
        with self._lock:
            if self._buckets and t - self._buckets[-1][0] < _BUCKET_S:
                bt, bn = self._buckets[-1]
                self._buckets[-1] = (bt, bn + n_tokens)
            else:
                self._buckets.append((t, n_tokens))
            self._total += n_tokens
            self._prune(t)

    def rate(self, now: Optional[float] = None) -> float:
        """Tokens/s over the window; 0.0 with no signal (callers fall back
        to a prior). A burst shorter than one bucket counts as one bucket
        interval, so an idle-then-burst engine never reports 0."""
        t = self._clock() if now is None else now
        with self._lock:
            self._prune(t)
            if not self._buckets:
                return 0.0
            span = t - self._buckets[0][0]
            return self._total / max(span, _BUCKET_S)

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._total = 0

    def _prune(self, now: float) -> None:
        # Callers hold self._lock.
        cutoff = now - self.window_s
        while self._buckets and self._buckets[0][0] < cutoff:
            _, n = self._buckets.popleft()
            self._total -= n


#: SLO-class dequeue rank: interactive jumps standard jumps batch.
#: Unknown classes rank as standard.
_CLASS_RANK = {"interactive": 0, "standard": 1, "batch": 2}


class ClassPriorityQueue:
    """The admission queue with per-SLO-class priority dequeue.

    * pop the head of the highest-priority non-empty class, FIFO within a
      class;
    * starvation bound: a lower-class head that has waited longer than
      ``promote_after_s`` is promoted — among over-age heads the oldest
      pops first whatever its class;
    * ``promote_after_s <= 0`` turns classing off: one FIFO.

    The ``queue.Queue`` subset the engine uses (``put_nowait``,
    ``get_nowait``, ``qsize``, ``empty``, ``maxsize``): put on submit
    threads, get on the scheduler thread, one lock.

    ``prefix_probe`` (``TPU_QUEUE_PREFIX_AWARE``): within the chosen class,
    the first of the lane's ``PREFIX_SCAN`` head entries the probe says
    has a prefix-cache hit pops ahead of its peers (a promoted pick is
    exempt: the starvation bound is an ordering contract). None keeps the
    pop order.
    """

    #: Prefix-aware pop scans at most this many entries from the lane head.
    PREFIX_SCAN = 16

    def __init__(
        self,
        maxsize: int = 0,
        *,
        promote_after_s: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
        prefix_probe: Optional[Callable[[Any], bool]] = None,
    ) -> None:
        self.maxsize = int(maxsize)
        self.promote_after_s = float(promote_after_s)
        self._clock = clock
        self._prefix_probe = prefix_probe
        self._lock = lockcheck.make_lock("ClassPriorityQueue._lock")
        # rank → FIFO of (enqueued_at, request); rank 1 is THE queue when
        # classing is off.
        self._lanes: dict[int, deque] = {0: deque(), 1: deque(), 2: deque()}

    def qsize(self) -> int:
        with self._lock:
            return sum(len(lane) for lane in self._lanes.values())

    def empty(self) -> bool:
        return self.qsize() == 0

    def put_nowait(self, req: Any) -> None:
        with self._lock:
            if 0 < self.maxsize <= sum(
                len(lane) for lane in self._lanes.values()
            ):
                raise _queue.Full
            rank = 1
            if self.promote_after_s > 0:
                rank = _CLASS_RANK.get(req.slo_class, 1)
            self._lanes[rank].append((self._clock(), req))

    def get_nowait(self) -> Any:
        with self._lock:
            now = self._clock()
            pick: Optional[int] = None
            promoted = False
            if self.promote_after_s > 0:
                # Starvation bound first: among heads past the promotion
                # age, the oldest wins whatever its class.
                oldest: Optional[float] = None
                for rank, lane in self._lanes.items():
                    if not lane:
                        continue
                    at = lane[0][0]
                    if now - at > self.promote_after_s and (
                        oldest is None or at < oldest
                    ):
                        oldest, pick = at, rank
                promoted = pick is not None
            if pick is None:
                pick = next((r for r in (0, 1, 2) if self._lanes[r]), None)
            if pick is None:
                raise _queue.Empty
            lane = self._lanes[pick]
            if self._prefix_probe is not None and not promoted:
                for i in range(min(len(lane), self.PREFIX_SCAN)):
                    try:
                        hit = bool(self._prefix_probe(lane[i][1]))
                    except Exception:  # a probe's fault must not wedge dequeue
                        hit = False
                    if hit:
                        if i == 0:
                            break
                        req = lane[i][1]
                        del lane[i]
                        return req
            return lane.popleft()[1]


def coalesce_deadline(
    deadline: Optional[Deadline], deadline_s: Optional[float]
) -> Optional[Deadline]:
    """An explicit Deadline wins (it may ride a test clock); otherwise a
    relative budget becomes one on the real monotonic clock."""
    if deadline is not None:
        return deadline
    if deadline_s is not None:
        return Deadline.after(float(deadline_s))
    return None


#: The SLO-class vocabulary (bounded: it appears in metric labels).
SLO_CLASSES = ("interactive", "standard", "batch")


def normalize_slo_class(value: str) -> str:
    """Clamp a request-controlled class string to the vocabulary ("" when
    it names no known class: the caller falls back to the tenant's
    default, then ``standard``)."""
    v = str(value or "").strip().lower()
    return v if v in SLO_CLASSES else ""


def parse_tenant_class_map(spec: str) -> Mapping[str, str]:
    """``"acme=batch,ops=interactive"`` → each tenant's default SLO class.
    Unknown class names are dropped; tenant keys are lower-cased (the
    lookup is case-insensitive)."""
    out: dict[str, str] = {}
    for entry in str(spec or "").replace(";", ",").split(","):
        entry = entry.strip()
        if not entry or "=" not in entry:
            continue
        tenant, cls = entry.split("=", 1)
        cls = normalize_slo_class(cls)
        if tenant.strip() and cls:
            out[tenant.strip().lower()] = cls
    return out
