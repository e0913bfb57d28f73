"""Deterministic fault injection for the serving core.

The port's copy of ``gofr_tpu/faults/injector.py``. In the port, the
service client fires the ``http.*`` points (``service/client.py``); the
catalog's other points name the seams of the reference's components that
fire them, ported or not, so a test written for the reference arms the
same names.

A :class:`FaultInjector` is a registry of *named injection points* —
the seams the resilience layer must survive — that production code
fires unconditionally and tests arm selectively:

* ``engine.submit``       — inside the submit path, before enqueue
* ``engine.tokenize``     — before the tokenizer encodes a prompt
* ``scheduler.window``    — top of every scheduler loop iteration
* ``scheduler.device_step`` — before a decode/prefill device dispatch
* ``http.request``        — in ``HTTPService.request`` before the wire:
  raise = connect-refused / transport loss; return a ``Response`` =
  canned upstream answer (5xx burst without a socket)
* ``http.stream.open``    — before an SSE stream connects: raise =
  connect-refused; return an iterable = serve the stream from it
* ``http.stream.event``   — per received SSE line: raise = mid-body
  connection reset; return ``"truncate"`` = upstream vanished without
  EOF framing (truncated SSE); a blocking action models a read stall
* ``tier.prefill_done``   — at the prefill→transfer boundary on a
  prefill-tier replica (scheduler, just after finalize): raise = the
  replica failing right as its prefill completes → local fused decode
* ``tier.transfer``       — per tier-transfer attempt in the pool:
  raise = the transfer leg dying mid-ship (retried with backoff, then
  fused fallback on a sibling)
* ``tier.import``         — in ``engine.handoff_prefilled`` on the
  decode replica: raise = the importer rejecting the shipped blocks
  (pool pressure / version mismatch)
* ``transfer.dma.offer``  — in ``DmaTransferServer.offer``
  (``service/dma.py``), before a payload stages for the dma leg:
  raise = the transfer server refusing/unreachable at export time —
  the ladder bans the dma rung and retries the same target via wire
* ``transfer.dma.fetch``  — in ``dma_fetch`` before the data socket
  opens (kwargs ``key``/``address``): raise = connect-refused/reset
  without a socket; raising ``DmaError(kind=...)`` picks the matrix
  row (connect / read / stale) deterministically
* ``transfer.dma.serve``  — server side, after the fetch key is read
  and before the reply frame (kwargs ``key``/``server``): a blocking
  action = a stalled exporter mid-transfer (slow-loris / partition) —
  the importer's read budget must cut the wait; the subprocess chaos
  suite parks a stall here then ``kill -9``s the exporter for the
  died-mid-DMA cell
* ``transfer.source.pull`` — in the pool's remote prefill-source pull
  (``replica_pool._source_prefill``), before the export request
  (kwargs ``source``/``mode``): raise = the source dying between
  discovery and pull — the request must fall back to local prefill
  with zero 5xx
* ``control.signal``      — per control-plane signal read
  (``serving/control_plane.py``; kwarg ``signal`` names it): raise =
  the sensor throwing; return ``"stale"`` = no fresh sample this pass;
  return a float (NaN included) = the sensor lying with that value.
  The control plane's guard must absorb every mode — last-good value,
  then observe-only — without a crash or a 5xx
* ``pubsub.deliver``      — in the async serving plane
  (``serving/async_serving.py``), after a request-topic lease before
  the payload is parsed/admitted (kwargs ``topic``/``message_id``/
  ``attempt``): raise = a broker read error or poison payload — the
  message must nack onto the jittered-backoff redelivery path, never
  be lost
* ``pubsub.publish``      — before a reply or dead-letter publish
  (kwargs ``topic``/``message_id``): raise = the broker rejecting the
  write; the request's lease must survive for redelivery (the reply
  is NOT recorded in the dedup ledger, so the retry republishes)
* ``pubsub.ack``          — before the request-topic ack: raise = the
  consumer dying between publish and ack; the lease expires, the
  broker redelivers, and the dedup ledger must swallow the replay
  without a second reply publish

Unarmed, ``fire`` is one dict read (the serving hot path pays nothing
measurable). Armed, a point either **raises** the configured exception
or **runs** a callable — the callable form is how tests simulate a
stalled device step without sleeping: the action blocks on a
``threading.Event`` the test controls, so every ordering is explicit.

Determinism rules this module enforces by design:

* no randomness — a fault fires on exact hit counts (``after`` skips,
  ``times`` bounds), never probabilistically;
* no timers — "slow" is modeled by test-controlled events, "expired"
  by injectable clocks (``serving/lifecycle.py``), never ``sleep``;
* re-arming a point replaces its registry entry WITHOUT touching an
  in-flight action from the previous arming — the chaos suite
  (``tests/test_supervisor.py``) relies on this to park a thread with a
  stall, then swap in the raise that kills its next iteration.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional


@dataclass
class _ArmedFault:
    point: str
    raises: Optional[BaseException] = None
    action: Optional[Callable[..., Any]] = None
    times: Optional[int] = None  # max fires; None = every hit
    after: int = 0  # skip the first `after` hits
    hits: int = 0
    fired: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock)


class FaultInjector:
    """Thread-safe named-fault registry (one global default below)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._points: dict[str, _ArmedFault] = {}

    # -- arming (test side) --------------------------------------------

    def arm(
        self,
        point: str,
        *,
        raises: Optional[BaseException] = None,
        action: Optional[Callable[..., Any]] = None,
        times: Optional[int] = None,
        after: int = 0,
    ) -> _ArmedFault:
        """Arm ``point``. Exactly one of ``raises``/``action`` must be
        given. ``times`` bounds total fires; ``after`` skips the first N
        hits (e.g. fail the *second* window only)."""
        if (raises is None) == (action is None):
            raise ValueError("arm() needs exactly one of raises= or action=")
        fault = _ArmedFault(
            point=point, raises=raises, action=action, times=times,
            after=after,
        )
        with self._lock:
            self._points[point] = fault
        return fault

    def disarm(self, point: str) -> None:
        with self._lock:
            self._points.pop(point, None)

    def reset(self) -> None:
        with self._lock:
            self._points.clear()

    @contextmanager
    def armed(
        self,
        point: str,
        *,
        raises: Optional[BaseException] = None,
        action: Optional[Callable[..., Any]] = None,
        times: Optional[int] = None,
        after: int = 0,
    ) -> Iterator[_ArmedFault]:
        """``with faults.armed("scheduler.device_step", raises=exc): ...``"""
        fault = self.arm(
            point, raises=raises, action=action, times=times, after=after
        )
        try:
            yield fault
        finally:
            self.disarm(point)

    def fired(self, point: str) -> int:
        """How many times ``point`` actually fired (0 if never armed)."""
        with self._lock:
            fault = self._points.get(point)
        return fault.fired if fault is not None else 0

    # -- firing (production side) --------------------------------------

    def fire(self, point: str, **ctx: Any) -> Any:
        """Called at the injection point. No-op unless armed; armed, it
        raises the configured exception or returns the action's result
        (the action receives ``ctx`` as keyword arguments)."""
        if not self._points:  # fast path: nothing armed anywhere
            return None
        fault = self._points.get(point)
        if fault is None:
            return None
        with fault.lock:
            fault.hits += 1
            if fault.hits <= fault.after:
                return None
            if fault.times is not None and fault.fired >= fault.times:
                return None
            fault.fired += 1
        if fault.action is not None:
            return fault.action(**ctx)
        assert fault.raises is not None
        raise fault.raises


#: Process-wide default injector: production seams fire on it, tests
#: arm it (and MUST disarm — use the ``armed`` context manager).
default_injector = FaultInjector()

fire = default_injector.fire
armed = default_injector.armed
arm = default_injector.arm
disarm = default_injector.disarm
reset = default_injector.reset
fired = default_injector.fired
