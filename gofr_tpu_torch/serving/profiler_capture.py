"""The device-trace capture singleton — the port's copy of
``gofr_tpu/serving/profiler_capture.py``, with ``torch.profiler`` in
place of ``jax.profiler``.

The profiler is a process-wide resource: one trace may run at a time,
and every capture writes its output on stop. The machinery lives here as
ONE process-wide :class:`ProfilerCapture` (:func:`get_capture`):

* **One trace dir, one lock, created at construction.** Every capture
  writes the same Chrome trace file in it (``trace.json``: CPU and, on
  the card, CUDA activity), so repeated captures cannot fill the disk.
* **Cooldown for auto-triggers**: a stall *storm* would otherwise
  re-trigger a capture per anomaly and thrash the profiler.
  :meth:`trigger` suppresses anything inside the cooldown (counted); a
  manual capture is never cooldown-gated but notes itself so the next
  auto-trigger backs off from it.
* **Non-blocking for the scheduler.** ``trigger`` hands the bounded
  capture to a daemon thread and returns immediately; the capture spans
  about ``ms``.
* **Started and stopped on the thread that drives the device.** Each
  engine registers itself while its scheduler thread runs
  (:func:`note_device_owner`). A capture then hands its profiler start and
  stop to that thread, which runs them at the top of its loop, between two
  passes (``run_between_passes``), and writes the trace on its own thread.
  On an H100 a ``torch.profiler`` capture begun on another thread while
  the scheduler replayed CUDA graphs took 7.6-11.8 s, traced no kernel,
  and once hung the process; begun between two of the scheduler's own
  passes it traces the replayed windows' kernels (PERF.md).

Clock, sleep, the start/stop callables and the thread spawn are all
injectable, so the cooldown and concurrency contracts are tested with
stated time and synchronous spawns.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
import weakref
from typing import Any, Callable, Optional

from gofr_tpu_torch.analysis import lockcheck


class ProfilerCapture:
    """One process-wide ``torch.profiler`` capture slot: a reusable trace
    directory, a non-blocking busy lock, and an auto-trigger cooldown.
    Construct via :func:`get_capture` — a second instance would defeat
    the whole point."""

    def __init__(
        self,
        *,
        cooldown_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        starter: Optional[Callable[[str], None]] = None,
        stopper: Optional[Callable[[], None]] = None,
        spawn: Optional[Callable[[Callable[[], None]], None]] = None,
        logger: Any = None,
    ) -> None:
        #: One reusable directory per process; every capture overwrites
        #: the last, so repeated captures cannot fill the disk.
        self.trace_dir = tempfile.mkdtemp(prefix="tpu-trace-")
        self.cooldown_s = max(0.0, float(cooldown_s))
        self._clock = clock
        self._sleep = sleep
        self._starter = starter
        self._stopper = stopper
        self._spawn = spawn
        self._logger = logger
        self._profile: Any = None
        # The capture slot: held for the duration of one trace. A
        # threading (not asyncio) lock — the auto-trigger fires from
        # the scheduler thread; the async endpoint polls it
        # non-blocking and replies 409 instead of queueing.
        self._busy = lockcheck.make_lock("ProfilerCapture._busy")
        # Bookkeeping (counters + cooldown anchor) under its own lock
        # so trigger() stays race-free against note_manual_capture().
        self._state_lock = lockcheck.make_lock("ProfilerCapture._state_lock")
        self.captures = 0
        self.suppressed = 0
        self.last_capture_at: Optional[float] = None
        self.last_reason = ""
        self.last_error = ""

    # -- the capture slot ----------------------------------------------

    def try_acquire(self) -> bool:
        """Claim the capture slot without blocking (False = a capture
        is already running — the endpoint's 409)."""
        return self._busy.acquire(blocking=False)

    def release(self) -> None:
        self._busy.release()

    @property
    def busy(self) -> bool:
        return self._busy.locked()

    # -- profiler plumbing ---------------------------------------------

    @property
    def trace_file(self) -> str:
        """The Chrome trace every capture (re)writes."""
        return os.path.join(self.trace_dir, "trace.json")

    def start_trace(self) -> None:
        """Start a trace (CPU activity, and CUDA on the card) whose output
        :meth:`stop_trace` writes into the singleton dir. On the calling
        thread: ``trigger`` calls it on the engine's scheduler thread."""
        if self._starter is not None:
            self._starter(self.trace_dir)
            return
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profile = torch.profiler.profile(activities=activities)
        self._profile.start()

    def stop_trace(self) -> None:
        self._export(self._halt())

    def _halt(self) -> Any:
        """Stop the running trace (``trigger``: on the thread that started
        it); returns what ``_export`` writes."""
        if self._stopper is not None:
            self._stopper()
            return None
        prof, self._profile = self._profile, None
        if prof is None:
            raise RuntimeError("stop_trace without a running trace")
        prof.stop()
        return prof

    def _export(self, prof: Any) -> None:
        if prof is not None:
            prof.export_chrome_trace(self.trace_file)

    def note_manual_capture(self) -> None:
        """Record an endpoint-driven capture (counts, cooldown anchor):
        the next auto-trigger backs off from a trace the operator just
        took rather than stacking a second one onto the same incident."""
        with self._state_lock:
            self.captures += 1
            self.last_capture_at = self._clock()
            self.last_reason = "manual"

    def capture(self, ms: int) -> None:
        """One bounded capture of ``ms`` milliseconds, blocking; the caller
        holds the slot. While an engine's scheduler runs, the profiler
        starts and stops on that thread, between two passes; else on the
        calling thread. The trace is written on the calling thread.
        ``/debug/tpu-trace`` and :meth:`trigger` both capture here."""
        owner = device_owner()
        on_owner = (
            (lambda fn: owner.run_between_passes(fn, timeout=HANDOFF_TIMEOUT_S))
            if owner is not None else (lambda fn: fn())
        )
        on_owner(self.start_trace)
        self._sleep(ms / 1e3)
        self._export(on_owner(self._halt))

    # -- anomaly auto-trigger ------------------------------------------

    def trigger(self, ms: int, reason: str = "loop-stall") -> bool:
        """Fire-and-forget bounded capture for a loop anomaly: claims
        the slot and spawns the capture off-thread, or returns False
        when inside the cooldown / already busy (both counted as
        suppressed — a stall storm must not thrash the profiler).
        Never blocks the calling (scheduler) thread. While an engine's
        scheduler runs, the profiler starts and stops on that thread,
        between two passes; the trace is written on the capture's own."""
        ms = max(1, int(ms))
        with self._state_lock:
            now = self._clock()
            if (
                self.last_capture_at is not None
                and now - self.last_capture_at < self.cooldown_s
            ):
                self.suppressed += 1
                return False
            if not self.try_acquire():
                self.suppressed += 1
                return False
            self.captures += 1
            self.last_capture_at = now
            self.last_reason = reason

        def run() -> None:
            try:
                self.capture(ms)
                with self._state_lock:
                    self.last_error = ""
            except Exception as exc:  # noqa: BLE001 — a failed capture must never take the scheduler with it
                with self._state_lock:
                    self.last_error = f"{type(exc).__name__}: {exc}"
                if self._logger is not None:
                    self._logger.warnf(
                        "loop-anomaly trace capture failed: %s", exc
                    )
            finally:
                self.release()

        if self._spawn is not None:
            self._spawn(run)
        else:
            threading.Thread(
                target=run, name="tpu-trace-capture", daemon=True
            ).start()
        return True

    # -- rendering -----------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        with self._state_lock:
            return {
                "trace_dir": self.trace_dir,
                "busy": self.busy,
                "cooldown_s": self.cooldown_s,
                "captures": self.captures,
                "suppressed": self.suppressed,
                "last_reason": self.last_reason,
                "last_error": self.last_error,
            }


# How long a capture waits for the scheduler to take its start or stop
# (a pass lasts well under a second).
HANDOFF_TIMEOUT_S = 30.0

# The owners (engines) whose scheduler thread drives the device right now,
# in registration order. An owner offers ``run_between_passes(fn,
# timeout)``: ``fn`` run on its scheduler thread between two passes.
_device_owners: "weakref.WeakValueDictionary[int, Any]" = weakref.WeakValueDictionary()
_owners_lock = lockcheck.make_lock("profiler_capture._owners_lock")


def note_device_owner(owner: Any, live: bool) -> None:
    """Register (``live``) or drop ``owner`` as driving the device."""
    with _owners_lock:
        if live:
            _device_owners[id(owner)] = owner
        elif _device_owners.get(id(owner)) is owner:
            del _device_owners[id(owner)]


def device_owner() -> Optional[Any]:
    """The first registered owner still alive, or None. With several
    engines serving, the capture rides the first one's scheduler."""
    with _owners_lock:
        for owner in _device_owners.values():
            return owner
    return None


_warm = {"done": False}
_warm_lock = lockcheck.make_lock("profiler_capture._warm_lock")


def warm_up(device: Any) -> None:
    """Attach ``torch.profiler``'s CUDA tracing once in the process: a
    short profile around one small kernel on ``device``. The engine's
    constructor calls it, on the constructing thread, before the scheduler
    captures its CUDA graphs, so the tracer is not first attached while
    graphs replay, nor on the scheduler thread."""
    import torch

    with _warm_lock:
        if _warm["done"] or torch.device(device).type != "cuda":
            return
        _warm["done"] = True
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.ones(8, device=device).add_(1)
            torch.cuda.synchronize(device)


_capture: Optional[ProfilerCapture] = None
_capture_lock = lockcheck.make_lock("profiler_capture._capture_lock")


def get_capture(cooldown_s: Optional[float] = None) -> ProfilerCapture:
    """The process-wide singleton, constructed exactly once under a
    module lock (two concurrent first callers can never mint two
    dirs/locks and trace concurrently). ``cooldown_s`` updates the
    auto-trigger cooldown when given (the reference's engine passes its
    ``TPU_LOOP_TRACE_COOLDOWN_S``; the port's loop profiler, ROADMAP
    Queue 1 item 7.2, is not ported yet)."""
    global _capture
    with _capture_lock:
        if _capture is None:
            _capture = ProfilerCapture()
        if cooldown_s is not None:
            _capture.cooldown_s = max(0.0, float(cooldown_s))
        return _capture
