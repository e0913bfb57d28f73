"""Runtime lock-discipline validator — the port's copy of
``gofr_tpu/analysis/lockcheck.py``, with the same API and the same
``TPU_LOCKCHECK`` switch.

Set ``TPU_LOCKCHECK=1`` and every serving lock built through
:func:`make_lock` becomes an instrumented wrapper that records, per
thread, the stack of locks currently held, and checks two invariants at
each acquisition:

* **no order inversion** — acquiring ``B`` while holding ``A`` adds the
  edge ``A→B`` to a process-wide order graph; if a path ``B→…→A`` was
  ever observed (any thread, any time), the acquisition is recorded as
  a violation: under the wrong interleaving those two threads deadlock.
  Edges persist for the process lifetime, so the two halves of an
  inversion need not collide in time to be caught — one run of each
  path suffices.
* **no device sync while holding a lock** — the designated device-wait
  seams call :func:`note_device_sync`; reaching one with any
  instrumented lock held is recorded (a device wait under the submit
  lock convoys every submitting thread behind the device).

A blocking re-acquisition of a lock the same thread already holds would
*deadlock the test run*, so that case raises :class:`LockCheckError`
immediately instead of recording and hanging. The instrumented lock is a
plain mutex only: a reentrant lock (the engine's ``_device_lock``) is
built outside this module and is not checked.

Violations are **recorded, not raised**, at the point of detection
(raising mid-hold would poison unrelated teardown): a test asserts
:func:`violations` is empty after it ran. With ``TPU_LOCKCHECK`` unset
(or ``0``), :func:`make_lock` returns a plain ``threading.Lock`` — the
instrumented path does not exist, so the overhead is exactly zero by
construction.

Cross-thread release is tolerated (``threading.Lock`` allows it, and
the profiler-capture slot is acquired by one thread and released by the
capture thread): release pops the lock from whichever thread's stack
holds it.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Optional, cast


def enabled() -> bool:
    """Is the validator armed (``TPU_LOCKCHECK`` truthy)?"""
    return os.environ.get("TPU_LOCKCHECK", "0").lower() not in (
        "", "0", "false", "no",
    )


class LockCheckError(RuntimeError):
    """Raised only for a blocking self-re-acquisition — the one
    violation that would hang the process if allowed to proceed."""


@dataclass(frozen=True)
class Violation:
    """One recorded invariant breach."""

    kind: str  # "order-inversion" | "device-sync-under-lock" | "self-deadlock"
    message: str
    thread: str
    held: tuple[str, ...]  # the thread's acquisition stack at detection


class _Registry:
    """Process-wide order graph + per-thread acquisition stacks."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # lock name -> names acquired at least once while it was held
        self._edges: dict[str, set[str]] = {}
        # (held, acquired) -> "thread/stack" witness of the first sight
        self._witness: dict[tuple[str, str], str] = {}
        # thread ident -> stack of held InstrumentedLock objects
        self._held: dict[int, list["InstrumentedLock"]] = {}
        self.violations: list[Violation] = []

    # -- helpers (call with self._mu held) -----------------------------

    def _stack(self, ident: Optional[int] = None) -> list["InstrumentedLock"]:
        key = threading.get_ident() if ident is None else ident
        return self._held.setdefault(key, [])

    def _path_exists(self, src: str, dst: str) -> bool:
        seen = {src}
        frontier = [src]
        while frontier:
            cur = frontier.pop()
            if cur == dst:
                return True
            for nxt in self._edges.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return False

    # -- events ---------------------------------------------------------

    def before_acquire(self, lock: "InstrumentedLock") -> None:
        """Blocking-acquire preflight: a self-re-acquisition would hang
        the run, so it raises instead of recording."""
        with self._mu:
            stack = self._stack()
            if lock in stack:
                names = tuple(x.name for x in stack)
                self.violations.append(
                    Violation(
                        kind="self-deadlock",
                        message=(
                            f"blocking re-acquisition of `{lock.name}` "
                            "by the thread already holding it"
                        ),
                        thread=threading.current_thread().name,
                        held=names,
                    )
                )
                raise LockCheckError(
                    f"lockcheck: `{lock.name}` re-acquired (blocking) by "
                    f"{threading.current_thread().name} while held "
                    f"(stack: {' -> '.join(names)}); this would deadlock"
                )

    def note_acquired(self, lock: "InstrumentedLock") -> None:
        with self._mu:
            stack = self._stack()
            thread = threading.current_thread().name
            for holder in stack:
                if holder.name == lock.name:
                    continue
                edge = (holder.name, lock.name)
                fresh = lock.name not in self._edges.setdefault(
                    holder.name, set()
                )
                if fresh:
                    self._edges[holder.name].add(lock.name)
                    self._witness[edge] = (
                        f"{thread}: "
                        + " -> ".join(x.name for x in stack)
                        + f" -> {lock.name}"
                    )
                # Inversion: a path back from the new lock to a holder
                # (excluding the edge just added — that trivial 2-cycle
                # is exactly what we look for, via the REVERSE edge).
                if self._path_exists(lock.name, holder.name):
                    reverse = self._witness.get(
                        (lock.name, holder.name),
                        "a transitive chain observed earlier",
                    )
                    self.violations.append(
                        Violation(
                            kind="order-inversion",
                            message=(
                                f"acquired `{lock.name}` while holding "
                                f"`{holder.name}`, but the opposite "
                                f"order was also observed ({reverse}); "
                                "these threads deadlock under the "
                                "wrong interleaving"
                            ),
                            thread=thread,
                            held=tuple(x.name for x in stack),
                        )
                    )
            stack.append(lock)

    def note_release(self, lock: "InstrumentedLock") -> None:
        with self._mu:
            stack = self._stack()
            if lock in stack:
                stack.remove(lock)
                return
            # Cross-thread release (the capture-slot idiom): pop it
            # from whichever thread still holds it.
            for other in self._held.values():
                if lock in other:
                    other.remove(lock)
                    return

    def clear(self) -> None:
        """Drop violations and the learned order graph IN PLACE.

        Every ``InstrumentedLock`` captures its registry reference at
        construction, so replacing the global registry object would
        orphan all previously minted locks (module-level locks, engine
        fixtures from earlier tests) — their events would land in a
        registry nobody reads.  Per-thread acquisition stacks are kept:
        locks held across the clear must still release-balance.
        """
        with self._mu:
            self._edges.clear()
            self._witness.clear()
            self.violations.clear()

    def note_device_sync(self, what: str) -> None:
        with self._mu:
            stack = self._stack()
            if not stack:
                return
            self.violations.append(
                Violation(
                    kind="device-sync-under-lock",
                    message=(
                        f"device sync `{what}` while holding "
                        + " -> ".join(x.name for x in stack)
                        + "; the device wait convoys every thread "
                        "contending for the lock(s)"
                    ),
                    thread=threading.current_thread().name,
                    held=tuple(x.name for x in stack),
                )
            )


class InstrumentedLock:
    """``threading.Lock``-shaped wrapper reporting to the registry.

    Only the mutex protocol the serving/service code uses is exposed:
    ``acquire``/``release``/``locked`` and the context manager."""

    __slots__ = ("name", "_reg", "_inner")

    def __init__(self, name: str, reg: _Registry) -> None:
        self.name = name
        self._reg = reg
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            self._reg.before_acquire(self)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._reg.note_acquired(self)
        return got

    def release(self) -> None:
        self._reg.note_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self.name} locked={self.locked()}>"


#: Built lazily on the first instrumented make_lock() call; stays None
#: forever when TPU_LOCKCHECK is off, which is what makes the disabled
#: path free: note_device_sync() is one global-is-None test.
_registry: Optional[_Registry] = None
_registry_mu = threading.Lock()


def make_lock(name: str) -> threading.Lock:
    """The serving lock constructor seam.

    Disabled (default): returns a plain ``threading.Lock`` — nothing
    instrumented is built, so there is no overhead to measure. Enabled:
    returns an :class:`InstrumentedLock` registered under ``name``
    (use ``"Class.attr"`` so runtime reports match the static model's
    lock keys)."""
    if not enabled():
        return threading.Lock()
    global _registry
    with _registry_mu:
        if _registry is None:
            _registry = _Registry()
    # The wrapper quacks like threading.Lock for every call site here;
    # the cast keeps annotated attributes (`_lock: threading.Lock`)
    # honest without weakening them to Any.
    return cast(threading.Lock, InstrumentedLock(name, _registry))


def note_device_sync(what: str) -> None:
    """Called at the designated device-wait seams (the scheduler's
    window fetch, the graph capture's device synchronize). Free when the
    validator is off."""
    reg = _registry
    if reg is not None:
        reg.note_device_sync(what)


def violations() -> list[Violation]:
    """Everything recorded so far (empty when disabled)."""
    reg = _registry
    return list(reg.violations) if reg is not None else []


def reset() -> None:
    """Drop recorded violations AND the learned order graph (test
    isolation: one test's lock order must not indict another's).

    Clears the live registry in place — existing ``InstrumentedLock``
    instances hold a reference to it, so swapping in a fresh registry
    would silently disconnect every lock minted before the reset."""
    reg = _registry
    if reg is not None:
        reg.clear()


def order_graph() -> dict:
    """The learned runtime lock-order graph.

    Returns ``{"enabled": bool, "edges": {held: [acquired, ...]},
    "witnesses": {"held -> acquired": "thread: stack"}}``. Edges are
    every ``A→B`` ordering the validator has OBSERVED this process.
    Empty (enabled=False) when ``TPU_LOCKCHECK`` is off."""
    reg = _registry
    if reg is None:
        return {"enabled": False, "edges": {}, "witnesses": {}}
    with reg._mu:
        return {
            "enabled": True,
            "edges": {
                held: sorted(acquired)
                for held, acquired in sorted(reg._edges.items())
                if acquired
            },
            "witnesses": {
                f"{a} -> {b}": w
                for (a, b), w in sorted(reg._witness.items())
            },
        }


def assert_clean() -> None:
    """Raise AssertionError listing every recorded violation."""
    found = violations()
    if found:
        lines = "\n".join(
            f"- [{v.kind}] {v.thread}: {v.message}" for v in found
        )
        raise AssertionError(
            f"lockcheck: {len(found)} lock-discipline violation(s):\n"
            f"{lines}"
        )
