"""Circuit breaker option (reference ``service/circuit_breaker.go:12-212``).

Closed → Open after ``threshold`` consecutive failures; while Open, calls
fast-fail with :class:`CircuitOpenError` and a background ticker probes the
health endpoint every ``interval`` seconds to auto-close (reference
``circuit_breaker.go:57-96,106-118``); a request-path probe also closes the
circuit when a live call succeeds after recovery.

The probe ticker is a daemon thread that is **stopped by ``close()``** —
a breaker must not keep probing a service whose client was torn down —
and breaker state is surfaced as the ``app_http_service_circuit_open``
gauge (1 = open) labeled by service address, so dashboards see an open
circuit the moment it opens rather than inferring it from error rates.
The port's copy of ``gofr_tpu/service/circuit_breaker.py``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any

from gofr_tpu_torch.analysis import lockcheck
from gofr_tpu_torch.service.wrapper import ServiceWrapper, innermost


class CircuitOpenError(Exception):
    def __init__(self) -> None:
        super().__init__("circuit breaker is open; service unavailable")
        self.status_code = 503


@dataclass
class CircuitBreakerConfig:
    threshold: int = 5
    interval_s: float = 10.0

    def add_option(self, svc: Any) -> "_CircuitBreakerService":
        return _CircuitBreakerService(svc, self.threshold, self.interval_s)


class _CircuitBreakerService(ServiceWrapper):
    """Wraps an HTTPService; delegates everything else."""

    def __init__(self, inner: Any, threshold: int, interval_s: float) -> None:
        super().__init__(inner)
        self._threshold = threshold
        self._interval = interval_s
        self._lock = lockcheck.make_lock("_CircuitBreakerService._lock")
        self._failures = 0
        self._open = False
        self._opened_at = 0.0
        self._closed = False  # client torn down; no more tickers
        self._stop = threading.Event()
        self._ticker: threading.Thread | None = None

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._open

    def _publish_state(self, open_: bool) -> None:
        """Breaker state gauge, labeled by the wrapped service address."""
        base = innermost(self)
        metrics = getattr(base, "_metrics", None)
        if metrics is not None:
            metrics.set_gauge(
                "app_http_service_circuit_open",
                1.0 if open_ else 0.0,
                "service", getattr(base, "address", "unknown"),
            )

    def _record_success(self) -> None:
        with self._lock:
            self._failures = 0
            was_open, self._open = self._open, False
        if was_open:
            self._publish_state(False)
        self._stop_ticker()

    def note_probe_success(self) -> None:
        """An out-of-band synthetic probe (replica pool's active prober)
        succeeded against the wrapped service: it demonstrably serves
        REAL traffic again, which is stronger evidence than the health
        ticker's liveness poll. Half-open the breaker NOW — reset the
        failure count and let requests flow — instead of making callers
        wait out the remainder of the probe interval on a replica that
        already returned to SERVING. No-op on a closed breaker."""
        self._record_success()

    def _record_failure(self) -> None:
        start_ticker = False
        with self._lock:
            self._failures += 1
            if self._failures >= self._threshold and not self._open:
                self._open = True
                self._opened_at = time.time()
                start_ticker = not self._closed
        if start_ticker:
            self._publish_state(True)
            self._start_ticker()

    def _start_ticker(self) -> None:
        """Health-probe loop to auto-close (reference ``:106-118``).
        Daemon: it must never pin the interpreter open, and ``close()``
        stops it explicitly so it cannot outlive the client either.
        The ``_closed`` re-check and the stop-clear both hold the lock:
        a failure racing ``close()`` could otherwise observe
        ``_closed=False``, lose the lock, and then spawn a ticker whose
        ``_stop.clear()`` undoes close()'s stop signal — resurrecting
        exactly the leak close() exists to prevent."""
        with self._lock:
            if self._closed:
                return
            self._stop.clear()
            self._ticker = threading.Thread(
                target=self._probe_loop, name="circuit-breaker-probe",
                daemon=True,
            )
            self._ticker.start()

    def _stop_ticker(self) -> None:
        self._stop.set()

    def _probe_loop(self) -> None:
        while not self._stop.wait(self._interval):
            if self._healthy():
                self._record_success()
                return

    def _healthy(self) -> bool:
        try:
            return self._inner.health_check().get("status") == "UP"
        except Exception:
            return False

    def close(self) -> None:
        """Stop the probe ticker with the client (the ticker previously
        could outlive it, probing a dead address forever), then close
        the wrapped service."""
        with self._lock:
            self._closed = True
        self._stop.set()
        ticker = self._ticker
        if ticker is not None and ticker.is_alive():
            ticker.join(timeout=5)
        self._ticker = None
        inner_close = getattr(self._inner, "close", None)
        if callable(inner_close):
            inner_close()

    def request(self, method: str, path: str, **kw: Any) -> Any:
        if self.is_open:
            # Recovery probe on the request path (reference :149-156).
            if self._healthy():
                self._record_success()
            else:
                raise CircuitOpenError()
        try:
            resp = self._inner.request(method, path, **kw)
        except Exception:
            self._record_failure()
            raise
        if resp.status_code >= 500:
            self._record_failure()
        else:
            self._record_success()
        return resp
