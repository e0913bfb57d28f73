"""Span model + W3C traceparent propagation.

Reference behavior being matched: server middleware extracts ``traceparent``
and opens a span per request (``http/middleware/tracer.go:15-32``); handlers
open child spans via ``ctx.Trace(name)`` (``context.go:45-51``); clients
inject ``traceparent`` downstream (``service/new.go:158``).

The port's copy of ``gofr_tpu/tracing/tracer.py`` without
``inject_traceparent`` (the service clients', ROADMAP Queue 1 item 7),
plus a copy of ``tracer_active`` from the reference's
``serving/observability.py`` (the rest of that module is item 7.2).
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from dataclasses import dataclass, field
from types import TracebackType
from typing import Any, Optional

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "gofr_tpu_current_span", default=None
)


def _rand_hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    start_ns: int = 0
    end_ns: Optional[int] = None
    attributes: dict[str, Any] = field(default_factory=dict)
    status: str = "OK"
    _tracer: Optional["Tracer"] = None
    _token: Optional[contextvars.Token[Optional["Span"]]] = None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def set_status(self, status: str) -> None:
        self.status = status

    def end(self) -> None:
        if self.end_ns is not None:
            return
        self.end_ns = time.time_ns()
        if self._token is not None:
            try:
                _current_span.reset(self._token)
            except ValueError:
                _current_span.set(None)
            self._token = None
        if self._tracer is not None:
            self._tracer._on_end(self)

    @property
    def duration_us(self) -> int:
        end = self.end_ns if self.end_ns is not None else time.time_ns()
        return (end - self.start_ns) // 1000

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    # context-manager sugar: `with ctx.trace("name"):`
    def __enter__(self) -> "Span":
        return self

    def __exit__(
        self,
        exc_type: Optional[type[BaseException]],
        exc: Optional[BaseException],
        tb: Optional[TracebackType],
    ) -> None:
        if exc is not None:
            self.set_status("ERROR")
            self.set_attribute("error.message", str(exc))
        self.end()


class Tracer:
    """Creates spans and hands completed ones to an exporter."""

    def __init__(
        self, service_name: str = "gofr-tpu-app", exporter: Any = None
    ) -> None:
        self.service_name = service_name
        self._exporter = exporter
        self._lock = threading.Lock()

    def start_span(
        self,
        name: str,
        parent: Optional[Span] = None,
        trace_id: Optional[str] = None,
        parent_span_id: Optional[str] = None,
        attributes: Optional[dict[str, Any]] = None,
    ) -> Span:
        if parent is None:
            parent = _current_span.get()
        if parent is not None:
            trace_id = parent.trace_id
            parent_span_id = parent.span_id
        span = Span(
            name=name,
            trace_id=trace_id or _rand_hex(16),
            span_id=_rand_hex(8),
            parent_id=parent_span_id,
            start_ns=time.time_ns(),
            attributes=dict(attributes or {}),
            _tracer=self,
        )
        span._token = _current_span.set(span)
        return span

    def emit_span(
        self,
        name: str,
        *,
        trace_id: str,
        parent_span_id: Optional[str] = None,
        start_ns: int,
        end_ns: int,
        attributes: Optional[dict[str, Any]] = None,
        status: str = "OK",
    ) -> Span:
        """Export an already-completed span with explicit timestamps.

        A span reconstructed after the fact (a graph capture's
        ``tpu.compile``, timed on the scheduler thread) is built fully
        ended, never touching the ambient context-var, so the calling
        thread's context is untouched, and goes straight to the
        exporter."""
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=_rand_hex(8),
            parent_id=parent_span_id,
            start_ns=int(start_ns),
            end_ns=int(end_ns),
            attributes=dict(attributes or {}),
            status=status,
            _tracer=None,  # already ended; do not re-enter _on_end
        )
        self._on_end(span)
        return span

    def _on_end(self, span: Span) -> None:
        if self._exporter is not None:
            self._exporter.export(span, self.service_name)

    def shutdown(self) -> None:
        if self._exporter is not None and hasattr(self._exporter, "shutdown"):
            self._exporter.shutdown()


def current_span() -> Optional[Span]:
    return _current_span.get()


_global_tracer = Tracer()


def get_tracer() -> Tracer:
    return _global_tracer


def set_tracer(tracer: Tracer) -> None:
    global _global_tracer
    _global_tracer = tracer


def tracer_active(tracer: Optional[Tracer] = None) -> bool:
    """True when completed spans actually go somewhere (an exporter that
    is not the no-op) — span construction is skipped entirely
    otherwise."""
    t = tracer or get_tracer()
    exporter = getattr(t, "_exporter", None)
    return exporter is not None and not getattr(exporter, "is_noop", False)


def extract_traceparent(
    headers: dict[str, str],
) -> tuple[Optional[str], Optional[str]]:
    """Parse W3C ``traceparent`` → (trace_id, parent_span_id)."""
    tp = headers.get("traceparent", "")
    parts = tp.split("-")
    if len(parts) == 4 and len(parts[1]) == 32 and len(parts[2]) == 16:
        return parts[1], parts[2]
    return None, None


def inject_traceparent(
    headers: dict[str, str], span: Optional[Span] = None
) -> dict[str, str]:
    span = span or current_span()
    if span is not None:
        headers["traceparent"] = span.traceparent()
    return headers
