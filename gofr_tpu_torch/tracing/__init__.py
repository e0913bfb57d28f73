"""Distributed tracing (reference: OTel wiring in ``gofr.go:250-300`` +
``http/middleware/tracer.go``).

A lightweight native tracer: W3C ``traceparent`` propagation and
contextvar-scoped spans. The port's copy of ``gofr_tpu/tracing``'s
tracer; the batch exporters (``gofr_tpu/tracing/exporter.py``) wait for
the operations plane (ROADMAP Queue 1 item 7), so spans end in-process.
"""

from gofr_tpu_torch.tracing.tracer import (
    Span,
    Tracer,
    current_span,
    extract_traceparent,
    get_tracer,
    set_tracer,
    tracer_active,
)

__all__ = [
    "Span",
    "Tracer",
    "current_span",
    "get_tracer",
    "set_tracer",
    "extract_traceparent",
    "tracer_active",
]
