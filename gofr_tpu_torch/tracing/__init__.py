"""Distributed tracing (reference: OTel wiring in ``gofr.go:250-300`` +
``http/middleware/tracer.go`` + ``exporter.go``).

A lightweight native tracer: W3C ``traceparent`` propagation,
contextvar-scoped spans, and pluggable batch exporters (console,
Zipkin-JSON and OTLP/HTTP-JSON over HTTP, ``TRACE_EXPORTER``). The port's
copy of ``gofr_tpu/tracing``.
"""

from gofr_tpu_torch.tracing.exporter import (
    ConsoleExporter,
    NoopExporter,
    OTLPExporter,
    ZipkinExporter,
    exporter_from_config,
)
from gofr_tpu_torch.tracing.tracer import (
    Span,
    Tracer,
    current_span,
    extract_traceparent,
    get_tracer,
    inject_traceparent,
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
    "inject_traceparent",
    "tracer_active",
    "ConsoleExporter",
    "NoopExporter",
    "OTLPExporter",
    "ZipkinExporter",
    "exporter_from_config",
]
