"""Trace exporters (reference ``exporter.go:22-130`` + ``gofr.go:250-300``).

Completed spans are queued and shipped by a background daemon thread in
JSON batches. Two wire formats, matching the reference's distinct sinks:

* **Zipkin JSON** — the shape of the reference's custom/zipkin exporters
  (``exporter.go:58-96`` builds ``[{id, traceId, parentId, name,
  timestamp, duration, tags}]``; zipkin at ``gofr.go:282``).
* **OTLP/HTTP JSON** — the reference treats jaeger as its own
  OTLP exporter (``gofr.go:277-286``, OTLP-gRPC); here jaeger maps to
  the standard OTLP/HTTP transport (``/v1/traces``,
  ``ExportTraceServiceRequest`` JSON) that jaeger ≥1.35 ingests natively
  on :4318 — a distinct protocol, not a zipkin alias.

Console and noop exporters cover dev/test. Selection mirrors the
reference's env switch (``gofr.go:251-253``): ``TRACE_EXPORTER`` ∈
{zipkin, gofr, jaeger, otlp, console, none} + ``TRACER_URL``.

The port's copy of ``gofr_tpu/tracing/exporter.py``.
"""

from __future__ import annotations

import json
import queue
import threading
import urllib.request
from typing import Any

from gofr_tpu_torch.tracing.tracer import Span


class NoopExporter:
    #: Lets callers (serving/observability.py) skip span construction
    #: entirely when completed spans would go nowhere.
    is_noop = True

    def export(self, span: Span, service_name: str) -> None:  # noqa: ARG002
        pass

    def shutdown(self) -> None:
        pass


class ConsoleExporter:
    def __init__(self, logger: Any = None) -> None:
        self._logger = logger

    def export(self, span: Span, service_name: str) -> None:
        line = {
            "traceId": span.trace_id,
            "id": span.span_id,
            "parentId": span.parent_id,
            "name": span.name,
            "durationUs": span.duration_us,
            "service": service_name,
            "tags": {str(k): str(v) for k, v in span.attributes.items()},
        }
        if self._logger is not None:
            self._logger.debug(line)
        else:
            print(json.dumps(line))


class _BatchingHTTPExporter:
    """Queue + daemon-thread batching over an HTTP POST sink (reference
    ``exporter.go:48-130``). Subclasses define ``_convert`` (span → wire
    dict) and ``_encode`` (batch → request body)."""

    def __init__(
        self,
        url: str,
        logger: Any = None,
        batch_size: int = 64,
        flush_interval_s: float = 2.0,
    ) -> None:
        self._url = url
        self._logger = logger
        self._batch_size = batch_size
        self._interval = flush_interval_s
        self._queue: "queue.Queue[tuple[Span, str]]" = queue.Queue(
            maxsize=4096
        )
        self._stop = threading.Event()
        self._failed_once = False
        self._thread = threading.Thread(target=self._run, name="trace-exporter", daemon=True)
        self._thread.start()

    def export(self, span: Span, service_name: str) -> None:
        try:
            self._queue.put_nowait((span, service_name))
        except queue.Full:
            pass  # drop rather than block the request path

    def _convert(self, span: Span, service_name: str) -> dict:
        raise NotImplementedError

    def _encode(self, batch: list[dict]) -> bytes:
        raise NotImplementedError

    def _run(self) -> None:
        batch: list[dict] = []
        while not self._stop.is_set():
            try:
                span, svc = self._queue.get(timeout=self._interval)
                batch.append(self._convert(span, svc))
            except queue.Empty:
                pass
            if batch and (len(batch) >= self._batch_size or self._queue.empty()):
                self._post(batch)
                batch = []
        while not self._queue.empty():
            span, svc = self._queue.get_nowait()
            batch.append(self._convert(span, svc))
        if batch:
            self._post(batch)

    def _post(self, batch: list[dict]) -> None:
        try:
            req = urllib.request.Request(
                self._url,
                data=self._encode(batch),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            urllib.request.urlopen(req, timeout=5).read()
        except Exception as exc:
            if self._logger is not None:
                # First failure at ERROR so a misconfigured sink (wrong
                # protocol/endpoint → every batch dropped) is visible at
                # default log level; repeats stay at debug.
                if not self._failed_once:
                    self._failed_once = True
                    self._logger.errorf(
                        "trace export to %s failed (further failures "
                        "logged at debug): %s", self._url, exc,
                    )
                else:
                    self._logger.debugf("trace export failed: %s", exc)

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


class ZipkinExporter(_BatchingHTTPExporter):
    """Zipkin-JSON HTTP exporter (reference ``exporter.go:58-96`` shape;
    also serves the hosted "gofr" sink, ``exporter.go:22-33``)."""

    def _convert(self, span: Span, service_name: str) -> dict:
        out: dict[str, Any] = {
            "traceId": span.trace_id,
            "id": span.span_id,
            "name": span.name,
            "timestamp": span.start_ns // 1000,
            "duration": span.duration_us,
            "localEndpoint": {"serviceName": service_name},
            "tags": {str(k): str(v) for k, v in span.attributes.items()},
        }
        if span.parent_id:
            out["parentId"] = span.parent_id
        return out

    def _encode(self, batch: list[dict]) -> bytes:
        return json.dumps(batch).encode()


class OTLPExporter(_BatchingHTTPExporter):
    """OTLP/HTTP JSON trace exporter (the reference's jaeger sink is OTLP,
    ``gofr.go:277-286``; jaeger ingests OTLP/HTTP natively on :4318
    ``/v1/traces``). Emits ``ExportTraceServiceRequest`` JSON:
    resourceSpans → scopeSpans → spans, with OTel AnyValue attributes."""

    _STATUS_CODES = {"OK": 1, "ERROR": 2}

    def _convert(self, span: Span, service_name: str) -> dict:
        # Exact end timestamp when the span was properly ended; derive
        # from duration only as a fallback.
        end_ns = span.end_ns or (span.start_ns + span.duration_us * 1000)
        out: dict[str, Any] = {
            "traceId": span.trace_id,
            "spanId": span.span_id,
            "name": span.name,
            # Root spans are server entry points; child spans (ctx.trace)
            # are INTERNAL — span-kind-based processors (spanmetrics,
            # service graphs) count SERVER spans as requests.
            "kind": 1 if span.parent_id else 2,
            "startTimeUnixNano": str(span.start_ns),
            "endTimeUnixNano": str(end_ns),
            "attributes": [
                {"key": str(k), "value": {"stringValue": str(v)}}
                for k, v in span.attributes.items()
            ],
            "status": {
                "code": self._STATUS_CODES.get(
                    getattr(span, "status", "OK"), 0
                )
            },
            "_service": service_name,  # grouped by _encode, then dropped
        }
        if span.parent_id:
            out["parentSpanId"] = span.parent_id
        return out

    def _encode(self, batch: list[dict]) -> bytes:
        by_service: dict[str, list[dict]] = {}
        for span in batch:
            svc = span.pop("_service", "unknown")
            by_service.setdefault(svc, []).append(span)
        return json.dumps({
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": [{
                            "key": "service.name",
                            "value": {"stringValue": svc},
                        }],
                    },
                    "scopeSpans": [{
                        "scope": {"name": "gofr-tpu"},
                        "spans": spans,
                    }],
                }
                for svc, spans in by_service.items()
            ],
        }).encode()


def exporter_from_config(config: Any, logger: Any = None) -> Any:
    """Reference ``gofr.go:250-300``: TRACE_EXPORTER + TRACER_URL select the
    sink — zipkin/gofr speak Zipkin JSON, jaeger/otlp speak OTLP/HTTP."""
    name = (config.get_or_default("TRACE_EXPORTER", "") or "").lower()
    url = config.get_or_default("TRACER_URL", "")
    if name in ("jaeger", "otlp") and url:
        # OTLP/HTTP's trace path is fixed; default it so TRACER_URL can be
        # just the collector base (e.g. http://jaeger:4318).
        from urllib.parse import urlparse

        if urlparse(url).path in ("", "/"):
            url = url.rstrip("/") + "/v1/traces"
        return OTLPExporter(url, logger=logger)
    if name in ("zipkin", "gofr") and url:
        return ZipkinExporter(url, logger=logger)
    if name == "console":
        return ConsoleExporter(logger=logger)
    return NoopExporter()
