"""Tracer middleware (reference ``http/middleware/tracer.go:15-32``).

Extracts the W3C ``traceparent`` header and opens a span named
``"METHOD /route"`` for the request; the span rides the request's
``ctx_data`` for downstream middleware/handlers.

The port's copy of ``gofr_tpu/http/middleware/tracer.py``.
"""

from __future__ import annotations

from gofr_tpu_torch.tracing import extract_traceparent, get_tracer


def tracer_middleware(tracer=None):
    def mw(next_handler):
        async def handler(raw):
            t = tracer or get_tracer()
            trace_id, parent_id = extract_traceparent(raw.headers)
            span = t.start_span(
                f"{raw.method} {raw.route_template or raw.target}",
                trace_id=trace_id,
                parent_span_id=parent_id,
                attributes={"http.method": raw.method, "http.target": raw.target},
            )
            raw.ctx_data["span"] = span
            try:
                resp = await next_handler(raw)
                span.set_attribute("http.status_code", resp.status)
                if resp.status >= 500:
                    span.set_status("ERROR")
                return resp
            finally:
                span.end()

        return handler

    return mw
