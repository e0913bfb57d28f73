"""CORS middleware (reference ``http/middleware/cors.go:6-23``).

Wildcard allow headers on every response; OPTIONS preflight short-circuits
with 200.

The port's copy of ``gofr_tpu/http/middleware/cors.py``.
"""

from __future__ import annotations

from gofr_tpu_torch.http.proto import Response

_CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "GET, POST, PUT, PATCH, DELETE, OPTIONS",
    "Access-Control-Allow-Headers": "Content-Type, Authorization, X-API-KEY, traceparent",
}


def cors_middleware(overrides: dict | None = None):
    headers = {**_CORS_HEADERS, **(overrides or {})}

    def mw(next_handler):
        async def handler(raw):
            if raw.method == "OPTIONS":
                return Response(status=200, headers=dict(headers))
            resp = await next_handler(raw)
            for k, v in headers.items():
                resp.headers.setdefault(k, v)
            return resp

        return handler

    return mw
