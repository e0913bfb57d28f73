"""Metrics middleware (reference ``http/middleware/metrics.go:21-44``).

Records the ``app_http_response`` histogram labeled by route template
(not raw path — bounded cardinality), method, and status.

The port's copy of ``gofr_tpu/http/middleware/metrics_mw.py``.
"""

from __future__ import annotations

import time


def metrics_middleware(metrics):
    def mw(next_handler):
        async def handler(raw):
            start = time.time()
            resp = await next_handler(raw)
            metrics.record_histogram(
                "app_http_response",
                time.time() - start,
                "path",
                raw.route_template or raw.target.split("?")[0],
                "method",
                raw.method,
                "status",
                str(resp.status),
            )
            return resp

        return handler

    return mw
