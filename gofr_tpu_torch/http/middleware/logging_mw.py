"""Request logging + panic recovery middleware
(reference ``http/middleware/logger.go:16-146``).

* logs a structured ``RequestLog`` (trace id, ip, method, uri, status,
  response time) after each request;
* surfaces the trace id as ``X-Correlation-ID`` (reference ``logger.go:80``);
* recovers handler/middleware exceptions into a 500 JSON envelope with the
  stack logged (reference ``logger.go:121-146``).

The port's copy of ``gofr_tpu/http/middleware/logging_mw.py``.
"""

from __future__ import annotations

import json
import time
import traceback
from dataclasses import dataclass

from gofr_tpu_torch.http.proto import Response


@dataclass
class RequestLog:
    trace_id: str
    span_id: str
    start_time: str
    response_time_us: int
    method: str
    ip: str
    uri: str
    response: int

    def to_log_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "start_time": self.start_time,
            "response_time": self.response_time_us,
            "method": self.method,
            "ip": self.ip,
            "uri": self.uri,
            "response": self.response,
        }

    def pretty_print(self, fp) -> None:
        # Colorized terminal line (reference logger.go:102-115).
        color = 32 if self.response < 400 else (33 if self.response < 500 else 31)
        fp.write(
            f"\x1b[{color}m{self.response}\x1b[0m "
            f"{self.response_time_us:>8}µs {self.method:>6} {self.uri} "
            f"(trace {self.trace_id})\n"
        )


def logging_middleware(logger):
    def mw(next_handler):
        async def handler(raw):
            start = time.time()
            span = raw.ctx_data.get("span")
            trace_id = span.trace_id if span is not None else ""
            span_id = span.span_id if span is not None else ""
            try:
                resp = await next_handler(raw)
            except Exception:
                logger.errorf(
                    "panic recovered in handler %s %s:\n%s",
                    raw.method,
                    raw.target,
                    traceback.format_exc(),
                )
                resp = Response(
                    status=500,
                    headers={"Content-Type": "application/json"},
                    body=json.dumps(
                        {"error": {"message": "some unexpected error has occurred"}}
                    ).encode(),
                )
            if trace_id:
                resp.set_header("X-Correlation-ID", trace_id)
            elapsed_us = int((time.time() - start) * 1e6)
            ip = raw.headers.get("x-forwarded-for")
            if not ip and raw.peer:
                ip = f"{raw.peer[0]}:{raw.peer[1]}"
            log = RequestLog(
                trace_id=trace_id,
                span_id=span_id,
                start_time=time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(start)),
                response_time_us=elapsed_us,
                method=raw.method,
                ip=ip or "",
                uri=raw.target,
                response=resp.status,
            )
            if resp.status >= 500:
                logger.error(log)
            else:
                logger.info(log)
            return resp

        return handler

    return mw
