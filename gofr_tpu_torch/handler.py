"""Handler adapter + built-in routes (reference ``pkg/gofr/handler.go``).

Wraps a user handler — sync or async ``fn(ctx) -> result`` (errors are
raised, not returned) — into the server's async handler: build the Context,
open the per-handler span (reference ``handler.go:36``), invoke, and let the
Responder shape the wire response. Sync handlers run on a thread pool so
blocking datasource calls don't stall the event loop (the role goroutines
play in the reference).

Built-ins: ``/.well-known/health`` (aggregate container health),
``/.well-known/alive``, favicon (reference ``handler.go:40-64``).

The port's copy of ``gofr_tpu/handler.py``.
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
from typing import Callable

from gofr_tpu_torch.context import Context
from gofr_tpu_torch.http.proto import RawRequest, Response
from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.responder import Responder
from gofr_tpu_torch.tracing import get_tracer


def wrap_handler(fn: Callable, container) -> Callable:
    """User handler → async ``(RawRequest) -> Response``."""

    is_async = inspect.iscoroutinefunction(fn)

    async def handler(raw: RawRequest) -> Response:
        request = Request(raw)
        responder = Responder(method=raw.method)
        span = raw.ctx_data.get("span")
        ctx = Context(request, container, responder, span=span)

        handler_span = get_tracer().start_span("gofr-handler", parent=span)
        try:
            if is_async:
                result = await fn(ctx)
            else:
                loop = asyncio.get_running_loop()
                # Copy context so ctx.trace() in threads parents correctly.
                cv_ctx = contextvars.copy_context()
                result = await loop.run_in_executor(None, cv_ctx.run, fn, ctx)
            error = None
        except Exception as exc:
            result, error = None, exc
            if not hasattr(exc, "status_code"):
                raise  # unexpected → panic-recovery middleware logs + 500
        finally:
            handler_span.end()
        return responder.respond(result, error)

    return handler


# -- built-in routes (reference handler.go:40-64) --------------------------


def health_handler(container):
    async def handler(ctx) -> dict:  # noqa: ARG001
        import asyncio

        # Health aggregation makes blocking HTTP probes to service
        # dependencies; run it off the event loop or a dependency pointing
        # back at this app (reference examples do exactly that) deadlocks.
        return await asyncio.get_running_loop().run_in_executor(
            None, container.health
        )

    return handler


async def alive_handler(ctx) -> dict:  # noqa: ARG001
    return {"status": "UP"}


def favicon_handler(ctx):  # noqa: ARG001
    from gofr_tpu_torch.static import FAVICON

    from gofr_tpu_torch.http.response import File

    return File(content=FAVICON, content_type="image/x-icon")
