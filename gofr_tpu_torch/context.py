"""Per-request Context (reference ``pkg/gofr/context.go:12-27``).

The facade handlers receive: request access (params, bind), the container's
datasources (``ctx.sql``, ``ctx.redis``, ``ctx.tpu``…), logger, metrics,
custom spans via ``ctx.trace(name)`` (reference ``context.go:45-51``), and
the net-new ``ctx.infer(...)`` primitive that submits work to the dynamic
batcher (SURVEY §2.6 maps it onto ``c.SQL.Select``-style convenience).

The port's copy of ``gofr_tpu/context.py``. ``http_service`` reads
``None`` until the service clients come (ROADMAP Queue 1 item 2.5), as in
a reference container with none registered.
"""

from __future__ import annotations

from typing import Any, Optional

from gofr_tpu_torch.tracing import get_tracer


class Context:
    def __init__(self, request, container, responder=None, span=None) -> None:
        self.request = request
        self.container = container
        self._responder = responder
        self._span = span

    # -- request passthrough ----------------------------------------------

    def param(self, key: str) -> str:
        return self.request.param(key)

    def params(self, key: str) -> list[str]:
        return self.request.params(key)

    def path_param(self, key: str) -> str:
        return self.request.path_param(key)

    def bind(self, target: Any) -> Any:
        return self.request.bind(target)

    def header(self, key: str) -> Optional[str]:
        return self.request.header(key) if hasattr(self.request, "header") else None

    def get(self, key: str, default: Any = None) -> Any:
        """Request-scoped values set by middleware (JWT claims, auth user)."""
        raw = getattr(self.request, "raw", None)
        if raw is not None:
            return raw.ctx_data.get(key, default)
        return default

    # -- request lifecycle (serving/lifecycle.py) -------------------------

    @property
    def deadline(self):
        """The request's Deadline (X-Request-Timeout header or gRPC
        deadline), or None. Handlers pass it to engine submits so
        expired requests retire mid-decode."""
        return self.get("deadline")

    @property
    def cancel_token(self):
        """The request's CancelToken — tripped by the server when the
        client disconnects mid-request. Share it with engine submits so
        abandoned generations free their KV blocks."""
        return self.get("cancel")

    # -- container passthrough --------------------------------------------

    @property
    def logger(self):
        return self.container.logger

    @property
    def metrics(self):
        return self.container.metrics

    @property
    def config(self):
        return self.container.config

    @property
    def sql(self):
        return self.container.sql

    @property
    def redis(self):
        return self.container.redis

    @property
    def pubsub(self):
        return self.container.pubsub

    @property
    def mongo(self):
        return self.container.mongo

    @property
    def tpu(self):
        return self.container.tpu

    def http_service(self, name: str):
        """Registered inter-service client (reference ``container.GetHTTPService``)."""
        return self.container.get_http_service(name)

    def publish(self, topic: str, message: bytes) -> None:
        publisher = self.container.get_publisher()
        if publisher is None:
            raise RuntimeError("no pub/sub backend configured")
        publisher.publish(topic, message)

    # -- tracing (reference context.go:45-51) -----------------------------

    def trace(self, name: str):
        """Open a child span: ``with ctx.trace("work"): ...``"""
        return get_tracer().start_span(name, parent=self._span)

    # -- inference (net-new, SURVEY §2.6) ---------------------------------

    async def infer(self, inputs: Any, model: str = "", **kw) -> Any:
        """Submit inputs to the TPU backend's dynamic batcher and await the
        result. Usable from async handlers; sync handlers use
        ``infer_sync``."""
        if self.container.tpu is None:
            raise RuntimeError("no TPU backend configured (set TPU_MODEL)")
        return await self.container.tpu.infer(inputs, model=model, **kw)

    def infer_sync(self, inputs: Any, model: str = "", **kw) -> Any:
        if self.container.tpu is None:
            raise RuntimeError("no TPU backend configured (set TPU_MODEL)")
        return self.container.tpu.infer_sync(inputs, model=model, **kw)
