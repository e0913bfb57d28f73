"""The App (reference ``pkg/gofr/gofr.go:35-170``).

Owns config, container, router, middleware, and the servers. Lifecycle:

* ``App()`` — load ``configs/`` dotenv, create the container (the serving
  engine from ``TPU_*`` keys when ``TPU_MODEL`` is set), initialise
  tracing (reference ``New()``, ``gofr.go:62-96``);
* route verbs ``get/post/put/patch/delete`` usable directly or as
  decorators (reference ``gofr.go:202-219``);
* ``run()`` — start the metrics server (:2121) and the HTTP server
  (:8000), then block until SIGINT/SIGTERM and shut down gracefully
  (``TPU_DRAIN_S`` > 0 drains the engine first).

The port's copy of ``gofr_tpu/app.py::App``, with the auth enablers
(``enable_basic_auth``, ``enable_api_key_auth``, their ``_with_validator``
forms and ``enable_oauth``; reference ``gofr.go:310-344``). Not ported
yet, each with its ROADMAP Queue 1 item: gRPC (``register_service``),
pub/sub (``use_pubsub``, ``subscribe``), ``use_mongo``,
``add_http_service``, ``migrate`` and ``add_rest_handlers`` (item 2); the
trace exporters (``TRACE_EXPORTER``), the async serving plane
(``TPU_ASYNC``) and the ``/debug/*`` surface of the metrics port (item
7). A config that asks for the exporters or the async plane raises
``NotImplementedError``.
"""

from __future__ import annotations

import asyncio
import signal
from typing import Callable, Optional

from gofr_tpu_torch.config.env import new_env_file
from gofr_tpu_torch.container import Container
from gofr_tpu_torch.handler import alive_handler, favicon_handler, health_handler, wrap_handler
from gofr_tpu_torch.http.middleware import (
    JWKSProvider,
    apikey_auth_middleware,
    basic_auth_middleware,
    cors_middleware,
    logging_middleware,
    metrics_middleware,
    oauth_middleware,
    tracer_middleware,
)
from gofr_tpu_torch.http.proto import Response
from gofr_tpu_torch.http.router import Router
from gofr_tpu_torch.http.server import HTTPServer
from gofr_tpu_torch.logging import Logger, level_from_string
from gofr_tpu_torch.metrics import render_prometheus
from gofr_tpu_torch.tracing import Tracer, set_tracer

DEFAULT_HTTP_PORT = 8000
DEFAULT_METRICS_PORT = 2121

_OPS_PLANE = "ROADMAP Queue 1 item 7: the operations plane"


class App:
    def __init__(self, config_dir: str = "./configs", config=None) -> None:
        bootstrap_logger = Logger()
        self.config = config if config is not None else new_env_file(config_dir, bootstrap_logger)
        if self.config.get_or_default("TRACE_EXPORTER", ""):
            raise NotImplementedError(
                "TRACE_EXPORTER is set, but the port's tracer has no exporters "
                f"yet ({_OPS_PLANE}: tracing/exporter.py)"
            )
        if self.config.get_or_default("TPU_ASYNC", "0").strip().lower() not in (
                "", "0", "false", "no"):
            raise NotImplementedError(
                f"TPU_ASYNC is set, but the async serving plane is not ported "
                f"yet ({_OPS_PLANE}: serving/async_serving.py)"
            )
        self.container = Container.create(self.config)
        self.logger = self.container.logger
        self.logger.change_level(
            level_from_string(self.config.get("LOG_LEVEL"), self.logger.level)
        )

        tracer = Tracer(service_name=self.container.app_name)
        set_tracer(tracer)
        self._tracer = tracer

        self.router = Router(logger=self.logger)
        # Default chain, reference http/router.go:23-28.
        self.router.use_middleware(
            tracer_middleware(tracer),
            logging_middleware(self.logger),
            cors_middleware(),
            metrics_middleware(self.container.metrics),
        )

        self.http_port = int(self.config.get_or_default("HTTP_PORT", str(DEFAULT_HTTP_PORT)))
        self.metrics_port = int(
            self.config.get_or_default("METRICS_PORT", str(DEFAULT_METRICS_PORT))
        )
        self._http_server: Optional[HTTPServer] = None
        self._metrics_server: Optional[HTTPServer] = None
        self._stop_event: Optional[asyncio.Event] = None

    # -- routing (reference gofr.go:202-227) -------------------------------

    def add_route(self, method: str, path: str, handler: Callable) -> None:
        self.router.add(method, path, wrap_handler(handler, self.container))

    def _verb(self, method: str, path: str, handler: Optional[Callable]):
        if handler is not None:
            self.add_route(method, path, handler)
            return handler

        def decorator(fn: Callable):
            self.add_route(method, path, fn)
            return fn

        return decorator

    def get(self, path: str, handler: Optional[Callable] = None):
        return self._verb("GET", path, handler)

    def post(self, path: str, handler: Optional[Callable] = None):
        return self._verb("POST", path, handler)

    def put(self, path: str, handler: Optional[Callable] = None):
        return self._verb("PUT", path, handler)

    def patch(self, path: str, handler: Optional[Callable] = None):
        return self._verb("PATCH", path, handler)

    def delete(self, path: str, handler: Optional[Callable] = None):
        return self._verb("DELETE", path, handler)

    def use_middleware(self, *mws) -> None:
        """Custom middleware (reference ``gofr.go:372``)."""
        self.router.use_middleware(*mws)

    # -- auth enablers (reference gofr.go:310-344) -------------------------

    def enable_basic_auth(self, users: dict[str, str]) -> None:
        self.router.use_middleware(basic_auth_middleware(users=users))

    def enable_basic_auth_with_validator(self, validate_func) -> None:
        self.router.use_middleware(
            basic_auth_middleware(validate_func=validate_func, container=self.container))

    def enable_api_key_auth(self, *keys: str) -> None:
        self.router.use_middleware(apikey_auth_middleware(keys=keys))

    def enable_api_key_auth_with_validator(self, validate_func) -> None:
        self.router.use_middleware(
            apikey_auth_middleware(validate_func=validate_func, container=self.container))

    def enable_oauth(self, jwks_url: str, refresh_interval_s: float = 300.0) -> None:
        provider = JWKSProvider(jwks_url, refresh_interval_s, logger=self.logger)
        provider.start()
        self.router.use_middleware(oauth_middleware(jwks=provider))

    # -- lifecycle ----------------------------------------------------------

    def _install_wellknown(self) -> None:
        self.add_route("GET", "/.well-known/health", health_handler(self.container))
        self.add_route("GET", "/.well-known/alive", alive_handler)
        self.add_route("GET", "/favicon.ico", favicon_handler)

    async def start(self) -> None:
        """Bind all servers (ephemeral-port friendly); used by run() and tests."""
        self._install_wellknown()
        self.container.mark_started()

        self._metrics_server = HTTPServer(
            self._metrics_handler(), port=self.metrics_port, logger=self.logger
        )
        await self._metrics_server.start()
        self.metrics_port = self._metrics_server.port
        self.logger.infof("metrics server started on :%d/metrics", self.metrics_port)

        self._http_server = HTTPServer(self.router, port=self.http_port, logger=self.logger)
        await self._http_server.start()
        self.http_port = self._http_server.port

        for engine in (self.container.tpu, self.container.tpu_embed):
            if engine is not None and hasattr(engine, "start"):
                await engine.start()

    async def stop(self) -> None:
        # TPU_DRAIN_S > 0: graceful engine drain — in-flight generations
        # complete (up to the deadline) while new submissions get 503,
        # so a rolling restart doesn't fail live requests.
        drain_s = float(self.config.get_or_default("TPU_DRAIN_S", "0"))
        for engine in (self.container.tpu, self.container.tpu_embed):
            if engine is None or not hasattr(engine, "stop"):
                continue
            import inspect

            if "drain_s" in inspect.signature(engine.stop).parameters:
                await engine.stop(drain_s=drain_s)
            else:  # injected engines without the kwarg
                await engine.stop()
        for server in (self._http_server, self._metrics_server):
            if server is not None:
                await server.shutdown()
        await self.container.close()
        self._tracer.shutdown()

    async def _run_async(self) -> None:
        await self.start()
        self._stop_event = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self._stop_event.set)
            except NotImplementedError:
                pass
        await self._stop_event.wait()
        self.logger.info("shutting down gracefully")
        await self.stop()

    def run(self) -> None:
        """Blocking entrypoint (reference ``gofr.go:114-170``)."""
        try:
            asyncio.run(self._run_async())
        except KeyboardInterrupt:
            pass

    # -- metrics endpoint ---------------------------------------------------

    def _metrics_handler(self):
        container = self.container

        async def handler(raw) -> Response:
            path = raw.target.split("?")[0]
            if path == "/metrics":
                container.push_system_metrics()
                body = render_prometheus(container.metrics, app_name=container.app_name)
                return Response(
                    status=200,
                    headers={"Content-Type": "text/plain; version=0.0.4"},
                    body=body.encode(),
                )
            if path == "/.well-known/alive":
                return Response(
                    status=200,
                    headers={"Content-Type": "application/json"},
                    body=b'{"status":"UP"}',
                )
            return Response(status=404, headers={}, body=b"404 page not found")

        return handler
