"""The App (reference ``pkg/gofr/gofr.go:35-170``).

Owns config, container, router, middleware, and the servers. Lifecycle:

* ``App()`` — load ``configs/`` dotenv, create the container (datasources
  and the serving engine from config), initialise tracing with the
  exporter ``TRACE_EXPORTER`` names (reference ``New()``,
  ``gofr.go:62-96``);
* route verbs ``get/post/put/patch/delete`` usable directly or as
  decorators (reference ``gofr.go:202-219``);
* ``run()`` — start the metrics server (:2121), the HTTP server (:8000),
  the gRPC server (:9000, ``GRPC_PORT``) when a service is registered,
  and the subscriber loops, then block until SIGINT/SIGTERM and shut down
  gracefully (``TPU_DRAIN_S`` > 0 drains the engine first).

The port's copy of ``gofr_tpu/app.py::App``, with the auth enablers
(reference ``gofr.go:310-344``), pub/sub (``use_pubsub``, ``subscribe``),
``use_mongo``, ``migrate``, ``add_rest_handlers``, ``add_http_service``,
``register_service``, ``new_cmd`` and the metrics port's ``/debug/*``
routes whose sources the port has. Not ported yet: the async serving
plane (``TPU_ASYNC``, ROADMAP Queue 1 item 7), which raises
``NotImplementedError`` when a config asks for it. The ``/debug/*`` routes
of item 7's components answer 501 naming it.
"""

from __future__ import annotations

import asyncio
import json
import signal
import sys
import threading
import traceback
import urllib.parse
from typing import Any, Callable, Optional

from gofr_tpu_torch.analysis import lockcheck
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
from gofr_tpu_torch.subscriber import SubscriptionManager
from gofr_tpu_torch.tracing import Tracer, exporter_from_config, set_tracer

DEFAULT_HTTP_PORT = 8000
DEFAULT_METRICS_PORT = 2121
DEFAULT_GRPC_PORT = 9000

_OPS_PLANE = "ROADMAP Queue 1 item 7: the operations plane"


class App:
    def __init__(self, config_dir: str = "./configs", config=None) -> None:
        bootstrap_logger = Logger()
        self.config = config if config is not None else new_env_file(config_dir, bootstrap_logger)
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

        tracer = Tracer(
            service_name=self.container.app_name,
            exporter=exporter_from_config(self.config, self.logger),
        )
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
        self.grpc_port = int(self.config.get_or_default("GRPC_PORT", str(DEFAULT_GRPC_PORT)))
        self._subscriptions = SubscriptionManager(self.container)
        self._grpc_services: list = []
        self._grpc_server = None
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

    def use_mongo(self, client) -> None:
        """Inject a Mongo driver (reference ``gofr.go:376-378``)."""
        self.container.use_mongo(client)

    def use_pubsub(self, client) -> None:
        """Inject a pub/sub client for brokers without bundled drivers."""
        self.container.use_pubsub(client)

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

    # -- pubsub / migrations -------------------------------------------------

    def subscribe(self, topic: str, handler: Optional[Callable] = None):
        """Register a subscription handler (reference ``gofr.go:346-354``)."""
        if handler is not None:
            self._subscriptions.register(topic, handler)
            return handler

        def decorator(fn: Callable):
            self._subscriptions.register(topic, fn)
            return fn

        return decorator

    def add_http_service(self, name: str, address: str, *options) -> None:
        """Register a downstream service client (reference ``gofr.go:189-199``)."""
        from gofr_tpu_torch.service import new_http_service

        if name in self.container.services:
            self.logger.warnf("service %s already registered; overwriting", name)
        self.container.services[name] = new_http_service(
            address,
            self.logger,
            self.container.metrics,
            *options,
        )

    def migrate(self, migrations: dict) -> None:
        """Run versioned migrations (reference ``gofr.go:243-248``)."""
        from gofr_tpu_torch.migration import run as run_migrations

        try:
            run_migrations(migrations, self.container)
        except Exception:
            self.logger.errorf("migration panicked:\n%s", traceback.format_exc())

    def add_rest_handlers(self, entity) -> None:
        """Auto-register CRUD routes for a dataclass entity
        (reference ``gofr.go:356-369``)."""
        from gofr_tpu_torch.crud import register_crud_handlers

        register_crud_handlers(self, entity)

    def register_service(self, add_servicer_fn, servicer) -> None:
        """Register a gRPC service (reference ``gofr.go:55-59``). The server
        starts only if at least one service is registered
        (``gofr.go:150-157``)."""
        self._grpc_services.append((add_servicer_fn, servicer))

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

        if self._grpc_services:
            from gofr_tpu_torch.grpc.server import GRPCServer

            self._grpc_server = GRPCServer(
                self.grpc_port, self.logger, self.container
            )
            for add_fn, servicer in self._grpc_services:
                self._grpc_server.register(add_fn, servicer)
            await self._grpc_server.start()
            self.grpc_port = self._grpc_server.port

        for engine in (self.container.tpu, self.container.tpu_embed):
            if engine is not None and hasattr(engine, "start"):
                await engine.start()

        self._subscriptions.start()

    async def stop(self) -> None:
        await self._subscriptions.stop()
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
        if self._grpc_server is not None:
            await self._grpc_server.stop()
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

        def json_response(status: int, body: Any) -> Response:
            return Response(
                status=status,
                headers={"Content-Type": "application/json"},
                body=json.dumps(body).encode(),
            )

        def engine_report(method: str) -> Response:
            """One JSON ops read per engine (``tpu``, ``tpu_embed``) from an
            engine-shaped ``method()`` report (reference ``app.py:365-390``)."""
            reports: dict = {}
            for name, eng in (("tpu", container.tpu), ("tpu_embed", container.tpu_embed)):
                if eng is None:
                    continue
                fn = getattr(eng, method, None)
                if not callable(fn):
                    continue
                try:
                    reports[name] = fn()
                except Exception as exc:  # noqa: BLE001 — debug surface
                    reports[name] = {"error": str(exc)}
            return json_response(200, reports)

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
            # /debug/* — the ops surface on the metrics port (reference
            # app.py:408-838).
            if path == "/debug/threads":
                names = {t.ident: t.name for t in threading.enumerate()}
                lines = []
                for ident, frame in sys._current_frames().items():
                    lines.append(f"Thread {names.get(ident, '?')} (ident {ident}):")
                    lines.extend(ln.rstrip() for ln in traceback.format_stack(frame))
                    lines.append("")
                return Response(
                    status=200,
                    headers={"Content-Type": "text/plain"},
                    body="\n".join(lines).encode(),
                )
            if path == "/debug/engine":
                return engine_report("health_check")
            if path == "/debug/capacity":
                return engine_report("capacity_report")
            if path == "/debug/lockgraph":
                return json_response(200, _lockgraph())
            if path == "/debug/tpu-trace":
                return await _tpu_trace(raw)
            if path in _UNPORTED_ROUTES:
                return json_response(501, {"error": (
                    f"{path} is not ported yet (ROADMAP Queue 1 "
                    f"{_UNPORTED_ROUTES[path]})")})
            return Response(status=404, headers={}, body=b"404 page not found")

        return handler


# The reference's ops routes that read the operations plane's components,
# each with the ROADMAP entry that ports them: 501 until then.
_UNPORTED_ROUTES = {
    "/debug/flight": "item 7.2: serving/observability.py",
    "/debug/loop": "item 7.2: serving/loop_profiler.py",
    "/debug/tenants": "item 7.3: serving/tenant_ledger.py",
    "/debug/slo": "item 7.3: serving/slo.py",
    "/debug/brownout": "item 7.3: serving/brownout.py",
    "/debug/control": "item 7.3: serving/control_plane.py",
    "/debug/async": "item 7.4: serving/async_serving.py",
    "/ops/tier-import": "item 7.6: tier import",
    "/ops/tier-export": "item 7.6: tier export",
}


def _lockgraph() -> dict:
    """``/debug/lockgraph``: the runtime lock-order graph ``TPU_LOCKCHECK``
    learned in this process beside the static model and their diff
    (reference ``app.py:532-584``). The static half is empty, as the
    reference's is when graftlint cannot run: the port has no graftlint,
    so every runtime edge lands in ``runtime_only``."""
    runtime = lockcheck.order_graph()
    run_edges = {(a, b) for a, bs in runtime["edges"].items() for b in bs}
    return {
        "runtime": runtime,
        "static": {"edges": [], "witnesses": {}},
        "diff": {
            "runtime_only": sorted(f"{a} -> {b}" for a, b in run_edges),
            "static_only": [],
        },
        "violations": [
            {"kind": v.kind, "thread": v.thread, "message": v.message}
            for v in lockcheck.violations()
        ],
    }


async def _tpu_trace(raw) -> Response:
    """``/debug/tpu-trace?ms=N``: one bounded device trace from the
    process-wide capture (reference ``app.py:779-838``): ``ms`` capped at
    30,000, a 409 while a capture runs. The reference starts and stops
    the profiler on executor threads; here the capture hands both to the
    scheduler thread of the engine that drives the device, and runs on
    its own thread only when no engine does (``ProfilerCapture.capture``:
    a CUDA trace begun off that thread under graph replays sees no kernel
    and can hang)."""
    from gofr_tpu_torch.serving.profiler_capture import get_capture

    q = urllib.parse.parse_qs(raw.target.partition("?")[2])
    try:
        ms = min(int(q.get("ms", ["1000"])[0]), 30_000)
    except ValueError:
        return Response(
            status=400,
            headers={"Content-Type": "application/json"},
            body=b'{"error": "ms must be an integer"}',
        )
    cap = get_capture()
    if not cap.try_acquire():
        return Response(
            status=409,
            headers={"Content-Type": "application/json"},
            body=b'{"error": "a trace capture is already running"}',
        )
    try:
        try:
            await asyncio.get_running_loop().run_in_executor(None, cap.capture, ms)
            cap.note_manual_capture()
            body: dict = {"trace_dir": cap.trace_dir, "captured_ms": ms}
            status = 200
        except Exception as exc:  # noqa: BLE001 — debug surface
            body = {"error": str(exc)}
            status = 500
    finally:
        cap.release()
    return Response(
        status=status,
        headers={"Content-Type": "application/json"},
        body=json.dumps(body).encode(),
    )


def new_cmd(config_dir: str = "./configs"):
    """CLI app factory (reference ``gofr.go:99-111``)."""
    from gofr_tpu_torch.cli import CMDApp

    return CMDApp(config_dir=config_dir)
