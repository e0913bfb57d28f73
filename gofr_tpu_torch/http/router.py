"""Router with path parameters and middleware chain.

The role gorilla-mux + the default middleware install play in the reference
(``http/router.go:21-49``): method+path routing with ``{param}`` segments,
route-template capture for metrics, 405 detection, and a middleware chain
applied outermost-first (Tracer → Logging → CORS → Metrics by default,
installed by the App).

Middleware here is ``mw(next) -> handler`` over async
``handler(RawRequest) -> Response`` — the direct analog of the reference's
``func(http.Handler) http.Handler`` (``http/router.go:18``).

The port's copy of ``gofr_tpu/http/router.py``.
"""

from __future__ import annotations

from typing import Awaitable, Callable, Optional

from gofr_tpu_torch.http.proto import RawRequest, Response

Handler = Callable[[RawRequest], Awaitable[Response]]
Middleware = Callable[[Handler], Handler]


class _Route:
    __slots__ = ("method", "segments", "handler", "template")

    def __init__(self, method: str, template: str, handler: Handler) -> None:
        self.method = method.upper()
        self.template = template
        self.segments = [s for s in template.strip("/").split("/")] if template.strip("/") else []

    def match(self, path_segments: list[str]) -> Optional[dict[str, str]]:
        if len(self.segments) != len(path_segments):
            # Trailing wildcard `{*}`-style catch-all is not used; exact arity.
            return None
        params: dict[str, str] = {}
        for pat, actual in zip(self.segments, path_segments):
            if pat.startswith("{") and pat.endswith("}"):
                params[pat[1:-1]] = actual
            elif pat != actual:
                return None
        return params


class Router:
    def __init__(self, logger=None) -> None:
        self._routes: list[_Route] = []
        self._middlewares: list[Middleware] = []
        self._not_found: Optional[Handler] = None
        self._logger = logger

    # -- registration (reference http/router.go:36-49) -------------------

    def add(self, method: str, template: str, handler: Handler) -> None:
        route = _Route(method, template, handler)
        route.handler = handler
        self._routes.append(route)

    def use_middleware(self, *mws: Middleware) -> None:
        self._middlewares.extend(mws)

    def set_not_found(self, handler: Handler) -> None:
        self._not_found = handler

    def routes(self) -> list[tuple[str, str]]:
        return [(r.method, r.template) for r in self._routes]

    # -- dispatch --------------------------------------------------------

    async def __call__(self, raw: RawRequest) -> Response:
        handler = self._resolve(raw)
        # Middlewares wrap the resolved handler, outermost = first installed
        # (reverse-registration order like the reference chain, SURVEY §3.2).
        for mw in reversed(self._middlewares):
            handler = mw(handler)
        return await handler(raw)

    def _resolve(self, raw: RawRequest) -> Handler:
        from urllib.parse import urlsplit, unquote

        path = unquote(urlsplit(raw.target).path) or "/"
        path_segments = [s for s in path.strip("/").split("/")] if path.strip("/") else []

        method_mismatch = False
        for route in self._routes:
            params = route.match(path_segments)
            if params is None:
                continue
            if route.method != raw.method and not (
                raw.method == "HEAD" and route.method == "GET"
            ):
                method_mismatch = True
                continue
            raw.route_template = route.template
            raw.path_params = params
            return route.handler

        if method_mismatch:
            return _status_handler(405)
        if self._not_found is not None:
            raw.route_template = "/"
            return self._not_found
        return _status_handler(404)


def _status_handler(status: int) -> Handler:
    async def handler(_: RawRequest) -> Response:
        import json

        msg = "Method Not Allowed" if status == 405 else "route not registered"
        return Response(
            status=status,
            headers={"Content-Type": "application/json"},
            body=json.dumps({"error": {"message": msg}}).encode(),
        )

    return handler
