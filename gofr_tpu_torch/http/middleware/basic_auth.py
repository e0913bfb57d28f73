"""Basic auth middleware (reference ``http/middleware/basic_auth.go:18-73``).

Validates ``Authorization: Basic`` against a static user→password map or a
user-supplied validate function, which receives the container when the
App passes one (``gofr.go:316``). Well-known probe routes are exempt
(reference ``http/middleware/validate.go:5-7``), so health probes stay
open.

The port's copy of ``gofr_tpu/http/middleware/basic_auth.py``.
"""

from __future__ import annotations

import base64
import hmac
import json

from gofr_tpu_torch.http.proto import Response

EXEMPT_PREFIXES = ("/.well-known/",)


def exempt(raw) -> bool:
    path = raw.target.split("?")[0]
    return any(path.startswith(p) for p in EXEMPT_PREFIXES)


def _unauthorized(msg: str = "Unauthorized") -> Response:
    return Response(
        status=401,
        headers={"Content-Type": "application/json", "WWW-Authenticate": "Basic"},
        body=json.dumps({"error": {"message": msg}}).encode(),
    )


def basic_auth_middleware(users: dict[str, str] | None = None, validate_func=None,
                          container=None):
    def mw(next_handler):
        async def handler(raw):
            if exempt(raw):
                return await next_handler(raw)
            header = raw.headers.get("authorization", "")
            if not header.startswith("Basic "):
                return _unauthorized()
            try:
                decoded = base64.b64decode(header[6:]).decode("utf-8")
                username, _, password = decoded.partition(":")
            except Exception:  # noqa: BLE001 — any undecodable header is a 401
                return _unauthorized("invalid authorization header")
            if validate_func is not None:
                ok = (validate_func(container, username, password) if container is not None
                      else validate_func(username, password))
                if not ok:
                    return _unauthorized()
            else:
                want = (users or {}).get(username)
                if want is None or not hmac.compare_digest(want.encode(), password.encode()):
                    return _unauthorized()
            raw.ctx_data["auth.user"] = username
            return await next_handler(raw)

        return handler

    return mw
