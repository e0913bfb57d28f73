"""API-key auth middleware (reference ``http/middleware/apikey_auth.go:11-57``).

Checks ``X-API-KEY`` against a static key list or a validator function
(given the container when the App passes one). Well-known probe routes
are exempt.

The port's copy of ``gofr_tpu/http/middleware/apikey_auth.py``.
"""

from __future__ import annotations

import hmac
import json

from gofr_tpu_torch.http.middleware.basic_auth import exempt
from gofr_tpu_torch.http.proto import Response


def apikey_auth_middleware(keys=(), validate_func=None, container=None):
    keyset = [k.encode() for k in keys]

    def mw(next_handler):
        async def handler(raw):
            if exempt(raw):
                return await next_handler(raw)
            key = raw.headers.get("x-api-key", "")
            if validate_func is not None:
                ok = (validate_func(container, key) if container is not None
                      else validate_func(key))
            else:
                given = key.encode()
                # Every key compared in constant time, none skipped.
                ok = any([hmac.compare_digest(given, k) for k in keyset])
            if not ok:
                return Response(
                    status=401,
                    headers={"Content-Type": "application/json"},
                    body=json.dumps({"error": {"message": "Unauthorized"}}).encode(),
                )
            return await next_handler(raw)

        return handler

    return mw
