"""Server middleware (reference: ``pkg/gofr/http/middleware``).

All middleware are ``mw(next) -> handler`` over async
``handler(RawRequest) -> Response`` — the analog of the reference's
``func(http.Handler) http.Handler``. The default chain is
Tracer → Logging → CORS → Metrics (reference ``http/router.go:23-28``).

The port's copy of ``gofr_tpu/http/middleware``: the default chain and
the auth middlewares the ``App.enable_*`` methods install — basic auth,
API-key auth and OAuth/JWKS (``basic_auth.py``, ``apikey_auth.py``,
``oauth.py``; RS256 checked in the standard library, see ``oauth.py``).
"""

from gofr_tpu_torch.http.middleware.tracer import tracer_middleware
from gofr_tpu_torch.http.middleware.logging_mw import logging_middleware
from gofr_tpu_torch.http.middleware.metrics_mw import metrics_middleware
from gofr_tpu_torch.http.middleware.cors import cors_middleware
from gofr_tpu_torch.http.middleware.basic_auth import basic_auth_middleware
from gofr_tpu_torch.http.middleware.apikey_auth import apikey_auth_middleware
from gofr_tpu_torch.http.middleware.oauth import JWKSProvider, oauth_middleware

__all__ = [
    "tracer_middleware",
    "logging_middleware",
    "metrics_middleware",
    "cors_middleware",
    "basic_auth_middleware",
    "apikey_auth_middleware",
    "oauth_middleware",
    "JWKSProvider",
]
