"""Server middleware (reference: ``pkg/gofr/http/middleware``).

All middleware are ``mw(next) -> handler`` over async
``handler(RawRequest) -> Response`` — the analog of the reference's
``func(http.Handler) http.Handler``. The default chain is
Tracer → Logging → CORS → Metrics (reference ``http/router.go:23-28``).

The port's copy of ``gofr_tpu/http/middleware``'s default chain. Basic
auth, API-key auth and OAuth/JWKS (``basic_auth.py``, ``apikey_auth.py``,
``oauth.py``) are not ported yet (ROADMAP Queue 1 item 2).
"""

from gofr_tpu_torch.http.middleware.tracer import tracer_middleware
from gofr_tpu_torch.http.middleware.logging_mw import logging_middleware
from gofr_tpu_torch.http.middleware.metrics_mw import metrics_middleware
from gofr_tpu_torch.http.middleware.cors import cors_middleware

__all__ = [
    "tracer_middleware",
    "logging_middleware",
    "metrics_middleware",
    "cors_middleware",
]
