"""HTTP transport layer (reference: ``pkg/gofr/http``).

A from-scratch asyncio HTTP/1.1 server (the role net/http + gorilla-mux play
in the reference), the framework ``Request``/``Responder`` implementations,
the router with path parameters and middleware chain, and the default
middleware set (Tracer → Logging → CORS → Metrics,
reference ``http/router.go:23-28``).

The port's copy of ``gofr_tpu/http/__init__.py``.
"""

from gofr_tpu_torch.http.proto import RawRequest, Response
from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.responder import Responder
from gofr_tpu_torch.http.response import File, Raw, Redirect, Stream
from gofr_tpu_torch.http.router import Router
from gofr_tpu_torch.http.server import HTTPServer

__all__ = [
    "RawRequest",
    "Response",
    "Request",
    "Responder",
    "Raw",
    "File",
    "Redirect",
    "Stream",
    "Router",
    "HTTPServer",
]
