"""Shared decorator shape for service client options (reference
``service/options.go:3-5`` — options fold wrappers over the base client).

Every option wrapper delegates unknown attributes to the wrapped service
and routes the five verb helpers through its own ``request`` so a single
override point intercepts all traffic.
"""

from __future__ import annotations

from typing import Any


def innermost(svc: Any) -> Any:
    """Walk the ``_inner`` chain to the base HTTPService."""
    while hasattr(svc, "_inner"):
        svc = svc._inner
    return svc


class ServiceWrapper:
    """Decorator base: wraps a service, delegates everything else."""

    def __init__(self, inner: Any) -> None:
        self._inner = inner

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    def request(self, method: str, path: str, **kw: Any) -> Any:
        return self._inner.request(method, path, **kw)

    def get(self, path: str, params: Any = None, headers: Any = None) -> Any:
        return self.request("GET", path, params=params, headers=headers)

    def post(self, path: str, params: Any = None, body: Any = None, json: Any = None, headers: Any = None) -> Any:
        return self.request("POST", path, params=params, body=body, json=json, headers=headers)

    def put(self, path: str, params: Any = None, body: Any = None, json: Any = None, headers: Any = None) -> Any:
        return self.request("PUT", path, params=params, body=body, json=json, headers=headers)

    def patch(self, path: str, params: Any = None, body: Any = None, json: Any = None, headers: Any = None) -> Any:
        return self.request("PATCH", path, params=params, body=body, json=json, headers=headers)

    def delete(self, path: str, params: Any = None, body: Any = None, headers: Any = None) -> Any:
        return self.request("DELETE", path, params=params, body=body, headers=headers)
