"""Service client option decorators (reference ``service/options.go:3-5`` +
the per-option files: ``apikey_auth.go``, ``basic_auth.go``, ``oauth.go``,
``health_config.go``, ``default_headers.go``). The port's copy of
``gofr_tpu/service/options.py``."""

from __future__ import annotations

import base64
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional

from gofr_tpu_torch.service.wrapper import ServiceWrapper, innermost


class _HeaderInjector(ServiceWrapper):
    """Shared shape: wraps a service and injects headers per request."""

    def _headers(self) -> dict:
        return {}

    def request(self, method: str, path: str, *, headers: Any = None, **kw: Any) -> Any:
        merged = {**self._headers(), **(headers or {})}
        return self._inner.request(method, path, headers=merged, **kw)


@dataclass
class APIKeyConfig:
    """X-API-KEY header on every call (reference ``service/apikey_auth.go``)."""

    api_key: str

    def add_option(self, svc: Any) -> Any:
        cfg = self

        class _Svc(_HeaderInjector):
            def _headers(self) -> dict:
                return {"X-API-KEY": cfg.api_key}

        return _Svc(svc)


@dataclass
class BasicAuthConfig:
    """Authorization: Basic (reference ``service/basic_auth.go``)."""

    username: str
    password: str

    def add_option(self, svc: Any) -> Any:
        token = base64.b64encode(
            f"{self.username}:{self.password}".encode()
        ).decode()

        class _Svc(_HeaderInjector):
            def _headers(self) -> dict:
                return {"Authorization": f"Basic {token}"}

        return _Svc(svc)


@dataclass
class OAuthConfig:
    """Client-credentials bearer token with caching + refresh
    (reference ``service/oauth.go:15-33``)."""

    token_url: str
    client_id: str
    client_secret: str
    scopes: tuple = ()
    _cache: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def _token(self) -> str:
        with self._lock:
            tok = self._cache.get("token")
            if tok and time.time() < self._cache.get("expiry", 0) - 30:
                return tok
            import json as jsonlib
            import urllib.parse
            import urllib.request

            data = urllib.parse.urlencode({
                "grant_type": "client_credentials",
                "client_id": self.client_id,
                "client_secret": self.client_secret,
                **({"scope": " ".join(self.scopes)} if self.scopes else {}),
            }).encode()
            # Single-flight by design: the lock held across the fetch is
            # what stops N threads with an expired token from minting N
            # tokens; waiters get the fresh token from the cache. The
            # urlopen timeout bounds the convoy.
            with urllib.request.urlopen(
                urllib.request.Request(self.token_url, data=data), timeout=10
            ) as resp:
                payload = jsonlib.loads(resp.read())
            self._cache["token"] = payload["access_token"]
            self._cache["expiry"] = time.time() + float(payload.get("expires_in", 3600))
            return self._cache["token"]

    def add_option(self, svc: Any) -> Any:
        cfg = self

        class _Svc(_HeaderInjector):
            def _headers(self) -> dict:
                return {"Authorization": f"Bearer {cfg._token()}"}

        return _Svc(svc)


@dataclass
class DefaultHeaders:
    headers: Mapping[str, str]

    def add_option(self, svc: Any) -> Any:
        cfg = self

        class _Svc(_HeaderInjector):
            def _headers(self) -> dict:
                return dict(cfg.headers)

        return _Svc(svc)


@dataclass
class HealthConfig:
    """Override the health endpoint (reference ``service/health_config.go``)."""

    endpoint: str = ".well-known/alive"

    def add_option(self, svc: Any) -> Any:
        # health_check() runs on the base client regardless of wrapping
        # order, so the override must land on the innermost service — not
        # on whatever wrapper happens to be outermost.
        innermost(svc).health_endpoint = self.endpoint.lstrip("/")
        return svc


@dataclass
class RetryConfig:
    """Retry 5xx / connection errors with JITTERED exponential backoff
    (net-new; the reference leaves retries to the caller).

    Fixed-delay retries synchronize thundering herds: every client that
    failed at t₀ retries at exactly t₀+d, re-spiking the service it just
    knocked over. Each delay is therefore the exponential base
    ``backoff_s · 2^attempt`` (capped at ``max_backoff_s``) scaled by a
    uniform draw from ``[1 - jitter, 1 + jitter]`` — clients decorrelate
    while the expected delay stays the configured schedule. ``rng`` is
    injectable so tests pin the draw (``docs/advanced-guide/
    http-communication.md``).
    """

    max_retries: int = 3
    backoff_s: float = 0.1
    jitter: float = 0.5  # ±50% of the exponential base
    max_backoff_s: float = 30.0
    rng: Callable[[], float] = field(default=random.random)

    def delay_s(self, attempt: int) -> float:
        """The jittered sleep before retry ``attempt + 1`` (attempt is
        0-based). Bounds: base·(1-jitter) ≤ delay ≤ base·(1+jitter)."""
        base = min(self.backoff_s * (2 ** attempt), self.max_backoff_s)
        jitter = min(max(self.jitter, 0.0), 1.0)
        factor = 1.0 - jitter + 2.0 * jitter * self.rng()
        return base * factor

    def add_option(self, svc: Any) -> Any:
        cfg = self

        class _Svc(_HeaderInjector):
            def request(self, method: str, path: str, **kw: Any) -> Any:
                last_exc: Optional[Exception] = None
                for attempt in range(cfg.max_retries + 1):
                    try:
                        resp = self._inner.request(method, path, **kw)
                        if resp.status_code < 500 or attempt == cfg.max_retries:
                            return resp
                    except Exception as exc:  # connection errors
                        last_exc = exc
                        if attempt == cfg.max_retries:
                            raise
                    time.sleep(cfg.delay_s(attempt))
                if last_exc is not None:
                    raise last_exc
                return resp

        return _Svc(svc)
