"""Base HTTP service client.

Reference behavior (``service/new.go:26-211``): per-call span with
traceparent injection, ``app_http_service_response`` histogram, structured
request logs, ``Response{body, status_code}`` + header access, and a
``.well-known/alive`` health probe consumed by the container's aggregate
health (``container/health.go:23-25``).

The port's copy of ``gofr_tpu/service/client.py``, on the standard
library's ``http.client`` where the reference uses ``httpx``: one
connection per call, opened by ``socket.create_connection`` with the
connect budget, then read with the read budget. Network-failure semantics
the replica tier builds on:

* **Separate connect and read budgets** — ``connect_timeout_s`` bounds
  only the TCP/TLS handshake while ``timeout`` bounds the response read.
  A *connect* failure means nothing is listening (dead upstream); a
  *read* timeout usually means a live upstream busy behind queued work.
  Every transport error raised here carries a ``kind`` attribute
  (``"connect"`` / ``"read"`` / ``"transport"``) so callers can tell them
  apart.
* **Deterministic fault points** — ``faults.fire("http.request")`` in
  :meth:`HTTPService.request` and ``http.stream.open`` /
  ``http.stream.event`` in :meth:`HTTPService.stream_lines` let a test
  inject connect-refused, 5xx bursts, mid-body resets, truncated SSE
  streams and read-stalls without real sockets (see ``gofr_tpu_torch/faults``).
"""

from __future__ import annotations

import http.client
import json as jsonlib
import socket
import ssl
import time
import urllib.parse
from contextlib import contextmanager
from typing import Any, Iterator, Mapping, Optional

from gofr_tpu_torch import faults
from gofr_tpu_torch.tracing import (
    current_span,
    extract_traceparent,
    get_tracer,
    inject_traceparent,
)


class TransportError(OSError):
    """A failure on the wire, tagged with its ``kind``."""

    def __init__(self, kind: str, message: str) -> None:
        super().__init__(message)
        self.kind = kind


def _client_span(name: str, hdrs: Mapping[str, str], url: str) -> Any:
    """Client span for an outbound request. The ambient contextvar span
    parents it when one exists (the in-app handler case). Without one —
    a call from a detached worker thread, where the contextvar chain is
    broken but the caller's trace context rides the request as an
    explicit ``traceparent`` header — the span joins THAT trace, so the
    header re-injected downstream carries the same trace id with this
    span as parent: one trace across hosts."""
    tracer = get_tracer()
    if current_span() is None:
        trace_id, parent_id = extract_traceparent(hdrs)
        if trace_id:
            return tracer.start_span(
                name, trace_id=trace_id, parent_span_id=parent_id,
                attributes={"http.url": url},
            )
    return tracer.start_span(name, attributes={"http.url": url})


def classify_transport_error(exc: BaseException) -> str:
    """Map a transport failure to its ``kind``: ``"connect"`` (nothing
    accepted the connection — the upstream is gone), ``"read"`` (the
    connection lives but bytes stopped — busy or stalled upstream), or
    ``"transport"`` (anything else on the wire)."""
    kind = getattr(exc, "kind", None)
    return kind if isinstance(kind, str) else "transport"


def _unavailable(address: str, exc: BaseException) -> Exception:
    """Typed 503 for a transport failure, tagged with the failure kind
    so the replica tier can classify dead-vs-busy correctly."""
    from gofr_tpu_torch.errors import ErrorServiceUnavailable

    err = ErrorServiceUnavailable(f"{address}: {exc}")
    err.kind = classify_transport_error(exc)  # type: ignore[attr-defined]
    return err


class _Connection:
    """One call's connection: the connect budget for the handshake, the
    read budget for every read after it."""

    def __init__(self, url: str, connect_timeout_s: float, read_timeout_s: float) -> None:
        parts = urllib.parse.urlsplit(url)
        self.https = parts.scheme == "https"
        self.host = parts.hostname or "127.0.0.1"
        self.port = parts.port or (443 if self.https else 80)
        self.target = urllib.parse.urlunsplit(("", "", parts.path or "/", parts.query, ""))
        try:
            sock = socket.create_connection((self.host, self.port), timeout=connect_timeout_s)
            if self.https:
                sock = ssl.create_default_context().wrap_socket(sock, server_hostname=self.host)
        except OSError as exc:
            raise TransportError("connect", f"connect to {self.host}:{self.port}: {exc}") from exc
        sock.settimeout(read_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        cls = http.client.HTTPSConnection if self.https else http.client.HTTPConnection
        self.conn = cls(self.host, self.port, timeout=read_timeout_s)
        self.conn.sock = sock

    def send(self, method: str, headers: Mapping[str, str], body: Optional[bytes]) -> http.client.HTTPResponse:
        try:
            self.conn.request(method, self.target, body=body, headers=dict(headers))
        except OSError as exc:
            raise TransportError("transport", f"send: {exc}") from exc
        try:
            return self.conn.getresponse()
        except (TimeoutError, socket.timeout) as exc:
            raise TransportError("read", "read timed out") from exc
        except (OSError, http.client.HTTPException) as exc:
            raise TransportError("read", f"read: {exc!r}") from exc

    def close(self) -> None:
        self.conn.close()


def _read(resp: http.client.HTTPResponse, n: int = -1) -> bytes:
    try:
        return resp.read() if n < 0 else resp.read(n)
    except (TimeoutError, socket.timeout) as exc:
        raise TransportError("read", "read timed out") from exc
    except (OSError, http.client.HTTPException) as exc:
        raise TransportError("read", f"read: {exc!r}") from exc


def _iter_lines(resp: http.client.HTTPResponse) -> Iterator[str]:
    """The body's lines without their endings, a blank line as ``""`` (as
    httpx's ``iter_lines``)."""
    while True:
        try:
            raw = resp.readline()
        except (TimeoutError, socket.timeout) as exc:
            raise TransportError("read", "read timed out") from exc
        except (OSError, http.client.HTTPException) as exc:
            raise TransportError("read", f"read: {exc!r}") from exc
        if not raw:
            return
        yield raw.decode("utf-8", "replace").rstrip("\r\n")


def _response_headers(resp: http.client.HTTPResponse) -> dict:
    out: dict[str, str] = {}
    for key, value in resp.getheaders():
        key = key.lower()
        out[key] = f"{out[key]}, {value}" if key in out else value
    return out


class Response:
    def __init__(self, body: bytes, status_code: int, headers: Mapping[str, str]) -> None:
        self.body = body
        self.status_code = status_code
        self._headers = dict(headers)

    def get_header(self, key: str) -> str:
        return self._headers.get(key, self._headers.get(key.lower(), ""))

    def json(self) -> Any:
        return jsonlib.loads(self.body or b"null")


class ServiceLog:
    """Structured outbound-call log (reference ``service/logger.go:13-37``)."""

    def __init__(self, method: str, url: str, status: int, duration_us: int, trace_id: str) -> None:
        self.method = method
        self.url = url
        self.status = status
        self.duration = duration_us
        self.trace_id = trace_id

    def to_log_dict(self) -> dict:
        return {
            "method": self.method, "uri": self.url, "response_code": self.status,
            "response_time": self.duration, "trace_id": self.trace_id,
        }

    def pretty_print(self, fp: Any) -> None:
        fp.write(
            f"\x1b[38;5;8mSVC\x1b[0m {self.duration:>8}µs {self.status} "
            f"{self.method} {self.url}\n"
        )


class HTTPService:
    """Concrete client; options wrap/extend it (``AddOption`` pattern)."""

    def __init__(
        self,
        address: str,
        logger: Any = None,
        metrics: Any = None,
        timeout: float = 30.0,
        connect_timeout_s: Optional[float] = None,
    ) -> None:
        self.address = address.rstrip("/")
        self._logger = logger
        self._metrics = metrics
        self.timeout = float(timeout)
        # Connect budget separate from (and much shorter than) the read
        # budget: a dead upstream refuses/blackholes the HANDSHAKE in
        # ~RTT time, while a busy-but-alive one accepts instantly and
        # is merely slow to ANSWER.
        self.connect_timeout_s = float(
            connect_timeout_s
            if connect_timeout_s is not None
            else min(self.timeout, 5.0)
        )
        self.health_endpoint = ".well-known/alive"  # reference service/health.go:18-20

    def _url(self, path: str, params: Optional[Mapping[str, Any]] = None) -> str:
        url = f"{self.address}/{path.lstrip('/')}" if path else self.address
        if params:
            sep = "&" if urllib.parse.urlsplit(url).query else "?"
            url += sep + urllib.parse.urlencode(params, doseq=True)
        return url

    @staticmethod
    def _body(hdrs: dict, body: Optional[bytes], json: Any) -> Optional[bytes]:
        if json is not None:
            if not any(k.lower() == "content-type" for k in hdrs):
                hdrs["Content-Type"] = "application/json"
            return jsonlib.dumps(json).encode()
        return body

    # -- core request (reference service/new.go:135-192) ------------------

    def request(
        self,
        method: str,
        path: str,
        *,
        params: Optional[Mapping[str, Any]] = None,
        headers: Optional[Mapping[str, str]] = None,
        body: Optional[bytes] = None,
        json: Any = None,
    ) -> Response:
        url = f"{self.address}/{path.lstrip('/')}" if path else self.address
        hdrs = dict(headers or {})
        span = _client_span(f"http-service {method} {url}", hdrs, url)
        inject_traceparent(hdrs, span)
        start = time.time()
        status = 0
        try:
            # Chaos seam: an armed fault either raises a transport error
            # (connect-refused) or returns a canned Response (5xx burst)
            # — the full request path below it stays exercised.
            canned = faults.fire(
                "http.request", address=self.address, method=method,
                path=path,
            )
            if isinstance(canned, Response):
                status = canned.status_code
                return canned
            content = self._body(hdrs, body, json)
            try:
                conn = _Connection(self._url(path, params), self.connect_timeout_s, self.timeout)
                try:
                    resp = conn.send(method, hdrs, content)
                    data = _read(resp)
                finally:
                    conn.close()
            except TransportError as exc:
                # Downstream unreachable → typed 503, not an anonymous 500
                # (the responder honors status_code; the breaker still counts
                # the raised error as a failure). The `kind` tag keeps
                # connect-vs-read distinguishable.
                raise _unavailable(self.address, exc) from exc
            status = resp.status
            return Response(data, resp.status, _response_headers(resp))
        finally:
            elapsed = time.time() - start
            span.set_attribute("http.status_code", status)
            span.end()
            if self._metrics is not None:
                self._metrics.record_histogram(
                    "app_http_service_response", elapsed,
                    "path", f"{self.address}/{path.lstrip('/')}", "method", method,
                    "status", str(status),
                )
            log = ServiceLog(method, url, status, int(elapsed * 1e6), span.trace_id)
            if self._logger is not None:
                if status == 0 or status >= 500:
                    self._logger.error(log)
                else:
                    self._logger.debug(log)

    # -- verb helpers (reference service/new.go:89-133) --------------------

    def get(self, path: str, params: Any = None, headers: Any = None) -> Response:
        return self.request("GET", path, params=params, headers=headers)

    def post(self, path: str, params: Any = None, body: Any = None, json: Any = None, headers: Any = None) -> Response:
        return self.request("POST", path, params=params, body=body, json=json, headers=headers)

    def put(self, path: str, params: Any = None, body: Any = None, json: Any = None, headers: Any = None) -> Response:
        return self.request("PUT", path, params=params, body=body, json=json, headers=headers)

    def patch(self, path: str, params: Any = None, body: Any = None, json: Any = None, headers: Any = None) -> Response:
        return self.request("PATCH", path, params=params, body=body, json=json, headers=headers)

    def delete(self, path: str, params: Any = None, body: Any = None, headers: Any = None) -> Response:
        return self.request("DELETE", path, params=params, body=body, headers=headers)

    # -- streaming (SSE consumer) -------------------------------------------

    @contextmanager
    def stream_lines(
        self,
        method: str,
        path: str,
        *,
        json: Any = None,
        headers: Optional[Mapping[str, str]] = None,
        read_timeout_s: Optional[float] = None,
    ) -> Iterator[Iterator[str]]:
        """Open a streaming request and yield an iterator of decoded
        response LINES (the SSE framing unit). ``read_timeout_s`` is the
        per-read idle budget: an upstream that stops sending bytes for
        longer raises a ``kind="read"`` 503 mid-iteration — a stall or
        slow-loris detector. Connect failures raise a ``kind="connect"``
        503 before any line is yielded; non-2xx statuses raise with the
        upstream's status attached.

        Fault points: ``http.stream.open`` fires before the connection
        attempt (raise = connect-refused; return an iterable = serve the
        stream from it, no socket at all); ``http.stream.event`` fires
        per line (raise = mid-body reset; return ``"truncate"`` = EOF
        now, the truncated-SSE fault).
        """
        url = f"{self.address}/{path.lstrip('/')}" if path else self.address
        hdrs = dict(headers or {})
        span = _client_span(
            f"http-service {method} {url} (stream)", hdrs, url
        )
        inject_traceparent(hdrs, span)
        status = 0
        try:
            canned = faults.fire(
                "http.stream.open", address=self.address, method=method,
                path=path,
            )
            if canned is not None:
                status = 200
                yield self._guarded_lines(iter(canned))
                return
            content = self._body(hdrs, None, json)
            read_timeout = self.timeout if read_timeout_s is None else read_timeout_s
            try:
                conn = _Connection(url, self.connect_timeout_s, read_timeout)
            except TransportError as exc:
                raise _unavailable(self.address, exc) from exc
            try:
                try:
                    resp = conn.send(method, hdrs, content)
                    status = resp.status
                    if status >= 400:
                        # Read the (bounded) error body so callers can
                        # map the upstream's status faithfully.
                        body = _read(resp, 2048)
                        from gofr_tpu_torch.errors import GofrError

                        exc = GofrError(
                            f"{self.address} answered {status}: "
                            f"{body.decode(errors='replace')}"
                        )
                        exc.status_code = status
                        raise exc
                except TransportError as exc:
                    raise _unavailable(self.address, exc) from exc
                yield self._guarded_lines(_iter_lines(resp))
            finally:
                conn.close()
        finally:
            span.set_attribute("http.status_code", status)
            span.end()

    def _guarded_lines(self, lines: Iterator[str]) -> Iterator[str]:
        """Wrap a line iterator with the per-event fault point and
        transport-error tagging (mid-body failures surface as tagged
        503s, same contract as the open path)."""
        index = 0
        while True:
            try:
                line = next(lines)
            except StopIteration:
                return
            except TransportError as exc:
                raise _unavailable(self.address, exc) from exc
            verdict = faults.fire(
                "http.stream.event", address=self.address, index=index,
                line=line,
            )
            if verdict == "truncate":
                return  # upstream vanished mid-stream, no EOF framing
            index += 1
            yield line

    # -- health (reference service/health.go) ------------------------------

    def health_check(self) -> dict:
        try:
            resp = self.get(self.health_endpoint)
            if resp.status_code < 400:
                details: dict[str, Any] = {"host": self.address}
                try:
                    # Surface the upstream's own health payload (engine
                    # state, loaded LoRA adapters, ...); liveness
                    # endpoints with non-JSON bodies keep the plain host
                    # detail.
                    body = resp.json()
                    if isinstance(body, dict):
                        if isinstance(body.get("data"), dict):
                            body = body["data"]  # gofr envelope
                        if isinstance(body.get("details"), dict):
                            details.update(body["details"])
                        if body.get("status"):
                            details["upstream_status"] = body["status"]
                except Exception:  # noqa: BLE001 — liveness bodies may be anything
                    pass
                return {"status": "UP", "details": details}
            return {
                "status": "DOWN",
                "details": {"host": self.address, "error": f"status {resp.status_code}"},
            }
        except Exception as exc:
            details = {"host": self.address, "error": str(exc)}
            kind = getattr(exc, "kind", "")
            if kind:
                details["error_kind"] = kind
            return {"status": "DOWN", "details": details}

    def close(self) -> None:
        """Nothing held between calls: each call closes its connection."""


def new_http_service(
    address: str, logger: Any = None, metrics: Any = None, *options: Any
) -> HTTPService:
    """Factory folding option decorators (reference ``service/new.go:68-87``)."""
    svc = HTTPService(address, logger=logger, metrics=metrics)
    for option in options:
        svc = option.add_option(svc)
    return svc
