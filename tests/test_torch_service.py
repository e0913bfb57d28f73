"""The port's inter-service client (``gofr_tpu_torch/service`` on
``http.client``) held against the reference's (``gofr_tpu/service`` on
httpx): every case of ``tests/test_service_client.py`` runs for each
package against one upstream App (the port's, with llama-tiny behind its
OpenAI routes), and so do the transport-error kinds, the metrics line, the
fault points and ``stream_lines`` over the SSE completions. Also the App's
``add_http_service``: the container's health and the overwrite warning."""

from __future__ import annotations

import asyncio
import base64
import http.client
import json
import threading
import time
from types import SimpleNamespace

import pytest

import gofr_tpu
import gofr_tpu.config
import gofr_tpu.errors
import gofr_tpu.faults
import gofr_tpu.metrics
import gofr_tpu.service
import gofr_tpu.service.wrapper
import gofr_tpu.tracing
import gofr_tpu_torch
import gofr_tpu_torch.config
import gofr_tpu_torch.errors
import gofr_tpu_torch.faults
import gofr_tpu_torch.metrics
import gofr_tpu_torch.service
import gofr_tpu_torch.service.wrapper
import gofr_tpu_torch.tracing
from gofr_tpu_torch.http.response import Raw
from gofr_tpu_torch.serving.openai_compat import add_openai_routes


def _pkg(root) -> SimpleNamespace:
    name = root.__name__
    import importlib

    return SimpleNamespace(
        name=name, App=root.App, MockConfig=importlib.import_module(f"{name}.config").MockConfig,
        service=importlib.import_module(f"{name}.service"),
        wrapper=importlib.import_module(f"{name}.service.wrapper"),
        errors=importlib.import_module(f"{name}.errors"),
        faults=importlib.import_module(f"{name}.faults"),
        metrics=importlib.import_module(f"{name}.metrics"),
        tracing=importlib.import_module(f"{name}.tracing"))


PKGS = {"reference": _pkg(gofr_tpu), "port": _pkg(gofr_tpu_torch)}


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    return PKGS[request.param]


class _Harness:
    def __init__(self, app) -> None:
        self.app = app
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True)

    def __enter__(self):
        self._thread.start()
        asyncio.run_coroutine_threadsafe(self.app.start(), self.loop).result(60)
        return self

    def __exit__(self, *exc):
        asyncio.run_coroutine_threadsafe(self.app.stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)
        self.loop.close()

    @property
    def address(self) -> str:
        return f"http://127.0.0.1:{self.app.http_port}"


@pytest.fixture(scope="module")
def upstream():
    """One upstream for both packages' clients: the port's App, with the
    routes of the reference's tests and llama-tiny behind the OpenAI
    routes."""
    app = gofr_tpu_torch.App(config=gofr_tpu_torch.config.MockConfig({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR",
        "TPU_MODEL": "llama-tiny", "TPU_DEVICE": "cpu", "TPU_KV_SLOTS": "2",
        "TPU_MAX_LEN": "128"}))
    add_openai_routes(app)
    state = {"fail": False, "hits": 0, "tokens": 0}

    @app.get("/data")
    def data(ctx):
        state["hits"] += 1
        if state["fail"]:
            raise RuntimeError("boom")
        return {"value": 42}

    @app.get("/echo-headers")
    def echo(ctx):
        return {
            "api_key": ctx.header("X-API-KEY"),
            "auth": ctx.header("Authorization"),
            "custom": ctx.header("X-Custom"),
            "traceparent": ctx.header("traceparent"),
        }

    @app.get("/sleep")
    async def sleep(ctx):
        await asyncio.sleep(1.5)
        return {"slept": True}

    @app.post("/token")
    def token(ctx):
        state["tokens"] += 1
        state["grant"] = ctx.request.body.decode()
        return Raw({"access_token": f"tok-{state['tokens']}", "expires_in": 31})

    with _Harness(app) as harness:
        harness.state = state
        yield harness


def test_basic_get_and_traceparent(upstream, pkg):
    svc = pkg.service.new_http_service(upstream.address)
    resp = svc.get("/data")
    assert resp.status_code == 200
    assert resp.json()["data"]["value"] == 42
    assert resp.get_header("Content-Type").startswith("application/json")
    tp = svc.get("/echo-headers").json()["data"]["traceparent"]
    assert tp and len(tp.split("-")) == 4  # W3C traceparent injected
    # Under an ambient span, the injected traceparent carries its trace.
    span = pkg.tracing.get_tracer().start_span("caller")
    try:
        tp = svc.get("/echo-headers").json()["data"]["traceparent"]
    finally:
        span.end()
    assert tp.split("-")[1] == span.trace_id
    for verb in ("post", "put", "patch"):
        assert getattr(svc, verb)("/data", json={"x": 1}).status_code == 405
    assert svc.delete("/data").status_code == 405
    assert svc.get("/data", params={"q": "a b"}).status_code == 200
    svc.close()


def test_health_check_and_override(upstream, pkg):
    svc = pkg.service.new_http_service(upstream.address)
    assert svc.health_check()["status"] == "UP"
    svc2 = pkg.service.new_http_service(upstream.address, None, None,
                                        pkg.service.HealthConfig("/data"))
    assert svc2.health_check()["status"] == "UP"
    down = pkg.service.new_http_service("http://127.0.0.1:1").health_check()
    assert down["status"] == "DOWN" and down["details"]["error_kind"] == "connect"
    svc4 = pkg.service.new_http_service(
        upstream.address, None, None, pkg.service.APIKeyConfig("k"),
        pkg.service.HealthConfig("/data"))
    assert svc4.health_check()["status"] == "UP"
    assert pkg.wrapper.innermost(svc4).health_endpoint == "data"


def test_auth_options_inject_headers(upstream, pkg):
    svc = pkg.service.new_http_service(
        upstream.address, None, None,
        pkg.service.APIKeyConfig("sekrit"), pkg.service.DefaultHeaders({"X-Custom": "v1"}))
    got = svc.get("/echo-headers").json()["data"]
    assert got["api_key"] == "sekrit" and got["custom"] == "v1"
    svc2 = pkg.service.new_http_service(upstream.address, None, None,
                                        pkg.service.BasicAuthConfig("user", "pass"))
    got = svc2.get("/echo-headers").json()["data"]
    assert got["auth"] == "Basic " + base64.b64encode(b"user:pass").decode()


def test_oauth2_client_credentials_token_flow(upstream, pkg):
    """Bearer tokens from a client-credentials grant, cached until 30 s
    before expiry, fetched again after."""
    start = upstream.state["tokens"]
    svc = pkg.service.new_http_service(
        upstream.address, None, None,
        pkg.service.OAuthConfig(token_url=f"{upstream.address}/token", client_id="cid",
                                client_secret="sec", scopes=("a", "b")))
    assert svc.get("/echo-headers").json()["data"]["auth"] == f"Bearer tok-{start + 1}"
    assert svc.get("/echo-headers").json()["data"]["auth"] == f"Bearer tok-{start + 1}"
    assert "grant_type=client_credentials" in upstream.state["grant"]
    assert "scope=a+b" in upstream.state["grant"]
    time.sleep(1.2)
    assert svc.get("/echo-headers").json()["data"]["auth"] == f"Bearer tok-{start + 2}"


def test_circuit_breaker_opens_and_recovers(upstream, pkg):
    svc = pkg.service.new_http_service(
        upstream.address, None, None, pkg.service.HealthConfig("/data"),
        pkg.service.CircuitBreakerConfig(threshold=2, interval_s=60))
    upstream.state["fail"] = True
    try:
        for _ in range(2):
            assert svc.get("/data").status_code == 500
        with pytest.raises(pkg.service.CircuitOpenError):
            svc.get("/data")
    finally:
        upstream.state["fail"] = False
    assert svc.get("/data").status_code == 200  # the request path's probe closes it
    assert svc.get("/data").status_code == 200
    svc.close()


def test_circuit_breaker_half_opens_on_probe_success(upstream, pkg):
    svc = pkg.service.new_http_service(
        upstream.address, None, None, pkg.service.HealthConfig("/data"),
        pkg.service.CircuitBreakerConfig(threshold=1, interval_s=3600))
    upstream.state["fail"] = True
    try:
        assert svc.get("/data").status_code == 500
        assert svc.is_open
        with pytest.raises(pkg.service.CircuitOpenError):
            svc.get("/data")
    finally:
        upstream.state["fail"] = False
    assert svc.is_open
    svc.note_probe_success()
    assert not svc.is_open
    assert svc.get("/data").status_code == 200
    svc.close()


def test_breaker_half_opens_through_option_chain(upstream, pkg):
    """The breaker wrapped by another option is reached through the
    ``_inner`` chain (the reference's replica test walks it the same
    way; the replica tier itself is ROADMAP item 7.5)."""
    svc = pkg.service.new_http_service(
        upstream.address, None, None, pkg.service.HealthConfig("/data"),
        pkg.service.CircuitBreakerConfig(threshold=1, interval_s=3600),
        pkg.service.DefaultHeaders({"X-Custom": "wrapped"}))
    upstream.state["fail"] = True
    try:
        assert svc.get("/data").status_code == 500
    finally:
        upstream.state["fail"] = False
    breaker = svc._inner
    assert breaker.is_open and pkg.wrapper.innermost(svc).health_endpoint == "data"
    breaker.note_probe_success()
    assert not breaker.is_open
    assert svc.get("/echo-headers").json()["data"]["custom"] == "wrapped"
    svc.close()


def test_circuit_breaker_gauge_and_ticker(upstream, pkg):
    """The open state on ``app_http_service_circuit_open``; the probe
    ticker dies with the client; recovery clears the gauge."""
    metrics = pkg.metrics.new_metrics_manager()
    metrics.new_gauge("app_http_service_circuit_open")
    svc = pkg.service.new_http_service(
        upstream.address, None, metrics, pkg.service.HealthConfig("/data"),
        pkg.service.CircuitBreakerConfig(threshold=1, interval_s=0.05))
    gauge = lambda: list({i.name: i for i in metrics.instruments()}[  # noqa: E731
        "app_http_service_circuit_open"].collect().values())
    upstream.state["fail"] = True
    try:
        assert svc.get("/data").status_code == 500
        assert gauge() == [1.0]
        assert svc._ticker is not None and svc._ticker.is_alive()
    finally:
        upstream.state["fail"] = False
    deadline = time.time() + 5
    while svc.is_open and time.time() < deadline:
        time.sleep(0.02)
    assert not svc.is_open and gauge() == [0.0]  # the ticker's probe closed it
    svc.close()
    assert not any(t.name == "circuit-breaker-probe" and t.is_alive()
                   for t in threading.enumerate())


def test_retry_config(upstream, pkg):
    before = upstream.state["hits"]
    upstream.state["fail"] = True
    try:
        svc = pkg.service.new_http_service(
            upstream.address, None, None, pkg.service.RetryConfig(max_retries=2, backoff_s=0.01))
        assert svc.get("/data").status_code == 500
        assert upstream.state["hits"] - before == 3  # initial + 2 retries
    finally:
        upstream.state["fail"] = False


def test_retry_on_connection_error(pkg):
    svc = pkg.service.new_http_service("http://127.0.0.1:1", None, None,
                                       pkg.service.RetryConfig(max_retries=2, backoff_s=0.01))
    with pytest.raises(pkg.errors.ErrorServiceUnavailable) as err:
        svc.get("/data")
    assert err.value.kind == "connect" and err.value.status_code == 503


def test_retry_backoff_jitter_bounds(pkg):
    import random

    rng = random.Random(7)
    cfg = pkg.service.RetryConfig(max_retries=3, backoff_s=0.1, jitter=0.5, max_backoff_s=0.3,
                                  rng=rng.random)
    for attempt in range(6):
        base = min(0.1 * (2 ** attempt), 0.3)
        for _ in range(50):
            assert base * 0.5 <= cfg.delay_s(attempt) <= base * 1.5
    fixed = pkg.service.RetryConfig(backoff_s=0.1, jitter=0.0, rng=rng.random)
    assert fixed.delay_s(2) == pytest.approx(0.4)
    assert pkg.service.RetryConfig(backoff_s=0.1, jitter=5.0, rng=lambda: 0.0).delay_s(
        0) == pytest.approx(0.0)


def test_transport_error_kinds(upstream, pkg):
    """``connect`` on a closed port, ``read`` on a handler that sleeps past
    the read budget; both typed 503s."""
    with pytest.raises(pkg.errors.ErrorServiceUnavailable) as err:
        pkg.service.HTTPService("http://127.0.0.1:1").get("/x")
    assert err.value.kind == "connect"
    slow = pkg.service.HTTPService(upstream.address, timeout=0.3, connect_timeout_s=2)
    with pytest.raises(pkg.errors.ErrorServiceUnavailable) as err:
        slow.get("/sleep")
    assert err.value.kind == "read"
    slow.close()


def test_fault_points(upstream, pkg):
    """``http.request`` (a canned answer, a raise), ``http.stream.open``
    (lines with no socket) and ``http.stream.event`` (a truncation)."""
    svc = pkg.service.HTTPService(upstream.address)
    canned = pkg.service.Response(b'{"canned": 1}', 503, {"X-Fault": "yes"})
    with pkg.faults.armed("http.request", action=lambda **kw: canned):
        resp = svc.get("/data")
    assert resp is canned and resp.get_header("X-Fault") == "yes"
    err = pkg.errors.ErrorServiceUnavailable("refused")
    with pkg.faults.armed("http.request", raises=err, times=1):
        with pytest.raises(pkg.errors.ErrorServiceUnavailable):
            svc.get("/data")
    assert svc.get("/data").status_code == 200
    lines = ["data: 1", "", "data: 2", "", "data: [DONE]"]
    with pkg.faults.armed("http.stream.open", action=lambda **kw: lines):
        with svc.stream_lines("POST", "/v1/completions", json={}) as it:
            assert list(it) == lines
        with pkg.faults.armed("http.stream.event",
                              action=lambda index, **kw: "truncate" if index == 2 else None):
            with svc.stream_lines("POST", "/v1/completions", json={}) as it:
                assert list(it) == lines[:2]


def _completion_text(lines: list) -> tuple:
    texts, done = [], False
    for line in lines:
        if not line.startswith("data: "):
            assert line == ""
            continue
        if line == "data: [DONE]":
            done = True
            continue
        texts.append(json.loads(line[6:])["choices"][0]["text"])
    return "".join(texts), done, len(texts)


def test_stream_lines_over_sse_completions(upstream):
    """Both packages' ``stream_lines`` read the port's SSE completion to
    the same lines of text, blank separators included; an upstream error
    raises with its status."""
    body = {"model": "llama-tiny", "prompt": "stream me", "max_tokens": 8, "temperature": 0,
            "stream": True}
    got = {}
    for name, p in PKGS.items():
        svc = p.service.HTTPService(upstream.address)
        with svc.stream_lines("POST", "/v1/completions", json=body, read_timeout_s=30) as it:
            got[name] = list(it)
        with pytest.raises(p.errors.GofrError) as err:
            with svc.stream_lines("POST", "/v1/completions", json={**body, "model": "nope"}):
                pass
        assert err.value.status_code == 404
    assert _completion_text(got["port"]) == _completion_text(got["reference"])
    text, done, n = _completion_text(got["port"])
    assert done and n >= 1
    assert [line == "" for line in got["port"]] == [line == "" for line in got["reference"]]


def _metrics_text(port: int) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/metrics")
        return conn.getresponse().read().decode()
    finally:
        conn.close()


def test_app_http_service(upstream, pkg, capsys):
    """``add_http_service``: the client in ``ctx.http_service`` and in the
    aggregate health as ``service:<name>``, the overwrite warning, and its
    calls on ``app_http_service_response``."""
    app = pkg.App(config=pkg.MockConfig({"HTTP_PORT": "0", "METRICS_PORT": "0",
                                         "LOG_LEVEL": "INFO"}))
    app.add_http_service("upstream", "http://127.0.0.1:1")
    app.add_http_service("upstream", upstream.address)
    assert "service upstream already registered; overwriting" in capsys.readouterr().out

    @app.get("/via")
    def via(ctx):
        return ctx.http_service("upstream").get("/data").json()["data"]

    with _Harness(app) as h:
        health = app.container.health()
        assert health["details"]["service:upstream"]["status"] == "UP"
        conn = http.client.HTTPConnection("127.0.0.1", app.http_port, timeout=30)
        conn.request("GET", "/via")
        assert json.loads(conn.getresponse().read())["data"] == {"value": 42}
        conn.close()
        lines = [line for line in _metrics_text(app.metrics_port).splitlines()
                 if line.startswith("app_http_service_response_count")]
    # The health check's call to .well-known/alive, and the route's.
    assert len(lines) == 2
    line = next(x for x in lines if f'path="{upstream.address}/data"' in x)
    assert 'method="GET"' in line and 'status="200"' in line
    assert line.endswith(" 1") or line.endswith(" 1.0")
