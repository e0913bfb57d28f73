"""The port's framework half against the reference's, on the CPU: the same
``App(config=MockConfig(...))`` built from each package (no engine), the
same routes on port 0, and the same requests over real sockets must give
the same status, body and relevant headers (``Date``, ids and trace ids
excepted). The requests mirror ``tests/test_http_server.py`` and
``tests/test_http_wire.py``. Also here, each case run on both packages'
classes: the config overlays of ``tests/test_config.py``, the logger of
``tests/test_logging.py`` (``RemoteLevelLogger`` against a local stub
server) and the metrics manager of ``tests/test_metrics.py``, with equal
``render_prometheus`` text for the same recordings.
"""

from __future__ import annotations

import asyncio
import http.client
import http.server
import io
import json
import re
import socket
import threading
import time
from dataclasses import dataclass

import pytest

import gofr_tpu
import gofr_tpu.config
import gofr_tpu.errors
import gofr_tpu.http.response
import gofr_tpu.logging
import gofr_tpu.metrics
import gofr_tpu_torch
import gofr_tpu_torch.config
import gofr_tpu_torch.errors
import gofr_tpu_torch.http.response
import gofr_tpu_torch.logging
import gofr_tpu_torch.metrics

PKGS = {"port": gofr_tpu_torch, "reference": gofr_tpu}
BOTH = pytest.mark.parametrize("pkg", list(PKGS), ids=list(PKGS))


@dataclass
class Person:
    name: str = ""
    age: int = 0


class Harness:
    """Runs an App's asyncio lifecycle on a background thread."""

    def __init__(self, app) -> None:
        self.app = app
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True)

    def __enter__(self) -> "Harness":
        self._thread.start()
        self.run(self.app.start())
        return self

    def run(self, coro, timeout: float = 30):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

    def __exit__(self, *exc) -> None:
        try:
            self.run(self.app.stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=5)
            self.loop.close()

    def request(self, method, path, body=None, headers=None, port=None):
        conn = http.client.HTTPConnection("127.0.0.1", port or self.app.http_port, timeout=10)
        try:
            payload = None
            if body is not None:
                payload = body if isinstance(body, bytes) else json.dumps(body).encode()
            conn.request(method, path, body=payload, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def raw(self, payload: bytes) -> bytes:
        s = socket.create_connection(("127.0.0.1", self.app.http_port), timeout=10)
        try:
            s.sendall(payload)
            out = b""
            while True:
                try:
                    chunk = s.recv(65536)
                except socket.timeout:
                    break
                if not chunk:
                    break
                out += chunk
            return out
        finally:
            s.close()


def _make_app(pkg):
    """The app of tests/test_http_server.py's fixture, built from ``pkg``."""
    mod = PKGS[pkg]
    response = mod.http.response
    app = mod.App(config=mod.config.MockConfig(
        {"HTTP_PORT": "0", "METRICS_PORT": "0", "APP_NAME": "test-app"}))

    @app.get("/hello")
    def hello(ctx):
        return f"Hello {ctx.param('name') or 'World'}!"

    @app.get("/items/{id}")
    def item(ctx):
        return {"id": ctx.path_param("id")}

    @app.post("/people")
    def create_person(ctx):
        p = ctx.bind(Person)
        return {"name": p.name, "age": p.age}

    @app.delete("/items/{id}")
    def delete_item(ctx):
        return None

    @app.get("/missing")
    def missing(ctx):
        raise mod.errors.ErrorEntityNotFound("id", "42")

    @app.get("/crash")
    def crash(ctx):
        raise RuntimeError("kaboom")

    @app.get("/raw")
    def raw(ctx):
        return response.Raw([1, 2, 3])

    @app.get("/file")
    def file(ctx):
        return response.File(content=b"bytes!", content_type="text/plain")

    @app.get("/redirect")
    def redirect(ctx):
        return response.Redirect("/hello")

    @app.get("/async")
    async def async_handler(ctx):
        await asyncio.sleep(0.01)
        return "async ok"

    @app.post("/echo")
    def echo(ctx):
        return {"len": len(ctx.request.body or b"")}

    @app.get("/hdr")
    def hdr(ctx):
        return {"via": ctx.request.headers.get("x-multi", "")}

    return app


@pytest.fixture(scope="module")
def apps():
    harnesses = {pkg: Harness(_make_app(pkg)) for pkg in PKGS}
    for h in harnesses.values():
        h.__enter__()
    yield harnesses
    for h in harnesses.values():
        h.__exit__(None, None, None)


# Headers whose values must agree; Date and the trace id (random) are
# compared by presence only.
_SAME_HEADERS = ("Content-Type", "Content-Length", "Location", "Connection", "Server",
                 "Cache-Control", "Access-Control-Allow-Origin",
                 "Access-Control-Allow-Methods", "Access-Control-Allow-Headers",
                 "Transfer-Encoding")


def _masked_health(body: bytes) -> dict:
    data = json.loads(body)
    data["data"].pop("startedAt")
    return data


HTTP_CASES = [
    ("envelope", "GET", "/hello?name=TPU", None),
    ("path params", "GET", "/items/abc123", None),
    ("bind and 201", "POST", "/people", {"name": "Ada", "age": 36}),
    ("delete 204", "DELETE", "/items/1", None),
    ("typed error 404", "GET", "/missing", None),
    ("panic 500", "GET", "/crash", None),
    ("route 404", "GET", "/nope", None),
    ("method 405", "PUT", "/hello", None),
    ("raw", "GET", "/raw", None),
    ("file", "GET", "/file", None),
    ("redirect", "GET", "/redirect", None),
    ("async handler", "GET", "/async", None),
    ("alive", "GET", "/.well-known/alive", None),
    ("health", "GET", "/.well-known/health", None),
    ("cors preflight", "OPTIONS", "/hello", None),
    ("favicon", "GET", "/favicon.ico", None),
    ("head", "HEAD", "/hello", None),
]


@pytest.mark.parametrize("case", HTTP_CASES, ids=[c[0] for c in HTTP_CASES])
def test_same_http_response(apps, case):
    name, method, path, body = case
    got = {pkg: h.request(method, path, body) for pkg, h in apps.items()}
    (ps, ph, pb), (rs, rh, rb) = got["port"], got["reference"]
    assert ps == rs
    if name == "health":
        assert _masked_health(pb) == _masked_health(rb)
        assert _masked_health(pb)["data"] == {
            "name": "test-app", "version": "dev", "status": "UP", "details": {}}
    else:
        assert pb == rb
    for key in _SAME_HEADERS:
        assert ph.get(key) == rh.get(key), key
    for key in ("Date", "X-Correlation-ID"):
        assert (key in ph) == (key in rh), key
    if name == "favicon":
        assert pb[:4] == b"\x00\x00\x01\x00"


def test_keepalive_and_metrics_scrape(apps):
    """Three requests on one connection, then the metrics port: the same
    ``app_http_response`` series (route template, method, status) and
    counts on both."""
    series = {}
    for pkg, h in apps.items():
        conn = http.client.HTTPConnection("127.0.0.1", h.app.http_port, timeout=10)
        try:
            for _ in range(3):
                conn.request("GET", "/items/7")
                resp = conn.getresponse()
                assert resp.status == 200
                resp.read()
        finally:
            conn.close()
        status, _, body = h.request("GET", "/metrics", port=h.app.metrics_port)
        assert status == 200
        text = body.decode()
        assert "process_threads" in text and 'app_info{app="test-app"' in text
        series[pkg] = sorted(
            line for line in text.splitlines()
            if line.startswith("app_http_response_count") and 'path="/items/{id}"' in line)
    assert series["port"] == series["reference"]
    assert any(re.fullmatch(r'app_http_response_count\{method="GET",path="/items/\{id\}",'
                            r'status="200"\} \d+', line) for line in series["port"])


WIRE_CASES = [
    ("malformed request line", 400, b"GARBAGE\r\n\r\n"),
    ("version", 505, b"GET /hello HTTP/2.0\r\n\r\n"),
    ("http/1.0 closes", 200, b"GET /hello HTTP/1.0\r\n\r\n"),
    ("header line", 431, b"GET /hello HTTP/1.1\r\nx-big: " + b"a" * 9000 + b"\r\n\r\n"),
    ("too many headers", 431,
     b"GET /hello HTTP/1.1\r\n" + b"".join(b"x-h%d: v\r\n" % i for i in range(150))
     + b"\r\n"),
    ("malformed header", 400, b"GET /hello HTTP/1.1\r\nno-colon-here\r\n\r\n"),
    ("bad content-length", 400, b"POST /echo HTTP/1.1\r\ncontent-length: nope\r\n\r\n"),
    ("negative content-length", 400,
     b"POST /echo HTTP/1.1\r\ncontent-length: -5\r\n\r\n"),
    ("body too large", 413,
     b"POST /echo HTTP/1.1\r\ncontent-length: 99999999999\r\n\r\n"),
    # Kept alive, then a second request on the connection: the trailers
    # must be consumed, or they would be read as the next request.
    ("chunked with trailers", 201,
     b"POST /echo HTTP/1.1\r\ntransfer-encoding: chunked\r\ncontent-type: application/json"
     b"\r\n\r\n5\r\nhello\r\n6\r\n world\r\n0\r\nx-trailer: ignored\r\n\r\n"
     b"GET /hello HTTP/1.1\r\nconnection: close\r\n\r\n"),
    ("bad chunk size", 400,
     b"POST /echo HTTP/1.1\r\ntransfer-encoding: chunked\r\n\r\nzz\r\nhello\r\n0\r\n\r\n"),
    ("repeated headers", 200,
     b"GET /hdr HTTP/1.1\r\nx-multi: a\r\nx-multi: b\r\nconnection: close\r\n\r\n"),
]


def _wire_parts(resp: bytes) -> tuple[list, bytes]:
    """The status lines of every response on the connection, and the bytes
    without the Date and X-Correlation-ID headers."""
    kept = re.sub(rb"(?im)^(date|x-correlation-id): [^\r\n]*\r\n", b"", resp)
    return re.findall(rb"HTTP/1\.1 \d{3} [^\r\n]*", kept), kept


@pytest.mark.parametrize("case", WIRE_CASES, ids=[c[0] for c in WIRE_CASES])
def test_same_wire_response(apps, case):
    name, status, payload = case
    port, ref = (_wire_parts(apps[pkg].raw(payload)) for pkg in ("port", "reference"))
    assert port == ref
    statuses = [int(line.split(b" ", 2)[1]) for line in port[0]]
    assert statuses[0] == status
    body = port[1].split(b"\r\n\r\n")[1]
    if name == "chunked with trailers":
        assert statuses == [201, 200]
        assert body.startswith(b'{"data": {"len": 11}}')
    if name == "repeated headers":
        assert json.loads(body)["data"]["via"] == "a, b"


# ----------------------------------------------------------------------
# config overlays (tests/test_config.py), on both packages
# ----------------------------------------------------------------------


def _write(path, content):
    path.write_text(content)


CONFIG_CASES = [
    ("base file", {".env": "TEST_KEY_A=hello\n# comment\nTEST_KEY_B=1\n"}, {}, None,
     {"TEST_KEY_A": "hello", "TEST_KEY_B": "1"}),
    ("process env wins", {".env": "TEST_KEY_C=from-file\n"}, {"TEST_KEY_C": "from-process"},
     None, {"TEST_KEY_C": "from-process"}),
    ("local overlay", {".env": "TEST_KEY_D=base\n", ".local.env": "TEST_KEY_D=local\n"}, {},
     None, {"TEST_KEY_D": "local"}),
    ("APP_ENV overlay", {".env": "TEST_KEY_E=base\n", ".stage.env": "TEST_KEY_E=stage\n",
                         ".local.env": "TEST_KEY_E=local\n"}, {}, "stage",
     {"TEST_KEY_E": "stage"}),
    ("quotes and export", {".env": 'export TEST_KEY_F="quoted value"\n'
                                   "TEST_KEY_G=plain # trailing\n"}, {}, None,
     {"TEST_KEY_F": "quoted value", "TEST_KEY_G": "plain"}),
]


@BOTH
@pytest.mark.parametrize("case", CONFIG_CASES, ids=[c[0] for c in CONFIG_CASES])
def test_config_overlays(pkg, case, tmp_path, monkeypatch):
    _, files, env, app_env, want = case
    keys = {k for body in files.values() for k in re.findall(r"(TEST_KEY_\w)=", body)}
    for k in keys:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if app_env:
        monkeypatch.setenv("APP_ENV", app_env)
    else:
        monkeypatch.delenv("APP_ENV", raising=False)
    for name, body in files.items():
        _write(tmp_path / name, body)
    cfg = PKGS[pkg].config.new_env_file(str(tmp_path))
    try:
        assert {k: cfg.get(k) for k in want} == want
        assert cfg.get_or_default("MISSING_KEY_XYZ", "fallback") == "fallback"
    finally:
        for k in keys:
            monkeypatch.delenv(k, raising=False)


@BOTH
def test_mock_config(pkg):
    cfg = PKGS[pkg].config.MockConfig({"A": "1", "E": ""})
    assert (cfg.get("A"), cfg.get("B"), cfg.get_or_default("B", "x"),
            cfg.get_or_default("E", "y")) == ("1", None, "x", "y")


# ----------------------------------------------------------------------
# logging (tests/test_logging.py), on both packages
# ----------------------------------------------------------------------


def _logger(pkg, level="INFO", terminal=False):
    lg = PKGS[pkg].logging
    out, err = io.StringIO(), io.StringIO()
    return lg.Logger(level=lg.Level[level], out=out, err=err, is_terminal=terminal), out, err


class _Payload:
    def __init__(self):
        self.query = "SELECT 1"
        self.duration = 3


class _Pretty:
    def pretty_print(self, fp):
        fp.write("PRETTY!\n")


def _log_record(text: str) -> list:
    """The JSON lines without their timestamps."""
    recs = [json.loads(line) for line in text.strip().splitlines()]
    for r in recs:
        r.pop("time")
    return recs


LOG_CASES = {
    "json and level filter": lambda log: (log.debug("hidden"), log.info("visible", 42)),
    "error to stderr": lambda log: log.error("boom"),
    "format variants": lambda log: (log.infof("x=%d y=%s", 7, "a"), log.warnf("bad %d", "x")),
    "structured payload": lambda log: log.info(_Payload()),
    "change level": lambda log: (log.change_level(type(log.level)["ERROR"]), log.info("nope"),
                                 log.change_level(type(log.level)["DEBUG"]), log.debug("yes")),
}


@pytest.mark.parametrize("case", list(LOG_CASES), ids=list(LOG_CASES))
def test_logger_output_equal(case):
    got = {}
    for pkg in PKGS:
        log, out, err = _logger(pkg)
        LOG_CASES[case](log)
        got[pkg] = (_log_record(out.getvalue()) if out.getvalue() else [],
                    _log_record(err.getvalue()) if err.getvalue() else [])
    assert got["port"] == got["reference"]
    assert got["port"] != ([], [])


@BOTH
def test_logger_terminal_fatal_and_levels(pkg, tmp_path):
    lg = PKGS[pkg].logging
    log, out, _ = _logger(pkg, terminal=True)
    log.info(_Pretty())
    assert "PRETTY!" in out.getvalue() and "INFO" in out.getvalue()
    log, _, err = _logger(pkg)
    with pytest.raises(SystemExit):
        log.fatal("dying")
    assert "dying" in err.getvalue()
    assert [lg.level_from_string(s) for s in ("debug", "WARN", "bogus", None)] == [
        lg.Level.DEBUG, lg.Level.WARN, lg.Level.INFO, lg.Level.INFO]
    flog = lg.new_file_logger(str(tmp_path / "cmd.log"))
    flog.info("to file")
    flog._out.flush()
    assert "to file" in (tmp_path / "cmd.log").read_text()
    lg.new_file_logger("").info("discarded")


@pytest.fixture(scope="module")
def level_server():
    """A local stub of the remote log-level endpoint; ``payload`` is live."""
    payload = {"data": [{"serviceName": "t", "logLevel": {"LOG_LEVEL": "DEBUG"}}]}

    class LevelHandler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), LevelHandler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/level", payload
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=5)


@BOTH
def test_remote_level_logger(pkg, level_server):
    """One poll hot-swaps the level; the background loop follows a change
    on its interval; empty data keeps the level; a dead endpoint is
    swallowed; no URL starts no thread."""
    url, payload = level_server
    lg = PKGS[pkg].logging
    payload["data"] = [{"serviceName": "t", "logLevel": {"LOG_LEVEL": "DEBUG"}}]
    log, _, _ = _logger(pkg)
    rl = lg.RemoteLevelLogger(log, url)
    rl.fetch_and_update()
    assert log.level == lg.Level.DEBUG
    rl.stop()

    payload["data"] = [{"serviceName": "t", "logLevel": {"LOG_LEVEL": "ERROR"}}]
    log, _, _ = _logger(pkg)
    rl = lg.RemoteLevelLogger(log, url, interval_s=0.05)
    rl.start()
    deadline = time.time() + 10
    while log.level != lg.Level.ERROR and time.time() < deadline:
        time.sleep(0.02)
    assert log.level == lg.Level.ERROR
    payload["data"] = []
    time.sleep(0.2)
    assert log.level == lg.Level.ERROR
    rl.stop()
    rl._thread.join(timeout=5)
    assert not rl._thread.is_alive()

    log, _, _ = _logger(pkg)
    dead = lg.RemoteLevelLogger(log, "http://127.0.0.1:1/level")
    dead.fetch_and_update()
    assert log.level == lg.Level.INFO
    dead.stop()
    off = lg.RemoteLevelLogger(log, "")
    off.start()
    assert off._thread is None


# ----------------------------------------------------------------------
# metrics (tests/test_metrics.py): equal exposition for equal recordings
# ----------------------------------------------------------------------


def _manager(pkg):
    lg = PKGS[pkg].logging
    out, err = io.StringIO(), io.StringIO()
    log = lg.Logger(level=lg.Level.DEBUG, out=out, err=err, is_terminal=False)
    return PKGS[pkg].metrics.Manager(logger=log), out, err


def _record_all(m):
    m.new_counter("reqs", "request count")
    m.increment_counter("reqs", "path", "/hello", "method", "GET")
    m.increment_counter("reqs", "path", "/hello", "method", "GET")
    m.add_counter("reqs", 3, "path", "/x", "method", "POST")
    m.new_gauge("hbm_used", "bytes")
    m.set_gauge("hbm_used", 10.0, "chip", "0")
    m.set_gauge("hbm_used", 20.0, "chip", "0")
    m.new_updown_counter("inflight")
    m.delta_updown_counter("inflight", 2)
    m.delta_updown_counter("inflight", -1)
    m.new_histogram("lat", "latency", buckets=[0.1, 1.0, 10.0])
    for v in (0.05, 0.5, 5.0, 50.0):
        m.record_histogram("lat", v, "kind", "a")
    m.new_histogram("h2", buckets=[1.0, 2.0])
    m.record_histogram("h2", 1.0)
    m.new_histogram("dflt", 'a "quoted"\ndescription')
    m.record_histogram("dflt", 0.3, "z", 'v"\\', "a", "1")


def _exposition(pkg) -> list[str]:
    """render_prometheus without the per-scrape runtime values."""
    m, _, _ = _manager(pkg)
    _record_all(m)
    text = PKGS[pkg].metrics.render_prometheus(m, app_name="test-app")
    return [re.sub(r"^((process|python)_\w+) .*", r"\1", line) for line in text.splitlines()]


def test_render_prometheus_equal():
    port, ref = _exposition("port"), _exposition("reference")
    assert port == ref
    assert 'reqs{method="GET",path="/hello"} 2.0' in port
    assert 'lat_bucket{kind="a",le="10.0"} 3' in port
    assert 'h2_bucket{le="1.0"} 1' in port
    assert "inflight 1.0" in port
    assert 'app_info{app="test-app",framework_version="0.1.0-dev"} 1' in port


METRIC_ERROR_CASES = {
    "unregistered": (lambda m: m.increment_counter("nope"), "not registered"),
    "duplicate": (lambda m: (m.new_counter("dup"), m.new_counter("dup")), "already registered"),
    "wrong type": (lambda m: (m.new_counter("c1"), m.set_gauge("c1", 5.0)), "not of type"),
    "odd labels": (lambda m: (m.new_counter("c2"), m.increment_counter("c2", "k")), "key/value"),
}


@pytest.mark.parametrize("case", list(METRIC_ERROR_CASES), ids=list(METRIC_ERROR_CASES))
def test_metrics_errors_logged_alike(case):
    fn, needle = METRIC_ERROR_CASES[case]
    msgs = {}
    for pkg in PKGS:
        m, _, err = _manager(pkg)
        fn(m)
        msgs[pkg] = [r["message"] for r in _log_record(err.getvalue())]
    assert msgs["port"] == msgs["reference"]
    assert needle in msgs["port"][0]


@BOTH
def test_cardinality_warning(pkg):
    m, out, _ = _manager(pkg)
    m.new_counter("wide")
    for i in range(25):
        m.increment_counter("wide", "id", str(i))
    assert "high cardinality" in out.getvalue()


def test_framework_errors_match_reference():
    """Every error type both packages have: same status and message."""
    ref, port = gofr_tpu.errors, gofr_tpu_torch.errors
    cases = {
        "ErrorEntityNotFound": ("id", "42"), "ErrorEntityAlreadyExists": (),
        "ErrorInvalidParam": (["a", "b"],), "ErrorMissingParam": (["a"],),
        "ErrorInvalidRoute": (), "ErrorRequestTimeout": (), "ErrorPanicRecovery": (),
        "ErrorServiceUnavailable": ("engine draining",),
        "ErrorPayloadTooLarge": ("file", 10, 5), "ErrorTooManyRequests": ("queue", 2.5),
        "ErrorDeadlineExceeded": ("late",), "ErrorRequestCancelled": (),
        "ErrorPromptTooLong": (300, 100),
    }
    for name, args in cases.items():
        a, b = getattr(port, name)(*args), getattr(ref, name)(*args)
        assert (a.status_code, str(a), getattr(a, "headers", None)) == (
            b.status_code, str(b), getattr(b, "headers", None)), name
