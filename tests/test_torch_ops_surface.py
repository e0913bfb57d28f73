"""The port's operations surface against the reference's: the trace
exporters (zipkin and OTLP bodies for the same spans, equal, at a local
``http.server`` collector; ``TRACE_EXPORTER`` selection; a dead collector
blocking no request; spans flushed by ``App.stop``), ``new_cmd``
(``sub_command``, flags, an unknown command, ``bind``, a command calling
``ctx.infer_sync`` on ``llama-tiny-f32``), and the metrics port's
``/debug/*`` routes: ``threads``, ``engine``, ``capacity``, ``lockgraph``
and ``tpu-trace`` against the reference App's (statuses, content types
and keys), the routes of the unported operations plane answering 501,
and ``/debug/tpu-trace`` handing its profiler start and stop to the
engine's scheduler thread (an injected starter and stopper record the
thread they ran on).
"""

from __future__ import annotations

import asyncio
import http.client
import io
import json
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, HTTPServer

import jax
import numpy as np
import pytest

import gofr_tpu
import gofr_tpu.app
import gofr_tpu.cli as ref_cli
import gofr_tpu.config
import gofr_tpu.serving.profiler_capture as ref_capture
import gofr_tpu.tracing as ref_tracing
import gofr_tpu_torch
import gofr_tpu_torch.app
import gofr_tpu_torch.cli as port_cli
import gofr_tpu_torch.config
import gofr_tpu_torch.serving.profiler_capture as port_capture
import gofr_tpu_torch.tracing as port_tracing
from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.serving.checkpoint import save_checkpoint
from gofr_tpu_torch.weights import params_from_jax

PKGS = {"port": gofr_tpu_torch, "reference": gofr_tpu}
TRACING = {"port": port_tracing, "reference": ref_tracing}
CLI = {"port": port_cli, "reference": ref_cli}
CAPTURE = {"port": port_capture, "reference": ref_capture}


def _config(pkg, keys):
    return PKGS[pkg].config.MockConfig(keys)


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------


@pytest.fixture
def collector():
    """A local HTTP sink recording (path, body) of every POST."""
    received: list[tuple[str, bytes]] = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            received.append((self.path, body))
            self.send_response(202)
            self.end_headers()

        def log_message(self, *args):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_port}", received
    srv.shutdown()
    srv.server_close()


SPANS = [
    dict(name="GET /hello", trace_id="0af7651916cd43dd8448eb211c80319c",
         span_id="b7ad6b7169203331", parent_id="00f067aa0ba902b7",
         start_ns=1_700_000_000_000_000_000, end_ns=1_700_000_000_005_000_000,
         attributes={"http.status": 200}),
    dict(name="tpu.infer", trace_id="0af7651916cd43dd8448eb211c80319c",
         span_id="c000000000000001", parent_id=None, start_ns=1_700_000_000_000_000_123,
         end_ns=1_700_000_000_900_000_000, attributes={"n": 3, "model": "m"}, status="ERROR"),
]


@pytest.mark.parametrize("kind,path", [("ZipkinExporter", "/api/v2/spans"),
                                       ("OTLPExporter", "/v1/traces")])
def test_exporter_bodies_match_the_reference(collector, kind, path):
    """The same spans give the same JSON body in both packages; OTLP ids
    are hex and its times nanoseconds as strings."""
    url, received = collector
    bodies = {}
    for pkg, mod in TRACING.items():
        received.clear()
        exp = getattr(mod, kind)(url + path, flush_interval_s=0.05)
        for fields in SPANS:
            exp.export(mod.Span(**fields), "svc-a")
        exp.shutdown()
        assert [p for p, _ in received] == [path]
        bodies[pkg] = json.loads(received[0][1])
    assert bodies["port"] == bodies["reference"]
    if kind == "OTLPExporter":
        spans = bodies["port"]["resourceSpans"][0]["scopeSpans"][0]["spans"]
        assert spans[0]["startTimeUnixNano"] == "1700000000000000000"
        assert [s["kind"] for s in spans] == [1, 2] and spans[1]["status"] == {"code": 2}
    else:
        assert bodies["port"][0]["duration"] == 5000
        assert bodies["port"][0]["tags"] == {"http.status": "200"}


@pytest.mark.parametrize("keys,expect", [
    ({"TRACE_EXPORTER": "jaeger", "TRACER_URL": "http://j:4318"}, "OTLPExporter"),
    ({"TRACE_EXPORTER": "otlp", "TRACER_URL": "http://j:4318/v1/traces"}, "OTLPExporter"),
    ({"TRACE_EXPORTER": "zipkin", "TRACER_URL": "http://z:9411/api/v2/spans"}, "ZipkinExporter"),
    ({"TRACE_EXPORTER": "gofr", "TRACER_URL": "http://g/api/spans"}, "ZipkinExporter"),
    ({"TRACE_EXPORTER": "jaeger"}, "NoopExporter"),
    ({"TRACE_EXPORTER": "console"}, "ConsoleExporter"),
    ({"TRACE_EXPORTER": "none"}, "NoopExporter"),
    ({}, "NoopExporter"),
])
def test_exporter_selection_matches_the_reference(keys, expect):
    out = {}
    for pkg, mod in TRACING.items():
        exp = mod.exporter_from_config(_config(pkg, keys))
        out[pkg] = (type(exp).__name__, getattr(exp, "_url", None))
        if hasattr(exp, "_stop"):
            exp._stop.set()  # its thread ends at its next poll; nothing to flush
    assert out["port"] == out["reference"] and out["port"][0] == expect


def test_console_exporter_matches_the_reference(capsys):
    lines = {}
    for pkg, mod in TRACING.items():
        mod.ConsoleExporter().export(mod.Span(**SPANS[0]), "svc")
        lines[pkg] = json.loads(capsys.readouterr().out)
    assert lines["port"] == lines["reference"]


def _app_with_exporter(url, pkg="port"):
    app = PKGS[pkg].App(config=_config(pkg, {
        "APP_NAME": "traced", "HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "WARN",
        "TRACE_EXPORTER": "zipkin", "TRACER_URL": url}))

    @app.get("/hello")
    def hello(ctx):
        with ctx.trace("work"):
            return "hi"

    return app


def _drive_app(app, paths):
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    took = []
    try:
        asyncio.run_coroutine_threadsafe(app.start(), loop).result(30)
        for path in paths:
            t0 = time.monotonic()
            conn = http.client.HTTPConnection("127.0.0.1", app.http_port, timeout=30)
            conn.request("GET", path)
            assert conn.getresponse().read()
            conn.close()
            took.append(time.monotonic() - t0)
    finally:
        asyncio.run_coroutine_threadsafe(app.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(5)
        loop.close()
    return took


def test_app_ships_zipkin_spans_and_flushes_them_on_stop(collector):
    """TRACE_EXPORTER=zipkin: each request's server span (its path and
    status tags), the handler's span and its child reach the collector
    before App.stop returns (the batcher's interval is 2 s: stop flushes),
    with the names, tags and parent links of the reference App's."""
    url, received = collector
    shapes = {}
    for pkg in PKGS:
        received.clear()
        _drive_app(_app_with_exporter(url + "/api/v2/spans", pkg), ["/hello", "/nope"])
        spans = [s for _, body in received for s in json.loads(body)]
        by_id = {s["id"]: s["name"] for s in spans}
        shapes[pkg] = sorted(
            (s["name"], by_id.get(s.get("parentId")), s["localEndpoint"]["serviceName"],
             sorted((k, v) for k, v in s["tags"].items() if k != "http.response_time"))
            for s in spans)
    assert shapes["port"] == shapes["reference"]
    names = [s[:2] for s in shapes["port"]]
    assert names == [("GET /hello", None), ("GET /nope", None),
                     ("gofr-handler", "GET /hello"), ("work", "GET /hello")]
    tags = {s[0]: dict(s[3]) for s in shapes["port"]}
    assert "200" in tags["GET /hello"].values() and "404" in tags["GET /nope"].values()


def test_a_dead_collector_blocks_no_request():
    with HTTPServer(("127.0.0.1", 0), BaseHTTPRequestHandler) as srv:
        dead = srv.server_port  # closed below: nothing listens there
    took = _drive_app(_app_with_exporter(f"http://127.0.0.1:{dead}/api/v2/spans"),
                      ["/hello"] * 5)
    assert max(took) < 1.0, took


# ---------------------------------------------------------------------------
# new_cmd
# ---------------------------------------------------------------------------


def _run_cmd(app, argv):
    out, err = io.StringIO(), io.StringIO()
    code = app.run(argv, out=out, err=err)
    return code, out.getvalue(), err.getvalue()


@dataclass
class Args:
    name: str = ""
    count: int = 0


def _cmd_observables(pkg):
    mod = CLI[pkg]
    app = mod.CMDApp(config=_config(pkg, {}))
    app.sub_command("^job run", lambda ctx: "specific")
    app.sub_command("^job", lambda ctx: "generic")

    @app.sub_command("^hello", description="says hello")
    def hello(ctx):
        return {"hello": ctx.param("name") or "World", "verbose": ctx.param("verbose"),
                "tags": ctx.params("tags")}

    @app.sub_command("^fail")
    def fail(ctx):
        raise ValueError("boom")

    runs = [_run_cmd(app, argv) for argv in (
        ["hello"], ["hello", "-name=Ada", "--verbose", "-tags=a,b"], ["job", "run"], ["job"],
        ["fail"], ["unknown"], ["help"], [], ["-x=1"])]
    req = mod.CMDRequest(["run", "-name=x", "-count=3", "--", "extra"])
    return runs, req.bind(Args), req.command, req.param("name"), req.body


def test_cmd_matches_the_reference():
    port = _cmd_observables("port")
    assert port == _cmd_observables("reference")
    runs = port[0]
    assert runs[0] == (0, '{"hello": "World", "verbose": "", "tags": []}\n', "")
    assert runs[4] == (1, "", "boom\n") and runs[5] == (1, "", "No Command Found!\n")
    assert port[1] == Args(name="x", count=3)


def test_new_cmd_is_exported_and_reads_its_config_dir(tmp_path):
    (tmp_path / ".env").write_text("APP_NAME=cli-app\n")
    assert gofr_tpu_torch.new_cmd is gofr_tpu_torch.app.new_cmd
    for pkg in PKGS:
        app = PKGS[pkg].app.new_cmd(config_dir=str(tmp_path))
        assert app.container.app_name == "cli-app", pkg


MODEL = "llama-tiny-f32"


@pytest.fixture(scope="module")
def jax_params():
    return init_transformer(jax.random.PRNGKey(11), ref_get_model(MODEL).config)


def test_cmd_infer_sync_matches_the_reference(jax_params, tmp_path):
    """A ``generate`` sub-command calling ``ctx.infer_sync``: the port's
    engine from config (the reference's weights through TPU_CHECKPOINT),
    the reference's injected with the same weights; the same text."""
    ckpt = str(tmp_path / "w.pt")
    save_checkpoint(ckpt, params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                                          get_model(MODEL).config, device="cpu"))
    out = {}
    for pkg in PKGS:
        keys = {"TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "128"}
        if pkg == "port":
            keys.update(TPU_MODEL=MODEL, TPU_DEVICE="cpu", TPU_CHECKPOINT=ckpt)
        app = CLI[pkg].CMDApp(config=_config(pkg, keys))
        if pkg == "reference":
            app.container.tpu = RefEngine(MODEL, params=jax_params, n_slots=2, max_len=128,
                                          tokenizer=RefByteTokenizer())
            app.container.tpu.start_sync()

        @app.sub_command("^generate")
        def generate(ctx):
            res = ctx.infer_sync(ctx.param("prompt"), max_new_tokens=int(ctx.param("n")),
                                 stop_on_eos=False)
            return {"text": res["text"], "tokens": res["tokens"]}

        try:
            out[pkg] = _run_cmd(app, ["generate", "-prompt=the cli", "-n=8"])
        finally:
            app.container.tpu.close() if pkg == "port" else app.container.tpu.stop_sync()
    assert out["port"] == out["reference"]
    assert out["port"][0] == 0 and json.loads(out["port"][1])["tokens"] == 8


# ---------------------------------------------------------------------------
# /debug/* on the metrics port
# ---------------------------------------------------------------------------


class Harness:
    def __init__(self, app) -> None:
        self.app = app
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._thread.start()
        asyncio.run_coroutine_threadsafe(app.start(), self.loop).result(120)

    def close(self) -> None:
        try:
            asyncio.run_coroutine_threadsafe(self.app.stop(), self.loop).result(60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=5)
            self.loop.close()

    def get(self, path):
        conn = http.client.HTTPConnection("127.0.0.1", self.app.metrics_port, timeout=60)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.getheader("Content-Type"), resp.read()
        finally:
            conn.close()


@pytest.fixture(scope="module")
def debug_apps():
    keys = {"APP_NAME": "debug-test", "HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "WARN",
            "TPU_MODEL": "llama-tiny", "TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "64",
            "TPU_KV_BLOCK": "16"}
    apps = {}
    try:
        apps["port"] = Harness(gofr_tpu_torch.App(config=_config(
            "port", dict(keys, TPU_DEVICE="cpu"))))
        apps["reference"] = Harness(gofr_tpu.App(config=_config("reference", keys)))
        yield apps
    finally:
        for h in apps.values():
            h.close()


def _both(apps, path):
    return {pkg: h.get(path) for pkg, h in apps.items()}


def test_alive_and_404_match_the_reference(debug_apps):
    for path in ("/.well-known/alive", "/debug/nope", "/metrics"):
        got = _both(debug_apps, path)
        assert got["port"][:2] == got["reference"][:2], path
    assert got["port"][0] == 200


def test_debug_threads_lists_the_scheduler_with_its_stack(debug_apps):
    got = _both(debug_apps, "/debug/threads")
    assert got["port"][:2] == got["reference"][:2] == (200, "text/plain")
    text = got["port"][2].decode()
    eng = debug_apps["port"].app.container.tpu
    block = text.split(f"Thread {eng._thread.name} (ident {eng._thread.ident}):")[1]
    block = block.split("\nThread ")[0]
    assert "in _run" in block and 'File "' in block


def test_debug_engine_is_the_health_check(debug_apps):
    got = _both(debug_apps, "/debug/engine")
    assert got["port"][:2] == got["reference"][:2] == (200, "application/json")
    port, ref = json.loads(got["port"][2]), json.loads(got["reference"][2])
    assert set(port) == set(ref) == {"tpu"}
    assert port["tpu"] == debug_apps["port"].app.container.tpu.health_check()
    assert port["tpu"]["status"] == "UP" and port["tpu"]["details"]["model"] == "llama-tiny"
    assert set(port["tpu"]) == set(ref["tpu"])


def test_debug_capacity_is_the_ledger_and_the_pool(debug_apps):
    got = _both(debug_apps, "/debug/capacity")
    assert got["port"][:2] == got["reference"][:2] == (200, "application/json")
    port, ref = json.loads(got["port"][2])["tpu"], json.loads(got["reference"][2])["tpu"]
    eng = debug_apps["port"].app.container.tpu
    assert port["hbm"] == eng.hbm_ledger() and port["compiles"] == eng.compile_stats()
    # The reference's loop, tenant, SLO, brownout and control blocks read
    # the operations plane's components (not ported): absent here.
    assert set(port) == {"model", "state", "hbm", "compiles", "kv_pool"}
    assert set(port) <= set(ref)
    assert set(ref) - set(port) <= {"loop", "tenants", "slo", "brownout", "control"}
    assert set(port["hbm"]) == set(ref["hbm"])
    assert set(port["kv_pool"]) == set(ref["kv_pool"])
    assert port["kv_pool"]["total_blocks"] == ref["kv_pool"]["total_blocks"]
    assert port["kv_pool"]["block_tokens"] == 16 and port["model"] == "llama-tiny"


def test_debug_lockgraph_matches_the_reference_shape(debug_apps):
    got = _both(debug_apps, "/debug/lockgraph")
    assert got["port"][:2] == got["reference"][:2] == (200, "application/json")
    port, ref = json.loads(got["port"][2]), json.loads(got["reference"][2])
    assert set(port) == set(ref) == {"runtime", "static", "diff", "violations"}
    assert set(port["runtime"]) == set(ref["runtime"])
    assert set(port["diff"]) == set(ref["diff"])
    # The port has no static model (no graftlint): empty, as the
    # reference's is when graftlint cannot run.
    assert port["static"] == {"edges": [], "witnesses": {}}
    assert port["diff"]["static_only"] == [] and port["violations"] == []


@pytest.mark.parametrize("path", ["/debug/flight", "/debug/loop", "/debug/tenants",
                                  "/debug/slo", "/debug/brownout", "/debug/control",
                                  "/debug/async", "/ops/tier-import", "/ops/tier-export"])
def test_operations_plane_routes_answer_501(debug_apps, path):
    """The reference answers these from its operations plane (ROADMAP
    Queue 1 item 7); the port answers 501 naming the item, never an
    empty report."""
    status, ctype, body = debug_apps["port"].get(path)
    assert (status, ctype) == (501, "application/json")
    assert "ROADMAP Queue 1 item 7." in json.loads(body)["error"]
    assert debug_apps["reference"].get(path)[0] != 404


@pytest.fixture
def recording_captures(monkeypatch):
    """Both packages' capture singletons with a starter and a stopper that
    record the thread they ran on (no profiler runs)."""
    seen = {pkg: [] for pkg in CAPTURE}
    for pkg, mod in CAPTURE.items():
        cap = mod.get_capture()
        monkeypatch.setattr(cap, "_starter",
                            lambda d, pkg=pkg: seen[pkg].append(("start", threading.current_thread())))
        monkeypatch.setattr(cap, "_stopper",
                            lambda pkg=pkg: seen[pkg].append(("stop", threading.current_thread())))
    return seen


def test_debug_tpu_trace_matches_the_reference(debug_apps, recording_captures):
    """``ms`` validated (400), a 409 while a capture runs, and the
    reference's ``{"trace_dir", "captured_ms"}`` body; the port's start
    and stop ran on the scheduler thread of the engine that drives the
    device."""
    got = _both(debug_apps, "/debug/tpu-trace?ms=nope")
    assert got["port"] == got["reference"] and got["port"][0] == 400
    for pkg, mod in CAPTURE.items():
        cap = mod.get_capture()
        assert cap.try_acquire()
        try:
            st, ctype, body = debug_apps[pkg].get("/debug/tpu-trace?ms=10")
        finally:
            cap.release()
        assert (st, json.loads(body)) == (409, {"error": "a trace capture is already running"})
    got = _both(debug_apps, "/debug/tpu-trace?ms=30")
    for pkg, (st, ctype, body) in got.items():
        assert (st, ctype) == (200, "application/json"), (pkg, body)
        assert json.loads(body) == {"trace_dir": CAPTURE[pkg].get_capture().trace_dir,
                                    "captured_ms": 30}
    # The thread of the engine that drives the device: the first one
    # registered (this module's, unless another test left one serving).
    owner = port_capture.device_owner()
    assert owner is not None
    assert [(k, t is owner._thread) for k, t in recording_captures["port"]] == [
        ("start", True), ("stop", True)]
    assert [k for k, _ in recording_captures["reference"]] == ["start", "stop"]


def test_debug_tpu_trace_caps_ms_and_runs_off_the_loop_without_an_engine(
        recording_captures, monkeypatch):
    """No engine drives the device: the capture starts and stops on its
    own (executor) thread, never on the event loop's; ``ms`` is capped at
    30,000 (the sleep is recorded, not slept)."""
    cap = port_capture.get_capture()
    slept = []
    monkeypatch.setattr(cap, "_sleep", slept.append)
    monkeypatch.setattr(port_capture, "device_owner", lambda: None)
    app = gofr_tpu_torch.App(config=gofr_tpu_torch.config.MockConfig({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "WARN"}))
    h = Harness(app)
    try:
        loop_thread = h._thread
        st, _, body = h.get("/debug/tpu-trace?ms=999999")
    finally:
        h.close()
    assert st == 200 and json.loads(body)["captured_ms"] == 30_000 and slept == [30.0]
    threads = [t for _, t in recording_captures["port"]]
    assert len(threads) == 2 and threads[0] is threads[1] and threads[0] is not loop_thread
