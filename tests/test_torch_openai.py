"""The port's App serving the OpenAI routes against the reference's, on
the CPU. Both Apps serve ``llama-tiny-f32`` with the same weights
(``init_transformer(PRNGKey(11))``, brought over with ``params_from_jax``);
the engines are injected as ``app.container.tpu`` (the reference's own
seam, ``tests/test_openai_compat.py``) and record into their App's
metrics. The same requests, mirroring ``tests/test_openai_compat.py``,
must give equal JSON bodies (``id`` and ``created`` aside; logprobs within
``LOGPROB_TOL``), equal SSE event sequences and equal error statuses and
messages. Also: ``ctx.infer`` through a route, the deadline header and a
client disconnect retiring a generation, equal ``app_tpu_*`` lines on
``/metrics``, ``/.well-known/health``, the ``TPU_DRAIN_S`` drain,
``InferenceEngine.from_config`` on one config in both packages, the
unported ``TPU_*`` keys, and an App that asks for CUDA where there is
none.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import re
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

import gofr_tpu
import gofr_tpu.config
import gofr_tpu.serving.backend
import gofr_tpu.serving.openai_compat as ref_oai
import gofr_tpu_torch
import gofr_tpu_torch.config
import gofr_tpu_torch.serving.openai_compat as port_oai
from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.registry import list_models as ref_list_models
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.serving import backend as port_backend
from gofr_tpu_torch.serving import engine as port_engine_mod
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax

MODEL = "llama-tiny-f32"
GEOMETRY = dict(n_slots=2, max_len=256, window_k=4, prefill_chunk=16, prefill_batch=2)
# Penalties and 3 top logprobs compiled in; a throughput prior so high that
# projected-wait shedding only refuses deadlines shorter than a few ms.
FLAGS = dict(enable_penalties=True, top_logprobs=3, expected_tps=1e5)
# f32 logprobs from two implementations, rounded to 6 decimals by the route.
LOGPROB_TOL = 1e-4
PKGS = {"port": gofr_tpu_torch, "reference": gofr_tpu}
OAI = {"port": port_oai, "reference": ref_oai}


def _slow(base):
    """A byte tokenizer whose decode can be slowed: the engines decode once
    a token when a request has stop strings, so a slow decode holds a
    generation open long enough to disconnect or expire mid-stream."""

    class Slow(base):
        delay_s = 0.0

        def decode(self, ids):
            if self.delay_s:
                time.sleep(self.delay_s)
            return super().decode(ids)

    return Slow()


class Harness:
    def __init__(self, app) -> None:
        self.app = app
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._thread.start()
        self.run(app.start())

    def run(self, coro, timeout: float = 60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

    def close(self) -> None:
        try:
            self.run(self.app.stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=5)
            self.loop.close()

    def request(self, method, path, body=None, headers=None, port=None):
        conn = http.client.HTTPConnection("127.0.0.1", port or self.app.http_port, timeout=120)
        try:
            payload = None
            if body is not None:
                payload = body if isinstance(body, bytes) else json.dumps(body).encode()
            conn.request(method, path, body=payload, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()


@pytest.fixture(scope="module")
def jax_params():
    return init_transformer(jax.random.PRNGKey(11), ref_get_model(MODEL).config)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                           get_model(MODEL).config, device="cpu")


def _engine(pkg, jax_params, port_params, app, **extra):
    kw = dict(GEOMETRY, **FLAGS, metrics=app.container.metrics, logger=app.logger, **extra)
    if pkg == "port":
        return InferenceEngine(MODEL, params=port_params, tokenizer=_slow(ByteTokenizer),
                               device="cpu", **kw)
    return RefEngine(MODEL, params=jax_params, tokenizer=_slow(RefByteTokenizer), **kw)


def _serve(pkg, jax_params, port_params, **config):
    mod = PKGS[pkg]
    app = mod.App(config=mod.config.MockConfig(
        {"APP_NAME": "oai-test", "HTTP_PORT": "0", "METRICS_PORT": "0", **config}))
    app.container.tpu = _engine(pkg, jax_params, port_params, app)
    OAI[pkg].add_openai_routes(app)

    @app.post("/generate")
    async def generate(ctx):
        body = ctx.request.json()
        return await ctx.infer(body.get("prompt", ""), max_new_tokens=4, stop_on_eos=False)

    return Harness(app)


@pytest.fixture(scope="module")
def apps(jax_params, port_params):
    harnesses = {pkg: _serve(pkg, jax_params, port_params) for pkg in PKGS}
    yield harnesses
    for h in harnesses.values():
        h.close()


def _both(apps, method, path, body=None, headers=None):
    return {pkg: h.request(method, path, body, headers) for pkg, h in apps.items()}


def _close(a, b, path="$"):
    """Equal JSON values, floats within LOGPROB_TOL."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), path
        assert abs(a - b) <= LOGPROB_TOL, (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _strip(obj):
    """A response body without its request id and creation time."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _sse(body: bytes) -> list:
    events = []
    for block in body.decode().split("\n\n"):
        if not block.strip():
            continue
        assert block.startswith("data: "), block
        data = block[len("data: "):]
        events.append(data if data == "[DONE]" else _strip(json.loads(data)))
    return events


def _same(got) -> tuple:
    """Assert the port's answer equals the reference's; return the port's
    (status, parsed body)."""
    (ps, ph, pb), (rs, rh, rb) = got["port"], got["reference"]
    assert ps == rs, (ps, pb, rs, rb)
    assert ph.get("Content-Type") == rh.get("Content-Type")
    if ph.get("Content-Type") == "text/event-stream":
        port, ref = _sse(pb), _sse(rb)
        assert ph.get("Transfer-Encoding") == "chunked"
    else:
        port, ref = _strip(json.loads(pb)), _strip(json.loads(rb))
    _close(port, ref)
    return ps, port


HELLO = {"prompt": "hello", "max_tokens": 8, "temperature": 0}
CHAT = {"messages": [{"role": "system", "content": "be brief"},
                     {"role": "user", "content": "hi"}], "max_tokens": 6, "temperature": 0}

CASES = {
    "completions": ("/v1/completions", dict(HELLO, model=MODEL)),
    "chat": ("/v1/chat/completions", CHAT),
    "completions stream": ("/v1/completions", dict(HELLO, stream=True)),
    "chat stream": ("/v1/chat/completions", dict(CHAT, stream=True)),
    "n and logprobs": ("/v1/completions", {"prompt": "abc", "max_tokens": 5, "temperature": 0,
                                           "n": 2, "logprobs": 2}),
    "logprobs clamped to the engine's 3": ("/v1/completions", dict(HELLO, logprobs=5)),
    "chat logprobs and top_logprobs": ("/v1/chat/completions",
                                       dict(CHAT, logprobs=True, top_logprobs=2)),
    "penalties": ("/v1/completions", {"prompt": "aaaa", "max_tokens": 16, "temperature": 0,
                                      "frequency_penalty": 1.0, "presence_penalty": 0.5}),
    "echo": ("/v1/completions", {"prompt": "hey", "max_tokens": 4, "temperature": 0,
                                 "echo": True}),
    "echo token ids": ("/v1/completions", {"prompt": [104, 105], "max_tokens": 4,
                                           "temperature": 0, "echo": True}),
    "include_usage": ("/v1/completions", dict(HELLO, stream=True,
                                              stream_options={"include_usage": True})),
    "include_tokens": ("/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 8,
                                           "temperature": 0, "stream": True,
                                           "stream_options": {"include_tokens": True}}),
    "null params and token ids": ("/v1/completions", {
        "prompt": [72, 105], "max_tokens": 4, "temperature": 0, "top_p": None,
        "frequency_penalty": None, "presence_penalty": None, "seed": None,
        "logit_bias": None}),
    "batch prompts": ("/v1/completions", {"prompt": ["ab", "cd"], "max_tokens": 3,
                                          "temperature": 0}),
    "batch token ids": ("/v1/completions", {"prompt": [[1, 2], [3, 4, 5]], "max_tokens": 3,
                                            "temperature": 0}),
    "top_p 0 is greedy": ("/v1/completions", dict(HELLO, top_p=0, temperature=0.9)),
    "logit_bias": ("/v1/completions", dict(HELLO, logit_bias={"65": 100})),
    "max_completion_tokens": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "max_completion_tokens": 3,
        "temperature": 0}),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_same_completion(apps, case):
    path, body = CASES[case]
    status, out = _same(_both(apps, "POST", path, body))
    assert status == 200
    if case == "top_p 0 is greedy":
        _, greedy = _same(_both(apps, "POST", path, HELLO))
        assert out["choices"] == greedy["choices"]
    if case == "logit_bias":
        assert out["choices"][0]["text"] == "A" * 8
    if isinstance(out, list):  # SSE: chunks, then [DONE]
        assert out[-1] == "[DONE]" and len(out) >= 3
        if case == "include_tokens":
            ids = [t for ev in out[:-1] for t in ev["choices"][0].get("token_ids", [])]
            assert len(ids) == 8 and out[-2]["choices"][0]["prompt_tokens"] == 3
        if case == "include_usage":
            assert out[-2]["choices"] == [] and out[-2]["usage"]["completion_tokens"] == 8
    elif case == "n and logprobs":
        assert [c["index"] for c in out["choices"]] == [0, 1]
        assert all(1 <= len(d) <= 2 for d in out["choices"][0]["logprobs"]["top_logprobs"])
    elif case == "logprobs clamped to the engine's 3":
        assert all(len(d) <= 3 for d in out["choices"][0]["logprobs"]["top_logprobs"])


ERROR_CASES = {
    "invalid json": ("/v1/completions", b"{nope", 400),
    "n 0": ("/v1/completions", dict(HELLO, n=0), 400),
    "n too large": ("/v1/completions", dict(HELLO, n=17), 400),
    "stream with n 2": ("/v1/completions", dict(HELLO, stream=True, n=2), 400),
    "five stops": ("/v1/completions", dict(HELLO, stop=["a", "b", "c", "d", "e"]), 400),
    "empty stop": ("/v1/completions", dict(HELLO, stop=[""]), 400),
    "empty prompt list": ("/v1/completions", {"prompt": [], "max_tokens": 2}, 400),
    "mixed prompt": ("/v1/completions", {"prompt": [1, "a"], "max_tokens": 2}, 400),
    "streamed batch": ("/v1/completions", {"prompt": ["a", "b"], "stream": True}, 400),
    "streamed echo": ("/v1/completions", dict(HELLO, stream=True, echo=True), 400),
    "no messages": ("/v1/chat/completions", {"messages": []}, 400),
    "top_p out of range": ("/v1/completions", dict(HELLO, top_p=1.5), 400),
    "top_p without the flag": ("/v1/completions", dict(HELLO, top_p=0.5), 400),
    "penalty out of range": ("/v1/completions", dict(HELLO, frequency_penalty=3.0), 400),
    "bad logit_bias": ("/v1/completions", dict(HELLO, logit_bias={"1.5": 1}), 400),
    "unknown model": ("/v1/completions", dict(HELLO, model="nope"), 404),
    "unknown chat model": ("/v1/chat/completions", dict(CHAT, model="gpt-4"), 404),
    "prompt too long": ("/v1/completions", {"prompt": "x" * 300, "max_tokens": 4}, 413),
    "stream prompt too long, before headers": (
        "/v1/completions", {"prompt": "x" * 300, "max_tokens": 4, "stream": True}, 413),
    "embeddings without an encoder": ("/v1/embeddings", {"input": "hi"}, 400),
}


@pytest.mark.parametrize("case", list(ERROR_CASES), ids=list(ERROR_CASES))
def test_same_error(apps, case):
    path, body, status = ERROR_CASES[case]
    got, out = _same(_both(apps, "POST", path, body))
    assert got == status
    assert set(out) == {"error"} and out["error"]["message"]
    if case.startswith("stream prompt"):
        assert apps["port"].request("POST", path, body)[1]["Content-Type"] == "application/json"


def test_models_lists_the_llm_subset(apps):
    """/v1/models lists the reference's built-in names, every family (the
    LLMs once alone; the encoders, the vision models and the seq2seq
    names since the encoder families were ported), entry for entry."""
    got = _both(apps, "GET", "/v1/models")
    (ps, _, pb), (rs, _, rb) = got["port"], got["reference"]
    assert ps == rs == 200
    port, ref = json.loads(pb), json.loads(rb)
    names = [n for n in ref_list_models()
             if ref_get_model(n).family in ("llm", "encoder", "vision", "seq2seq")]
    assert {"bert-base", "resnet-50", "vit-base", "t5-tiny"} <= set(names)
    assert [m for m in ref["data"] if m["id"] in names] == port["data"]
    assert [m["id"] for m in port["data"]] == names
    assert [m["id"] for m in port["data"] if m["loaded"]] == [MODEL]


def test_ctx_infer_through_a_route(apps):
    """tests/test_serving.py::test_ctx_infer_through_http_app on both."""
    got = _both(apps, "POST", "/generate", {"prompt": "hey"})
    data = {}
    for pkg, (status, _, body) in got.items():
        assert status == 201
        data[pkg] = json.loads(body)["data"]
        assert data[pkg]["tokens"] == 4 and "ttft_ms" in data[pkg]
    assert data["port"]["text"] == data["reference"]["text"]


def test_deadline_header_sheds_before_admission(apps):
    """An X-Request-Timeout that has run out by the time the request is
    submitted: 504 before the request takes a slot, with the reference's
    message."""
    got = _both(apps, "POST", "/v1/completions", HELLO, {"X-Request-Timeout": "0.000001"})
    for status, _, body in got.values():
        assert status == 504
        assert json.loads(body)["error"]["message"].startswith(
            "deadline exceeded: projected queue wait")


def test_health(apps):
    details = {}
    for pkg, h in apps.items():
        status, _, body = h.request("GET", "/.well-known/health")
        data = json.loads(body)["data"]
        assert status == 200 and data["status"] == "UP"
        tpu = data["details"]["tpu"]
        assert (tpu["status"], tpu["state"]) == ("UP", "SERVING")
        details[pkg] = tpu["details"]
    port, ref = details["port"], details["reference"]
    assert set(port) <= set(ref)
    for key in ("model", "family", "running", "state", "kv_slots", "max_len", "pending",
                "prefilling"):
        assert port[key] == ref[key], key
    assert port["devices"] == ["cpu"]


# The app_tpu_* instruments the port records, compared line for line;
# timing histograms and the per-window step gauge by their series only.
_PORT_SERIES = ("app_tpu_tokens_generated", "app_tpu_requests_shed_total",
                "app_tpu_requests_cancelled_total", "app_tpu_deadline_exceeded_total",
                "app_tpu_queue_depth", "app_tpu_kv_slots_in_use", "app_tpu_engine_state")
_TIMED = ("app_tpu_infer_latency", "app_tpu_decode_step_seconds", "app_tpu_batch_size")


def _metric_lines(h) -> tuple[list, list]:
    status, _, body = h.request("GET", "/metrics", port=h.app.metrics_port)
    assert status == 200
    exact, timed = [], []
    for line in body.decode().splitlines():
        name = re.sub(r"^# (HELP|TYPE) ", "", line).split("{")[0].split(" ")[0]
        if name in _PORT_SERIES:
            exact.append(line)
        elif any(name.startswith(t) for t in _TIMED):
            timed.append(line.rsplit(" ", 1)[0] if not line.startswith("#") else line)
    return exact, timed


def test_metrics_after_the_same_requests(apps):
    """Every test above sent the same requests to both Apps: the counters
    and gauges the port records read the same, and its timing series have
    the reference's names, labels and buckets."""
    port, ref = _metric_lines(apps["port"]), _metric_lines(apps["reference"])
    assert port[0] == ref[0]
    assert f'app_tpu_requests_shed_total{{model="{MODEL}",reason="deadline"}} 1.0' in port[0]
    tokens = [ln for ln in port[0] if ln.startswith("app_tpu_tokens_generated{")]
    assert len(tokens) == 1 and float(tokens[0].split()[-1]) > 100
    assert set(port[1]) <= set(ref[1])
    for kind in ("prefill", "decode_fetch", "decode_window_pipeline"):
        assert f'app_tpu_infer_latency_count{{kind="{kind}"}}' in port[1]
    assert 'app_tpu_batch_size_count{batcher="prefill"}' in port[1]


@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
def test_stop_sequences_and_finish_reason(apps, stream):
    """A stop string taken from the greedy text cuts it at the match, with
    finish_reason "stop", on both (the SSE path holds text back so the
    stop never reaches the wire). After the metrics test: a stream that
    ends at its stop cancels the engine request it no longer needs, which
    the two engines may count differently."""
    _, full = _same(_both(apps, "POST", "/v1/completions",
                          {"prompt": "stop test", "max_tokens": 16, "temperature": 0}))
    text = full["choices"][0]["text"]
    assert full["choices"][0]["finish_reason"] == "length" and len(text) >= 6
    stop = text[4:6]
    cut = text[: text.find(stop)]
    body = {"prompt": "stop test", "max_tokens": 16, "temperature": 0, "stop": [stop],
            "stream": stream, "logprobs": 1}
    if stream:
        body.pop("logprobs")
    _, out = _same(_both(apps, "POST", "/v1/completions", body))
    if stream:
        streamed = "".join(ev["choices"][0]["text"] for ev in out[:-1])
        assert streamed == cut and out[-2]["choices"][0]["finish_reason"] == "stop"
    else:
        choice = out["choices"][0]
        assert (choice["text"], choice["finish_reason"]) == (cut, "stop")
        assert len(choice["logprobs"]["tokens"]) == len(choice["logprobs"]["token_logprobs"])


def _counter(h, name: str) -> float:
    _, _, body = h.request("GET", "/metrics", port=h.app.metrics_port)
    m = re.search(rf"^{name}{{[^}}]*}} (\S+)$", body.decode(), re.M)
    return float(m.group(1)) if m else 0.0


def _wait(fn, timeout=30.0) -> bool:
    end = time.time() + timeout
    while time.time() < end:
        if fn():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture
def slow_decode(apps):
    """Slow both engines' decode (see _slow) for one test."""
    engines = [h.app.container.tpu for h in apps.values()]
    for eng in engines:
        eng.tokenizer.delay_s = 0.01
    yield
    for eng in engines:
        eng.tokenizer.delay_s = 0.0


@pytest.mark.parametrize("pkg", list(PKGS))
def test_deadline_ends_a_stream_mid_generation(apps, slow_decode, pkg):
    """X-Request-Timeout expiring mid-stream: the stream ends with the
    terminal 504 error event, then [DONE], and the slot is freed."""
    h = apps[pkg]
    before = _counter(h, "app_tpu_deadline_exceeded_total")
    body = {"prompt": "deadline", "max_tokens": 200, "temperature": 0, "stop": ["\x00\x01"],
            "stream": True}
    status, _, raw = h.request("POST", "/v1/completions", body, {"X-Request-Timeout": "0.5"})
    events = _sse(raw)
    assert status == 200 and events[-1] == "[DONE]"
    err = events[-2]["error"]
    assert (err["type"], err["code"]) == ("ErrorDeadlineExceeded", 504)
    assert err["message"].startswith("deadline exceeded: after")
    assert len(events) >= 4  # tokens streamed before the deadline
    assert _wait(lambda: _counter(h, "app_tpu_deadline_exceeded_total") == before + 1)
    eng = h.app.container.tpu
    assert _wait(lambda: all(s is None for s in eng._slots))


@pytest.mark.parametrize("pkg", list(PKGS))
def test_client_disconnect_retires_the_generation(apps, slow_decode, pkg):
    """A client that reads one SSE chunk and closes its socket: the engine
    retires the generation (cancelled counter +1) and frees the slot."""
    h = apps[pkg]
    before = _counter(h, "app_tpu_requests_cancelled_total")
    body = json.dumps({"prompt": "bye", "max_tokens": 200, "temperature": 0,
                       "stop": ["\x00\x01"], "stream": True}).encode()
    s = socket.create_connection(("127.0.0.1", h.app.http_port), timeout=30)
    s.sendall(b"POST /v1/completions HTTP/1.1\r\nContent-Type: application/json\r\n"
              b"Content-Length: %d\r\n\r\n" % len(body) + body)
    got = b""
    while b"data: " not in got:
        got += s.recv(4096)
    s.close()
    assert _wait(lambda: _counter(h, "app_tpu_requests_cancelled_total") == before + 1)
    eng = h.app.container.tpu
    assert _wait(lambda: all(s is None for s in eng._slots))


@pytest.mark.parametrize("pkg", list(PKGS))
def test_drain_on_stop(jax_params, port_params, pkg):
    """TPU_DRAIN_S: App.stop drains the engine first — a new request gets
    503 with the reference's message while the stream in flight runs to
    its end; the engine is DOWN after."""
    h = _serve(pkg, jax_params, port_params, TPU_DRAIN_S="30")
    eng = h.app.container.tpu
    try:
        eng.tokenizer.delay_s = 0.005
        results = {}

        def stream():
            results["stream"] = h.request("POST", "/v1/completions", {
                "prompt": "drain", "max_tokens": 60, "temperature": 0, "stream": True,
                "stop": ["\x00\x01"]})

        t = threading.Thread(target=stream)
        t.start()
        assert _wait(lambda: any(s is not None for s in eng._slots))
        stop = asyncio.run_coroutine_threadsafe(h.app.stop(), h.loop)
        assert _wait(lambda: eng._draining)
        status, _, body = h.request("POST", "/v1/completions", HELLO)
        assert status == 503
        assert json.loads(body)["error"]["message"] == (
            "service unavailable: engine draining for shutdown; retry against another "
            "replica")
        stop.result(timeout=60)
        t.join(timeout=60)
        status, _, raw = results["stream"]
        events = _sse(raw)
        assert status == 200 and events[-1] == "[DONE]"
        assert events[-2]["choices"][0]["finish_reason"] in ("length", "stop")
        assert eng.state == "DOWN"
    finally:
        eng.tokenizer.delay_s = 0.0
        h.loop.call_soon_threadsafe(h.loop.stop)
        h._thread.join(timeout=5)
        h.loop.close()


# ----------------------------------------------------------------------
# the engine from config
# ----------------------------------------------------------------------

_CONFIG = {
    "TPU_MODEL": MODEL, "TPU_KV_SLOTS": "3", "TPU_MAX_LEN": "512", "TPU_DECODE_WINDOW": "4",
    "TPU_PREFILL_CHUNK": "32", "TPU_PREFILL_BATCH": "8", "TPU_KV_BLOCK": "16",
    "TPU_KV_POOL_BLOCKS": "40", "TPU_KV_QUANT": "int8", "TPU_TOP_K": "5", "TPU_TOP_P": "true",
    "TPU_PENALTIES": "1", "TPU_TOP_LOGPROBS": "2", "TPU_QUEUE_MAX": "7",
    "TPU_QUEUE_TOKENS": "999", "TPU_QUEUE_CLASS_PROMOTE_S": "2.5",
    "TPU_TENANT_QUEUE_MAX": "4", "TPU_TENANT_SLO_CLASS": "acme=batch",
    "TPU_EXPECTED_TPS": "123", "TPU_TRUNCATE_PROMPTS": "yes", "TPU_SPEC_TOKENS": "auto",
    "TPU_PIPELINE_DEPTH": "3", "TPU_MEGA_WINDOWS": "4", "TPU_PREFILL_DEPTH": "4",
}


def _geometry(e) -> dict:
    return {k: getattr(e, k) for k in (
        "n_slots", "max_len", "window_k", "prefill_chunk", "prefill_batch", "kv_block",
        "truncate_prompts", "top_logprobs", "enable_top_p", "enable_penalties", "queue_max",
        "queue_max_tokens", "class_promote_s", "tenant_queue_max", "_tenant_class_map",
        "_expected_tps", "max_prompt_tokens", "model_name", "family", "pipeline_depth",
        "mega_windows", "prefill_depth")}


@pytest.mark.parametrize("config", [_CONFIG, {"TPU_MODEL": MODEL}], ids=["set", "defaults"])
def test_from_config_matches_the_reference(config):
    """The same MockConfig gives both engines the same geometry and flags:
    every key set, and every key at the reference's default."""
    port = InferenceEngine.from_config(
        gofr_tpu_torch.config.MockConfig(dict(config, TPU_DEVICE="cpu")))
    try:
        ref = RefEngine.from_config(gofr_tpu.config.MockConfig(config))
        assert _geometry(port) == _geometry(ref)
        assert _geometry(port)["max_len"] == 256  # the model's context
        assert port.sampler.top_k == ref._top_k
        if port.kv_block:
            assert port.cache.n_blocks == ref.cache.n_blocks
        assert port.spec_tokens == ref.spec_tokens == 0
    finally:
        port.close()


def test_every_reference_key_is_served_or_refused():
    """Every TPU_* key the reference's from_config and backend read is read
    by the port's from_config, refused by its table, or handled by the
    backend, the container or the App."""
    import inspect

    ref_src = (inspect.getsource(RefEngine.from_config)
               + inspect.getsource(gofr_tpu.serving.backend))
    ref_keys = set(re.findall(r'"(TPU_[A-Z0-9_]+)"', ref_src))
    served = set(re.findall(r'"(TPU_[A-Z0-9_]+)"',
                            inspect.getsource(InferenceEngine.from_config)
                            + inspect.getsource(port_backend.new_tpu_embed_from_config)))
    refused = {k for k, _, _ in port_engine_mod._UNPORTED_KEYS}
    elsewhere = {"TPU_REPLICAS", "TPU_REPLICA_ADDRS", "TPU_EMBED_MODEL"}
    assert ref_keys - served - refused - elsewhere == set()
    assert not served & refused


def _non_default(default: str) -> str:
    low = default.lower()
    if low in ("1", "true", "yes"):
        return "false"
    if low in ("0", "false", "no", ""):
        return "3" if low == "0" else ("true" if low == "false" else "x")
    try:
        return str(float(default) + 1)
    except ValueError:
        return default + "x"


@pytest.mark.parametrize("key,default,item", port_engine_mod._UNPORTED_KEYS,
                         ids=[k[0] for k in port_engine_mod._UNPORTED_KEYS])
def test_unported_key_raises_with_its_item(key, default, item):
    """Each TPU_* key of an unported feature, set to anything but the
    reference's default, raises naming its ROADMAP item; at the default
    it is accepted. The key and its default come from the reference's
    from_config and backend."""
    ref_src = (open(gofr_tpu.serving.engine.__file__).read()
               + open(gofr_tpu.serving.backend.__file__).read())
    assert f'"{key}"' in ref_src
    base = {"TPU_MODEL": MODEL, "TPU_DEVICE": "cpu", "TPU_KV_SLOTS": "1", "TPU_MAX_LEN": "64"}
    cfg = gofr_tpu_torch.config.MockConfig(dict(base, **{key: _non_default(default)}))
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        InferenceEngine.from_config(cfg)
    assert item.startswith("ROADMAP Queue 1 item ")
    if default:
        InferenceEngine.from_config(
            gofr_tpu_torch.config.MockConfig(dict(base, **{key: default}))).close()


@pytest.mark.parametrize("config,item", [
    ({"TPU_SLO_TENANT_ACME_TTFT_MS": "500"}, "item 7"),
    ({"TPU_REPLICAS": "2"}, "item 7"),
    ({"TPU_REPLICA_ADDRS": "http://127.0.0.1:1"}, "item 7"),
    # The exporters and the datasources are ported: the App boots with the
    # member the reference's would have (a dead collector or an absent
    # Redis server is no error at boot; an unknown backend logs).
    ({"TRACE_EXPORTER": "zipkin", "TRACER_URL": "http://127.0.0.1:1"},
     lambda app: type(app._tracer._exporter).__name__ == "ZipkinExporter"),
    ({"TPU_ASYNC": "1"}, "item 7"),
    ({"DB_DIALECT": "sqlite"}, lambda app: app.container.sql.dialect() == "sqlite"),
    ({"REDIS_HOST": "127.0.0.1", "REDIS_PORT": "1"}, lambda app: app.container.redis is None),
    ({"PUBSUB_BACKEND": "memory"}, lambda app: app.container.pubsub is None),
    # An encoder beside a primary asked for a mesh (T5 and the encoder
    # itself are ported: tests/test_torch_t5_engine.py serves the pair).
    ({"TPU_EMBED_MODEL": "bert-tiny", "TPU_MESH_TP": "2"}, "item 8"),
], ids=["tenant slo", "replicas", "replica addrs", "trace exporter",
        "async plane", "sql", "redis", "pubsub", "embed model"])
def test_unported_app_config_raises(config, item):
    """A config that asks for an unported part raises naming its ROADMAP
    item; one whose part is ported since (``item`` is a check of the App
    instead) boots."""
    base = {"HTTP_PORT": "0", "METRICS_PORT": "0", "TPU_MODEL": MODEL, "TPU_DEVICE": "cpu",
            "TPU_KV_SLOTS": "1", "TPU_MAX_LEN": "64"}
    cfg = gofr_tpu_torch.config.MockConfig(dict(base, **config))
    if isinstance(item, str):
        with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
            gofr_tpu_torch.App(config=cfg)
        return
    app = gofr_tpu_torch.App(config=cfg)
    try:
        assert item(app)
    finally:
        app.container.tpu.close()
        app._tracer.shutdown()
        if app.container.sql is not None:
            app.container.sql.close()


def test_app_from_config_serves_on_the_cpu_when_asked():
    app = gofr_tpu_torch.App(config=gofr_tpu_torch.config.MockConfig({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "TPU_MODEL": MODEL, "TPU_DEVICE": "cpu",
        "TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "64", "TPU_SPEC_TOKENS": "0"}))
    eng = app.container.tpu
    try:
        assert isinstance(eng, InferenceEngine) and eng.device.type == "cpu"
        assert eng._metrics is app.container.metrics
        assert len(eng.generate_sync([1, 2, 3], max_new_tokens=3).token_ids) == 3
    finally:
        eng.close()


def test_app_serves_speculative_decoding_from_config():
    """TPU_SPEC_TOKENS=2 through the App: the container's engine drafts 2
    tokens a step, serves, and records the acceptance histogram the
    container registered (app_tpu_spec_tokens_per_step)."""
    app = gofr_tpu_torch.App(config=gofr_tpu_torch.config.MockConfig({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "TPU_MODEL": MODEL, "TPU_DEVICE": "cpu",
        "TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "128", "TPU_DECODE_WINDOW": "4",
        "TPU_SPEC_TOKENS": "2"}))
    eng = app.container.tpu
    try:
        assert eng.spec_tokens == 2
        assert len(eng.generate_sync([1, 2, 3] * 4, max_new_tokens=9,
                                     stop_on_eos=False).token_ids) == 9
    finally:
        eng.close()
    hist = next(i for i in app.container.metrics.instruments()
                if i.name == "app_tpu_spec_tokens_per_step")
    (_, (total, n)), = hist.collect().values()
    assert n >= 2 and 1.0 <= total / n <= 3.0


def test_app_with_a_model_and_no_cuda_raises(monkeypatch):
    """No fallback: without CUDA and without TPU_DEVICE=cpu the App does
    not come up (the reference's backend would log and serve with no
    engine)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gofr_tpu_torch.App(config=gofr_tpu_torch.config.MockConfig({
            "HTTP_PORT": "0", "METRICS_PORT": "0", "TPU_MODEL": MODEL}))
