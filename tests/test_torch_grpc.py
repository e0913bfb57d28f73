"""The port's gRPC surface (``gofr_tpu_torch/grpc``) held against the
reference's (``gofr_tpu/grpc`` on grpcio) on the same weights: a stock
grpcio client with the reference's stubs gets the same replies and status
codes from the port's server as from the reference's, and the port's
channel gets the same from the reference's server as from the port's.
Generate, GenerateStream and Health on llama-tiny-f32 (identical token
streams), Embed on bert-tiny, Classify on resnet-tiny, seq2seq on an f32
t5-tiny; the counterparts of ``tests/test_serving.py`` (JSON service, typed
service with ``top_p`` and stop trimming, a cancelled stream freeing its
slot), ``tests/test_lora.py`` (the adapter kwarg) and ``tests/test_t5.py``
(seq2seq routed); status mapping, metadata, deadlines, panics with their
RPCLog lines, gzip requests, and the App's ``register_service``."""

from __future__ import annotations

import asyncio
import dataclasses
import io
import json
import socket
import threading
import time

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.grpc import InferenceClient as RefInferenceClient
from gofr_tpu.grpc import inference_pb2 as ref_pb
from gofr_tpu.grpc import inference_pb2_grpc as ref_pb_grpc
from gofr_tpu.grpc import server as ref_server
from gofr_tpu.grpc.inference import InferenceServicer as RefJSONServicer
from gofr_tpu.grpc.inference import add_inference_service as ref_add_json
from gofr_tpu.grpc.inference_typed import TypedInferenceServicer as RefTypedServicer
from gofr_tpu.grpc.inference_typed import add_typed_inference_service as ref_add_typed
from gofr_tpu.logging import Level as RefLevel
from gofr_tpu.logging import Logger as RefLogger
from gofr_tpu.models import registry as ref_registry
from gofr_tpu.models.t5 import init_t5 as ref_init_t5
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch import App
from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.errors import ErrorDeadlineExceeded
from gofr_tpu_torch.grpc import InferenceClient, inference_pb2, inference_pb2_grpc
from gofr_tpu_torch.grpc import h2
from gofr_tpu_torch.grpc import server as port_server
from gofr_tpu_torch.grpc.channel import RpcError, insecure_channel
from gofr_tpu_torch.grpc.inference import InferenceServicer
from gofr_tpu_torch.grpc.inference import add_inference_service
from gofr_tpu_torch.grpc.inference_typed import (
    TypedInferenceServicer,
    add_typed_inference_service,
)
from gofr_tpu_torch.logging import Level, Logger
from gofr_tpu_torch.models import registry
from gofr_tpu_torch.models.t5 import init_t5
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.tracing import Tracer, set_tracer
from gofr_tpu_torch.models.bert import init_bert
from gofr_tpu_torch.models.resnet import init_resnet
from gofr_tpu_torch.weights import (
    bert_params_to_reference,
    params_from_jax,
    resnet_params_to_reference,
    t5_params_from_jax,
)
from tests.test_torch_grpc_wire import _raw_request
from tests.test_torch_model import _np_tree

MODEL = "llama-tiny-f32"
GEOMETRY = dict(n_slots=2, max_len=128, window_k=4, prefill_chunk=16, prefill_batch=2)
LOGPROB_TOL = 1e-5  # f32 twins: the same arithmetic in another order
BERT_TOL = 4e-3  # bf16 bert-tiny, unit-norm embeddings (tests/test_torch_encoders.py)
RESNET_RTOL = 1e-2  # the classify check of tests/test_torch_encoders.py
T5_NAME = "t5-tiny-f32-grpc"
PKGS = {"reference": ref_server, "port": port_server}


def _logger(pkg: str):
    cls, level = (RefLogger, RefLevel) if pkg == "reference" else (Logger, Level)
    buf = io.StringIO()
    return cls(level=level.INFO, out=buf, err=buf, is_terminal=False), buf


def _rpc_logs(buf: io.StringIO) -> list:
    out = []
    for line in buf.getvalue().splitlines():
        msg = json.loads(line).get("message")
        if isinstance(msg, dict) and "rpc" in msg:
            out.append(msg)
    return out


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    thread = threading.Thread(target=lp.run_forever, daemon=True)
    thread.start()
    yield lp
    lp.call_soon_threadsafe(lp.stop)
    thread.join(timeout=5)


def _serve(loop, pkg: str, registrations: list):
    logger, buf = _logger(pkg)
    server = PKGS[pkg].GRPCServer(0, logger)
    for add_fn, servicer in registrations:
        server.register(add_fn, servicer)
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(30)
    server.logs = buf
    return server


def _stop(loop, *servers):
    for server in servers:
        asyncio.run_coroutine_threadsafe(server.stop(0), loop).result(30)


class _Probe:
    """A JSON service on both servers: metadata, a slow call, a panic, an
    abort, an echo."""

    def __init__(self, mod) -> None:
        self.mod = mod

    async def meta(self, request, context):
        from gofr_tpu_torch.tracing import current_span as port_span

        from gofr_tpu.tracing import current_span as ref_span

        span = port_span() if self.mod is port_server else ref_span()
        return {"tenant": self.mod.tenant_from_context(context),
                "slo": self.mod.slo_class_from_context(context),
                "deadline": self.mod.deadline_from_context(context) is not None,
                "trace_id": span.trace_id if span is not None else None}

    async def slow(self, request, context):
        await asyncio.sleep(5)
        return {}

    async def boom(self, request, context):
        raise RuntimeError("boom")

    async def abort(self, request, context):
        codes = port_server.StatusCode if self.mod is port_server else grpc.StatusCode
        await context.abort(codes.RESOURCE_EXHAUSTED, "shed 100% ✓")

    async def echo(self, request, context):
        return request


def _add_probe(server, probe, container):
    server.add_generic_rpc_handlers((probe.mod.json_method_handlers(
        "t.Probe", {n: getattr(probe, n) for n in ("meta", "slow", "boom", "abort", "echo")}),))


@pytest.fixture(scope="module")
def llm(loop):
    """The reference's and the port's llama-tiny-f32 engines on the same
    weights, each behind its package's server with the typed, JSON and
    probe services."""
    jparams = init_transformer(jax.random.PRNGKey(11), ref_registry.get_model(MODEL).config)
    ref = RefEngine(MODEL, params=jparams, tokenizer=RefByteTokenizer(), **GEOMETRY)
    ref.start_sync()
    port = InferenceEngine(MODEL, params=params_from_jax(_np_tree(jparams), registry.get_model(
        MODEL).config, device="cpu"), tokenizer=ByteTokenizer(), device="cpu", **GEOMETRY)
    port.start_sync()
    servers = {
        "reference": _serve(loop, "reference", [
            (ref_add_typed, RefTypedServicer(ref)), (ref_add_json, RefJSONServicer(ref)),
            (_add_probe, _Probe(ref_server))]),
        "port": _serve(loop, "port", [
            (add_typed_inference_service, TypedInferenceServicer(port)),
            (add_inference_service, InferenceServicer(port)), (_add_probe, _Probe(port_server))]),
    }
    yield {"engines": {"reference": ref, "port": port}, "servers": servers}
    _stop(loop, *servers.values())
    ref.stop_sync()
    port.stop_sync()


def _stub(client: str, port: int):
    """(stub, messages module, channel, error class) for a client kind."""
    addr = f"127.0.0.1:{port}"
    if client == "grpcio":
        channel = grpc.insecure_channel(addr)
        return ref_pb_grpc.InferenceStub(channel), ref_pb, channel, grpc.RpcError
    channel = insecure_channel(addr)
    return inference_pb2_grpc.InferenceStub(channel), inference_pb2, channel, RpcError


def _generate_replies(client: str, port: int) -> dict:
    stub, pb, channel, err_cls = _stub(client, port)
    try:
        out = {}
        r = stub.Generate(pb.GenerateRequest(prompt="hello proto", max_new_tokens=6), timeout=60)
        out["unary"] = r
        out["ids"] = stub.Generate(pb.GenerateRequest(prompt_ids=[5, 6, 7], max_new_tokens=3),
                                   timeout=60)
        out["stream"] = list(stub.GenerateStream(pb.GenerateRequest(
            prompt="stream", max_new_tokens=5, stop_on_eos=False), timeout=60))
        out["health"] = stub.Health(pb.HealthRequest(), timeout=30)
        with pytest.raises(err_cls) as exc:
            stub.Generate(pb.GenerateRequest(prompt="x", max_new_tokens=2, top_p=0.9),
                          timeout=60)
        out["top_p"] = (exc.value.code().name, exc.value.details())
        return out
    finally:
        channel.close()


@pytest.mark.parametrize("client", ["grpcio", "port"])
def test_generate_stream_health_interop(llm, client):
    """Each client against both servers: the same text, token counts,
    finish reasons, log-probs (within the f32 twins' tolerance) and
    stream chunks; the clocks (``ttft_ms``, ``tokens_per_sec``) present
    and positive on both."""
    got = {name: _generate_replies(client, srv.port) for name, srv in llm["servers"].items()}
    ref, port = got["reference"], got["port"]
    for key in ("unary", "ids"):
        a, b = ref[key], port[key]
        assert (b.text, b.tokens, b.truncated, b.finish_reason) == (
            a.text, a.tokens, a.truncated, a.finish_reason)
        np.testing.assert_allclose(list(b.token_logprobs), list(a.token_logprobs),
                                   atol=LOGPROB_TOL)
        assert a.ttft_ms > 0 and b.ttft_ms > 0 and a.tokens_per_sec > 0 and b.tokens_per_sec > 0
    assert port["unary"].tokens == 6 and port["ids"].tokens == 3
    strip = [(c.token, c.text, c.done, c.tokens, c.finish_reason) for c in ref["stream"]]
    assert [(c.token, c.text, c.done, c.tokens, c.finish_reason) for c in port["stream"]] == strip
    assert port["stream"][-1].done and port["stream"][-1].tokens == 5
    assert port["stream"][-1].ttft_ms > 0 and ref["stream"][-1].ttft_ms > 0
    assert port["health"].status == ref["health"].status == "UP"
    assert json.loads(port["health"].details_json)["kv_slots"]["total"] == 2
    assert port["top_p"] == ref["top_p"]
    assert port["top_p"][0] == "INVALID_ARGUMENT"


@pytest.mark.parametrize("client", ["grpcio", "port"])
def test_typed_stop_trimming_unary_equals_stream(llm, client):
    """``tests/test_serving.py:738``'s stop case: unary and streamed text
    trimmed the same, on both servers, equal across them."""
    texts = {}
    for name, srv in llm["servers"].items():
        stub, pb, channel, _ = _stub(client, srv.port)
        try:
            probe = stub.Generate(pb.GenerateRequest(prompt="abc", max_new_tokens=8,
                                                     stop_on_eos=False), timeout=60)
            stop_s = probe.text[2:4]
            assert stop_s
            req = pb.GenerateRequest(prompt="abc", max_new_tokens=8, stop_on_eos=False,
                                     stop=[stop_s])
            unary = stub.Generate(req, timeout=60)
            chunks = list(stub.GenerateStream(req, timeout=60))
            streamed = "".join(c.text for c in chunks if not c.done)
            assert unary.finish_reason == chunks[-1].finish_reason == "stop"
            assert streamed == unary.text
            texts[name] = (probe.text, unary.text)
        finally:
            channel.close()
    assert texts["port"] == texts["reference"]


@pytest.mark.parametrize("client", ["reference", "port"])
def test_json_service(llm, client):
    """``tests/test_serving.py:580`` on both servers through each
    package's ``InferenceClient``: unary, stream and health agree."""
    cls = RefInferenceClient if client == "reference" else InferenceClient
    got = {}
    for name, srv in llm["servers"].items():
        c = cls(f"127.0.0.1:{srv.port}")
        try:
            out = c.generate("hello grpc", max_new_tokens=4, stop_on_eos=False)
            assert out["tokens"] == 4 and out["ttft_ms"] > 0
            chunks = list(c.generate_stream("stream", max_new_tokens=3))
            assert chunks[-1]["done"] is True and chunks[-1]["tokens"] == 3
            assert c.health()["status"] == "UP"
            got[name] = (out["text"], out["finish_reason"],
                         [(ch.get("token"), ch.get("text")) for ch in chunks[:-1]])
        finally:
            c.close()
    assert got["port"] == got["reference"]


@pytest.mark.parametrize("client", ["grpcio", "port"])
def test_stream_cancel_frees_slot(llm, client):
    """``tests/test_serving.py:925`` on the port's server: a client's
    cancel (grpcio's or the port channel's) cancels the engine request,
    and its slot frees."""
    eng = llm["engines"]["port"]
    stub, pb, channel, _ = _stub(client, llm["servers"]["port"].port)
    try:
        call = stub.GenerateStream(pb.GenerateRequest(prompt="cancel me", max_new_tokens=90,
                                                      stop_on_eos=False))
        next(iter(call))
        victims = [s for s in eng._slots if s is not None]
        assert victims, "stream started but no active slot"
        victim = victims[0]
        call.cancel()
        deadline = time.time() + 30
        while not victim.future.done() and time.time() < deadline:
            time.sleep(0.05)
        assert victim.future.cancelled()
        assert len(victim.token_ids) < 90
        deadline = time.time() + 10
        while any(s is not None for s in eng._slots) and time.time() < deadline:
            time.sleep(0.05)
        assert all(s is None for s in eng._slots)
        r = stub.Generate(pb.GenerateRequest(prompt="after cancel", max_new_tokens=4,
                                             stop_on_eos=False), timeout=60)
        assert r.tokens == 4
    finally:
        channel.close()


def test_deadline_frees_slot(llm, monkeypatch):
    """A ``grpc-timeout`` of 0.3 s that expires mid-generation, from a client
    that does not enforce it itself: the request is admitted and holds a
    slot, the server ends the call with DEADLINE_EXCEEDED in its trailers,
    the engine request ends before its budget, and the slot frees. Each
    decode window is slowed by 20 ms so that 120 tokens outlast the
    deadline, and an optimistic throughput prior lets admission control
    admit it (with the measured rate it would shed the request at once,
    which ``test_metadata_deadline_panic_abort`` does not rely on)."""
    eng = llm["engines"]["port"]
    submitted, submit, process = [], eng.submit_generate, eng._process_window

    def spy(*args, **kw):
        req = submit(*args, **kw)
        submitted.append(req)
        return req

    def slow_window(win):
        time.sleep(0.02)
        return process(win)

    monkeypatch.setattr(eng, "submit_generate", spy)
    monkeypatch.setattr(eng, "_process_window", slow_window)
    monkeypatch.setattr(eng, "_expected_tps", 1e5)
    body = port_server.frame_message(inference_pb2.GenerateRequest(
        prompt="slow", max_new_tokens=120, stop_on_eos=False).SerializeToString())
    events = _raw_request(llm["servers"]["port"].port, "/gofr.tpu.v1.Inference/GenerateStream",
                          lambda sid: [h2.frame(h2.DATA, h2.END_STREAM, sid, body)],
                          headers=(("grpc-timeout", "300m"),))
    trailers = [dict(e[2]) for e in events if e[0] == "headers" and e[3]]
    expired = str(port_server.StatusCode.DEADLINE_EXCEEDED.value)
    assert trailers and trailers[0]["grpc-status"] == expired, events
    assert len(submitted) == 1, "the request was shed at admission"
    req = submitted[0]
    deadline = time.time() + 10
    while not req.future.done() and time.time() < deadline:
        time.sleep(0.02)
    assert 1 <= len(req.token_ids) < 120, len(req.token_ids)
    assert req.future.cancelled() or isinstance(req.future.exception(), ErrorDeadlineExceeded)
    chunks = [e for e in events if e[0] == "data"]
    assert chunks, "no token reached the client before the deadline"
    deadline = time.time() + 10
    while any(s is not None for s in eng._slots) and time.time() < deadline:
        time.sleep(0.05)
    assert all(s is None for s in eng._slots)


@pytest.mark.parametrize("client", ["grpcio", "port"])
def test_metadata_deadline_panic_abort(llm, client):
    """``x-tenant-id``, ``x-slo-class``, ``traceparent`` and the deadline
    reach the handler alike; ``grpc-timeout`` gives DEADLINE_EXCEEDED; a
    panic gives INTERNAL and an abort its own code (percent-encoded
    details), with the same RPCLog lines on both servers."""
    set_tracer(Tracer())
    trace = "4bf92f3577b34da6a3ce929d0e0e4736"
    meta = [("x-tenant-id", "acme"), ("x-slo-class", "batch"),
            ("traceparent", f"00-{trace}-00f067aa0ba902b7-01")]
    got = {}
    for name, srv in llm["servers"].items():
        addr = f"127.0.0.1:{srv.port}"
        channel = grpc.insecure_channel(addr) if client == "grpcio" else insecure_channel(addr)
        err_cls = grpc.RpcError if client == "grpcio" else RpcError
        ser = lambda o: json.dumps(o).encode()  # noqa: E731
        call = {m: channel.unary_unary(f"/t.Probe/{m}", request_serializer=ser,
                                       response_deserializer=json.loads)
                for m in ("meta", "slow", "boom", "abort")}
        try:
            srv.logs.truncate(0)
            srv.logs.seek(0)
            out = {"meta": call["meta"]({}, metadata=meta, timeout=30)}
            for m, timeout in (("slow", 0.2), ("boom", 30), ("abort", 30)):
                with pytest.raises(err_cls) as err:
                    call[m]({}, timeout=timeout)
                out[m] = (err.value.code().name, err.value.details())
            time.sleep(0.3)  # the slow handler's log line
            out["logs"] = sorted((r["rpc"], r["status"]) for r in _rpc_logs(srv.logs))
            out["trace_ids"] = [r["trace_id"] for r in _rpc_logs(srv.logs)
                                if r["rpc"] == "/t.Probe/meta"]
            got[name] = out
        finally:
            channel.close()
    assert got["port"] == got["reference"]
    assert got["port"]["meta"] == {"tenant": "acme", "slo": "batch", "deadline": True,
                                   "trace_id": trace}
    assert got["port"]["slow"][0] == "DEADLINE_EXCEEDED"
    assert got["port"]["boom"] == ("INTERNAL", "internal error")
    assert got["port"]["abort"] == ("RESOURCE_EXHAUSTED", "shed 100% ✓")
    assert got["port"]["trace_ids"] == [trace]


def test_gzip_requests(llm):
    """grpcio's gzip-compressed requests to both servers."""
    for srv in llm["servers"].values():
        channel = grpc.insecure_channel(f"127.0.0.1:{srv.port}",
                                        compression=grpc.Compression.Gzip)
        try:
            echo = channel.unary_unary("/t.Probe/echo", request_serializer=lambda o: json.dumps(
                o).encode(), response_deserializer=json.loads)
            assert echo({"blob": "z" * 50_000}, timeout=30) == {"blob": "z" * 50_000}
        finally:
            channel.close()


def test_grpc_status_code_by_name():
    for status in (400, 429, 499, 502, 503, 504, 500):
        exc = Exception()
        exc.status_code = status
        assert port_server.grpc_status_code(exc).name == ref_server.grpc_status_code(exc).name
        assert port_server.grpc_status_code(exc).value == ref_server.grpc_status_code(
            exc).value[0]


def test_grpc_kwargs_pass_adapter():
    """``tests/test_lora.py:727``: both surfaces forward the adapter."""

    class _Eng:
        tokenizer = None

    for json_cls, typed_cls, pb in ((RefJSONServicer, RefTypedServicer, ref_pb),
                                    (InferenceServicer, TypedInferenceServicer, inference_pb2)):
        kw = json_cls(_Eng())._gen_kwargs({"prompt": "x", "adapter": "tuned"}, False)
        assert kw["adapter"] == "tuned"
        assert "adapter" not in json_cls(_Eng())._gen_kwargs({"prompt": "x"}, False)
        _, tkw = typed_cls(_Eng())._gen_kwargs(pb.GenerateRequest(prompt="x", adapter="tuned"))
        assert tkw["adapter"] == "tuned"


# -- encoders and seq2seq ------------------------------------------------------

@pytest.fixture(scope="module")
def encoders(loop):
    """bert-tiny and resnet-tiny pairs on the same weights, each engine
    behind its package's typed service."""
    # The port's seeded weights carried to the reference (the reference's
    # own resnet init runs eagerly and is slow).
    bert_p = init_bert(registry.get_model("bert-tiny").config, 0, device="cpu")
    res_p = init_resnet(registry.get_model("resnet-tiny").config, 0, device="cpu")
    engines = {
        ("bert", "reference"): RefEngine("bert-tiny", tokenizer=RefByteTokenizer(), max_batch=4,
                                         max_wait_s=0.01, params=bert_params_to_reference(
                                             bert_p, registry.get_model("bert-tiny").config)),
        ("bert", "port"): InferenceEngine("bert-tiny", tokenizer=ByteTokenizer(), max_batch=4,
                                          max_wait_s=0.01, device="cpu", params=bert_p),
        ("resnet", "reference"): RefEngine("resnet-tiny", max_batch=4, max_wait_s=0.01,
                                           params=resnet_params_to_reference(res_p)),
        ("resnet", "port"): InferenceEngine("resnet-tiny", max_batch=4, max_wait_s=0.01,
                                            device="cpu", params=res_p),
    }
    servers = {}
    for (model, pkg), eng in engines.items():
        if pkg == "reference":
            eng.start_sync()
            reg = [(ref_add_typed, RefTypedServicer(eng))]
        else:
            reg = [(add_typed_inference_service, TypedInferenceServicer(eng))]
        servers[model, pkg] = _serve(loop, pkg, reg)
    yield servers
    _stop(loop, *servers.values())
    for (_, pkg), eng in engines.items():
        eng.stop_sync() if pkg == "reference" else eng.close()


@pytest.mark.parametrize("client", ["grpcio", "port"])
def test_embed_and_classify_interop(encoders, client):
    """``tests/test_serving.py:838``: Embed (bert-tiny) and Classify
    (resnet-tiny, a 32x32x3 image) from both servers."""
    got = {}
    img = np.random.RandomState(0).randn(32, 32, 3).astype(np.float32)
    for pkg in ("reference", "port"):
        stub, pb, channel, _ = _stub(client, encoders["bert", pkg].port)
        try:
            emb = stub.Embed(pb.EmbedRequest(text="vector me"), timeout=60)
        finally:
            channel.close()
        stub, pb, channel, _ = _stub(client, encoders["resnet", pkg].port)
        try:
            out = stub.Classify(pb.ClassifyRequest(image=img.ravel().tolist(), shape=[32, 32, 3]),
                                timeout=60)
        finally:
            channel.close()
        got[pkg] = (np.asarray(emb.embedding), out.label, np.asarray(out.logits))
    (e_ref, l_ref, g_ref), (e_port, l_port, g_port) = got["reference"], got["port"]
    assert e_port.shape == e_ref.shape == (128,)
    np.testing.assert_allclose(e_port, e_ref, atol=BERT_TOL)
    assert g_port.shape == g_ref.shape == (10,)
    np.testing.assert_allclose(g_port, g_ref, rtol=RESNET_RTOL, atol=RESNET_RTOL)
    assert l_port == l_ref == int(np.argmax(g_ref))


@pytest.fixture(scope="module")
def t5_pair(loop):
    """An f32 t5-tiny in both registries, a reference and a port engine on
    the same weights, the port's behind its typed and JSON services."""
    mp = pytest.MonkeyPatch()
    ref_cfg = dataclasses.replace(ref_registry.get_model("t5-tiny").config, dtype=jnp.float32)
    cfg = dataclasses.replace(registry.get_model("t5-tiny").config, dtype=torch.float32)
    mp.setitem(ref_registry._REGISTRY, T5_NAME, ref_registry.ModelSpec(
        name=T5_NAME, family="seq2seq", config=ref_cfg, init=ref_init_t5, eos_token=1))
    mp.setitem(registry._REGISTRY, T5_NAME, registry.ModelSpec(
        name=T5_NAME, family="seq2seq", config=cfg, init=init_t5, eos_token=1))
    mp.setenv("TPU_SEQ2SEQ_MAX_NEW", "12")
    mp.setenv("TPU_SEQ2SEQ_CHUNK", "2")
    tree = _np_tree(ref_init_t5(jax.random.PRNGKey(3), ref_cfg))
    ref = RefEngine(T5_NAME, params=jax.tree_util.tree_map(jnp.asarray, tree),
                    tokenizer=RefByteTokenizer(), max_batch=2)
    ref.start_sync()
    port = InferenceEngine(T5_NAME, params=t5_params_from_jax(tree, cfg, device="cpu"),
                           tokenizer=ByteTokenizer(), device="cpu", max_batch=2)
    srv = _serve(loop, "port", [(add_typed_inference_service, TypedInferenceServicer(port)),
                                (add_inference_service, InferenceServicer(port))])
    yield ref, port, srv
    _stop(loop, srv)
    ref.stop_sync()
    port.close()
    mp.undo()


def test_t5_generate_routes_seq2seq(t5_pair):
    """``tests/test_t5.py:331``: both surfaces serve seq2seq, over the
    wire; the streamed pieces concatenate to the unary text, the ids are
    the one-shot program's, and the text is the reference's."""
    ref, port, srv = t5_pair
    prompt = "translate this text"
    want_ids = port.seq2seq_sync(prompt)
    assert want_ids == ref.seq2seq_sync(prompt)
    ref_text = asyncio.run(RefJSONServicer(ref).Generate({"prompt": prompt}, None))["text"]
    stub, pb, channel, _ = _stub("port", srv.port)
    try:
        unary = stub.Generate(pb.GenerateRequest(prompt=prompt), timeout=60)
        chunks = list(stub.GenerateStream(pb.GenerateRequest(prompt=prompt), timeout=60))
    finally:
        channel.close()
    assert unary.text == ref_text and unary.finish_reason == "stop"
    assert unary.tokens == chunks[-1].tokens == len(want_ids)
    assert "".join(c.text for c in chunks[:-1]) == unary.text
    assert len(chunks) > 2  # stepped: more than one content chunk
    assert [c.token for c in chunks[:-1]] == want_ids[::2][:len(chunks) - 1]
    client = InferenceClient(f"127.0.0.1:{srv.port}")
    try:
        out = client.generate(prompt)
        js = list(client.generate_stream(prompt))
    finally:
        client.close()
    assert out["text"] == unary.text and out["tokens"] == len(want_ids)
    assert "".join(c.get("text", "") for c in js[:-1]) == out["text"]


# -- the App ---------------------------------------------------------------------

def test_app_register_service_and_grpc_port(llm):
    """The gRPC server starts only when a service is registered;
    ``GRPC_PORT=0`` binds a free port, ``stop`` closes it."""
    keys = {"HTTP_PORT": "0", "METRICS_PORT": "0", "GRPC_PORT": "0", "LOG_LEVEL": "WARN"}
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        bare = App(config=MockConfig(keys))
        asyncio.run_coroutine_threadsafe(bare.start(), loop).result(30)
        assert bare._grpc_server is None and bare.grpc_port == 0
        asyncio.run_coroutine_threadsafe(bare.stop(), loop).result(30)

        assert App(config=MockConfig({"LOG_LEVEL": "WARN"})).grpc_port == 9000
        app = App(config=MockConfig(keys))
        app.register_service(add_typed_inference_service,
                             TypedInferenceServicer(llm["engines"]["port"]))
        app.register_service(_add_probe, _Probe(port_server))
        asyncio.run_coroutine_threadsafe(app.start(), loop).result(30)
        port = app.grpc_port
        assert port > 0
        stub, pb, channel, _ = _stub("grpcio", port)
        try:
            assert stub.Health(pb.HealthRequest(), timeout=30).status == "UP"
        finally:
            channel.close()
        asyncio.run_coroutine_threadsafe(app.stop(), loop).result(30)
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", port), timeout=2).close()
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=5)
