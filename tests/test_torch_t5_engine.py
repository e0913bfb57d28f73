"""The port's seq2seq engine (``serving/modalities.py``: T5 behind the
dynamic batcher, the stepped stream, ``ctx.infer``; ``from_config`` with
an HF ``TPU_CHECKPOINT`` and ``TPU_QUANT``; ``stream_seq2seq``) against
the reference's on the CPU.

The exact-comparison model is an f32 twin of ``t5-tiny`` registered under
a test-only name in both registries (``MonkeyPatch.setitem``); both
engines compute with the reference's ``init_t5`` tree (carried across by
``weights.t5_params_from_jax``) or with the same HF directory written by
``transformers``, and must give the same ids, id for id, and the same
text. ``TPU_SEQ2SEQ_MAX_NEW`` is 12 here (the engines read it from the
process environment, as the reference) to keep the reference's programs
small; ``TPU_SEQ2SEQ_CHUNK`` takes a value that divides it and one that
does not.
"""

from __future__ import annotations

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import gofr_tpu
import gofr_tpu.config
import gofr_tpu_torch
import gofr_tpu_torch.config
from gofr_tpu.models import registry as ref_registry
from gofr_tpu.models.t5 import init_t5 as ref_init_t5
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.stream_text import stream_seq2seq as ref_stream_seq2seq
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models import registry
from gofr_tpu_torch.models.t5 import init_t5
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.stream_text import stream_seq2seq
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import t5_params_from_jax
from tests.test_torch_model import _np_tree
from tests.test_torch_openai import Harness

NAME = "t5-tiny-f32-test"
MAX_NEW = "12"
TEXTS = ("translate this text", "another input", "a third one, longer than the others", "")


@pytest.fixture(scope="module")
def twin():
    """The f32 twin registered in both registries for the module: (port
    config, reference config, reference params as numpy)."""
    mp = pytest.MonkeyPatch()
    ref_cfg = dataclasses.replace(ref_registry.get_model("t5-tiny").config, dtype=jnp.float32)
    cfg = dataclasses.replace(registry.get_model("t5-tiny").config, dtype=torch.float32)
    mp.setitem(ref_registry._REGISTRY, NAME, ref_registry.ModelSpec(
        name=NAME, family="seq2seq", config=ref_cfg, init=ref_init_t5, eos_token=1))
    mp.setitem(registry._REGISTRY, NAME, registry.ModelSpec(
        name=NAME, family="seq2seq", config=cfg, init=init_t5, eos_token=1))
    mp.setenv("TPU_SEQ2SEQ_MAX_NEW", MAX_NEW)
    yield cfg, ref_cfg, _np_tree(ref_init_t5(jax.random.PRNGKey(3), ref_cfg))
    mp.undo()


def _pair(twin, quant: str = "", **kw):
    """A reference and a port engine on the same weights (the reference
    gets fresh arrays: given ``quant`` it donates them)."""
    cfg, _, tree = twin
    ref = RefEngine(NAME, params=jax.tree_util.tree_map(jnp.asarray, tree), quant=quant,
                    tokenizer=RefByteTokenizer(), **kw)
    ref.start_sync()
    port = InferenceEngine(NAME, params=t5_params_from_jax(tree, cfg, device="cpu"),
                           quant=quant, tokenizer=ByteTokenizer(), device="cpu", **kw)
    return ref, port


@pytest.fixture(scope="module")
def pair(twin):
    ref, port = _pair(twin, max_batch=4, max_wait_s=0.05)
    yield ref, port
    ref.stop_sync()
    port.close()


def test_infer_and_infer_sync_equal_reference(pair):
    """``ctx.infer``'s seam and ``infer_sync``: {"text", "token_ids"} equal
    to the reference engine's, EOS-trimmed; the health and the ledger name
    the family and hold the params."""
    ref, port = pair
    for text in TEXTS[:2]:
        want = ref.infer_sync(text)
        assert port.infer_sync(text) == want
        assert asyncio.run(port.infer(text)) == asyncio.run(ref.infer(text)) == want
        assert set(want) == {"text", "token_ids"} and 1 not in want["token_ids"]
    h = port.health_check()
    assert h["status"] == "UP" and h["details"]["family"] == "seq2seq"
    assert set(h["details"]["hbm_ledger"]["components"]) == {"params"}
    assert set(port.compile_stats()["programs"]) >= {"seq2seq"}
    with pytest.raises(RuntimeError, match="not a generative LLM"):
        port.submit_generate("hi")


def test_a_batch_equals_each_request_served_alone(pair):
    """Requests submitted together coalesce into one padded flush (of the
    longest one's bucket): each answer equals its request served alone,
    and the reference's."""
    ref, port = pair
    solo = [port.seq2seq_sync(t) for t in TEXTS]
    flushes = []
    inner = port._batcher._execute
    port._batcher._execute = lambda payloads: flushes.append(len(payloads)) or inner(payloads)
    try:
        futures = [port._batcher.submit(t) for t in TEXTS]
        got = [f.result(timeout=60) for f in futures]
    finally:
        port._batcher._execute = inner
    assert max(flushes) > 1
    assert got == solo == [ref.seq2seq_sync(t) for t in TEXTS]
    assert port.seq2seq_sync([5, 6, 7]) == ref.seq2seq_sync([5, 6, 7])


@pytest.mark.parametrize("chunk", ["4", "5"], ids=["divides", "does-not-divide"])
def test_stream_chunks_and_events_equal_reference(twin, monkeypatch, chunk):
    """``seq2seq_stream_blocking``'s chunks and ``stream_seq2seq``'s events
    (pieces by cumulative decode, then ``done``; ``ttft_ms`` aside) equal
    the reference's, and the stream's ids are the one-shot ids, at a
    ``TPU_SEQ2SEQ_CHUNK`` that divides ``TPU_SEQ2SEQ_MAX_NEW`` and one
    that does not (the buffer padded to a chunk multiple)."""
    monkeypatch.setenv("TPU_SEQ2SEQ_CHUNK", chunk)
    ref, port = _pair(twin, max_batch=2)
    try:
        assert port._seq2seq_buf_len == ref._seq2seq_buf_len == -(-12 // int(chunk)) * int(chunk)
        for text in TEXTS[:3]:
            chunks = list(port.seq2seq_stream_blocking(text))
            assert chunks == list(ref.seq2seq_stream_blocking(text))
            assert [t for c in chunks for t in c] == port.seq2seq_sync(text)

            async def drain(fn, eng):
                return [e async for e in fn(eng, text, eng.tokenizer)]

            got = asyncio.run(drain(stream_seq2seq, port))
            want = asyncio.run(drain(ref_stream_seq2seq, ref))
            strip = [{k: v for k, v in e.items() if k != "ttft_ms"} for e in got]
            assert strip == [{k: v for k, v in e.items() if k != "ttft_ms"} for e in want]
            assert got[-1]["type"] == "done" and got[-1]["tokens"] == sum(map(len, chunks))
            assert "".join(e["text"] for e in got[:-1]) == port.tokenizer.decode(
                port.seq2seq_sync(text))
        enc = InferenceEngine("bert-tiny", device="cpu")
        try:
            with pytest.raises(RuntimeError, match="not a seq2seq model"):
                next(enc.seq2seq_stream_blocking("x"))
        finally:
            enc.close()
    finally:
        ref.stop_sync()
        port.close()


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_engine_equals_reference(twin, quant):
    """``quant=`` on a seq2seq engine quantizes the T5 tree (the
    reference's policy): the same ids as the reference's quantized engine,
    ``param_bytes`` below the f32 tree's, the mode kept."""
    ref, port = _pair(twin, quant=quant, max_batch=2)
    try:
        assert port.quant == ref.quant == quant
        for text in TEXTS[:2]:
            assert port.seq2seq_sync(text) == ref.seq2seq_sync(text)
        f32_bytes = sum(a.size * 4 for a in jax.tree_util.tree_leaves(twin[2]))
        assert port.param_bytes() < f32_bytes
        assert port.hbm_ledger()["components"]["params"] == port.param_bytes()
        port.apply_quantization(quant)  # the same mode: a no-op
        with pytest.raises(RuntimeError, match="cannot re-quantize"):
            port.apply_quantization("int8" if quant == "int4" else "int4")
    finally:
        ref.stop_sync()
        port.close()


def _hf_dir(path, cfg) -> str:
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.T5Config(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv, num_heads=cfg.n_heads,
        num_layers=cfg.n_layers, d_ff=cfg.d_ff, feed_forward_proj="gated-gelu",
        tie_word_embeddings=False, dropout_rate=0.0)
    torch.manual_seed(9)
    transformers.T5ForConditionalGeneration(hf_cfg).save_pretrained(path, safe_serialization=True)
    return str(path)


@pytest.mark.parametrize("quant", ["", "int8"])
def test_from_config_with_an_hf_checkpoint(twin, tmp_path, quant):
    """``TPU_MODEL`` + an HF ``TPU_CHECKPOINT`` (+ ``TPU_QUANT``) through
    ``from_config`` on both packages: the checkpoint loads through
    ``load_hf_t5`` with the registry's config (quantized as it lands), the
    batcher keys reach the engine, and the answers are the reference's."""
    ckpt = _hf_dir(tmp_path, twin[0])
    keys = {"TPU_MODEL": NAME, "TPU_CHECKPOINT": ckpt, "TPU_QUANT": quant,
            "TPU_MAX_BATCH": "2", "TPU_BATCH_WAIT_MS": "7"}
    ref = RefEngine.from_config(gofr_tpu.config.MockConfig(keys))
    ref.start_sync()
    port = InferenceEngine.from_config(gofr_tpu_torch.config.MockConfig(
        {**keys, "TPU_DEVICE": "cpu"}))
    try:
        assert port.family == "seq2seq" and port.quant == quant
        assert (port._batcher.max_batch, port._batcher.max_wait_s) == (2, 0.007)
        for text in TEXTS[:2]:
            assert port.infer_sync(text) == ref.infer_sync(text)
    finally:
        ref.stop_sync()
        port.close()


def test_from_config_t5_tiny_seed_weights_and_int8():
    """``TPU_MODEL=t5-tiny`` (bf16) from config alone builds the port's
    seed-0 weights and serves; ``TPU_QUANT=int8`` quantizes them."""
    for quant in ("", "int8"):
        eng = InferenceEngine.from_config(gofr_tpu_torch.config.MockConfig({
            "TPU_MODEL": "t5-tiny", "TPU_DEVICE": "cpu", "TPU_QUANT": quant}))
        try:
            assert eng.family == "seq2seq" and eng.quant == quant and eng.max_len == 128
            ids = eng.seq2seq_sync("hello")
            assert isinstance(ids, list) and len(ids) <= 64 and 1 not in ids
        finally:
            eng.close()


def test_app_routes_a_seq2seq_primary_as_the_reference(twin):
    """Both Apps with the twin injected as the container's engine: a route
    calling ``ctx.infer`` answers with the same body; the completion
    routes refuse a seq2seq primary with the same status."""
    import gofr_tpu.serving.openai_compat as ref_oai
    import gofr_tpu_torch.serving.openai_compat as port_oai

    ref, port = _pair(twin, max_batch=2)
    harnesses = {}
    try:
        for pkg, mod, oai, eng in (("port", gofr_tpu_torch, port_oai, port),
                                   ("reference", gofr_tpu, ref_oai, ref)):
            app = mod.App(config=mod.config.MockConfig({"HTTP_PORT": "0",
                                                        "METRICS_PORT": "0"}))
            app.container.tpu = eng
            oai.add_openai_routes(app)

            @app.post("/t2t")
            async def t2t(ctx):
                return await ctx.infer(ctx.request.json()["input"])

            harnesses[pkg] = Harness(app)
        got = {pkg: h.request("POST", "/t2t", {"input": "translate this text"})
               for pkg, h in harnesses.items()}
        assert got["port"][0] == got["reference"][0] == 201
        assert got["port"][2] == got["reference"][2]
        got = {pkg: h.request("POST", "/v1/completions", {"prompt": "hi", "max_tokens": 3})
               for pkg, h in harnesses.items()}
        assert got["port"][0] == got["reference"][0]
    finally:
        for h in harnesses.values():
            h.close()
        ref.stop_sync()
        port.close()


def test_encoder_beside_a_seq2seq_primary():
    """``TPU_MODEL=t5-tiny`` beside ``TPU_EMBED_MODEL=bert-tiny``: one App,
    text-to-text from the primary, embeddings from the encoder."""
    app = gofr_tpu_torch.App(config=gofr_tpu_torch.config.MockConfig({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "TPU_MODEL": "t5-tiny", "TPU_DEVICE": "cpu",
        "TPU_EMBED_MODEL": "bert-tiny", "TPU_MAX_LEN": "64"}))
    try:
        assert app.container.tpu.family == "seq2seq"
        assert app.container.tpu_embed.family == "encoder"
        assert set(app.container.tpu.infer_sync("hi")) == {"text", "token_ids"}
        assert app.container.tpu_embed.embed_sync("hi").shape == (128,)
    finally:
        app.container.tpu.close()
        app.container.tpu_embed.close()


def test_stream_resumes_on_another_thread(pair):
    """``seq2seq_stream`` resumes its generator on whichever executor thread
    is free, and inference mode is per thread: each chunk after the first,
    read from a second thread, gives the one-shot ids."""
    import threading

    _, port = pair
    gen = port.seq2seq_stream_blocking(TEXTS[0])
    chunks = [next(gen)]
    reader = threading.Thread(target=lambda: chunks.extend(gen))
    reader.start()
    reader.join(timeout=60)
    assert not reader.is_alive()
    assert len(chunks) > 1 and [t for c in chunks for t in c] == port.seq2seq_sync(TEXTS[0])
