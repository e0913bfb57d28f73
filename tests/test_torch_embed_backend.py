"""``TPU_EMBED_MODEL``, ``/v1/embeddings`` and the encoder and vision
families through the App, on the port and on the reference, compared
response for response on the CPU.

Both Apps come up from config alone (``TPU_MODEL=llama-tiny`` beside
``TPU_EMBED_MODEL=bert-tiny``, or a vision or encoder ``TPU_MODEL``). The
reference's engines take their seed-0 weights; the port takes the same
weights through ``TPU_EMBED_CHECKPOINT`` / ``TPU_CHECKPOINT``: a
``serving/checkpoint.py`` file written here from the reference's tree
(``bert_params_from_jax``, ``resnet_params_from_jax``). The embeddings
are held at ``tests/test_torch_encoders.py``'s BERT_TOL, the logits at
its ResNet tolerance.
"""

from __future__ import annotations

import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest

import gofr_tpu
import gofr_tpu.config
import gofr_tpu.serving.openai_compat as ref_oai
import gofr_tpu_torch
import gofr_tpu_torch.config
import gofr_tpu_torch.serving.openai_compat as port_oai
from gofr_tpu.logging import Level as RefLevel
from gofr_tpu.logging import Logger as RefLogger
from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu_torch.logging import Level, Logger
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.serving.checkpoint import save_checkpoint
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import bert_params_from_jax, resnet_params_from_jax
from tests.test_torch_encoders import BERT_TOL, RESNET_RTOL
from tests.test_torch_openai import Harness

BASE = {"APP_NAME": "embed-test", "HTTP_PORT": "0", "METRICS_PORT": "0",
        "TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "128"}
CONVERT = {"bert-tiny": bert_params_from_jax, "resnet-tiny": resnet_params_from_jax}


def _checkpoint(tmp_path, name: str) -> str:
    """The reference engine's seed-0 weights of ``name`` as a port
    checkpoint file."""
    ref = ref_get_model(name)
    tree = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(0), ref.config))
    path = str(tmp_path / f"{name}.pt")
    save_checkpoint(path, CONVERT[name](tree, get_model(name).config, device="cpu"))
    return path


def _apps(port_extra: dict, **config) -> dict:
    """The port's and the reference's App from ``config`` (the port's
    also on the CPU, with ``port_extra``), OpenAI routes added and a
    /infer route that calls ctx.infer on the body's ``input``."""
    out = {}
    for pkg, mod, oai, extra in (("port", gofr_tpu_torch, port_oai,
                                  dict(port_extra, TPU_DEVICE="cpu")),
                                 ("reference", gofr_tpu, ref_oai, {})):
        app = mod.App(config=mod.config.MockConfig({**BASE, **config, **extra}))
        oai.add_openai_routes(app)

        @app.post("/infer")
        async def infer(ctx):
            body = ctx.request.json()
            inputs = body["input"]
            if isinstance(inputs, list):
                inputs = np.asarray(inputs, np.float32)
            return await ctx.infer(inputs)

        out[pkg] = Harness(app)
    return out


def _close_all(apps: dict) -> None:
    for h in apps.values():
        h.close()


def _post(apps, path, body):
    got = {pkg: h.request("POST", path, body) for pkg, h in apps.items()}
    return {pkg: (status, json.loads(raw)) for pkg, (status, _, raw) in got.items()}


def _same_embeddings(port: dict, ref: dict) -> None:
    """Equal responses, each embedding within BERT_TOL."""
    assert [d["index"] for d in port["data"]] == [d["index"] for d in ref["data"]]
    for p, r in zip(port["data"], ref["data"]):
        assert p["object"] == r["object"] == "embedding"
        np.testing.assert_allclose(p["embedding"], r["embedding"], atol=BERT_TOL["bf16"])
    strip = lambda body: {k: v for k, v in body.items() if k != "data"}  # noqa: E731
    assert strip(port) == strip(ref)


@pytest.fixture(scope="module")
def embed_apps(tmp_path_factory):
    ckpt = _checkpoint(tmp_path_factory.mktemp("embed"), "bert-tiny")
    apps = _apps({"TPU_EMBED_CHECKPOINT": ckpt}, TPU_MODEL="llama-tiny",
                 TPU_EMBED_MODEL="bert-tiny")
    yield apps
    _close_all(apps)


def test_embeddings_endpoint_with_secondary_encoder(embed_apps):
    """TPU_EMBED_MODEL wires a second (encoder) engine into the container:
    /v1/embeddings answers as the reference's (200, a list of embeddings
    in input order, the model, the prompt tokens), /v1/models marks both
    engines loaded."""
    assert embed_apps["port"].app.container.tpu_embed is not None
    got = _post(embed_apps, "/v1/embeddings", {"input": ["the cat sat", "on the mat"]})
    (ps, port), (rs, ref) = got["port"], got["reference"]
    assert ps == rs == 200
    assert port["object"] == "list" and port["usage"]["prompt_tokens"] > 0
    _same_embeddings(port, ref)
    for pkg, h in embed_apps.items():
        status, _, raw = h.request("GET", "/v1/models")
        loaded = {m["id"] for m in json.loads(raw)["data"] if m["loaded"]}
        assert status == 200 and loaded == {"llama-tiny", "bert-tiny"}, pkg


def test_a_single_string_and_a_named_model(embed_apps):
    got = _post(embed_apps, "/v1/embeddings", {"input": "vector me", "model": "bert-tiny"})
    (ps, port), (rs, ref) = got["port"], got["reference"]
    assert ps == rs == 200 and port["model"] == "bert-tiny"
    _same_embeddings(port, ref)


@pytest.mark.parametrize("body,status", [
    ({"input": []}, 400), ({"input": [1, 2]}, 400), ({"input": "x", "model": "gpt-4"}, 404),
], ids=["empty", "not strings", "unknown model"])
def test_embedding_errors_match(embed_apps, body, status):
    got = _post(embed_apps, "/v1/embeddings", body)
    assert got["port"][0] == got["reference"][0] == status
    assert set(got["port"][1]) == set(got["reference"][1]) == {"error"}


def test_the_batcher_keys_reach_the_encoder(embed_apps):
    """TPU_MAX_BATCH / TPU_BATCH_WAIT_MS at their defaults (8, 5 ms) on
    both encoders; the encoder's own byte tokenizer; health names the
    family."""
    port = embed_apps["port"].app.container.tpu_embed
    ref = embed_apps["reference"].app.container.tpu_embed
    assert (port._batcher.max_batch, port._batcher.max_wait_s) == (
        ref._batcher.max_batch, ref._batcher.max_wait_s) == (8, 0.005)
    assert isinstance(port.tokenizer, ByteTokenizer) and port.max_len == ref.max_len == 128
    assert port.health_check()["details"]["family"] == "encoder"
    health = embed_apps["port"].app.container.health()
    assert health["details"]["tpu_embed"]["status"] == "UP"


def test_primary_encoder_serves_embeddings_and_infer(tmp_path):
    """TPU_MODEL=bert-tiny: /v1/embeddings from the primary and ctx.infer's
    {"embedding": ...}, both as the reference's; TPU_MAX_BATCH and
    TPU_BATCH_WAIT_MS reach its batcher."""
    ckpt = _checkpoint(tmp_path, "bert-tiny")
    apps = _apps({"TPU_CHECKPOINT": ckpt}, TPU_MODEL="bert-tiny", TPU_MAX_BATCH="3",
                 TPU_BATCH_WAIT_MS="7")
    try:
        port = apps["port"].app.container.tpu
        assert port.family == "encoder" and apps["port"].app.container.tpu_embed is None
        assert (port._batcher.max_batch, port._batcher.max_wait_s) == (3, 0.007)
        got = _post(apps, "/v1/embeddings", {"input": ["a", "bb", "ccc", "dddd"]})
        assert got["port"][0] == got["reference"][0] == 200
        _same_embeddings(got["port"][1], got["reference"][1])
        got = _post(apps, "/infer", {"input": "the cat sat"})
        (ps, port_body), (rs, ref_body) = got["port"], got["reference"]
        assert ps == rs == 201
        np.testing.assert_allclose(port_body["data"]["embedding"], ref_body["data"]["embedding"],
                                   atol=BERT_TOL["bf16"])
    finally:
        _close_all(apps)


def test_vision_model_through_ctx_infer(tmp_path):
    """TPU_MODEL=resnet-tiny through from_config: an app route calls
    ctx.infer on an [32, 32, 3] image; logits and class as the
    reference's, a 400-class-free image batch of one."""
    ckpt = _checkpoint(tmp_path, "resnet-tiny")
    apps = _apps({"TPU_CHECKPOINT": ckpt}, TPU_MODEL="resnet-tiny")
    try:
        assert apps["port"].app.container.tpu.family == "vision"
        image = np.random.default_rng(7).standard_normal((32, 32, 3)).round(3).tolist()
        got = _post(apps, "/infer", {"input": image})
        (ps, port), (rs, ref) = got["port"], got["reference"]
        assert ps == rs == 201
        want = np.asarray(ref["data"]["logits"])
        np.testing.assert_allclose(port["data"]["logits"], want, rtol=RESNET_RTOL,
                                   atol=RESNET_RTOL * np.abs(want).max())
        assert port["data"]["class"] == ref["data"]["class"] == int(np.argmax(want))
        got = _post(apps, "/v1/embeddings", {"input": "x"})
        assert got["port"][0] == got["reference"][0] == 400  # no encoder engine
    finally:
        _close_all(apps)


def test_embed_model_must_be_an_encoder():
    """The reference's family check and message; the port raises it where
    the reference logs it and serves with no encoder."""
    cfg = {**BASE, "TPU_MODEL": "llama-tiny", "TPU_EMBED_MODEL": "resnet-tiny"}
    with pytest.raises(ValueError, match="is family 'vision', need an encoder"):
        gofr_tpu_torch.App(config=gofr_tpu_torch.config.MockConfig({**cfg, "TPU_DEVICE": "cpu"}))
    err = io.StringIO()
    logger = RefLogger(level=RefLevel.INFO, out=io.StringIO(), err=err, is_terminal=False)
    from gofr_tpu.serving.backend import new_tpu_embed_from_config

    assert new_tpu_embed_from_config(gofr_tpu.config.MockConfig(cfg), logger) is None
    assert "is family 'vision', need an encoder" in err.getvalue()


def test_a_wordpiece_tokenizer_is_logged_and_served_by_bytes(tmp_path):
    """A WordPiece tokenizer.json the reader cannot read (one with a
    SentencePiece ``Precompiled`` normalizer, ROADMAP Queue 1 item 6.4):
    the error is logged and the encoder serves the byte tokenizer. A plain
    BERT file is read (test_wordpiece_embed_tokenizer_serves_as_the_reference)."""
    tok = tmp_path / "bert-tok"
    tok.mkdir()
    (tok / "tokenizer.json").write_text(json.dumps({
        "version": "1.0", "added_tokens": [], "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": "AAAA"},
            {"type": "BertNormalizer"}]},
        "pre_tokenizer": {"type": "BertPreTokenizer"}, "post_processor": None,
        "decoder": {"type": "WordPiece", "prefix": "##"},
        "model": {"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": {"[UNK]": 0, "the": 1}},
    }))
    (tok / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "BertTokenizer"}))
    err = io.StringIO()
    logger = Logger(level=Level.INFO, out=io.StringIO(), err=err, is_terminal=False)
    from gofr_tpu_torch.serving.backend import new_tpu_embed_from_config

    eng = new_tpu_embed_from_config(gofr_tpu_torch.config.MockConfig({
        "TPU_EMBED_MODEL": "bert-tiny", "TPU_EMBED_TOKENIZER": str(tok), "TPU_DEVICE": "cpu",
        "TPU_MAX_LEN": "64"}), logger)
    try:
        assert isinstance(eng.tokenizer, ByteTokenizer)
        assert "could not load tokenizer" in err.getvalue() and str(tok) in err.getvalue()
        assert "Precompiled" in err.getvalue()
        assert eng.embed_sync("the cat").shape == (128,)
    finally:
        eng.close()


def test_wordpiece_embed_tokenizer_serves_as_the_reference(tmp_path):
    """TPU_EMBED_TOKENIZER with a WordPiece BERT tokenizer.json (trained
    here with ``tokenizers``): the port's reader serves it, and
    /v1/embeddings answers as the reference's (which reads it with
    transformers) on the same weights."""
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers
    from tokenizers import processors, trainers

    from gofr_tpu_torch.serving.hf_tokenizer import HFTokenizer

    wp = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    wp.normalizer = normalizers.BertNormalizer(lowercase=True)
    wp.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    wp.decoder = decoders.WordPiece()
    wp.train_from_iterator(
        (Path(__file__).resolve().parents[1] / "README.md").read_text().split("\n"),
        trainers.WordPieceTrainer(vocab_size=400, special_tokens=[
            "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]))
    wp.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", special_tokens=[("[CLS]", 2), ("[SEP]", 3)])
    tok = tmp_path / "wordpiece"
    tok.mkdir()
    wp.save(str(tok / "tokenizer.json"))
    (tok / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "BertTokenizer"}))
    ckpt = _checkpoint(tmp_path, "bert-tiny")
    apps = _apps({"TPU_EMBED_CHECKPOINT": ckpt}, TPU_MODEL="llama-tiny",
                 TPU_EMBED_MODEL="bert-tiny", TPU_EMBED_TOKENIZER=str(tok))
    try:
        emb = apps["port"].app.container.tpu_embed
        assert isinstance(emb.tokenizer, HFTokenizer)
        ref_tok = apps["reference"].app.container.tpu_embed.tokenizer
        text = "The Cat sat, on the mat — naïvely!"
        assert emb.tokenizer.encode(text) == ref_tok.encode(text)
        got = _post(apps, "/v1/embeddings", {"input": [text, "the embeddings endpoint"]})
        assert got["port"][0] == got["reference"][0] == 200
        _same_embeddings(got["port"][1], got["reference"][1])
    finally:
        _close_all(apps)
