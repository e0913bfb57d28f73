"""The encoder and vision families of the port (``models/bert.py``,
``models/vit.py``, ``models/resnet.py``, the registry's encoders and the
engine's batched families in ``serving/modalities.py``) against the
reference on the same weights and inputs, all on the CPU.

Weights come from the reference's own init (``init_bert``, ``init_vit``,
``init_resnet``) and cross over through the port's ``*_params_from_jax``;
inputs are made with numpy from a seed. The reference's attention takes
its dense formula on the CPU (BERT with a mask always does); the port's
ViT attention is the plain version of its flash_attention kernel there.
Each tolerance is stated beside its test.
"""

from __future__ import annotations

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import bert as ref_bert
from gofr_tpu.models import resnet as ref_resnet
from gofr_tpu.models import vit as ref_vit
from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models import bert, resnet, vit
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import (
    bert_params_from_jax,
    bert_params_to_reference,
    resnet_params_from_jax,
    resnet_params_to_reference,
    vit_params_from_jax,
    vit_params_to_reference,
)
from tests.test_torch_model import _np_tree

# bf16 models: a few bf16 ulps of the output (2**-8 relative at its
# magnitude; rounding at other places in the two frameworks). f32 twins:
# the same arithmetic in another order.
BERT_TOL = {"bf16": 4e-3, "f32": 1e-5}  # unit-norm embeddings
VIT_TOL = {"bf16": 3e-2, "f32": 1e-4}  # logits of magnitude ~2
RESNET_RTOL = 1e-4  # f32 after the bf16 stem, as the reference
CONVERTERS = {
    "bert": (bert_params_from_jax, bert_params_to_reference),
    "vit": (vit_params_from_jax, vit_params_to_reference),
    "resnet": (resnet_params_from_jax, resnet_params_to_reference),
}


def _configs(name: str, dtype: str = "bf16"):
    ref_cfg, cfg = ref_get_model(name).config, get_model(name).config
    if dtype == "f32" and not name.startswith("resnet"):
        ref_cfg = dataclasses.replace(ref_cfg, dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return ref_cfg, cfg


def _weights(name: str, dtype: str = "bf16", seed: int = 0):
    """(reference params, port params, port config, reference config)."""
    ref_cfg, cfg = _configs(name, dtype)
    jparams = ref_get_model(name).init(jax.random.PRNGKey(seed), ref_cfg)
    to_port = CONVERTERS[name.split("-")[0]][0]
    return jparams, to_port(_np_tree(jparams), cfg, device="cpu"), cfg, ref_cfg


def test_registry_mirrors_reference_encoder_and_vision_entries():
    """Same names, families and config fields as the reference (the
    seq2seq names with T5's configs and init)."""
    for name in ("bert-base", "bert-tiny", "vit-base", "vit-tiny", "resnet-50",
                 "resnet-tiny", "flan-t5-small", "t5-tiny"):
        ref, port = ref_get_model(name), get_model(name)
        assert port.family == ref.family and port.eos_token == ref.eos_token
        assert port.init is not None
        for field in dataclasses.fields(port.config):
            want = getattr(ref.config, field.name)
            got = getattr(port.config, field.name)
            if field.name == "dtype":
                assert str(got).split(".")[-1] == want.__name__
            else:
                assert got == want, (name, field.name)
        assert (port.forward is None) == (ref.forward is None)


@pytest.mark.parametrize("name", ["bert-tiny", "vit-tiny", "resnet-tiny"])
def test_params_cross_over_and_back_exactly(name):
    """``*_params_from_jax`` then ``*_params_to_reference`` returns every
    leaf of the reference tree bit for bit, in its layout."""
    jparams, params, cfg, _ = _weights(name)
    back = CONVERTERS[name.split("-")[0]][1](params, cfg)
    want = _np_tree(jparams)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["bert-tiny", "vit-tiny", "resnet-tiny"])
def test_init_makes_the_reference_tree(name):
    """The port's seeded init has every leaf of the reference's, of its
    shape (through the converter), with the reference's statistics: norm
    weights one, biases and batch-norm moments at identity."""
    _, cfg = _configs(name)
    params = get_model(name).init(cfg, 0, "cpu")
    back = CONVERTERS[name.split("-")[0]][1](params, cfg)
    want = _np_tree(ref_get_model(name).init(jax.random.PRNGKey(0), ref_get_model(name).config))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree_util.tree_leaves(want)):
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, path
        if not b.any() or (b == 1).all():
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
        else:
            # Two samples' std: five standard errors of their ratio.
            tol = max(0.05, 5 / np.sqrt(a.size))
            assert abs(a.std() / b.std() - 1) < tol, jax.tree_util.keystr(path)


def _tokens_and_mask(cfg, b: int = 3, s: int = 16, seed: int = 1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 5:] = 0
    mask[2, 1:] = 0
    return tokens, mask


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_bert_embed_matches_reference_with_a_padding_mask(dtype):
    """bert-tiny's embeddings, rows padded to 16, 5 and 1 real tokens,
    within BERT_TOL of the reference's; unit norm; the mask changes the
    output (padding is attended by no query), as in the reference."""
    jparams, params, cfg, ref_cfg = _weights("bert-tiny", dtype)
    tokens, mask = _tokens_and_mask(cfg)
    want = np.asarray(ref_bert.bert_embed(jparams, jnp.asarray(tokens), jnp.asarray(mask),
                                          ref_cfg))
    got = bert.bert_embed(params, torch.from_numpy(tokens), torch.from_numpy(mask), cfg)
    assert got.dtype == torch.float32 and got.shape == (3, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, atol=BERT_TOL[dtype], rtol=0)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    full = bert.bert_embed(params, torch.from_numpy(tokens), torch.ones(3, 16, dtype=torch.int32),
                           cfg)
    assert not np.allclose(full[1].numpy(), got[1].numpy(), atol=1e-3)
    np.testing.assert_allclose(full[0].numpy(), got[0].numpy(), atol=1e-6)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_bert_forward_hidden_states_match_reference(dtype):
    jparams, params, cfg, ref_cfg = _weights("bert-tiny", dtype)
    tokens, mask = _tokens_and_mask(cfg)
    want = np.asarray(ref_bert.bert_forward(jparams, jnp.asarray(tokens), jnp.asarray(mask),
                                            ref_cfg), dtype=np.float32)
    got = bert.bert_forward(params, torch.from_numpy(tokens), torch.from_numpy(mask), cfg)
    assert got.dtype == cfg.dtype
    tol = {"bf16": 5e-2, "f32": 1e-4}[dtype]  # LayerNorm outputs of magnitude ~1
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_patchify_matches_reference_exactly():
    images = np.random.default_rng(2).standard_normal((2, 32, 48, 3)).astype(np.float32)
    want = np.asarray(ref_vit.patchify(jnp.asarray(images), 8))
    got = vit.patchify(torch.from_numpy(images), 8)
    assert got.shape == (2, 4 * 6, 8 * 8 * 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # Patch 1 is row 0, column 1; within it rows, then columns, then channels.
    np.testing.assert_array_equal(got[0, 1].reshape(8, 8, 3).numpy(), images[0, :8, 8:16])


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_vit_logits_match_reference(dtype):
    """vit-tiny (patch 8 on 32 x 32: 16 patches and the class token, exact
    GELU) within VIT_TOL of the reference's logits; the dense-attention
    path (the plain path a card run is held against) agrees as well."""
    jparams, params, cfg, ref_cfg = _weights("vit-tiny", dtype)
    images = np.random.default_rng(3).standard_normal((3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(ref_vit.vit_forward(jparams, jnp.asarray(images), ref_cfg))
    got = vit.vit_forward(params, torch.from_numpy(images), cfg)
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=VIT_TOL[dtype], rtol=0)
    dense = vit.vit_forward(params, torch.from_numpy(images), cfg, dense_attn=True)
    np.testing.assert_allclose(dense.numpy(), got.numpy(), atol=VIT_TOL[dtype], rtol=0)


@pytest.mark.parametrize("size,k,stride,pads", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)),
    (7, 3, 2, (1, 1)), (50, 7, 2, (2, 3)),
])
def test_same_pads_are_xla_same(size, k, stride, pads):
    """XLA's "SAME": the odd pixel at the high end (224 -> 7x7/2 pads 2, 3;
    112 -> 3x3/2 pads 0, 1)."""
    assert resnet.same_pads(size, k, stride) == pads
    x = jnp.ones((1, size, size, 1))
    w = jnp.ones((k, k, 1, 1))
    same = jax.lax.conv_general_dilated(x, w, (stride, stride), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    explicit = jax.lax.conv_general_dilated(x, w, (stride, stride), [pads, pads],
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_array_equal(np.asarray(same), np.asarray(explicit))


@pytest.mark.parametrize("size", [64, 50])
def test_resnet_logits_match_reference(size):
    """resnet-tiny on 64 x 64 and on 50 x 50 (odd sizes deep in the net,
    where only the asymmetric "SAME" padding agrees) within RESNET_RTOL of
    the reference's logits."""
    jparams, params, cfg, ref_cfg = _weights("resnet-tiny")
    images = np.random.default_rng(4).standard_normal((2, size, size, 3)).astype(np.float32)
    want = np.asarray(ref_resnet.resnet_forward(jparams, jnp.asarray(images), ref_cfg))
    got = resnet.resnet_forward(params, torch.from_numpy(images), cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=RESNET_RTOL,
                               atol=RESNET_RTOL * np.abs(want).max())


def test_resnet_runs_f32_after_the_bf16_stem(monkeypatch):
    """The stem's convolution takes bf16; every later one f32 (the batch
    norm's f32 parameters promote, and each weight is cast to the
    activation's dtype), as the reference's promotion."""
    _, params, cfg, _ = _weights("resnet-tiny")
    seen = []
    real = torch.nn.functional.conv2d
    monkeypatch.setattr(resnet.F, "conv2d",
                        lambda x, w, **kw: (seen.append((x.dtype, w.dtype)), real(x, w, **kw))[1])
    resnet.resnet_forward(params, torch.zeros(1, 64, 64, 3), cfg)
    assert seen[0] == (torch.bfloat16, torch.bfloat16)
    assert set(seen[1:]) == {(torch.float32, torch.float32)} and len(seen) == 1 + 4 * 4


# -- the engine's batched families ------------------------------------------


@pytest.fixture(scope="module")
def bert_pair():
    """The reference's and the port's bert-tiny engines on the same
    weights (max_batch 4, a 50 ms window, the byte tokenizer)."""
    jparams = ref_get_model("bert-tiny").init(jax.random.PRNGKey(0),
                                              ref_get_model("bert-tiny").config)
    ref = RefEngine("bert-tiny", tokenizer=RefByteTokenizer(), max_batch=4, max_wait_s=0.05,
                    params=jparams)
    ref.start_sync()
    port = InferenceEngine("bert-tiny", tokenizer=ByteTokenizer(), max_batch=4, max_wait_s=0.05,
                           params=bert_params_from_jax(_np_tree(jparams),
                                                       get_model("bert-tiny").config,
                                                       device="cpu"),
                           device="cpu")
    yield ref, port
    ref.stop_sync()
    port.close()


TEXTS = ["the cat sat", "on the mat " * 3, "x", "a longer sentence about nothing " * 2]


def test_embed_sync_matches_reference(bert_pair):
    """embed_sync per text (rows padded to a bucket of 16 or 64) within
    BERT_TOL of the reference engine's; equal texts equal vectors."""
    ref, port = bert_pair
    for text in TEXTS:
        got, want = port.embed_sync(text), ref.embed_sync(text)
        assert got.shape == want.shape == (128,)
        np.testing.assert_allclose(got, want, atol=BERT_TOL["bf16"], rtol=0)
    np.testing.assert_array_equal(port.embed_sync(TEXTS[0]), port.embed_sync(TEXTS[0]))


def test_concurrent_embeds_coalesce_and_match(bert_pair):
    """Four texts submitted together flush as one batch of 4 (padded to the
    longest's bucket), each vector within BERT_TOL of the reference's,
    results in order."""
    ref, port = bert_pair
    futures = [port._batcher.submit(t) for t in TEXTS]
    got = [f.result(timeout=60) for f in futures]
    want = [ref.embed_sync(t) for t in TEXTS]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=BERT_TOL["bf16"], rtol=0)


def test_infer_dispatches_on_the_family(bert_pair):
    ref, port = bert_pair
    got, want = port.infer_sync("the cat sat"), ref.infer_sync("the cat sat")
    assert set(got) == set(want) == {"embedding"}
    np.testing.assert_allclose(got["embedding"], want["embedding"], atol=BERT_TOL["bf16"])
    got = asyncio.run(port.infer("the cat sat"))
    np.testing.assert_allclose(got["embedding"], want["embedding"], atol=BERT_TOL["bf16"])
    with pytest.raises(RuntimeError, match="not a generative LLM"):
        port.submit_generate("hi")
    with pytest.raises(RuntimeError, match="not a generative LLM"):
        ref.submit_generate("hi")


def test_encoder_health_ledger_and_programs(bert_pair):
    """health_check names the family; the HBM ledger (built once) holds the
    params alone, as the reference's; the compile tracker counts the embed
    program once per bucket shape."""
    ref, port = bert_pair
    port.embed_sync("x")
    h, rh = port.health_check(), ref.health_check()
    assert h["status"] == rh["status"] == "UP"
    assert h["details"]["family"] == rh["details"]["family"] == "encoder"
    assert set(h["details"]["hbm_ledger"]["components"]) == {"params"}
    assert h["details"]["hbm_ledger"]["components"]["params"] == sum(
        p.numel() * p.element_size() for p in port.params.values())
    assert set(rh["details"]["hbm_ledger"]["components"]) == {"params"}
    assert h["details"]["hbm_ledger"]["components"]["params"] == \
        rh["details"]["hbm_ledger"]["components"]["params"]
    programs = port.compile_stats()["programs"]
    assert set(programs) == {"embed"} and programs["embed"]["compiles"] >= 1
    assert "kv_slots" not in h["details"]


@pytest.mark.parametrize("name,size", [("resnet-tiny", 64), ("vit-tiny", 32)])
def test_classify_sync_matches_reference(name, size):
    """classify_sync and infer through both engines on the same weights:
    logits within tolerance, the same class; three images submitted
    together coalesce into one batch (app_tpu_batch_size 3) and record
    app_tpu_infer_latency{kind="classify"}."""

    class Metrics:
        def __init__(self):
            self.calls = []

        def __getattr__(self, name):
            return lambda *a: self.calls.append((name, a))

    jparams, params, cfg, ref_cfg = _weights(name)
    ref = RefEngine(name, max_batch=4, max_wait_s=0.05, params=jparams)
    ref.start_sync()
    metrics = Metrics()
    port = InferenceEngine(name, max_batch=4, max_wait_s=0.05, params=params, device="cpu",
                           metrics=metrics)
    try:
        images = np.random.default_rng(5).standard_normal((3, size, size, 3)).astype(np.float32)
        tol = RESNET_RTOL * 100 if name.startswith("resnet") else VIT_TOL["bf16"]
        futures = [port._batcher.submit(img) for img in images]
        got = [f.result(timeout=60) for f in futures]
        for img, g in zip(images, got):
            w = ref.classify_sync(img)
            assert g.shape == w.shape == (10,)
            np.testing.assert_allclose(g, w, atol=tol, rtol=0)
            out, rout = port.infer_sync(img), ref.infer_sync(img)
            assert set(out) == set(rout) == {"logits", "class"}
            assert out["class"] == int(np.argmax(out["logits"]))
            np.testing.assert_allclose(out["logits"], rout["logits"], atol=tol)
        sizes = [a[1] for n, a in metrics.calls
                 if n == "record_histogram" and a[0] == "app_tpu_batch_size"]
        assert sizes[0] == 3
        assert any(n == "record_histogram" and a[0] == "app_tpu_infer_latency"
                   and a[2:] == ("kind", "classify") for n, a in metrics.calls)
        assert port.health_check()["details"]["family"] == "vision"
    finally:
        ref.stop_sync()
        port.close()


def test_unported_and_refused_options():
    """A seq2seq model serves (T5, ported); quantizing an encoder raises
    the reference's ValueError; an engine stops and restarts its
    batcher."""
    t5 = InferenceEngine("t5-tiny", device="cpu")
    try:
        assert t5.family == "seq2seq" and isinstance(t5.seq2seq_sync("hi"), list)
    finally:
        t5.close()
    with pytest.raises(ValueError, match="quantization supports llm and seq2seq models only"):
        InferenceEngine("bert-tiny", quant="int8", device="cpu")
    eng = InferenceEngine("resnet-tiny", device="cpu")
    try:
        with pytest.raises(ValueError, match="llm and seq2seq"):
            eng.apply_quantization("int8")
        eng.stop_sync()
        assert eng.health_check()["status"] == "DOWN" and eng.state == "DOWN"
        eng.start_sync()
        assert eng.classify_sync(np.zeros((32, 32, 3), np.float32)).shape == (10,)
    finally:
        eng.close()
