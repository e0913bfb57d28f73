"""T5 in the port (``gofr_tpu_torch/models/t5.py``) against the reference
(``gofr_tpu/models/t5.py``) and ``transformers``' ``T5ForConditionalGeneration``
on the CPU.

Both packages compute with the same weights: the reference's ``init_t5``
tree carried across by ``weights.t5_params_from_jax``; inputs are made
with numpy from a seed. The model is ``t5-tiny`` (d 64, 4 heads of 16,
2+2 layers) in bf16 and as an f32 twin, with relu and tied-head variants.
Tolerances, each stated beside its test: on the f32 twin the largest
difference within 1e-5 of the output's rms for encoder states and 5e-5
for decoder logits (the reference's own f32 logits sit 1.4e-5 from a
wider-precision run of the same tree: 2+2 layers of f32 sums in another
order); in bf16 the rms of the difference within 0.03 of the output's rms
and the largest within 2**-4 of the largest output (a few bf16 ulps: the
two frameworks round at other places, so most elements differ by an
ulp); greedy
ids equal on the f32 twin; quantized leaves and loaded trees bit for bit
(the reference quantizes under jit, as it serves: its loader and its
engine; the port computes that form).
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import t5 as R
from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu_torch.models import t5 as P
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.ops.quant import Q4, Q8, is_quantized
from gofr_tpu_torch.weights import t5_params_from_jax, t5_params_to_reference
from tests.test_torch_model import _np_tree

# f32: max |difference| over the reference output's rms, (encoder states,
# decoder logits); bf16: rms of the difference over its rms, and max
# |difference| over max |output|.
F32_TOL = (1e-5, 5e-5)
BF16_RMS_TOL, BF16_MAX_TOL = 0.03, 2.0**-4


def _assert_close(got, want, dtype: str, f32_tol: float) -> None:
    d = np.abs(got - want)
    rms = float(np.sqrt((want ** 2).mean()))
    if dtype == "f32":
        assert d.max() <= f32_tol * rms, (d.max(), rms)
    else:
        assert np.sqrt((d ** 2).mean()) <= BF16_RMS_TOL * rms, (np.sqrt((d ** 2).mean()), rms)
        assert d.max() <= BF16_MAX_TOL * np.abs(want).max(), (d.max(), np.abs(want).max())
HF_TOL = 2e-3  # the reference's own bound against transformers (f32)
VARIANTS = {
    "gated": {},
    "relu": {"gated_ffn": False},
    "tied": {"tied_head": True},
    "relu-tied": {"gated_ffn": False, "tied_head": True},
}


def _configs(dtype: str = "f32", **over):
    ref_cfg, cfg = ref_get_model("t5-tiny").config, get_model("t5-tiny").config
    if dtype == "f32":
        ref_cfg = dataclasses.replace(ref_cfg, dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return dataclasses.replace(ref_cfg, **over), dataclasses.replace(cfg, **over)


def _weights(dtype: str = "f32", seed: int = 0, **over):
    """(reference params, port params, reference config, port config)."""
    ref_cfg, cfg = _configs(dtype, **over)
    jparams = R.init_t5(jax.random.PRNGKey(seed), ref_cfg)
    return jparams, t5_params_from_jax(_np_tree(jparams), cfg, device="cpu"), ref_cfg, cfg


def _inputs(seed: int = 0, b: int = 3, s: int = 16, vocab: int = 512):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, s + 1, b)
    lens[0] = s
    toks = rng.integers(2, vocab, (b, s))
    toks[np.arange(s)[None, :] >= lens[:, None]] = 0
    return toks, lens


def _ref_generate(jparams, toks, lens, ref_cfg, max_new):
    return np.asarray(jax.jit(lambda p, t, n: R.t5_generate(p, t, n, ref_cfg, max_new=max_new))(
        jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(lens, jnp.int32)))


_ref_encode = jax.jit(R.t5_encode, static_argnums=(3,))


def _generate(params, toks, lens, cfg, max_new):
    with torch.inference_mode():
        return P.t5_generate(params, torch.from_numpy(toks), torch.from_numpy(lens), cfg,
                             max_new=max_new).numpy()


def _flat(tree, prefix: str = "") -> dict:
    """name → numpy array, a quantized leaf as its ``.q`` and ``.s``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        elif hasattr(v, "q") and hasattr(v, "s"):
            out[name + ".q"] = np.asarray(v.q.cpu() if torch.is_tensor(v.q) else v.q)
            out[name + ".s"] = np.asarray(v.s.cpu() if torch.is_tensor(v.s) else v.s)
        else:
            out[name] = (v.float().cpu().numpy() if torch.is_tensor(v)
                         else np.asarray(v, np.float32))
    return out


def _assert_same_tree(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k].astype(g[k].dtype), err_msg=k)


@pytest.mark.parametrize("buckets,max_dist", [(32, 128), (128, 128), (16, 32), (64, 256)])
@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidirectional", "causal"])
def test_rel_bucket_ids_equal_reference_and_transformers(buckets, max_dist, bidirectional):
    """Over distances -1024..1024 (an ulp at a bucket boundary would move a
    distance into the next bucket): the port's ids equal the reference's
    and transformers' ``_relative_position_bucket``; the cached host ids
    of ``bucket_ids`` are the same ids laid out [q, k]."""
    from transformers.models.t5.modeling_t5 import T5Attention

    rel = np.arange(-1024, 1025)
    got = P._rel_bucket(torch.from_numpy(rel), bidirectional, buckets, max_dist).numpy()
    want = np.asarray(R._rel_bucket(jnp.asarray(rel, jnp.int32), bidirectional, buckets,
                                    max_dist))
    hf = T5Attention._relative_position_bucket(
        torch.from_numpy(rel), bidirectional=bidirectional, num_buckets=buckets,
        max_distance=max_dist).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, hf)
    ids = P.bucket_ids(7, 40, bidirectional, buckets, max_dist, torch.device("cpu")).numpy()
    rel2 = np.arange(40)[None, :] - np.arange(7)[:, None]
    np.testing.assert_array_equal(
        ids, np.asarray(R._rel_bucket(jnp.asarray(rel2, jnp.int32), bidirectional, buckets,
                                      max_dist)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encode_and_decode_match_reference(dtype):
    """``t5_encode`` states and ``t5_decode`` logits (with and without the
    generation buffer's ``dec_lengths``) within F32_TOL / the bf16 bounds."""
    jparams, params, ref_cfg, cfg = _weights(dtype)
    toks, lens = _inputs()
    dec = np.random.default_rng(1).integers(2, 512, (3, 9))
    dec[:, 0] = 0
    dec_lens = np.array([9, 4, 1])
    j = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    ref_enc = _ref_encode(jparams, j(toks), j(lens), ref_cfg)
    want_enc = np.asarray(ref_enc, np.float32)
    ref_dec = jax.jit(R.t5_decode, static_argnums=(4,))
    want = [np.asarray(ref_dec(jparams, j(dec), ref_enc, j(lens), ref_cfg, dl))
            for dl in (None, j(dec_lens))]
    with torch.inference_mode():
        t = torch.from_numpy
        enc = P.t5_encode(params, t(toks), t(lens), cfg)
        got_enc = enc.float().numpy()
        got = [P.t5_decode(params, t(dec), enc, t(lens), cfg, dl).numpy()
               for dl in (None, t(dec_lens))]
    _assert_close(got_enc, want_enc, dtype, F32_TOL[0])
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (3, 9, 512)
        _assert_close(g, w, dtype, F32_TOL[1])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generate_ids_equal_reference(variant):
    """Greedy ids equal the reference's on the f32 twin, gated-gelu or
    relu, untied or tied (the d_model**-0.5 scale only when tied); EOS
    then zeros."""
    jparams, params, ref_cfg, cfg = _weights(**VARIANTS[variant])
    toks, lens = _inputs(2)
    got = _generate(params, toks, lens, cfg, 12)
    np.testing.assert_array_equal(got, _ref_generate(jparams, toks, lens, ref_cfg, 12))
    for row in got.tolist():
        if 1 in row:
            assert not any(row[row.index(1) + 1:])


def test_masked_row_softmax_is_uniform_not_nan():
    """A row with no valid key (length 0) gets -1e30 everywhere: a uniform
    softmax, finite states equal to the reference's."""
    jparams, params, ref_cfg, cfg = _weights()
    toks = np.zeros((2, 8), np.int64)
    toks[0, :5] = [5, 6, 7, 8, 9]
    lens = np.array([5, 0])
    want = np.asarray(_ref_encode(jparams, jnp.asarray(toks, jnp.int32),
                                  jnp.asarray(lens, jnp.int32), ref_cfg))
    with torch.inference_mode():
        got = P.t5_encode(params, torch.from_numpy(toks), torch.from_numpy(lens), cfg).numpy()
    assert np.isfinite(got).all()
    _assert_close(got, want, "f32", F32_TOL[0])


@pytest.fixture(scope="module")
def tiny_f32():
    return _weights()


@pytest.mark.parametrize("chunk", [3, 8])
@pytest.mark.parametrize("max_new", [1, 7, 64])
def test_generate_chunk_equals_generate(tiny_f32, chunk, max_new):
    """``t5_generate_chunk`` run chunk by chunk over a buffer padded to a
    chunk multiple gives ``t5_generate``'s ids (the engine's streaming
    unit), in place on the buffer."""
    _, params, _, cfg = tiny_f32
    toks, lens = _inputs(3, b=2)
    want = _generate(params, toks, lens, cfg, max_new)
    buf_len = -(-max_new // chunk) * chunk
    with torch.inference_mode():
        t = torch.from_numpy
        enc = P.t5_encode(params, t(toks), t(lens), cfg)
        buf = torch.zeros((2, 1 + buf_len), dtype=torch.long)
        done = torch.zeros((2,), dtype=torch.bool)
        for start in range(0, buf_len, chunk):
            out, done_out = P.t5_generate_chunk(params, buf, done, enc, t(lens), start, cfg,
                                                chunk)
            assert out is buf and done_out is done
    np.testing.assert_array_equal(buf[:, 1:1 + max_new].numpy(), want)


def test_padding_invariance(tiny_f32):
    """The reference's ``test_padding_invariance``: extra right padding on
    the encoder input changes nothing (the length masks own validity), and
    the ids are the reference's."""
    jparams, params, ref_cfg, cfg = tiny_f32
    lens = np.array([3])
    a = _generate(params, np.array([[5, 6, 7, 0]]), lens, cfg, 6)
    b = _generate(params, np.array([[5, 6, 7, 0, 0, 0, 0]]), lens, cfg, 6)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, _ref_generate(jparams, np.array([[5, 6, 7, 0]]), lens,
                                                   ref_cfg, 6))


def _save_hf(path, seed: int, proj: str = "gated-gelu", tied: bool = False):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.T5Config(
        vocab_size=64, d_model=32, d_kv=8, num_heads=4, num_layers=2, d_ff=64,
        relative_attention_num_buckets=32, relative_attention_max_distance=128,
        feed_forward_proj=proj, tie_word_embeddings=tied, dropout_rate=0.0,
    )
    torch.manual_seed(seed)
    model = transformers.T5ForConditionalGeneration(hf_cfg).eval()
    model.save_pretrained(path, safe_serialization=True)
    return model


@pytest.mark.parametrize("proj,tied", [("gated-gelu", False), ("relu", True)],
                         ids=["gated-untied", "relu-tied"])
def test_matches_transformers_t5(tmp_path, proj, tied):
    """The reference's ``test_t5_matches_torch_oracle`` for the port: a
    ``T5ForConditionalGeneration`` saved and read by ``load_hf_t5`` in f32,
    decoder logits within HF_TOL of transformers' own."""
    model = _save_hf(tmp_path, 6, proj, tied)
    cfg = dataclasses.replace(P.config_from_hf_t5(str(tmp_path)), dtype=torch.float32)
    assert cfg.gated_ffn == (proj == "gated-gelu") and cfg.tied_head == tied
    params = P.load_hf_t5(str(tmp_path), cfg, device="cpu")
    rng = np.random.default_rng(0)
    inp = rng.integers(2, 64, (2, 9))
    dec = rng.integers(2, 64, (2, 5))
    dec[:, 0] = 0  # the decoder start token (pad)
    lens = np.array([9, 9])
    t = torch.from_numpy
    with torch.inference_mode():
        enc = P.t5_encode(params, t(inp), t(lens), cfg)
        ours = P.t5_decode(params, t(dec), enc, t(lens), cfg).numpy()
        theirs = model(input_ids=t(inp), attention_mask=torch.ones((2, 9), dtype=torch.long),
                       decoder_input_ids=t(dec)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, atol=HF_TOL, rtol=HF_TOL)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_t5_params_bit_for_bit(mode):
    """Every Q8/Q4 leaf (``q`` and its scales) equals ``jax.jit`` of the
    reference's ``quantize_t5_params`` on the same bf16 tree; norms, the
    embedding and the bias tables stay plain; the int8 f32-twin ids equal
    the reference's int8 ids."""
    jparams, params, _, _ = _weights("bf16")
    want = jax.jit(lambda p: R.quantize_t5_params(p, mode))(jparams)
    got = P.quantize_t5_params(params, mode)
    kind = Q8 if mode == "int8" else Q4
    for side in ("encoder", "decoder"):
        for k, v in got[side].items():
            assert is_quantized(v) == k.startswith(("sa_", "ca_", "w_")), (side, k)
            if is_quantized(v):
                assert isinstance(v, kind)
    assert is_quantized(got["lm_head"])
    for k in ("embed", "enc_rel_bias", "dec_rel_bias", "enc_norm", "dec_norm"):
        assert got[k] is params[k]
    _assert_same_tree(got, _np_tree(want))
    if mode == "int8":
        jparams, params, ref_cfg, cfg = _weights()
        jq = jax.jit(lambda p: R.quantize_t5_params(p, "int8"))(jparams)
        toks, lens = _inputs(4)
        np.testing.assert_array_equal(
            _generate(P.quantize_t5_params(params, "int8"), toks, lens, cfg, 10),
            _ref_generate(jq, toks, lens, ref_cfg, 10))


def test_params_cross_over_and_back_exactly():
    """``t5_params_from_jax`` then ``t5_params_to_reference`` returns every
    leaf of the reference's tree (plain and int8) bit for bit."""
    jparams, params, _, cfg = _weights("bf16")
    _assert_same_tree(t5_params_to_reference(params, cfg), _np_tree(jparams))
    jq = _np_tree(jax.jit(lambda p: R.quantize_t5_params(p, "int8"))(jparams))
    _assert_same_tree(t5_params_to_reference(t5_params_from_jax(jq, cfg, device="cpu")), jq)
    assert P.t5_param_count(cfg) == sum(v.size for v in _flat(_np_tree(jparams)).values())


@pytest.mark.parametrize("proj,tied", [("gated-gelu", False), ("relu", True)],
                         ids=["gated-untied", "relu-tied"])
@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_load_hf_t5_trees_equal_reference(tmp_path, proj, tied, quant):
    """``config_from_hf_t5`` and ``load_hf_t5`` on a tiny directory written
    by transformers: the same config fields, and a tree equal leaf for
    leaf to the reference's load (bf16; quantized on load, the reference
    quantizing each leaf under jit as it lands). A mismatching config
    raises the reference's error."""
    _save_hf(tmp_path, 8, proj, tied)
    ref_cfg, cfg = R.config_from_hf_t5(str(tmp_path)), P.config_from_hf_t5(str(tmp_path))
    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    got = P.load_hf_t5(str(tmp_path), cfg, quant=quant, device="cpu")
    want = R.load_hf_t5(str(tmp_path), ref_cfg, quant=quant)
    assert ("lm_head" in got) == (not tied)
    assert ("w_gate" in got["encoder"]) == (proj == "gated-gelu")
    _assert_same_tree(got, _np_tree(want))
    with pytest.raises(ValueError, match="checkpoint/config mismatch: d_ff=64"):
        P.load_hf_t5(str(tmp_path), dataclasses.replace(cfg, d_ff=128), device="cpu")
    cfg_json = json.loads((tmp_path / "config.json").read_text())
    (tmp_path / "config.json").write_text(json.dumps({**cfg_json, "feed_forward_proj": "gelu"}))
    with pytest.raises(ValueError, match="unsupported t5 feed_forward_proj"):
        P.config_from_hf_t5(str(tmp_path))
