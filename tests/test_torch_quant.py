"""Weight quantization (``gofr_tpu_torch/ops/quant.py``) against the
reference's ``gofr_tpu/ops/quant.py``, bit for bit, and the engine's
``quant`` / ``apply_quantization`` against the reference engine's.

The reference quantizes under jit wherever it serves (its HF loader, its
quantized init and ``apply_quantization``), and there XLA turns the
division of the absmax by 127 (7 for int4) into a product with the f32
reciprocal, which moves the last bit of some scales against the eager
function. The port computes the jitted form, so the reference side of
each comparison is ``jax.jit`` of its function; the eager one is held to
the same ``q`` within one step and the same scales within one f32 ulp.

Inputs are seeded numpy arrays rounded to bf16, with an all-zero column
(scale 1) and contraction dims that shrink the int4 group (96, 48).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.ops import quant as rq
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.models.transformer import init_params, transformer_forward
from gofr_tpu_torch.ops import quant
from gofr_tpu_torch.parallel.sharding import loss_and_grads
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax, params_to_reference
from tests.test_torch_model import _np_tree

MODES = {"int8": (rq.quantize_array, quant.quantize_array, rq.Q8, quant.Q8),
         "int4": (rq.quantize_array4, quant.quantize_array4, rq.Q4, quant.Q4)}
# Stacked [L, D, O], a bare matrix (lm_head), an MoE stack [L, E, D, O],
# and a contraction of 48 that shrinks the int4 group to 48.
SHAPES = [(3, 256, 384), (256, 200), (2, 4, 96, 40), (48, 24)]


def _bf16(shape, seed=0, scale=0.05):
    """The same bf16 values on both sides: (jax array, torch tensor)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * scale).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero output column: scale 1, q 0
    x = jnp.asarray(w).astype(jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)


def _assert_same(got, want):
    """A port Q8/Q4 equal to a reference one bit for bit."""
    assert got.q.dtype == {np.dtype("int8"): torch.int8,
                           np.dtype("uint8"): torch.uint8}[np.asarray(want.q).dtype]
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    assert got.s.dtype == torch.float32


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_matches_reference_bit_for_bit(mode, shape):
    ref_fn, fn, ref_cls, cls = MODES[mode]
    x, t = _bf16(shape)
    got = fn(t)
    assert type(got) is cls and tuple(got.shape) == shape
    _assert_same(got, jax.jit(ref_fn)(x))
    # The eager reference divides: the same values but for the last bit
    # of some scales (and a q that may move by one where that matters).
    eager = ref_fn(x)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(eager.s), rtol=2 ** -23, atol=0)
    if mode == "int8":
        assert np.abs(got.q.numpy().astype(int) - np.asarray(eager.q).astype(int)).max() <= 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", MODES)
def test_dequantize_matches_reference_bit_for_bit(mode, dtype):
    ref_fn, fn, ref_cls, cls = MODES[mode]
    for shape in SHAPES:
        x, t = _bf16(shape, seed=1)
        want_q = jax.jit(ref_fn)(x)
        got_q = fn(t)
        want = np.asarray(rq.dequantize(want_q, getattr(jnp, dtype)), np.float32)
        got = quant.dequantize(got_q, getattr(torch, dtype))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert quant.dequantize(t) is t  # a plain weight passes through


def test_odd_contraction_and_mode_errors_match_reference():
    x, t = _bf16((7, 16))
    with pytest.raises(ValueError) as want:
        rq.quantize_array4(x)
    with pytest.raises(ValueError) as got:
        quant.quantize_array4(t)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        rq.quantize_params({"layers": {}}, "int2")
    with pytest.raises(ValueError) as got:
        quant.quantize_params({}, "int2")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", MODES)
def test_fused_and_sliced_quantization_is_exact(mode):
    """Quantizing Q|K|V fused is the three quantized apart, concatenated
    along the output axis (q and s alike); quantizing a stacked leaf one
    leading slice at a time (quantize_into) is quantizing it whole."""
    fn = MODES[mode][1]
    parts = [_bf16((2, 256, n), seed=n)[1] for n in (96, 32, 32)]
    fused = fn(torch.cat(parts, dim=-1))
    apart = [fn(p) for p in parts]
    assert torch.equal(fused.q, torch.cat([a.q for a in apart], dim=-1))
    assert torch.equal(fused.s, torch.cat([a.s for a in apart], dim=-1))
    w = _bf16((2, 3, 256, 64), seed=5)[1]
    whole = fn(w)
    sliced = quant.empty_quantized(mode, tuple(w.shape), "cpu")
    for i in range(2):
        for e in range(3):
            quant.quantize_into(sliced, (i, e), w[i, e])
    assert torch.equal(sliced.q, whole.q) and torch.equal(sliced.s, whole.s)
    layer = whole[1]  # a Q8/Q4 indexes by its leading axes
    assert type(layer) is type(whole) and tuple(layer.shape) == (3, 256, 64)
    assert torch.equal(layer.q, whole.q[1]) and torch.equal(layer.s, whole.s[1])


@pytest.mark.parametrize("name", ["llama-tiny", "moe-tiny", "neox-tiny"])
@pytest.mark.parametrize("mode", MODES)
def test_params_from_jax_of_quantized_tree_matches_port_quantization(name, mode):
    """params_from_jax of the reference's (jitted) quantize_params tree is
    the port's quantize_params of params_from_jax of the bf16 tree, leaf
    for leaf, bit for bit; params_to_reference splits it back into the
    reference's leaves; the router and the embedding stay bf16."""
    ref_cfg, cfg = ref_get_model(name).config, get_model(name).config
    tree = init_transformer(jax.random.PRNGKey(2), ref_cfg)
    qtree = _np_tree(jax.jit(lambda p: rq.quantize_params(p, mode))(tree))
    got = params_from_jax(qtree, cfg, device="cpu")
    want = quant.quantize_params(params_from_jax(_np_tree(tree), cfg, device="cpu"), mode)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert type(g) is type(w), k
        if quant.is_quantized(w):
            assert k in quant.QUANT_KEYS
            assert torch.equal(g.q, w.q) and torch.equal(g.s, w.s), k
        else:
            assert g.dtype == cfg.dtype and torch.equal(g, w), k
    assert not quant.is_quantized(got["embed"])
    assert quant.params_quant_mode(got) == mode
    back = params_to_reference(got, cfg)
    for k, v in qtree["layers"].items():
        if isinstance(v, (rq.Q8, rq.Q4)):
            np.testing.assert_array_equal(back["layers"][k].q, v.q, err_msg=k)
            np.testing.assert_array_equal(back["layers"][k].s, v.s, err_msg=k)
    np.testing.assert_array_equal(back["lm_head"].q, qtree["lm_head"].q)


def test_quantized_forward_matches_reference():
    """transformer_forward of the reference's quantized llama-tiny-f32 and
    the port's on the same Q8/Q4 leaves: the same f32 logits, as for plain
    weights (the products differ only in summation order)."""
    ref_cfg = ref_get_model("llama-tiny-f32").config
    cfg = get_model("llama-tiny-f32").config
    tree = init_transformer(jax.random.PRNGKey(4), ref_cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    from gofr_tpu.models.transformer import transformer_forward as ref_forward
    for mode in MODES:
        qtree = jax.jit(lambda p: rq.quantize_params(p, mode))(tree)
        want = np.asarray(ref_forward(qtree, jnp.asarray(tokens), ref_cfg))
        with torch.no_grad():
            got = transformer_forward(params_from_jax(_np_tree(qtree), cfg, device="cpu"),
                                      torch.from_numpy(tokens).long(), cfg)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


GEOMETRY = dict(n_slots=2, max_len=128, window_k=4, prefill_chunk=16, prefill_batch=2)
GEN = dict(max_new_tokens=10, temperature=0.0, stop_on_eos=False)
MODEL = "llama-tiny-f32"


@pytest.fixture(scope="module")
def np_tree():
    return _np_tree(init_transformer(jax.random.PRNGKey(0), ref_get_model(MODEL).config))


def _fresh(tree):
    """New device arrays for a reference engine (its quantization donates
    the params it is given)."""
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, n).tolist() for n in (40, 16, 3)]


def _streams(eng, submit):
    reqs = [submit(p, **GEN) for p in _prompts()]
    return [r.future.result(timeout=120).token_ids for r in reqs]


@pytest.mark.parametrize("mode", MODES)
def test_engine_quant_streams_equal_reference_engine(np_tree, mode):
    """Both engines given the same plain weights and ``quant=mode`` (each
    quantizes them in its constructor, the reference under jit): the port
    holds the reference's quantized leaves bit for bit, and the greedy
    streams are identical; ``param_bytes`` agrees."""
    cfg = get_model(MODEL).config
    ref = RefEngine(MODEL, tokenizer=RefByteTokenizer(), params=_fresh(np_tree), quant=mode,
                    **GEOMETRY)
    ref.start_sync()
    try:
        want = _streams(ref, ref.submit_generate)
        ref_bytes = ref.param_bytes()
        ref_leaves = params_from_jax(_np_tree(ref.params), cfg, device="cpu")
    finally:
        ref.stop_sync()
    eng = InferenceEngine(MODEL, tokenizer=ByteTokenizer(), device="cpu", quant=mode,
                          params=params_from_jax(np_tree, cfg, device="cpu"),
                          **GEOMETRY)
    try:
        assert eng.quant == mode
        for k, w in ref_leaves.items():
            g = eng.params[k]
            if quant.is_quantized(w):
                assert torch.equal(g.q, w.q) and torch.equal(g.s, w.s), k
            else:
                assert torch.equal(g, w), k
        got = _streams(eng, eng.submit_generate)
        assert eng.param_bytes() == ref_bytes
    finally:
        eng.close()
    assert got == want and all(len(w) == GEN["max_new_tokens"] for w in want)


def test_apply_quantization_errors_match_reference(np_tree):
    """The reference's errors word for word: an unknown mode (in the
    constructor, and in apply_quantization), a second mode over quantized
    weights, and quantizing a running engine; the same mode again is a
    no-op, and quantizing a stopped port engine takes effect at its next
    start (the decode programs are captured again)."""
    cfg = get_model(MODEL).config
    plain = params_from_jax(np_tree, cfg, device="cpu")

    def both(fn_ref, fn_port, exc):
        with pytest.raises(exc) as want:
            fn_ref()
        with pytest.raises(exc) as got:
            fn_port()
        assert str(got.value) == str(want.value)

    both(lambda: RefEngine(MODEL, params=_fresh(np_tree), quant="int3", **GEOMETRY),
         lambda: InferenceEngine(MODEL, device="cpu", params=plain, quant="int3", **GEOMETRY),
         ValueError)
    ref = RefEngine(MODEL, params=_fresh(np_tree), quant="int8", **GEOMETRY)
    eng = InferenceEngine(MODEL, device="cpu", params=plain, quant="int8", **GEOMETRY)
    try:
        both(lambda: ref.apply_quantization("int4"), lambda: eng.apply_quantization("int4"),
             RuntimeError)
        before = eng.params
        eng.apply_quantization("INT8")  # the same mode: nothing happens
        assert eng.params is before
    finally:
        eng.close()
    ref = RefEngine(MODEL, params=_fresh(np_tree), **GEOMETRY)
    ref.start_sync()
    eng = InferenceEngine(MODEL, device="cpu", params=plain, **GEOMETRY)
    try:
        both(lambda: ref.apply_quantization("int8"), lambda: eng.apply_quantization("int8"),
             RuntimeError)
        both(lambda: ref.apply_quantization("fp8"), lambda: eng.apply_quantization("fp8"),
             ValueError)
        eng.stop_sync()
        eng.apply_quantization("int4")
        assert eng.quant == "int4" and quant.params_quant_mode(eng.params) == "int4"
        eng.start_sync()
        assert len(eng.generate_sync([1, 2, 3], max_new_tokens=3).token_ids) == 3
    finally:
        ref.stop_sync()
        eng.close()


def test_quantized_init_is_made_a_layer_at_a_time(monkeypatch):
    """init_params(quant=...) makes every quantized leaf one layer (for
    MoE: one layer's experts) in the model dtype at a time, never a whole
    leaf; the router, the embedding and the norms stay plain; the same
    seed gives the same weights, with the init's fan-in scale."""
    from gofr_tpu_torch.models import transformer

    cfg = get_model("moe-tiny").config
    seen = []
    real = transformer.quantize_into

    def spy(dst, idx, w):
        seen.append((tuple(dst.shape), tuple(w.shape), w.dtype))
        real(dst, idx, w)

    monkeypatch.setattr(transformer, "quantize_into", spy)
    params = init_params(cfg, 3, "cpu", quant="int8")
    for full, part, dtype in seen:
        assert dtype == cfg.dtype
        assert part == (full if len(full) == 2 else full[1:])  # lm_head: 2-D, whole
    assert {full for full, _, _ in seen} == {tuple(params[k].shape) for k in quant.QUANT_KEYS
                                             if k in params}
    assert not quant.is_quantized(params["router"]) and params["router"].dtype == cfg.dtype
    assert not quant.is_quantized(params["embed"])
    again = init_params(cfg, 3, "cpu", quant="int8")
    for k in quant.QUANT_KEYS:
        if k in params:
            assert torch.equal(params[k].q, again[k].q) and torch.equal(params[k].s, again[k].s)
    w = quant.dequantize(params["w_gate_up"], torch.float32)
    assert abs(w.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    with pytest.raises(ValueError, match="unsupported quant mode 'int2'"):
        init_params(cfg, 3, "cpu", quant="int2")


def test_training_refuses_quantized_weights():
    cfg = get_model("llama-tiny").config
    params = quant.quantize_params(init_params(cfg, 0, "cpu"), "int8")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="wqkv.*make_lora_train_step"):
        loss_and_grads(params, tokens, cfg)


def test_quantized_bytes_counts_as_stored():
    cfg = dataclasses.replace(get_model("llama-tiny").config)
    params = init_params(cfg, 0, "cpu")
    plain = quant.quantized_bytes(params)
    assert plain == sum(p.numel() * 2 for p in params.values())
    q8, q4 = (quant.quantize_params(params, m) for m in MODES)
    n = sum(params[k].numel() for k in quant.QUANT_KEYS if k in params)
    scales8 = sum(q8[k].s.numel() * 4 for k in quant.QUANT_KEYS if k in q8)
    scales4 = sum(q4[k].s.numel() * 4 for k in quant.QUANT_KEYS if k in q4)
    assert quant.quantized_bytes(q8) == plain - n * 2 + n + scales8
    assert quant.quantized_bytes(q4) == plain - n * 2 + n // 2 + scales4
