"""Mistral's sliding window through the whole port, against the reference
on the reference's own windowed test config (``SWA_CFG`` of
tests/test_sliding_window.py: f32, 2 layers, window 8, max_len 128):
the training forward, chunked prefill and split decode past the window,
and the serving engine's token streams on the slot cache, on a pool whose
block equals the window (the shape that once zeroed the reference's
window) and on the int8 cache. The same weights cross over through
``params_from_jax``; inputs are made with numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import registry as ref_registry
from gofr_tpu.models.transformer import TransformerConfig as RefConfig
from gofr_tpu.models.transformer import (
    init_transformer,
    transformer_decode_step,
    transformer_forward as ref_forward,
    transformer_prefill_chunk,
)
from gofr_tpu.ops.kv_cache import KVCache as RefKVCache
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models import registry
from gofr_tpu_torch.models.transformer import (
    TransformerConfig,
    decode_step,
    prefill_chunk,
    rope_tables,
    transformer_forward,
)
from gofr_tpu_torch.ops.kv_cache import KVCache
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax

DIMS = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_len=128, rope_theta=10000.0, sliding_window=8)
REF_CFG = RefConfig(dtype=jnp.float32, **DIMS)
CFG = TransformerConfig(dtype=torch.float32, **DIMS)
NAME = "swa-port-test"
# f32 on both sides, the same arithmetic in another order (as in
# tests/test_torch_model.py): logits agree to ~1e-6 relative.
TOL = 1e-4
PROMPT = [ord(ch) for ch in "sliding windows"]  # 15 tokens > window 8


@pytest.fixture(scope="module")
def models():
    """(reference params, port params), with the config registered under
    NAME in both registries for this module only."""
    jparams = init_transformer(jax.random.PRNGKey(3), REF_CFG)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), CFG,
                             device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ref_registry._REGISTRY, NAME, ref_registry.ModelSpec(
            name=NAME, family="llm", config=REF_CFG, init=lambda key, c: jparams))
        mp.setitem(registry._REGISTRY, NAME, registry.ModelSpec(
            name=NAME, family="llm", config=CFG))
        yield jparams, params


def test_forward_matches_reference_and_the_window_binds(models):
    jparams, params = models
    toks = np.arange(1, 33, dtype=np.int32)[None, :]
    want = np.asarray(ref_forward(jparams, jnp.asarray(toks), REF_CFG))
    got = transformer_forward(params, torch.from_numpy(toks).long(), CFG).detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    full = transformer_forward(params, torch.from_numpy(toks).long(),
                               dataclasses.replace(CFG, sliding_window=0)).detach().numpy()
    np.testing.assert_array_equal(full[:, :8], got[:, :8])  # inside the window
    assert not np.allclose(full[:, -1], got[:, -1], atol=1e-3)


def test_prefill_chunks_and_decode_past_the_window_match_reference(models):
    """Two chunks (16 tokens at 0 on slot 0, 8 more at 16; 5 tokens at 0
    on slot 1), then three decode steps: every query past position 7 has
    keys below its window."""
    jparams, params = models
    L, KV, hd = CFG.n_layers, CFG.n_kv_heads, CFG.head_dim
    S, max_len, c = 2, 64, 16
    rng = np.random.default_rng(1)
    ref_cache = RefKVCache.create(L, S, max_len, KV, hd, dtype=jnp.float32)
    cache = KVCache.create(L, S, max_len, KV, hd, dtype=torch.float32)
    rope = rope_tables(CFG, max_len, "cpu")
    for starts, lens in (([0, 0], [16, 5]), ([16, 5], [8, 0])):
        tokens = rng.integers(0, 256, (2, c)).astype(np.int32)
        rows = [np.array(x, np.int32) for x in ([0, 1], starts, lens)]
        want, ref_cache = transformer_prefill_chunk(
            jparams, jnp.asarray(tokens), ref_cache, *map(jnp.asarray, rows), REF_CFG,
            dense_attn=True)
        got = prefill_chunk(params, torch.from_numpy(tokens).long(), cache,
                            *map(torch.from_numpy, rows), CFG, rope=rope)
        live = rows[2] > 0
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   atol=TOL, rtol=TOL)
    lengths = np.array([24, 5], np.int32)
    ref_cache = ref_cache._replace(lengths=jnp.asarray(lengths))
    cache.lengths.copy_(torch.from_numpy(lengths))
    active = np.array([True, True])
    for _ in range(3):
        step = rng.integers(0, 256, (S,)).astype(np.int32)
        want, ref_cache = transformer_decode_step(
            jparams, jnp.asarray(step), ref_cache, jnp.asarray(active), REF_CFG,
            dense_attn=True)
        got = decode_step(params, torch.from_numpy(step).long(), cache,
                          torch.from_numpy(active), CFG, rope=rope)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize(
    "kv", [{}, {"kv_block": 8}, {"kv_quant": "int8"}], ids=["slot", "pool_block_8", "int8"])
def test_engine_streams_equal_reference_engine_across_the_window(models, kv):
    """A 15-token prompt and 12 new tokens (generation crosses the window)
    through both engines: identical greedy token ids."""
    jparams, params = models
    geometry = dict(n_slots=2, max_len=128, window_k=4, prefill_chunk=16, **kv)
    gen = dict(max_new_tokens=12, temperature=0.0, stop_on_eos=False, timeout=120)
    ref = RefEngine(NAME, tokenizer=RefByteTokenizer(), params=jparams, **geometry)
    ref.start_sync()
    try:
        want = ref.generate_sync(PROMPT, **gen).token_ids
    finally:
        ref.stop_sync()
    eng = InferenceEngine(NAME, tokenizer=ByteTokenizer(), params=params, device="cpu",
                          **geometry)
    try:
        got = eng.generate_sync(PROMPT, **gen).token_ids
    finally:
        eng.close()
    assert len(want) == 12
    assert got == want
