"""The serving engine on Mixtral's MoE: greedy token streams of the
port's engine identical to the reference engine's on the f32 twin of
``moe-tiny`` (registered in both registries under a test-only name only
while a test runs), with plain and int8 weights, on the slot cache and a
B=16 pool. Prompts are made with numpy and span several prefill chunks on
two slots.
"""

import numpy as np
import pytest

from gofr_tpu.models import registry as ref_registry
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models import registry
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from tests.test_torch_families import family_configs
from tests.test_torch_moe import _weights

GEOMETRY = dict(n_slots=2, max_len=128, window_k=4, prefill_chunk=16, prefill_batch=2)
GEN = dict(max_new_tokens=10, temperature=0.0, stop_on_eos=False)


@pytest.mark.parametrize("kv", [{}, {"kv_block": 16}], ids=["slot", "pool"])
@pytest.mark.parametrize("mode", ["", "int8"], ids=["plain", "int8"])
def test_greedy_streams_equal_reference_engine(mode, kv):
    """The f32 twin served by both engines on the same (quantized) weights:
    identical greedy streams."""
    ref_cfg, cfg = family_configs("moe-tiny", "f32")
    tree, params = _weights(ref_cfg, cfg, seed=7, mode=mode)
    name = "moe-tiny-f32-engine-test"
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).tolist() for n in (40, 16, 3)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ref_registry._REGISTRY, name, ref_registry.ModelSpec(
            name=name, family="llm", config=ref_cfg, init=lambda key, c: tree))
        mp.setitem(registry._REGISTRY, name, registry.ModelSpec(
            name=name, family="llm", config=cfg))
        ref = RefEngine(name, tokenizer=RefByteTokenizer(), params=tree, **GEOMETRY, **kv)
        ref.start_sync()
        try:
            want = [r.future.result(timeout=120).token_ids
                    for r in [ref.submit_generate(p, **GEN) for p in prompts]]
        finally:
            ref.stop_sync()
        eng = InferenceEngine(name, tokenizer=ByteTokenizer(), params=params, device="cpu",
                              **GEOMETRY, **kv)
        try:
            assert eng.quant == mode
            got = [r.future.result(timeout=120).token_ids
                   for r in [eng.submit_generate(p, **GEN) for p in prompts]]
        finally:
            eng.close()
    assert all(len(w) == GEN["max_new_tokens"] for w in want)
    assert got == want


@pytest.mark.parametrize("extra", [{"spec_tokens": 2}, {"kv_block": 16, "auto_prefix": True}],
                         ids=["spec", "prefix"])
def test_spec_and_prefix_cache_keep_the_streams(extra):
    """The f32 twin with int8 experts through a speculative engine (G = 2:
    the verify runs the MoE decode step once a candidate) and a pool with
    the radix prefix cache (a repeated prompt served warm): the greedy
    streams of the plain engine, token for token."""
    ref_cfg, cfg = family_configs("moe-tiny", "f32")
    _, params = _weights(ref_cfg, cfg, seed=7, mode="int8")
    name = "moe-tiny-f32-engine-test"
    rng = np.random.default_rng(6)
    base = rng.integers(0, 256, 40).tolist()
    prompts = [base, base + [5, 9], list(range(30, 36)) * 4]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(registry._REGISTRY, name, registry.ModelSpec(
            name=name, family="llm", config=cfg))
        streams = []
        for kw in ({}, extra):
            eng = InferenceEngine(name, tokenizer=ByteTokenizer(), params=params, device="cpu",
                                  **GEOMETRY, **kw)
            try:
                streams.append([eng.generate_sync(p, **GEN).token_ids for p in prompts])
                if kw.get("auto_prefix"):
                    assert eng._prefix_hit_tokens > 0
            finally:
                eng.close()
    assert streams[1] == streams[0]
