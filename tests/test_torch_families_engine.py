"""The serving engine on the other dense families: greedy token streams of
the port's engine identical to the reference engine's on f32 twins of
``gemma-tiny``, ``neox-tiny``, ``gpt2-tiny`` and the Qwen2-shaped tiny
(tests/test_torch_families.py), on the slot cache and on a B=16 pool,
with the same weights (bias leaves seeded noise). Each config is
registered in both registries under a test-only name for the module's
duration (``monkeypatch``); prompts are made with numpy and span several
prefill chunks on two slots.
"""

import numpy as np
import pytest

from gofr_tpu.models import registry as ref_registry
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models import registry
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from tests.test_torch_families import family_configs, family_weights

GEOMETRY = dict(n_slots=2, max_len=128, window_k=4, prefill_chunk=16, prefill_batch=2)
GEN = dict(max_new_tokens=10, temperature=0.0, stop_on_eos=False)


@pytest.fixture(scope="module", params=["gemma-tiny", "neox-tiny", "gpt2-tiny", "qwen2-tiny"])
def family(request):
    """(name, reference params, port params), the f32 twin registered under
    ``name`` in both registries for the module's duration."""
    ref_cfg, cfg = family_configs(request.param, "f32")
    jparams, params = family_weights(ref_cfg, cfg, seed=7)
    name = f"{request.param}-f32-engine-test"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ref_registry._REGISTRY, name, ref_registry.ModelSpec(
            name=name, family="llm", config=ref_cfg, init=lambda key, c: jparams))
        mp.setitem(registry._REGISTRY, name, registry.ModelSpec(
            name=name, family="llm", config=cfg))
        yield name, jparams, params


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, n).tolist() for n in (40, 16, 3)]


@pytest.mark.parametrize("kv", [{}, {"kv_block": 16}], ids=["slot", "pool"])
def test_greedy_streams_equal_reference_engine(family, kv):
    name, jparams, params = family
    ref = RefEngine(name, tokenizer=RefByteTokenizer(), params=jparams, **GEOMETRY, **kv)
    ref.start_sync()
    try:
        reqs = [ref.submit_generate(p, **GEN) for p in _prompts()]
        want = [r.future.result(timeout=120).token_ids for r in reqs]
    finally:
        ref.stop_sync()
    eng = InferenceEngine(name, tokenizer=ByteTokenizer(), params=params, device="cpu",
                          **GEOMETRY, **kv)
    try:
        reqs = [eng.submit_generate(p, **GEN) for p in _prompts()]
        got = [r.future.result(timeout=120).token_ids for r in reqs]
    finally:
        eng.close()
    assert all(len(w) == GEN["max_new_tokens"] for w in want)
    assert got == want
