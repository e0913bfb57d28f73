"""Multi-LoRA through the port's engine on the caches and families the
other LoRA tests do not reach, greedy streams against the reference
engine's on the same weights and adapters (numpy at a seed, loaded by
``load_lora`` on both):

* ``llama-tiny-f32`` with 2 adapter slots of rank 4 on an int8 pool of
  40 blocks of 16 with the radix prefix cache, and on the int8 slot cache
  with the explicit prefix pool (``register_prefix``): base and two
  adapters over a shared prompt, solo and then batched together, then an
  unload and a load into the freed slot;
* the f32 twins of ``gemma-tiny``, ``neox-tiny``, ``gpt2-tiny`` and the
  Qwen2-shaped tiny (``tests/test_torch_families.py``, bias leaves seeded
  noise) with an adapter on every target the family has, on the slot
  cache and on a pool of blocks of 16 with the radix cache: base and
  adapter streams.

Every stream is held equal token for token.
"""

import numpy as np
import pytest

from gofr_tpu.models import registry as ref_registry
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models import registry
from gofr_tpu_torch.models.transformer import LORA_TARGETS, lora_dims
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from tests.test_torch_families import family_configs, family_weights
from tests.test_torch_lora_engine import CFG, MODEL, adapter

SHARED = list(range(30, 62))  # a 32-token shared prompt
SUFFIXES = ([5, 9, 11], [7, 7, 7, 7], [200, 3])
CACHES = {
    "int8 pool + radix": dict(kv_block=16, kv_pool_blocks=40, kv_quant="int8",
                              auto_prefix=True),
    "int8 slot cache + prefix pool": dict(kv_quant="int8", prefix_slots=2),
}
GEN = dict(max_new_tokens=10, temperature=0.0, stop_on_eos=False)


def _script(eng, prefix_pool: bool) -> list:
    """The same calls on either engine; every greedy stream, in order."""
    out = []
    eng.load_lora("a1", adapter(21))
    eng.load_lora("a2", adapter(22))
    if prefix_pool:
        for name in ("", "a1"):
            eng.register_prefix_sync(SHARED, adapter=name)
    names = ("", "a1", "a2")
    for name, suffix in zip(names, SUFFIXES):  # solo
        out.append(eng.generate_sync(SHARED + suffix, adapter=name, timeout=120, **GEN).token_ids)
    reqs = [eng.submit_generate(SHARED + suffix, adapter=name, **GEN)  # batched
            for name, suffix in zip(names, SUFFIXES)]
    out.extend(r.future.result(timeout=120).token_ids for r in reqs)
    eng.unload_lora("a1")
    eng.load_lora("a3", adapter(23))  # into the freed slot
    reqs = [eng.submit_generate(SHARED + suffix, adapter=name, **GEN)
            for name, suffix in zip(("a3", "a2", ""), SUFFIXES)]
    out.extend(r.future.result(timeout=120).token_ids for r in reqs)
    return out


@pytest.fixture(scope="module")
def tree():
    import jax

    from gofr_tpu.models.registry import get_model as ref_get_model
    from gofr_tpu.models.transformer import init_transformer

    np_tree = jax.tree_util.tree_map(
        np.asarray, init_transformer(jax.random.PRNGKey(11), ref_get_model(MODEL).config))
    return jax.tree_util.tree_map(jax.numpy.asarray, np_tree), np_tree


@pytest.mark.parametrize("cache", list(CACHES))
def test_multi_lora_streams_equal_reference_on_int8_caches(tree, cache):
    from gofr_tpu_torch.weights import params_from_jax

    jparams, np_tree = tree
    kv = CACHES[cache]
    geometry = dict(n_slots=4, max_len=128, window_k=4, lora_slots=2, lora_rank=4, **kv)
    ref = RefEngine(MODEL, params=jparams, tokenizer=RefByteTokenizer(), **geometry)
    ref.start_sync()
    try:
        want = _script(ref, "prefix_slots" in kv)
    finally:
        ref.stop_sync()
    port = InferenceEngine(MODEL, params=params_from_jax(np_tree, CFG, device="cpu"),
                           tokenizer=ByteTokenizer(), device="cpu", **geometry)
    try:
        got = _script(port, "prefix_slots" in kv)
        if "prefix_slots" in kv:
            assert port._prefix_pool is not None
        else:
            assert port._prefix_lookups > 0
    finally:
        port.close()
    assert all(len(w) == GEN["max_new_tokens"] for w in want)
    assert got == want
    assert len({tuple(w) for w in want[:3]}) == 3  # the adapters change the streams


def family_adapter(cfg, seed: int) -> dict:
    """Every target the family has (a non-gated MLP has no gate), rank 4."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in LORA_TARGETS:
        if t == "w_gate" and cfg.ffn == "mlp":
            continue
        d_in, d_out = lora_dims(cfg, t)
        out[t] = (0.5 * rng.standard_normal((cfg.n_layers, d_in, 4)).astype(np.float32),
                  0.5 * rng.standard_normal((cfg.n_layers, 4, d_out)).astype(np.float32))
    return out


@pytest.mark.parametrize("kv", [{}, {"kv_block": 16, "auto_prefix": True}],
                         ids=["slot", "pool+radix"])
@pytest.mark.parametrize("fam", ["gemma-tiny", "neox-tiny", "gpt2-tiny", "qwen2-tiny"])
def test_family_adapter_streams_equal_reference(fam, kv):
    ref_cfg, cfg = family_configs(fam, "f32")
    jparams, params = family_weights(ref_cfg, cfg, seed=7)
    name = f"{fam}-f32-lora-test"
    lora = family_adapter(cfg, 31)
    geometry = dict(n_slots=2, max_len=128, window_k=4, prefill_chunk=16, prefill_batch=2,
                    lora_slots=1, lora_rank=4, lora_targets=",".join(lora), **kv)
    prompts = [SHARED + list(s) for s in SUFFIXES[:2]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ref_registry._REGISTRY, name, ref_registry.ModelSpec(
            name=name, family="llm", config=ref_cfg, init=lambda key, c: jparams))
        mp.setitem(registry._REGISTRY, name, registry.ModelSpec(
            name=name, family="llm", config=cfg))
        streams = {}
        for pkg, make in (("reference", lambda: RefEngine(name, params=jparams,
                                                           tokenizer=RefByteTokenizer(),
                                                           **geometry)),
                          ("port", lambda: InferenceEngine(name, params=params,
                                                           tokenizer=ByteTokenizer(),
                                                           device="cpu", **geometry))):
            eng = make()
            if pkg == "reference":
                eng.start_sync()
            try:
                eng.load_lora("t", lora)
                reqs = [eng.submit_generate(p, adapter=a, **GEN)
                        for p in prompts for a in ("", "t")]
                streams[pkg] = [r.future.result(timeout=120).token_ids for r in reqs]
            finally:
                eng.stop_sync() if pkg == "reference" else eng.close()
    assert streams["port"] == streams["reference"]
    assert streams["port"][0] != streams["port"][1]  # the adapter changes the stream
