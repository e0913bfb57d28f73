"""The port's explicit prefix pool (``serving/prefix_cache.py``,
``register_prefix``) and the prefix cache's configuration, against the
reference's.

* ``PrefixPool``'s registry driven by one sequence of ``store`` /
  ``lookup`` / ``purge_aid`` on both packages' pools: the same rows, the
  same LRU victims, the same longest match.
* Engines on the same ``llama-tiny-f32`` weights with ``prefix_slots``
  (``tests/test_prefix_cache.py``'s geometry: 2 slots, max_len 128), on
  the f32 and the int8 slot cache: a prompt cold, then after
  ``register_prefix_sync`` twice warm; the prefix itself as a prompt; a
  miss. Token ids identical to the reference's, logprobs within 1e-5, warm
  equal to cold; the pool's rows equal the reference pool's rows and the
  slot's own rows. LRU reuse of a row, the disabled error, and the longest
  match through ``from_config``.
* The mirror of ``tests/test_spec_decoding.py::
  test_prefix_cache_warm_hit_byte_identical`` on the reference's bf16
  ``llama-tiny`` with ``prefix_slots`` 2: cold and warm, G = 2 against G =
  0, equal to each other and to the reference engine's streams.
* The five ``TPU_*`` prefix keys the port now serves: each, read by the
  port's ``from_config``, sets the engine attribute the reference's sets,
  to the same value; ``TPU_PREFIX_EVICT_HBM_FRAC`` still raises.
"""

import inspect
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.config import MockConfig as RefMockConfig
from gofr_tpu.container.container import Container as RefContainer
from gofr_tpu.metrics import new_metrics_manager as ref_new_metrics_manager
from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.ops.kv_cache import KVCache as RefKVCache
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.prefix_cache import PrefixPool as RefPrefixPool
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.metrics import new_metrics_manager
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.ops.kv_cache import KVCache
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.prefix_cache import PrefixPool
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax

MODEL = "llama-tiny-f32"
LOGPROB_TOL = 1e-5
SYSTEM = "You are a terse assistant. Answer in one word. "
# The pool tests' prefix: 58 tokens, no multiple of 16 or 32, so a copy
# that stopped short of the prefix would leave positions unread.
PREFIX = SYSTEM + "Be brief. "
GEOMETRY = dict(n_slots=2, max_len=128)
GREEDY = dict(max_new_tokens=8, temperature=0.0, stop_on_eos=False, timeout=120)


def test_pool_registry_equals_reference():
    """Rows, hits, LRU victims and purges of one op sequence, on pools of
    2 rows over tiny slot caches of both packages."""
    import jax.numpy as jnp

    ref = RefPrefixPool(2, RefKVCache.create(1, 2, 64, 1, 4, dtype=jnp.float32))
    port = PrefixPool(2, KVCache.create(1, 2, 64, 1, 4, dtype=torch.float32))
    ops = [("store", [1, 2, 3]), ("store", [1, 2, 3, 4, 5]), ("lookup", [1, 2, 3, 4, 5, 6]),
           ("lookup", [1, 2, 3, 9]), ("lookup", [7]), ("store", [7, 7]),
           ("lookup", [1, 2, 3, 4]), ("lookup", [7, 7, 7]), ("store", [1, 2, 3]),
           ("store", [1, 2, 3, 4, 5]), ("purge", 0), ("lookup", [1, 2, 3]),
           ("store", [4]), ("lookup", [4, 4])]
    outs = []
    for pool in (ref, port):
        out = []
        for op, arg in ops:
            if op == "store":
                if pool is ref:
                    out.append(pool.store(arg, RefKVCache.create(1, 2, 64, 1, 4), 0))
                else:
                    out.append(pool.store(arg, KVCache.create(1, 2, 64, 1, 4), 0))
            elif op == "lookup":
                out.append(pool.lookup(arg))
            else:
                out.append(pool.purge_aid(arg))
            out.append(len(pool))
        outs.append(out)
    assert outs[0] == outs[1]
    assert port.hbm_bytes() == 2 * (1 * 2 * 1 * 64 * 4 * 4)


@pytest.fixture(scope="module")
def jax_params():
    return init_transformer(jax.random.PRNGKey(11), ref_get_model(MODEL).config)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_params), get_model(MODEL).config,
        device="cpu",
    )


def _metrics(container_cls, new_manager):
    """A metrics manager with a container's framework instruments."""
    box = SimpleNamespace(metrics=new_manager())
    container_cls.register_framework_metrics(box)
    return box.metrics


def _pool_hits(eng) -> dict:
    inst = {i.name: i for i in eng._metrics.instruments()}
    return dict(inst["app_tpu_prefix_hits"].collect())


@pytest.fixture(scope="module", params=["", "int8"], ids=["f32", "int8"])
def pair(request, jax_params, port_params):
    kw = dict(GEOMETRY, prefix_slots=2, kv_quant=request.param)
    ref = RefEngine(MODEL, params=jax_params, tokenizer=RefByteTokenizer(),
                    metrics=_metrics(RefContainer, ref_new_metrics_manager), **kw)
    ref.start_sync()
    port = InferenceEngine(MODEL, params=port_params, tokenizer=ByteTokenizer(),
                           device="cpu", metrics=_metrics(Container, new_metrics_manager),
                           **kw)
    yield ref, port
    ref.stop_sync()
    port.close()


def _same(got, want):
    assert got.token_ids == want.token_ids
    np.testing.assert_allclose(got.token_logprobs, want.token_logprobs, atol=LOGPROB_TOL)


def test_registered_prefix_warm_equals_cold_and_reference(pair):
    """Cold (nothing registered), then after register_prefix_sync twice
    warm, then the prefix itself as the prompt (the last chunk reruns to
    sample) and a miss: each stream equal to the reference engine's, the
    warm ones to the cold one."""
    ref, port = pair
    want, got = [], []
    for side, eng in ((want, ref), (got, port)):
        eng._prefix_pool.purge_aid(0)
        side.append(eng.generate_sync(PREFIX + "hi", **GREEDY))
        side.append(eng.register_prefix_sync(PREFIX))
        side.append(len(eng._prefix_pool))
        side += [eng.generate_sync(PREFIX + "hi", **GREEDY) for _ in range(2)]
        side.append(eng.generate_sync(PREFIX, **GREEDY))
        side.append(eng.generate_sync("completely different", **GREEDY))
    assert got[1:3] == want[1:3] == [0, 1]
    for i in (0, 3, 4, 5, 6):
        _same(got[i], want[i])
    assert got[3].token_ids == got[4].token_ids == got[0].token_ids
    assert len(got[5].token_ids) == len(got[6].token_ids) == 8
    # app_tpu_prefix_hits counts the three pool hits on both.
    assert _pool_hits(port) == _pool_hits(ref) == {(("model", MODEL),): 3.0}


def test_pool_rows_equal_reference_and_slot_rows(pair):
    """The pool row holds the prefix's real K/V: equal to the reference
    pool's row (f32 values within 1e-5; int8 values within one step and
    scales within 1e-5) and to the slot row a cold prefill of the same
    prefix writes."""
    ref, port = pair
    plen = len(port.tokenizer.encode(PREFIX))
    for eng in pair:
        eng._prefix_pool.purge_aid(0)
        assert eng.register_prefix_sync(PREFIX) == 0
    pk = port._prefix_pool._pool[0][:, 0, :, :plen]
    rk = np.asarray(ref._prefix_pool._pool[0][:, 0, :, :plen])
    assert float(pk.float().abs().max()) > 0.0
    if port.cache.quantized:
        assert np.abs(pk.numpy().astype(np.int32) - rk.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(port._prefix_pool._pool[2][:, 0, :, :plen].numpy(),
                                   np.asarray(ref._prefix_pool._pool[2])[:, 0, :, 0, :plen],
                                   rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(pk.numpy(), rk, atol=1e-5)
    # The slot rows of a cold prefill of the prefix: a pool-less engine.
    cold = InferenceEngine(MODEL, params=port.params, tokenizer=ByteTokenizer(),
                           device="cpu", **GEOMETRY, kv_quant="int8" if port.cache.quantized else "")
    try:
        cold.generate_sync(PREFIX, max_new_tokens=1, timeout=120)
        slot_k = cold.cache.k[:, 0, :, :plen]
        assert torch.equal(slot_k, pk)
    finally:
        cold.close()


def test_lru_reuse_disabled_error_and_longest_match(port_params):
    eng = InferenceEngine(MODEL, params=port_params, tokenizer=ByteTokenizer(), device="cpu",
                          **GEOMETRY, prefix_slots=1)
    try:
        eng.register_prefix_sync("prefix one ")
        assert eng.register_prefix_sync("prefix two ") == 0  # the LRU row reused
        assert len(eng._prefix_pool) == 1
        assert eng._prefix_pool.lookup(eng.tokenizer.encode("prefix one and more")) == (-1, 0)
    finally:
        eng.close()
    eng = InferenceEngine(MODEL, params=port_params, tokenizer=ByteTokenizer(), device="cpu",
                          **GEOMETRY)
    try:
        with pytest.raises(RuntimeError, match="prefix pool disabled"):
            eng.register_prefix("nope")
    finally:
        eng.close()
    eng = InferenceEngine.from_config(MockConfig({
        "TPU_MODEL": "llama-tiny", "TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "128",
        "TPU_PREFIX_SLOTS": "2", "TPU_DEVICE": "cpu", "TPU_SPEC_TOKENS": "0"}))
    try:
        short = eng.register_prefix_sync("abcd")
        long = eng.register_prefix_sync("abcdefgh")
        enc = eng.tokenizer.encode
        assert eng._prefix_pool.lookup(enc("abcdefghij")) == (long, len(enc("abcdefgh")))
        assert eng._prefix_pool.lookup(enc("abcdx")) == (short, len(enc("abcd")))
        with pytest.raises(ValueError, match="at least one token"):
            eng.register_prefix([])
        with pytest.raises(KeyError, match="no loaded LoRA adapter 'a'"):
            eng.register_prefix("x", adapter="a")
    finally:
        eng.close()


def test_prefix_cache_warm_hit_stream_contract():
    """The reference's test_prefix_cache_warm_hit_byte_identical on the
    port (bf16 llama-tiny, 4 slots, max_len 256, k 4, prefix_slots 2): a
    registered system prompt, the prompt cold and warm at G = 0 and G = 2;
    every stream equal, and equal to the reference engine's at G = 0."""
    cfg = ref_get_model("llama-tiny").config
    jp = init_transformer(jax.random.PRNGKey(11), cfg)
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         get_model("llama-tiny").config, device="cpu")
    kw = dict(n_slots=4, max_len=256, window_k=4, prefix_slots=2)
    greedy = dict(max_new_tokens=24, temperature=0.0, stop_on_eos=False, timeout=120)
    prompt = SYSTEM + "go go go go"
    ref = RefEngine("llama-tiny", params=jp, tokenizer=RefByteTokenizer(), **kw)
    ref.start_sync()
    try:
        ref.register_prefix_sync(SYSTEM)
        want = [ref.generate_sync(prompt, **greedy).token_ids for _ in range(2)]
    finally:
        ref.stop_sync()
    streams = []
    for G in (0, 2):
        eng = InferenceEngine("llama-tiny", params=pp, tokenizer=ByteTokenizer(), device="cpu",
                              spec_tokens=G, **kw)
        try:
            eng.register_prefix_sync(SYSTEM)
            streams += [eng.generate_sync(prompt, **greedy).token_ids for _ in range(2)]
        finally:
            eng.close()
    assert want[0] == want[1]
    assert all(s == want[0] for s in streams)


# The prefix keys the port serves: (key, value, engine attribute, extra keys).
SERVED = [
    ("TPU_AUTO_PREFIX", "true", "auto_prefix", {"TPU_KV_BLOCK": "16"}),
    ("TPU_PREFIX_SLOTS", "2", "prefix_slots", {}),
    ("TPU_PREFIX_CACHE_BLOCKS", "12", "prefix_cache_blocks",
     {"TPU_KV_BLOCK": "16", "TPU_AUTO_PREFIX": "1"}),
    ("TPU_PREFIX_EVICT_WM", "3", "prefix_evict_watermark",
     {"TPU_KV_BLOCK": "16", "TPU_AUTO_PREFIX": "1"}),
    ("TPU_QUEUE_PREFIX_AWARE", "on", "queue_prefix_aware",
     {"TPU_KV_BLOCK": "16", "TPU_AUTO_PREFIX": "1"}),
]


@pytest.mark.parametrize("key,value,attr,extra", SERVED, ids=[k[0] for k in SERVED])
def test_served_prefix_key_sets_the_reference_attribute(key, value, attr, extra):
    """Each key, read by both packages' from_config, sets the same engine
    attribute to the same value (and to its default without the key)."""
    base = {"TPU_MODEL": "llama-tiny", "TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "64", **extra}
    ref_src = open(inspect.getsourcefile(RefEngine)).read()
    assert f'"{key}"' in ref_src
    values = []
    for cfg in ({**base, key: value}, base):
        ref = RefEngine.from_config(RefMockConfig(cfg))
        port = InferenceEngine.from_config(MockConfig(
            {**cfg, "TPU_DEVICE": "cpu", "TPU_SPEC_TOKENS": "0"}))
        try:
            assert getattr(port, attr) == getattr(ref, attr)
            values.append(getattr(port, attr))
            if attr == "queue_prefix_aware":  # the probe is wired from it
                assert (port._pending._prefix_probe is not None) == values[-1]
        finally:
            port.close()
    assert values[0] != values[1]


def test_hbm_frac_watermark_still_raises_naming_its_item():
    """TPU_PREFIX_EVICT_HBM_FRAC is served since the HBM ledger was ported
    (it no longer raises): on the slot cache the watermark stays 0, on a
    pool it is the ledger's derived one, as in the reference. The name is
    the one this test had while the key raised, kept so its history
    stays one test's; it now checks the key is served."""
    cfg = MockConfig({
        "TPU_MODEL": "llama-tiny", "TPU_DEVICE": "cpu", "TPU_KV_SLOTS": "1",
        "TPU_MAX_LEN": "64", "TPU_PREFIX_EVICT_HBM_FRAC": "0.1"})
    eng = InferenceEngine.from_config(cfg)
    try:
        assert eng.prefix_evict_hbm_frac == pytest.approx(0.1)
        assert eng.effective_evict_watermark == 0
    finally:
        eng.close()
    eng = InferenceEngine("llama-tiny", device="cpu", n_slots=1, max_len=64,
                          kv_block=16, auto_prefix=True, prefix_evict_hbm_frac=0.1)
    try:
        derived = eng._ledger.derive_block_watermark(0.1)
        assert derived > 0
        assert eng.effective_evict_watermark == derived
    finally:
        eng.close()
