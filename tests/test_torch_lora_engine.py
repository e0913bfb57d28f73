"""The port's engine serving LoRA adapters against the reference engine on
the same weights (``init_transformer`` → ``params_from_jax``) and the same
adapters (numpy at a seed, loaded by ``load_lora`` on both): greedy
streams on ``llama-tiny-f32`` equal to the reference's under an adapter —
and to a port engine serving the merged weights W + A B — with base and
adapters batched together, through mega windows, speculative windows,
the FFN targets, a multi-chunk prefill that reuses a slot, a reload with
fewer targets, and an int8 base. The cases are the reference's
``tests/test_lora.py``.
"""

import jax
import numpy as np
import pytest

from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.models.transformer import LORA_TARGETS, lora_dims
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax

MODEL = "llama-tiny-f32"
CFG = get_model(MODEL).config
GEOMETRY = dict(n_slots=4, max_len=128, window_k=4)
LORA = dict(lora_slots=2, lora_rank=4)
TARGETS = ("wq", "wk", "wv", "wo")


def adapter(seed: int, targets=TARGETS, rank: int = 4, scale: float = 0.5) -> dict:
    """{target: (a [L, d_in, r], b [L, r, d_out])} f32 numpy, load_lora's
    raw form."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in targets:
        d_in, d_out = lora_dims(CFG, t)
        out[t] = (scale * rng.standard_normal((CFG.n_layers, d_in, rank)).astype(np.float32),
                  scale * rng.standard_normal((CFG.n_layers, rank, d_out)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def np_tree():
    tree = init_transformer(jax.random.PRNGKey(11), ref_get_model(MODEL).config)
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params(np_tree):
    return jax.tree_util.tree_map(jax.numpy.asarray, np_tree)


@pytest.fixture(scope="module")
def port_params(np_tree):
    return params_from_jax(np_tree, CFG, device="cpu")


def merged(np_tree: dict, leaves: dict) -> dict:
    """The port's params of the merged model W + A B (the reference test's
    oracle, formed in f32 on the reference layout)."""
    layers = dict(np_tree["layers"])
    for t, (a, b) in leaves.items():
        layers[t] = layers[t] + np.einsum("ldr,lro->ldo", a, b).astype(layers[t].dtype)
    return params_from_jax({**np_tree, "layers": layers}, CFG, device="cpu")


def port_engine(params, **kw) -> InferenceEngine:
    return InferenceEngine(MODEL, params=params, tokenizer=ByteTokenizer(), device="cpu",
                           **{**GEOMETRY, **kw})


def ref_engine(params, **kw) -> RefEngine:
    ref = RefEngine(MODEL, params=params, tokenizer=RefByteTokenizer(), **{**GEOMETRY, **kw})
    ref.start_sync()
    return ref


def gen(eng, prompt, n: int = 10, **kw) -> list[int]:
    return eng.generate_sync(prompt, max_new_tokens=n, temperature=0.0, stop_on_eos=False,
                             timeout=120, **kw).token_ids


@pytest.fixture(scope="module")
def pair(jax_params, port_params):
    """A reference and a port engine with two adapter slots, each holding
    the adapters "a1" and "a2"."""
    ref, port = ref_engine(jax_params, **LORA), port_engine(port_params, **LORA)
    for eng in (ref, port):
        eng.load_lora("a1", adapter(21))
        eng.load_lora("a2", adapter(22))
    yield ref, port
    ref.stop_sync()
    port.close()


def test_adapter_stream_equals_reference_and_merged_engine(pair, np_tree):
    """Greedy generation under an adapter equals the reference engine's and
    a port engine serving the merged weights; the base stream differs and
    is unaffected."""
    ref, port = pair
    base = gen(port, "hello")
    tuned = gen(port, "hello", adapter="a1")
    assert tuned == gen(ref, "hello", adapter="a1")
    assert base == gen(ref, "hello")
    merged_eng = port_engine(merged(np_tree, adapter(21)))
    try:
        assert tuned == gen(merged_eng, "hello")
    finally:
        merged_eng.close()
    assert tuned != base
    assert gen(port, "hello") == base


def test_concurrent_adapters_batch_isolation(pair):
    """Base and two adapters decoding in one batch reproduce their solo
    streams (and the reference's) token for token."""
    ref, port = pair
    solo = {name: gen(port, "hello", adapter=name) for name in ("", "a1", "a2")}
    assert len({tuple(v) for v in solo.values()}) == 3
    assert solo == {name: gen(ref, "hello", adapter=name) for name in solo}
    prompts = ["hello", "hi there", "hello", "abc"]
    names = ["", "a1", "a2", "a1"]
    reqs = [port.submit_generate(p, max_new_tokens=10, temperature=0.0, stop_on_eos=False,
                                 adapter=name) for p, name in zip(prompts, names)]
    outs = [r.future.result(timeout=120).token_ids for r in reqs]
    assert outs == [gen(ref, p, adapter=name) for p, name in zip(prompts, names)]
    assert outs[0] == solo[""] and outs[1] == gen(port, "hi there", adapter="a1")
    assert outs[2] == solo["a2"]


@pytest.mark.parametrize("kw", [dict(mega_windows=4), dict(spec_tokens=2),
                                dict(mega_windows=4, spec_tokens=2)],
                         ids=["mega", "spec", "mega-spec"])
def test_decode_loop_variants_adapter_parity(pair, port_params, kw):
    """Mega windows, speculative windows and both honour each slot's
    adapter: streams equal the reference's plain engine's."""
    ref, _ = pair
    eng = port_engine(port_params, **LORA, **kw)
    try:
        eng.load_lora("a1", adapter(21))
        eng.load_lora("a2", adapter(22))
        prompts = ["ab", "abcabcabc", "hello"]
        names = ["a1", "a2", ""]
        reqs = [eng.submit_generate(p, max_new_tokens=10, temperature=0.0, stop_on_eos=False,
                                    adapter=name) for p, name in zip(prompts, names)]
        outs = [r.future.result(timeout=120).token_ids for r in reqs]
        assert outs == [gen(ref, p, adapter=name) for p, name in zip(prompts, names)]
    finally:
        eng.close()


def test_ffn_targets_through_engine(jax_params, port_params, np_tree):
    """All seven targets (w_gate/w_up/w_down land on the fused gate|up and
    the down projection) on the prefill chunk, the decode window and the
    speculative verify: the port's streams at G = 0 and 2 equal the
    reference's and the merged engine's."""
    leaves = adapter(61, LORA_TARGETS)
    kw = dict(lora_slots=1, lora_rank=4, lora_targets=",".join(LORA_TARGETS))
    ref = ref_engine(jax_params, **kw)
    try:
        ref.load_lora("full", leaves)
        want = gen(ref, "hello", adapter="full")
    finally:
        ref.stop_sync()
    merged_eng = port_engine(merged(np_tree, leaves))
    try:
        assert gen(merged_eng, "hello") == want
    finally:
        merged_eng.close()
    for spec_tokens in (0, 2):
        eng = port_engine(port_params, spec_tokens=spec_tokens, **kw)
        try:
            eng.load_lora("full", leaves)
            assert gen(eng, "hello", adapter="full") == want, f"spec_tokens={spec_tokens}"
        finally:
            eng.close()


def test_multi_chunk_prefill_uses_fresh_adapter(jax_params, port_params):
    """prefill_depth 4 over a 128-token prompt (8 chunks of 16): a base
    request, then the same prompt under an adapter in the same slot, must
    prefill with the request's adapter (the plane is uploaded before the
    deep dispatch), as the reference."""
    kw = dict(n_slots=2, max_len=256, window_k=4, prefill_chunk=16, prefill_depth=4,
              lora_slots=1, lora_rank=4)
    prompt = "abcdefgh" * 16
    outs = []
    for eng in (ref_engine(jax_params, **kw), port_engine(port_params, **kw)):
        try:
            eng.load_lora("t", adapter(71))
            outs.append((gen(eng, prompt), gen(eng, prompt, adapter="t")))
        finally:
            eng.stop_sync()
    assert outs[1] == outs[0]
    assert outs[1][0] != outs[1][1]


def test_reload_with_fewer_targets_zeroes_stale_deltas(jax_params, port_params, np_tree):
    """Reloading a name with only wq clears the old version's wk/wv/wo
    deltas: the stream equals the reference's and the wq-only merged
    engine's."""
    v1 = adapter(81)
    v2 = {"wq": v1["wq"]}
    outs = []
    for eng in (ref_engine(jax_params, **LORA), port_engine(port_params, **LORA)):
        try:
            eng.load_lora("a", v1)
            eng.load_lora("a", v2)
            outs.append(gen(eng, "hello", adapter="a"))
        finally:
            eng.stop_sync()
    assert outs[1] == outs[0]
    merged_eng = port_engine(merged(np_tree, v2))
    try:
        assert outs[1] == gen(merged_eng, "hello")
    finally:
        merged_eng.close()


def test_int8_base_serves_adapters(jax_params, port_params):
    """An int8 base (quantized in the constructor on both sides) with
    adapters: the leaves stay f32 (the config's dtype) and the streams
    equal the reference's."""
    kw = dict(quant="int8", **LORA)
    outs = []
    for eng in (ref_engine(jax_params, **kw), port_engine(port_params, **kw)):
        try:
            eng.load_lora("a1", adapter(21))
            outs.append([gen(eng, "hello", adapter=name) for name in ("", "a1")])
        finally:
            eng.stop_sync()
    assert outs[1] == outs[0]
    assert outs[1][0] != outs[1][1]
