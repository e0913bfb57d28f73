"""The port's serving engine against the reference engine: the same
weights (``init_transformer`` → ``params_from_jax``) must give identical
greedy token ids on ``llama-tiny-f32`` for concurrent prompts that reuse
slots and span several prefill chunks — on the slot cache, the paged
pool, the int8 cache and both — and the same prompt limit, budget clamp
and pool errors. Plus the port's own contracts: seeded sampling
independent of the batch, pool deferral, and no silent CPU fallback.
"""

import jax
import numpy as np
import pytest
import torch

from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.models.transformer import init_params
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax

MODEL = "llama-tiny-f32"
GEOMETRY = dict(n_slots=2, max_len=128, window_k=4, prefill_chunk=16,
                prefill_batch=2)


@pytest.fixture(scope="module")
def jax_params():
    return init_transformer(jax.random.PRNGKey(11), ref_get_model(MODEL).config)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_params), get_model(MODEL).config,
        device="cpu",
    )


@pytest.fixture(scope="module")
def engine(port_params):
    eng = InferenceEngine(MODEL, params=port_params, tokenizer=ByteTokenizer(),
                          device="cpu", **GEOMETRY)
    yield eng
    eng.close()


def _ref_engine(jax_params, **kw):
    ref = RefEngine(MODEL, params=jax_params, tokenizer=RefByteTokenizer(), **kw)
    ref.start_sync()
    return ref


@pytest.fixture(scope="module")
def ref_engine(jax_params):
    ref = _ref_engine(jax_params, **GEOMETRY)
    yield ref
    ref.stop_sync()


def _prompts():
    rng = np.random.default_rng(5)
    # One prompt longer than prefill_chunk (three chunks), one exactly a
    # chunk, one short; three prompts on two slots reuse a slot.
    return [rng.integers(0, 256, n).tolist() for n in (40, 16, 3)]


def _streams(eng, prompts, **kw):
    reqs = [eng.submit_generate(p, **kw) for p in prompts]
    return [r.future.result(timeout=120).token_ids for r in reqs]


def test_greedy_streams_equal_reference_engine(engine, ref_engine):
    want = _streams(ref_engine, _prompts(), max_new_tokens=12)
    reqs = [engine.submit_generate(p, max_new_tokens=12) for p in _prompts()]
    got = [r.future.result(timeout=120) for r in reqs]
    assert [g.token_ids for g in got] == want
    for g in got:
        assert len(g.token_ids) == 12 or g.token_ids[-1] == ByteTokenizer.eos_id
        assert np.all(np.isfinite(g.token_logprobs))
    assert engine.prefill_steps >= 3  # the long prompt took several chunks


@pytest.mark.parametrize(
    "kv", [dict(kv_block=16), dict(kv_quant="int8"), dict(kv_block=16, kv_quant="int8")],
    ids=["paged", "int8", "paged+int8"],
)
def test_greedy_streams_equal_reference_engine_on_kv_variants(port_params, jax_params, kv):
    """The same prompts through both engines on a B=16 pool, an int8
    cache, or both: identical greedy streams; the pool is whole again
    after the run."""
    ref = _ref_engine(jax_params, **GEOMETRY, **kv)
    try:
        want = _streams(ref, _prompts(), max_new_tokens=12)
    finally:
        ref.stop_sync()
    eng = InferenceEngine(MODEL, params=port_params, tokenizer=ByteTokenizer(),
                          device="cpu", **GEOMETRY, **kv)
    try:
        assert _streams(eng, _prompts(), max_new_tokens=12) == want
        total, used, _ = eng.kv_pool_counts()
        assert used == 0 and total == (16 if "kv_block" in kv else 0)
    finally:
        eng.close()


def test_prompt_limit_and_budget_match_reference(engine, ref_engine, port_params):
    """Room for the windows in flight, as the reference reserves it
    (pipeline_depth 2): at max_len 128 and window_k 4 the longest prompt
    is 128 - 2 - 3*4 = 114, and a 100-token prompt gets at most
    128 - 1 - 100 - 12 = 15 tokens. At depth 3 the engine serves with one
    window more reserved: 110 and 11."""
    from gofr_tpu.errors import ErrorPromptTooLong as RefErrorPromptTooLong
    from gofr_tpu_torch.errors import ErrorPromptTooLong

    assert engine.max_prompt_tokens == ref_engine.max_prompt_tokens == 114
    long = list(range(2, 117))  # 115 tokens
    with pytest.raises(ErrorPromptTooLong, match="exceeds") as got:
        engine.submit_generate(long)
    with pytest.raises(RefErrorPromptTooLong) as want:
        ref_engine.submit_generate(long)
    assert str(got.value) == str(want.value)
    assert got.value.status_code == want.value.status_code == 413
    prompt = np.random.default_rng(9).integers(0, 256, 100).tolist()
    kw = dict(max_new_tokens=30, stop_on_eos=False)
    want = _streams(ref_engine, [prompt], **kw)[0]
    assert len(want) == 15
    assert _streams(engine, [prompt], **kw)[0] == want
    deep = InferenceEngine(MODEL, params=port_params, tokenizer=ByteTokenizer(),
                           device="cpu", pipeline_depth=3, **GEOMETRY)
    try:
        assert deep.pipeline_depth == 3 and deep.max_prompt_tokens == 110
        assert _streams(deep, [prompt], **kw)[0] == want[:11]
    finally:
        deep.close()


def test_tight_pool_defers_admission_and_completes(engine, port_params):
    """Four 40-token prompts on four slots over 8 allocatable blocks of 16:
    three blocks each at admission, four at their peak, so the last two
    wait for the first two to retire. Every stream equals the slot
    cache's, and every block comes back."""
    prompts = [np.random.default_rng(i).integers(0, 256, 40).tolist() for i in range(4)]
    want = _streams(engine, prompts, max_new_tokens=8)
    tight = InferenceEngine(MODEL, params=port_params, tokenizer=ByteTokenizer(),
                            device="cpu", **{**GEOMETRY, "n_slots": 4},
                            kv_block=16, kv_pool_blocks=9)
    try:
        assert _streams(tight, prompts, max_new_tokens=8) == want
        assert tight.kv_admission_waits > 0
        assert tight.kv_blocks_peak == 8
        assert tight.kv_pool_counts() == (8, 0, 0)
        assert len(tight._allocator.free_blocks) == 8
    finally:
        tight.close()


def test_pool_errors_match_reference(port_params, jax_params):
    """Four allocatable blocks of 16: a 70-token prompt needs five and
    fails at admission; two 20-token prompts generating 30 tokens each
    outgrow the pool, and one of them fails mid-generation — the same
    RuntimeErrors in both engines. The port's pool is whole afterwards."""
    kw = dict(**GEOMETRY, kv_block=16, kv_pool_blocks=5)
    rng = np.random.default_rng(4)
    big = rng.integers(0, 256, 70).tolist()
    pair = [rng.integers(0, 256, 20).tolist() for _ in range(2)]

    def outcomes(eng):
        with pytest.raises(RuntimeError, match="KV blocks but the pool has 4"):
            eng.submit_generate(big, max_new_tokens=4).future.result(timeout=120)
        reqs = [eng.submit_generate(p, max_new_tokens=30, stop_on_eos=False) for p in pair]
        out = []
        for r in reqs:
            try:
                out.append(len(r.future.result(timeout=120).token_ids))
            except RuntimeError as exc:
                assert "exhausted mid-generation" in str(exc)
                out.append("exhausted")
        return out

    ref = _ref_engine(jax_params, **kw)
    try:
        want = outcomes(ref)
    finally:
        ref.stop_sync()
    eng = InferenceEngine(MODEL, params=port_params, tokenizer=ByteTokenizer(),
                          device="cpu", **kw)
    try:
        got = outcomes(eng)
        assert eng.kv_pool_counts() == (4, 0, 0)
    finally:
        eng.close()
    assert sorted(map(str, got)) == sorted(map(str, want)) == ["30", "exhausted"]


def test_seeded_sampling_is_batch_independent(engine):
    prompt = "sampled prompt"
    alone = engine.generate_sync(prompt, max_new_tokens=10, temperature=0.9,
                                 seed=1234, timeout=60)
    others = [engine.submit_generate(p, max_new_tokens=10) for p in _prompts()]
    mixed = engine.submit_generate(prompt, max_new_tokens=10, temperature=0.9,
                                   seed=1234)
    for r in others:
        r.future.result(timeout=60)
    assert mixed.future.result(timeout=60).token_ids == alone.token_ids
    other_seed = engine.generate_sync(prompt, max_new_tokens=10,
                                      temperature=0.9, seed=99, timeout=60)
    assert other_seed.token_ids != alone.token_ids


def test_stream_and_infer_surfaces(engine):
    import asyncio

    async def drive():
        toks = [t async for t in engine.generate_stream("abc", max_new_tokens=5)]
        out = await engine.infer("abc", max_new_tokens=5)
        return toks, out

    toks, out = asyncio.run(drive())
    res = engine.generate_sync("abc", max_new_tokens=5)
    assert toks == res.token_ids
    assert out["tokens"] == len(res.token_ids)
    assert engine.infer_sync("abc", max_new_tokens=5)["text"] == res.text


def test_concurrent_submitters_all_complete_with_solo_results(engine):
    """More submitting threads than cores, a short switch interval: every
    request completes, and each greedy stream equals the same prompt run
    alone (a lost or crossed update in the queue/slot tables breaks it)."""
    import sys
    import threading

    prompts = [[(7 * i + j) % 250 for j in range(1 + i % 19)] for i in range(24)]
    solo = {
        i: engine.generate_sync(p, max_new_tokens=4, timeout=60).token_ids
        for i, p in enumerate(prompts[:6])
    }
    results, errors = {}, []

    def worker(w):
        try:
            for i in range(w, len(prompts), 12):
                results[i] = engine.generate_sync(
                    prompts[i], max_new_tokens=4, timeout=120
                ).token_ids
        except Exception as exc:  # reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert sorted(results) == list(range(len(prompts)))
    for i, toks in solo.items():
        assert results[i] == toks


def test_unported_options_raise(engine):
    """The sampler options are ported: top_p (with its engine flag) and
    logit_bias are accepted; auto_prefix and MoE still raise."""
    from gofr_tpu_torch.errors import ErrorInvalidParam

    with pytest.raises(ErrorInvalidParam, match="TPU_TOP_P"):  # the flag is off here
        engine.submit_generate("x", top_p=0.5)
    res = engine.submit_generate("x", max_new_tokens=3, logit_bias={65: 100.0}).future.result(
        timeout=120)
    assert res.token_ids == [65, 65, 65]
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        InferenceEngine(MODEL, device="cpu", auto_prefix=True)
    with pytest.raises(NotImplementedError):  # MoE: refused before any weights are made
        InferenceEngine("mixtral-8x7b", device="cpu")


def _non_neutral(name, default):
    """A value of the reference option ``name`` other than its default."""
    if isinstance(default, bool):
        return not default
    if isinstance(default, (int, float)):
        return default + 1
    return default + "a"


def test_reference_submit_options_are_accepted_at_neutral_or_not_ported(engine):
    """Every keyword of the reference's ``submit_generate`` that the port
    does not take as its own parameter: accepted at the reference's
    default, ``NotImplementedError`` otherwise — never ``TypeError``,
    which stays for names the reference does not have."""
    import inspect

    own = set(inspect.signature(InferenceEngine.submit_generate).parameters)
    ref = inspect.signature(RefEngine.submit_generate).parameters
    options = {n: p.default for n, p in ref.items() if n not in own}
    # The sampler and lifecycle options and the trace context are the
    # port's own parameters now; what is left waits for LoRA and the
    # replica pool.
    assert set(options) == {"adapter", "pin_replica"}
    assert {"deadline", "deadline_s", "cancel", "tenant", "slo_class", "top_p", "stop",
            "frequency_penalty", "presence_penalty", "logit_bias", "top_logprobs",
            "traceparent"} <= own
    res = engine.submit_generate([1, 2, 3], max_new_tokens=2, **options).future.result(
        timeout=120)
    assert len(res.token_ids) >= 1
    for name, default in options.items():
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
            engine.submit_generate("x", **{name: _non_neutral(name, default)})
    with pytest.raises(TypeError, match="unexpected option"):
        engine.submit_generate("x", not_an_option=1)


def test_traceparent_request_is_served_like_the_reference(engine, ref_engine):
    """A request carrying a W3C ``traceparent`` (every OpenAI request
    behind the tracer middleware) is served, with the reference's tokens;
    the port keeps the context on the request."""
    tp = "00-" + "1" * 32 + "-" + "2" * 16 + "-01"
    prompt = _prompts()[0]
    req = engine.submit_generate(prompt, max_new_tokens=6, traceparent=tp)
    got = req.future.result(timeout=120).token_ids
    want = ref_engine.submit_generate(prompt, max_new_tokens=6, traceparent=tp).future.result(
        timeout=120).token_ids
    assert req.traceparent == tp
    assert got == want and len(got) == 6


def test_no_cuda_and_no_explicit_cpu_raises(monkeypatch, jax_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_model(MODEL).config
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(MODEL)
    np_params = jax.tree_util.tree_map(np.asarray, jax_params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(np_params, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, seed=0)
