"""The port's sampler against the reference's: the same weights
(``init_transformer`` → ``params_from_jax``) and the same engine flags
(``top_k``, ``enable_top_p``, ``enable_penalties``, ``top_logprobs``) must
give identical greedy streams on ``llama-tiny-f32`` with penalties,
``logit_bias``, ``top_logprobs`` and stop sequences; ``top_k=1`` and a
tiny ``top_p`` must turn sampled streams greedy in both engines; the
admissible sets of ``ops/sampling.py::sample_logits`` and
``programs.sample`` must equal the reference's on the same logits, and
their draws must fit the renormalised distribution; and every
submit-time validation error must match the reference's in class, status
and message.
"""

import inspect
import types
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.ops.sampling import sample_logits as ref_sample_logits
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.programs import LLMProgramsMixin
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.ops import sampling
from gofr_tpu_torch.serving import programs
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax

MODEL = "llama-tiny-f32"
GEOMETRY = dict(n_slots=2, max_len=128, window_k=4, prefill_chunk=16, prefill_batch=2)
FLAGS = dict(enable_top_p=True, enable_penalties=True, top_logprobs=5)
PROMPT = "the quick brown fox"
TOP_LOGPROB_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return init_transformer(jax.random.PRNGKey(11), ref_get_model(MODEL).config)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_params), get_model(MODEL).config,
        device="cpu",
    )


def _port(port_params, **kw):
    return InferenceEngine(MODEL, params=port_params, tokenizer=ByteTokenizer(),
                           device="cpu", **GEOMETRY, **kw)


def _ref(jax_params, start=True, **kw):
    ref = RefEngine(MODEL, params=jax_params, tokenizer=RefByteTokenizer(), **GEOMETRY, **kw)
    if start:
        ref.start_sync()
    return ref


@pytest.fixture(scope="module")
def engines(port_params, jax_params):
    """(port, reference), both with every sampler flag on."""
    eng, ref = _port(port_params, **FLAGS), _ref(jax_params, **FLAGS)
    yield eng, ref
    eng.close()
    ref.stop_sync()


def _run(eng, prompt=PROMPT, n=24, **kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("stop_on_eos", False)
    return eng.generate_sync(prompt, max_new_tokens=n, timeout=120, **kw)


def _max_repeat(tokens):
    return max(Counter(tokens).values())


@pytest.mark.parametrize("n, kw", [
    (24, dict()),
    (24, dict(frequency_penalty=1.5)),
    (48, dict(presence_penalty=0.3)),
    (48, dict(frequency_penalty=0.3)),
    (24, dict(frequency_penalty=1.5, presence_penalty=0.5)),
    (24, dict(frequency_penalty=-0.5, presence_penalty=-0.25)),
], ids=["zero", "frequency", "presence", "mild-frequency", "both", "negative"])
def test_penalised_greedy_streams_equal_reference(engines, n, kw):
    """The scenarios of the reference's penalties tests: every stream
    identical to the reference engine's, and a strong frequency penalty
    breaks the base stream's repetition in both."""
    eng, ref = engines
    got, want = _run(eng, n=n, **kw), _run(ref, n=n, **kw)
    assert got.token_ids == want.token_ids
    np.testing.assert_allclose(got.token_logprobs, want.token_logprobs, atol=TOP_LOGPROB_TOL)
    if kw.get("frequency_penalty") == 1.5:
        base = _run(eng, n=n).token_ids
        assert got.token_ids != base
        assert _max_repeat(got.token_ids) < _max_repeat(base)


def test_penalties_are_per_slot(engines):
    """A penalised and a plain request side by side on one engine: the
    plain one keeps the base stream, the penalised one its solo stream,
    in both engines."""
    for e in engines:
        base = _run(e).token_ids
        solo = _run(e, frequency_penalty=1.5).token_ids
        pen = e.submit_generate(PROMPT, max_new_tokens=24, stop_on_eos=False,
                                frequency_penalty=1.5)
        plain = e.submit_generate(PROMPT, max_new_tokens=24, stop_on_eos=False)
        assert plain.future.result(timeout=120).token_ids == base
        assert pen.future.result(timeout=120).token_ids == solo


@pytest.mark.parametrize("kw", [
    dict(logit_bias={101: 4.0, 32: -3.0}),
    dict(logit_bias={65: 100.0}),
    dict(logit_bias={65: 2.5, 66: 2.0}, frequency_penalty=1.0),
    dict(logit_bias={str(t): -100 for t in range(256, 512)}, presence_penalty=0.5),
], ids=["small", "forced", "with-frequency", "bytes-only-with-presence"])
def test_logit_bias_streams_equal_reference(engines, kw):
    eng, ref = engines
    got, want = _run(eng, **kw), _run(ref, **kw)
    assert got.token_ids == want.token_ids
    np.testing.assert_allclose(got.token_logprobs, want.token_logprobs, atol=TOP_LOGPROB_TOL)
    if kw["logit_bias"] == {65: 100.0}:
        assert got.token_ids == [65] * 24
    assert got.token_ids != _run(eng).token_ids


def test_top_logprobs_equal_reference(engines):
    """Alternatives from the biased/penalised distribution: ids equal,
    logprobs within 1e-5; a greedy row's first alternative is its token."""
    eng, ref = engines
    for kw in (dict(top_logprobs=5), dict(top_logprobs=3, frequency_penalty=0.7,
                                          logit_bias={120: 3.0})):
        got, want = _run(eng, n=12, **kw), _run(ref, n=12, **kw)
        assert got.token_ids == want.token_ids
        assert len(got.token_top_logprobs) == len(got.token_ids)
        for tok, lp, alts, ref_alts in zip(got.token_ids, got.token_logprobs,
                                           got.token_top_logprobs, want.token_top_logprobs):
            assert [i for i, _ in alts] == [i for i, _ in ref_alts]
            np.testing.assert_allclose([v for _, v in alts], [v for _, v in ref_alts],
                                       atol=TOP_LOGPROB_TOL)
            assert len(alts) == kw["top_logprobs"]
            assert alts[0][0] == tok and abs(alts[0][1] - lp) <= TOP_LOGPROB_TOL
    assert _run(eng, n=4).token_top_logprobs is None


def test_stop_sequences_equal_reference(engines):
    """Engine-level stop: the text cut at the match, ids and logprobs (and
    alternatives) trimmed with it, the same result as the reference's."""
    eng, ref = engines
    full = _run(eng, "align", n=20)
    assert full.token_ids == _run(ref, "align", n=20).token_ids
    assert len(full.text) >= 6 and full.finish_reason == "length"
    marker = full.text[2:4]
    for kw in (dict(stop=[marker]), dict(stop=["\x00never", marker], top_logprobs=2)):
        got, want = _run(eng, "align", n=20, **kw), _run(ref, "align", n=20, **kw)
        assert (got.text, got.token_ids, got.finish_reason) == (
            want.text, want.token_ids, want.finish_reason)
        assert got.finish_reason == "stop"
        assert got.text == full.text[: full.text.find(marker)]
        assert len(got.token_logprobs) == len(got.token_ids) < len(full.token_ids)
        assert got.token_ids == full.token_ids[: len(got.token_ids)]
        assert eng.tokenizer.decode(got.token_ids) == got.text[
            : len(eng.tokenizer.decode(got.token_ids))]
        if "top_logprobs" in kw:
            assert len(got.token_top_logprobs) == len(got.token_ids)


def test_tiny_top_p_and_top_k_1_sample_greedy(engines, port_params, jax_params):
    """A nucleus of 1e-6 keeps only the top token, and so does an
    engine-wide top_k of 1: sampled streams equal the greedy stream, in
    both engines."""
    for e in engines:
        greedy = _run(e).token_ids
        assert _run(e, temperature=0.9, top_p=1e-6, seed=3).token_ids == greedy
        assert _run(e, temperature=0.9, seed=3).token_ids != greedy
    eng, ref = _port(port_params, top_k=1), _ref(jax_params, top_k=1)
    try:
        for e in (eng, ref):
            assert _run(e, temperature=1.3, seed=5).token_ids == _run(e).token_ids
    finally:
        eng.close()
        ref.stop_sync()


# ----------------------------------------------------------------------
# admissible sets: the sampling functions on the same numpy logits
# ----------------------------------------------------------------------

V = 48
SWEEP = [(t, k, p) for t in (0.5, 1.0, 2.0) for k in (0, 1, 5, 40) for p in (1.0, 0.9, 0.5, 0.1)]


def _row(seed):
    return (np.random.default_rng(seed).standard_normal(V) * 2.5).astype(np.float32)


def _set(chosen):
    """Rows are V copies of one logits row whose noise favours token r on
    row r: row r draws r exactly when r is admissible."""
    return {r for r, c in enumerate(np.asarray(chosen).tolist()) if c == r}


def _favour_row(shape):
    return torch.eye(shape[0], shape[1]) * 1e30


def _ref_sample_logits_set(row, t, k, p, monkeypatch):
    seen = {}

    def capture(key, logits, axis=-1):
        seen["logits"] = np.asarray(logits)
        return jnp.argmax(logits, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    ref_sample_logits(jnp.asarray(row[None]), jax.random.PRNGKey(0), temperature=t,
                      top_k=k, top_p=p)
    monkeypatch.undo()
    return set(np.flatnonzero(np.isfinite(seen["logits"][0])).tolist())


def _ref_programs_sample(top_k, enable_top_p):
    """The reference engine's own ``sample`` closure, built from
    ``LLMProgramsMixin._build_llm_steps`` on a stand-in engine (building
    the jitted programs compiles nothing)."""
    stub = types.SimpleNamespace(
        _jax=jax, _jnp=jnp, cfg=ref_get_model(MODEL).config, _top_k=top_k, mesh=None,
        enable_top_p=enable_top_p, enable_penalties=False, top_logprobs=0, _seed=0,
        tokenizer=RefByteTokenizer(), spec_tokens=0,
        _compiles=types.SimpleNamespace(wrap=lambda name, fn, shared=False: fn),
    )
    LLMProgramsMixin._build_llm_steps(stub)
    core = stub._prefill_chunk_step.__wrapped__
    return inspect.getclosurevars(core).nonlocals["sample"]


def _ref_programs_set(row, t, k, p, monkeypatch):
    sample = _ref_programs_sample(k, p < 1.0)

    def favour(key, logits, axis=-1):  # vmapped: key[1] is the row index
        return jnp.argmax(logits + jnp.where(jnp.arange(logits.shape[-1]) == key[1],
                                             1e30, 0.0), axis=axis)

    monkeypatch.setattr(jax.random, "categorical", favour)
    keys = jnp.stack([jnp.array([0, r], jnp.uint32) for r in range(V)])
    tok, _, _, _ = sample(jnp.asarray(np.tile(row, (V, 1))), keys, jnp.full((V,), t),
                          jnp.zeros((V,), bool), jnp.full((V,), p))
    monkeypatch.undo()
    return _set(tok)


def _port_programs_set(row, t, k, p, monkeypatch):
    monkeypatch.setattr(programs, "gumbel_noise", lambda b, s, c, n: _favour_row((V, n)))
    ones = torch.ones(V)
    tok, _, _, _ = programs.sample(
        torch.from_numpy(np.tile(row, (V, 1))), torch.zeros(V, dtype=torch.long),
        torch.zeros(V, dtype=torch.long), ones * t, torch.zeros(V, dtype=torch.bool),
        ones * p, 2, programs.SamplerFlags(top_k=k, top_p=p < 1.0),
        sampling=True)
    monkeypatch.undo()
    return _set(tok)


def _port_sample_logits_set(row, t, k, p, monkeypatch):
    monkeypatch.setattr(sampling, "gumbel", lambda shape, g, d: _favour_row(shape))
    tok = sampling.sample_logits(torch.from_numpy(np.tile(row, (V, 1))),
                                 torch.Generator().manual_seed(0), temperature=t,
                                 top_k=k, top_p=p)
    monkeypatch.undo()
    return _set(tok)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admissible_sets_equal_reference(seed, monkeypatch):
    """Over a sweep of temperature, top_k and top_p: the port's
    ``sample_logits`` keeps exactly the reference ``sample_logits``'s set;
    the port's ``programs.sample`` keeps exactly the reference engine's
    ``sample``'s set, which is the same set whenever one filter is on (with
    both, the engine's nucleus is taken over the top-k distribution)."""
    row = _row(seed)
    sizes = set()
    for t, k, p in SWEEP:
        want = _ref_sample_logits_set(row, t, k, p, monkeypatch)
        assert _port_sample_logits_set(row, t, k, p, monkeypatch) == want, (t, k, p)
        engine_want = _ref_programs_set(row, t, k, p, monkeypatch)
        if not (k and p < 1.0):
            assert engine_want == want, (t, k, p)
        assert _port_programs_set(row, t, k, p, monkeypatch) == engine_want, (t, k, p)
        sizes.add(len(want))
    assert len(sizes) >= 6  # the sweep reaches sets of many sizes


def _renormalised(row, t, k, p):
    """softmax(row / t) over the reference's admissible set, in numpy
    (one filter at a time, where both references keep the same set)."""
    scaled = row.astype(np.float64) / t
    keep = np.ones(V, dtype=bool)
    if k:
        keep &= scaled >= np.sort(scaled)[::-1][k - 1]
    if p < 1.0:
        order = np.argsort(-scaled)
        cum = np.cumsum(np.exp(scaled[order] - scaled.max()) / np.exp(
            scaled - scaled.max()).sum())
        keep &= scaled >= scaled[order][np.argmax(cum >= p)]
    probs = np.where(keep, np.exp(scaled - scaled.max()), 0.0)
    return probs / probs.sum()


@pytest.mark.parametrize("t, k, p", [(1.0, 0, 0.9), (0.7, 12, 1.0), (1.5, 0, 0.6)])
def test_draws_fit_the_renormalised_nucleus(t, k, p):
    """20,000 seeded draws from each sampler: none outside the admissible
    set, and a chi-square statistic against the renormalised
    probabilities below its 0.999 quantile."""
    from scipy.stats import chi2

    row = _row(7)
    probs = _renormalised(row, t, k, p)
    N = 20000
    rows = torch.from_numpy(np.tile(row, (N, 1)))
    draws = {
        "sample_logits": sampling.sample_logits(
            rows, torch.Generator().manual_seed(1), temperature=t, top_k=k, top_p=p),
        "programs.sample": programs.sample(
            rows, torch.full((N,), 77, dtype=torch.long), torch.arange(N), torch.full((N,), t),
            torch.zeros(N, dtype=torch.bool), torch.full((N,), p), 2,
            programs.SamplerFlags(top_k=k, top_p=p < 1.0), sampling=True)[0],
    }
    support = probs > 0
    for name, tok in draws.items():
        counts = np.bincount(tok.numpy(), minlength=V)
        assert counts[~support].sum() == 0, name
        expected = probs[support] * N
        stat = float(((counts[support] - expected) ** 2 / expected).sum())
        assert stat < chi2.ppf(0.999, support.sum() - 1), (name, stat)


# ----------------------------------------------------------------------
# validation: the reference's error types, status codes and messages
# ----------------------------------------------------------------------

_OFF_CASES = [dict(top_p=0.5), dict(frequency_penalty=0.5), dict(presence_penalty=-1.0),
              dict(top_logprobs=2)]
_ON_CASES = [
    dict(top_p=0.0), dict(top_p=1.5), dict(frequency_penalty=2.5), dict(presence_penalty=-3.0),
    dict(top_logprobs=6), dict(logit_bias=[1, 2]), dict(logit_bias={t: 1.0 for t in range(301)}),
    dict(logit_bias={1.5: 1.0}), dict(logit_bias={"a": 1.0}), dict(logit_bias={600: 1.0}),
    dict(logit_bias={1: 150.0}), dict(logit_bias={1: "x"}), dict(prompt=list(range(2, 117))),
    dict(top_p=0.0, frequency_penalty=9.0),
]


def _error(eng, kw):
    kw = dict(kw)
    prompt = kw.pop("prompt", "x")
    with pytest.raises(Exception) as info:
        eng.submit_generate(prompt, max_new_tokens=2, **kw)
    e = info.value
    return type(e).__name__, getattr(e, "status_code", None), str(e)


def test_validation_errors_match_reference(engines, port_params, jax_params):
    eng, ref = engines
    for kw in _ON_CASES:
        got, want = _error(eng, kw), _error(ref, kw)
        assert got == want, kw
        assert got[1] in (400, 413)
    off, ref_off = _port(port_params), _ref(jax_params, start=False)
    try:
        for kw in _OFF_CASES:
            got, want = _error(off, kw), _error(ref_off, kw)
            assert got == want and got[:2] == ("ErrorInvalidParam", 400), kw
    finally:
        off.close()
