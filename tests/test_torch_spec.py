"""The port's speculative decoding against the reference's: ``ngram_draft``
on seeded numpy histories (exactly equal), spec engines on
``llama-tiny-f32`` with the same weights (``init_transformer`` →
``params_from_jax``) on the slot cache and a pool (greedy streams
identical, logprobs within 1e-5), the ``TPU_SPEC_TOKENS`` seam
(``resolve_spec_tokens`` on a grid of raw values x backends x conflicts,
the reference's own seam test, the port's device types as backends) and
``from_config`` (auto resolves to 0 on the CPU and on CUDA with a logged
note, an explicit value wins, and the penalties / top_logprobs precedence
in both directions). The spec-on against spec-off contract of the
reference's ``tests/test_spec_decoding.py`` is held in
``test_torch_spec_contract.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.config import MockConfig as RefMockConfig
from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.models.transformer import ngram_draft as ref_ngram_draft
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.engine import resolve_spec_tokens as ref_resolve
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.models.transformer import ngram_draft
from gofr_tpu_torch.serving.engine import (
    SPEC_AUTO_TOKENS,
    InferenceEngine,
    resolve_spec_tokens,
)
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax

MODEL = "llama-tiny-f32"
G = 2
GEOMETRY = dict(n_slots=4, max_len=256, window_k=4, spec_tokens=G)
# The reference's BENCH_SPEC_WORKLOAD prompts (tests/test_spec_decoding.py):
# repeated text, the n-gram draft's best case.
BENCH_PROMPTS = [("abcdefgh"[i % 4:] + "abcdefgh" * 12)[:64] for i in range(8)]
# f32 on both sides, the same arithmetic in another order.
LOGPROB_TOL = 1e-5


def _histories():
    """(history [S, T], lengths [S], current [S]) covering lengths 0, 1
    and 2, a row with no match, a row whose bigram occurs three times (the
    last wins), a row at lengths T - 1, and random rows over a small
    alphabet (many matches)."""
    rng = np.random.default_rng(0)
    T = 24
    rows, lengths, current = [], [], []

    def row(h, n, cur):
        rows.append(np.asarray(h, dtype=np.int32))
        lengths.append(n)
        current.append(cur)

    row(rng.integers(0, 9, T), 0, 3)
    row(rng.integers(0, 9, T), 1, 4)
    h = rng.integers(0, 9, T)
    row(h, 2, int(h[0]))  # current equals history[0], a prior unigram
    row(np.arange(T) + 100, 10, 7)  # no match: repeats current
    h = np.full(T, 50)
    h[[2, 3, 9, 10, 15, 16]] = [5, 6, 5, 6, 5, 6]
    h[[4, 11, 17]] = [70, 71, 72]
    h[19], h[20] = 5, 6  # (previous, current) at lengths 20
    row(h, 20, 6)
    h = rng.integers(0, 3, T)
    row(h, T - 1, int(h[T - 1]))
    for n in (3, 7, 12, 18):
        h = rng.integers(0, 4, T)
        row(h, n, int(h[n]))
    return np.stack(rows), np.asarray(lengths, np.int32), np.asarray(current, np.int32)


@pytest.mark.parametrize("n_draft", [1, 2, 4])
def test_ngram_draft_equals_reference(n_draft):
    hist, lengths, current = _histories()
    want = np.asarray(ref_ngram_draft(jnp.asarray(hist), jnp.asarray(lengths),
                                      jnp.asarray(current), n_draft))
    got = ngram_draft(torch.from_numpy(hist).long(), torch.from_numpy(lengths),
                      torch.from_numpy(current).long(), n_draft).numpy()
    np.testing.assert_array_equal(got, want)
    # The cases bind: no match repeats current, the last of three matches wins.
    assert (got[3] == 7).all()
    assert got[4, 0] == 72


@pytest.fixture(scope="module")
def jax_params():
    return init_transformer(jax.random.PRNGKey(11), ref_get_model(MODEL).config)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_params), get_model(MODEL).config,
        device="cpu",
    )


def _greedy(eng, prompts, n=24):
    reqs = [eng.submit_generate(p, max_new_tokens=n, stop_on_eos=False) for p in prompts]
    return [r.future.result(timeout=120) for r in reqs]


@pytest.mark.parametrize("kv", [{}, dict(kv_block=32, kv_pool_blocks=40)], ids=["slot", "pool"])
def test_spec_engine_streams_equal_reference(jax_params, port_params, kv):
    """Both engines at G = 2 on the same f32 weights: the repeated-text
    prompts (drafts accept) and a plain one (drafts mostly reject), with
    more prompts than slots. Token streams identical, logprobs within
    1e-5; the port's pool is whole afterwards."""
    prompts = BENCH_PROMPTS[:5] + ["the quick brown fox"]
    ref = RefEngine(MODEL, params=jax_params, tokenizer=RefByteTokenizer(), **GEOMETRY, **kv)
    ref.start_sync()
    try:
        want = _greedy(ref, prompts)
    finally:
        ref.stop_sync()
    eng = InferenceEngine(MODEL, params=port_params, tokenizer=ByteTokenizer(),
                          device="cpu", **GEOMETRY, **kv)
    try:
        got = _greedy(eng, prompts)
        assert eng.kv_pool_counts()[1] == 0
    finally:
        eng.close()
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids
        np.testing.assert_allclose(g.token_logprobs, w.token_logprobs, atol=LOGPROB_TOL)


def test_resolve_spec_tokens_auto_seam():
    """The reference's seam test (tests/test_spec_decoding.py), on the
    port's function."""
    n, note = resolve_spec_tokens("auto", "tpu", False, 0)
    assert n == SPEC_AUTO_TOKENS and "ON by default" in note
    n, note = resolve_spec_tokens("auto", "cpu", False, 0)
    assert n == 0 and "backend='cpu'" in note
    n, note = resolve_spec_tokens("auto", "tpu", True, 0)
    assert n == 0 and "TPU_PENALTIES" in note
    n, note = resolve_spec_tokens("auto", "tpu", False, 3)
    assert n == 0 and "TPU_TOP_LOGPROBS" in note
    assert resolve_spec_tokens("3", "cpu", True, 5) == (3, None)
    assert resolve_spec_tokens("0", "tpu", False, 0) == (0, None)
    assert resolve_spec_tokens("-2", "tpu", False, 0) == (0, None)
    with pytest.raises(ValueError, match="integer or 'auto'"):
        resolve_spec_tokens("bogus", "tpu", False, 0)


@pytest.mark.parametrize("raw", ["auto", "", " AUTO ", None, "0", "2", "5", "-1", " 3 ",
                                 "two", "2.5"])
def test_resolve_spec_tokens_equals_reference(raw):
    """Every raw value on every backend the two packages name, with and
    without each conflicting feature: the same count and the same note,
    or the same ValueError. ``cuda`` resolves auto to 0 with a note; -1
    gives 0; ``two`` raises."""
    for backend in ("tpu", "cpu", "cuda", "gpu"):
        for penalties in (False, True):
            for top_logprobs in (0, 3):
                args = (raw, backend, penalties, top_logprobs)
                try:
                    want = ref_resolve(*args)
                except ValueError as exc:
                    with pytest.raises(ValueError) as got:
                        resolve_spec_tokens(*args)
                    assert str(got.value) == str(exc)
                    continue
                assert resolve_spec_tokens(*args) == want
    if raw in ("two", "2.5"):
        with pytest.raises(ValueError, match="expected an integer or 'auto'"):
            resolve_spec_tokens(raw, "cuda", False, 0)
        return
    n, note = resolve_spec_tokens(raw, "cuda", False, 0)
    if raw in ("auto", "", " AUTO ", None):
        assert n == 0 and "backend='cuda'" in note
    if raw == "-1":
        assert (n, note) == (0, None)


class _RecordingLogger:
    def __init__(self):
        self.lines = []

    def infof(self, fmt, *args):
        self.lines.append(fmt % args if args else fmt)

    warnf = errorf = debugf = infof


def _cfg(**extra):
    return MockConfig({"TPU_MODEL": MODEL, "TPU_DEVICE": "cpu", "TPU_KV_SLOTS": "2",
                       "TPU_MAX_LEN": "128", **extra})


def test_from_config_auto_resolves_off_with_a_note_and_explicit_wins():
    """Unset (auto) on the port's CPU engine: 0 and the reference's
    "stays off on backend='cpu'" note in the log, as the reference's own
    CPU run logs it; TPU_SPEC_TOKENS=2 gives 2 and serves; -1 gives 0."""
    logger = _RecordingLogger()
    eng = InferenceEngine.from_config(_cfg(), logger=logger)
    try:
        assert eng.spec_tokens == 0
        assert any("stays off on backend='cpu'" in ln for ln in logger.lines)
    finally:
        eng.close()
    ref_logger = _RecordingLogger()
    ref = RefEngine.from_config(RefMockConfig({"TPU_MODEL": MODEL, "TPU_KV_SLOTS": "2",
                                               "TPU_MAX_LEN": "128"}), logger=ref_logger)
    try:
        assert ref.spec_tokens == 0
        spec_notes = [ln for ln in ref_logger.lines if "speculative" in ln]
        assert spec_notes == [ln for ln in logger.lines if "speculative" in ln]
    finally:
        ref.close()
    eng = InferenceEngine.from_config(_cfg(TPU_SPEC_TOKENS="2"))
    try:
        assert eng.spec_tokens == 2
        # Short enough for max_len 128 to leave room for 3 windows of
        # 8 steps x 3 positions past the prompt.
        r = eng.generate_sync(BENCH_PROMPTS[0][:16], max_new_tokens=6, stop_on_eos=False)
        assert len(r.token_ids) == 6
    finally:
        eng.close()
    eng = InferenceEngine.from_config(_cfg(TPU_SPEC_TOKENS="-1"))
    try:
        assert eng.spec_tokens == 0
    finally:
        eng.close()
    with pytest.raises(ValueError, match="integer or 'auto'"):
        InferenceEngine.from_config(_cfg(TPU_SPEC_TOKENS="two"))


def test_auto_resolves_off_on_cuda_with_a_note(monkeypatch):
    """The backend the port passes is its device's type: on ``cuda`` auto
    is 0 with the reference's note (the engine's own construction is
    replaced, so no card is needed)."""
    import gofr_tpu_torch.serving.engine as engine_mod

    monkeypatch.setattr(engine_mod, "resolve_device", lambda d: torch.device("cuda", 0))
    built = {}
    monkeypatch.setattr(InferenceEngine, "__init__",
                        lambda self, *a, **kw: built.update(kw))
    logger = _RecordingLogger()
    InferenceEngine.from_config(MockConfig({"TPU_MODEL": MODEL}), logger=logger)
    assert built["spec_tokens"] == 0
    assert any("stays off on backend='cuda'" in ln for ln in logger.lines)
    InferenceEngine.from_config(MockConfig({"TPU_MODEL": MODEL, "TPU_SPEC_TOKENS": "2"}))
    assert built["spec_tokens"] == 2


def test_spec_feature_precedence_both_directions():
    """The reference's precedence test: the implicit default yields to
    penalties or top_logprobs with a "default-on skipped" note; an
    explicit TPU_SPEC_TOKENS beside them raises "mutually exclusive"
    through from_config and the constructor; a max_len below the
    speculative overshoot reserve raises naming spec_tokens."""
    for extra in ({"TPU_PENALTIES": "true"}, {"TPU_TOP_LOGPROBS": "3"}):
        logger = _RecordingLogger()
        eng = InferenceEngine.from_config(_cfg(**extra), logger=logger)
        try:
            assert eng.spec_tokens == 0
            assert any("default-on skipped" in ln for ln in logger.lines)
        finally:
            eng.close()
    with pytest.raises(ValueError, match="mutually exclusive"):
        InferenceEngine.from_config(_cfg(TPU_PENALTIES="true", TPU_SPEC_TOKENS="2"))
    with pytest.raises(ValueError, match="mutually"):
        InferenceEngine(MODEL, n_slots=2, max_len=128, device="cpu",
                        tokenizer=ByteTokenizer(), top_logprobs=2, spec_tokens=2)
    with pytest.raises(ValueError, match="spec_tokens"):
        InferenceEngine(MODEL, n_slots=2, max_len=64, window_k=8, device="cpu",
                        spec_tokens=2)
