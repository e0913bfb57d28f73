"""The reference's speculative-decoding contract (``tests/test_spec_decoding.py``,
``tests/test_mega_window.py``'s spec cases, ``tests/test_sliding_window.py``'s
spec rollout) held in the port: an engine at G = 2 gives the G = 0
engine's streams, tokens and logprob floats, on bf16 ``llama-tiny``
(both engines' weights from the same seed): greedy on the BENCH prompts,
seeded-sampled at 0.8 and 0.2 with drafts accepted, ``logit_bias``, the
acceptance histogram's bounds, an int8 pool, pipeline depth 1 and 3, mega
windows (against G = 2 plain windows: budgets over several dispatches, a
pool, the device's EOS exit), multi-chunk prefill writing the same history
as single chunks, and a sliding-window model crossing its window against a
full-forward rollout. One speculative step is also checked directly at a
slot near ``max_len``: accepted drafts, the bonus, and the parking of
rejected drafts in the history plane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models.transformer import TransformerConfig as RefConfig
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.models.transformer import transformer_forward as ref_forward
from gofr_tpu_torch.metrics import new_metrics_manager
from gofr_tpu_torch.models import registry
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.models.transformer import TransformerConfig, init_params, rope_tables
from gofr_tpu_torch.ops.kv_cache import KVCache
from gofr_tpu_torch.serving import programs as pg
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax

G = 2
ENG_KW = dict(n_slots=4, max_len=256, window_k=4)
BENCH_PROMPTS = [("abcdefgh"[i % 4:] + "abcdefgh" * 12)[:64] for i in range(8)]
GREEDY = dict(max_new_tokens=24, temperature=0.0, stop_on_eos=False)
SAMPLED = dict(max_new_tokens=24, temperature=0.8, seed=42, stop_on_eos=False)


def _metrics():
    m = new_metrics_manager()
    m.new_histogram("app_tpu_spec_tokens_per_step", "", (1, 1.5, 2, 2.5, 3, 4, 5, 6, 8))
    return m


def _acceptance(metrics):
    """(sum, count) of the acceptance histogram over every record."""
    for inst in metrics.instruments():
        if inst.name == "app_tpu_spec_tokens_per_step":
            total = n = 0.0
            for _, (_, (s, c)) in inst.collect().items():
                total += s
                n += c
            return total, n
    return 0.0, 0.0


def _engine(spec_tokens, model="llama-tiny", **kw):
    return InferenceEngine(model, tokenizer=ByteTokenizer(), device="cpu",
                           spec_tokens=spec_tokens, **{**ENG_KW, **kw})


@pytest.fixture(scope="module")
def spec_metrics():
    return _metrics()


@pytest.fixture(scope="module")
def engines(spec_metrics):
    ref, spec = _engine(0), _engine(G, metrics=spec_metrics)
    yield ref, spec
    ref.close()
    spec.close()


def _same(got, want):
    assert got.token_ids == want.token_ids
    assert got.token_logprobs == want.token_logprobs  # exact floats
    assert got.finish_reason == want.finish_reason


def test_greedy_equal_on_bench_prompts(engines):
    """All 8 BENCH prompts submitted together (more than the slots):
    tokens and logprob floats equal to G = 0's."""
    ref, spec = engines
    want = [ref.generate_sync(p, **GREEDY) for p in BENCH_PROMPTS]
    reqs = [spec.submit_generate(p, **GREEDY) for p in BENCH_PROMPTS]
    for r, w in zip(reqs, want):
        _same(r.future.result(timeout=120), w)


def test_seeded_sampled_equal_and_accepting(engines, spec_metrics):
    """Seeded sampling at 0.8 and at 0.2: the verify samples each position
    at the counter G = 0 uses there, so the streams are equal, and sampled
    slots accept drafts (mean tokens per step above 1)."""
    ref, spec = engines
    sum0, n0 = _acceptance(spec_metrics)
    near_greedy = dict(max_new_tokens=32, temperature=0.2, seed=7, stop_on_eos=False)
    for params in (SAMPLED, near_greedy):
        got, want = ([eng.submit_generate(p, **params) for p in BENCH_PROMPTS[:4]]
                     for eng in (spec, ref))
        for g, w in zip(got, want):
            _same(g.future.result(timeout=120), w.future.result(timeout=120))
    sum1, n1 = _acceptance(spec_metrics)
    assert n1 > n0
    assert (sum1 - sum0) / (n1 - n0) > 1.0


def test_logit_bias_composes_with_speculation(engines):
    ref, spec = engines
    banned = ByteTokenizer().encode("a")[0]
    params = dict(max_new_tokens=16, temperature=0.0, stop_on_eos=False,
                  logit_bias={int(banned): -100.0})
    got = spec.generate_sync(BENCH_PROMPTS[0], **params)
    _same(got, ref.generate_sync(BENCH_PROMPTS[0], **params))
    assert banned not in got.token_ids


def test_acceptance_counter_math(engines, spec_metrics):
    """Tokens per live step lie in [1, G + 1], and repeated text accepts
    well above 1."""
    _, spec = engines
    sum0, n0 = _acceptance(spec_metrics)
    reqs = [spec.submit_generate(p, max_new_tokens=32, temperature=0.0, stop_on_eos=False)
            for p in BENCH_PROMPTS[:4]]
    results = [r.future.result(timeout=120) for r in reqs]
    assert all(len(r.token_ids) == 32 for r in results)
    sum1, n1 = _acceptance(spec_metrics)
    assert n1 > n0
    mean = (sum1 - sum0) / (n1 - n0)
    assert 1.0 <= mean <= G + 1
    assert mean > 1.2


@pytest.mark.parametrize("kw", [dict(kv_block=16, kv_quant="int8", kv_pool_blocks=40),
                                dict(pipeline_depth=1), dict(pipeline_depth=3)],
                         ids=["int8 pool", "depth 1", "depth 3"])
def test_spec_equals_spec_off(kw):
    """On an int8 pool (the rejected drafts' K/V and scales are written
    and later overwritten) and at pipeline depth 1 and 3: G = 2 streams,
    greedy and seeded-sampled, equal G = 0's on the same cache; the pool
    is whole afterwards."""
    prompts = BENCH_PROMPTS[:5] + ["the quick brown fox"]
    out = {}
    for g in (0, G):
        eng = _engine(g, **kw)
        try:
            reqs = [eng.submit_generate(p, **GREEDY) for p in prompts]
            reqs.append(eng.submit_generate(BENCH_PROMPTS[1], **SAMPLED))
            out[g] = [r.future.result(timeout=120) for r in reqs]
            assert eng.kv_pool_counts()[1] == 0
        finally:
            eng.close()
    for got, want in zip(out[G], out[0]):
        _same(got, want)


PROMPT = "the quick brown fox"
MEGA_KW = dict(max_len=128, window_k=4)


@pytest.fixture(scope="module")
def spec_base_tokens():
    eng = _engine(G, **MEGA_KW)
    try:
        return eng.generate_sync(PROMPT, **GREEDY).token_ids
    finally:
        eng.close()


def test_mega_spec_matches_windowed_spec(spec_base_tokens):
    eng = _engine(G, mega_windows=4, **MEGA_KW)
    try:
        assert eng.generate_sync(PROMPT, **GREEDY).token_ids == spec_base_tokens
        assert eng.mega_dispatches >= 1 and eng.decode_windows >= eng.mega_dispatches
    finally:
        eng.close()


def test_mega_spec_budgets_and_paged(spec_base_tokens):
    """Uneven budgets on one mega engine with a pool: each comes out
    exact though a step emits a variable count."""
    eng = _engine(G, mega_windows=4, kv_block=32, kv_pool_blocks=40, **MEGA_KW)
    try:
        reqs = [eng.submit_generate(PROMPT, max_new_tokens=n, temperature=0.0,
                                    stop_on_eos=False) for n in (3, 9, 24)]
        results = [r.future.result(timeout=120) for r in reqs]
        assert [len(r.token_ids) for r in results] == [3, 9, 24]
        assert results[2].token_ids == spec_base_tokens
        assert eng.kv_pool_counts()[1] == 0
    finally:
        eng.close()


def test_mega_spec_device_eos_exit(spec_base_tokens):
    """An EOS id the stream produces stops the request that stops on EOS
    there and leaves a concurrent request's budget whole."""
    eos_tok = int(spec_base_tokens[5])

    class EosTokenizer(ByteTokenizer):
        eos_id = eos_tok

    eng = InferenceEngine("llama-tiny", tokenizer=EosTokenizer(), device="cpu",
                          spec_tokens=G, mega_windows=4, n_slots=4, **MEGA_KW)
    try:
        stopping = eng.submit_generate(PROMPT, max_new_tokens=24, temperature=0.0,
                                       stop_on_eos=True)
        free = eng.submit_generate(PROMPT, max_new_tokens=24, temperature=0.0,
                                   stop_on_eos=False)
        r_stop, r_free = (r.future.result(timeout=120) for r in (stopping, free))
    finally:
        eng.close()
    first = spec_base_tokens.index(eos_tok)
    assert r_stop.token_ids == spec_base_tokens[: first + 1]
    assert r_stop.finish_reason == "stop"
    assert r_free.token_ids == spec_base_tokens


def test_multi_chunk_prefill_writes_the_same_history():
    """prefill_depth 4 (a 127-token prompt at chunk 16: 8 chunks, two
    multi-chunk dispatches, then the finalize chunk) gives the
    single-chunk stream and leaves the same history row, prompt included,
    so the drafts are the same."""
    long = "a quick brown fox jumps over the lazy dog " * 3
    ids = ByteTokenizer().encode(long)
    rows, toks = [], []
    for depth in (1, 4):
        eng = _engine(G, prefill_chunk=16, prefill_depth=depth)
        try:
            toks.append(eng.generate_sync(long, max_new_tokens=12, stop_on_eos=False).token_ids)
            rows.append(eng.planes.history[0].clone())
            assert eng.prefill_steps == (-(-len(ids) // 16) if depth == 1 else 3)
        finally:
            eng.close()
    assert toks[0] == toks[1]
    assert torch.equal(rows[0], rows[1])
    assert rows[1][: len(ids)].tolist() == ids


def test_spec_step_near_max_len_parks_rejected_drafts():
    """One spec_step on a slot whose length is max_len - 4 (the verify's
    last position is max_len - 2): slot 0's history is built so its draft
    is the true continuation (both accepted: 3 tokens, the bonus at
    max_len - 1), slot 1's so that its first draft is wrong (1 token; its
    rejected drafts park at max_len - 1, leaving max_len - 2 untouched);
    slot 2 is inactive and keeps its length, counter and history. Tokens
    equal three plain decode steps from the same state."""
    cfg = get_model("llama-tiny-f32").config
    T, S = 32, 3
    params = init_params(cfg, 0, "cpu")
    rope = rope_tables(cfg, T, torch.device("cpu"))
    flags = pg.SamplerFlags()

    def state():
        cache = KVCache.create(cfg.n_layers, S, T, cfg.n_kv_heads, cfg.head_dim,
                               dtype=cfg.dtype, device="cpu")
        return cache, pg.SlotPlanes.create(S, "cpu", cfg.vocab_size, flags, history_len=T)

    rng = np.random.default_rng(2)
    n0 = T - 4
    plain = state()
    prompt = torch.from_numpy(rng.integers(0, 256, (S, n0))).long()
    i32 = dict(dtype=torch.int32)
    ones = torch.ones((S,), dtype=torch.bool)
    pg.prefill_chunk_step(params, plain[0], cfg, rope, plain[1], flags, prompt,
                          torch.arange(S, **i32), torch.zeros((S,), **i32),
                          torch.full((S,), n0, **i32), ones, ones, torch.ones((S,)), ones,
                          torch.ones((S,)), 2, sampling=False, history=True)
    plain[1].active.copy_(torch.tensor([True, True, False]))
    spec = state()
    for a, b in ((spec[0].k, plain[0].k), (spec[0].v, plain[0].v),
                 (spec[0].lengths, plain[0].lengths)):
        a.copy_(b)
    for f in ("tokens", "nsteps", "seeds", "active", "history"):
        getattr(spec[1], f).copy_(getattr(plain[1], f))
    want = pg.decode_window(params, plain[0], cfg, rope, plain[1], flags, 3, 2,
                            sampling=False)[0].long().T  # [S, 3]
    hist = spec[1].history
    cur = spec[1].tokens.clone()
    # Slot 0: (previous, current) earlier at 4, 5, followed by the truth.
    hist[0, 4], hist[0, 5], hist[0, 6], hist[0, 7] = hist[0, n0 - 1], cur[0], want[0, 0], want[0, 1]
    # Slot 1: the same bigram followed by a wrong first draft.
    hist[1, 4], hist[1, 5] = hist[1, n0 - 1], cur[1]
    hist[1, 6], hist[1, 7] = (want[1, 0] + 1) % cfg.vocab_size, want[1, 1]
    before = hist.clone()
    tokens, logps, counts = pg.spec_step(params, spec[0], cfg, rope, spec[1], flags, G, 2,
                                         sampling=False)
    assert counts.tolist() == [3, 1, 0]
    assert tokens[0].tolist() == want[0].tolist()
    assert tokens[1, 0] == want[1, 0]
    assert spec[0].lengths.tolist() == [n0 + 3, n0 + 1, n0]
    assert spec[1].nsteps.tolist() == [1 + 3, 1 + 1, 1]
    assert spec[1].tokens[:2].tolist() == [want[0, 2], want[1, 0]]
    h = spec[1].history
    assert h[0, n0:].tolist() == [cur[0], want[0, 0], want[0, 1], want[0, 2]]
    assert h[1, n0:n0 + 2].tolist() == [cur[1], want[1, 0]]
    assert h[1, n0 + 2] == before[1, n0 + 2]  # a rejected draft's position: untouched
    assert torch.equal(h[2, : T - 1], before[2, : T - 1])
    assert torch.equal(h[:, : n0], before[:, : n0])


SWA_DIMS = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                d_ff=128, max_len=128, rope_theta=10000.0, sliding_window=8)
SWA_NAME = "swa-spec-port-test"


def test_sliding_window_spec_matches_full_forward_rollout():
    """``tests/test_sliding_window.py``'s rollout on ``tests/test_torch_window.py``'s
    windowed dims (f32, window 8): a 15-token prompt and 12 greedy tokens
    crossing the window, at G = 0 and G = 2, on the slot cache and on a
    pool whose block is the window, equal to the reference's full-forward
    greedy rollout on the same weights."""
    ref_cfg = RefConfig(dtype=jnp.float32, **SWA_DIMS)
    cfg = TransformerConfig(dtype=torch.float32, **SWA_DIMS)
    jparams = init_transformer(jax.random.PRNGKey(3), ref_cfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    prompt = [ord(c) for c in "sliding windows"]
    ids = list(prompt)
    forward = jax.jit(lambda p, t: ref_forward(p, t, ref_cfg))
    for _ in range(12):
        # One compiled shape: the forward is causal, so zeros after the
        # last token change nothing before it.
        padded = np.zeros((1, len(prompt) + 12), dtype=np.int32)
        padded[0, : len(ids)] = ids
        logits = np.asarray(forward(jparams, jnp.asarray(padded)))
        ids.append(int(logits[0, len(ids) - 1].argmax()))
    want = ids[len(prompt):]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(registry._REGISTRY, SWA_NAME,
                   registry.ModelSpec(name=SWA_NAME, family="llm", config=cfg))
        for spec_tokens, kv_block in ((0, 0), (G, 0), (G, 8)):
            eng = InferenceEngine(SWA_NAME, n_slots=2, max_len=128, window_k=4,
                                  prefill_chunk=16, tokenizer=ByteTokenizer(), params=params,
                                  device="cpu", spec_tokens=spec_tokens, kv_block=kv_block)
            try:
                got = eng.generate_sync(prompt, max_new_tokens=12, stop_on_eos=False).token_ids
            finally:
                eng.close()
            assert got == want, f"spec_tokens={spec_tokens} kv_block={kv_block}"


def test_mega_spec_exit_counts_delivered_tokens_and_valid_eos():
    """The mega spec program (``mega_window`` with ``spec_tokens``, the
    reference's ``mega_spec_window``) against m plain spec windows from the
    same state after a prefill of repeated text, with the exit computed on
    the host: a window takes from each budget the tokens it delivered (the
    first ``counts`` of each step), and an EOS ends a budget only among
    them. One budget is what a slot delivers in two windows (fewer than k
    a window would need); one EOS id is a token that appears only at a
    rejected position of its slot's windows, which must not end it."""
    cfg = get_model("llama-tiny").config
    S, T, k, m = 4, 256, 4, 3
    params = init_params(cfg, 0, "cpu")
    rope = rope_tables(cfg, T, torch.device("cpu"))
    flags = pg.SamplerFlags()

    def state():
        cache = KVCache.create(cfg.n_layers, S, T, cfg.n_kv_heads, cfg.head_dim,
                               dtype=cfg.dtype, device="cpu")
        return cache, pg.SlotPlanes.create(S, "cpu", cfg.vocab_size, flags, history_len=T)

    start = state()
    i32 = dict(dtype=torch.int32)
    ones = torch.ones((S,), dtype=torch.bool)
    toks = torch.tensor([[ord(ch) for ch in p[:48]] for p in BENCH_PROMPTS[:S]])
    pg.prefill_chunk_step(params, start[0], cfg, rope, start[1], flags, toks,
                          torch.arange(S, **i32), torch.zeros((S,), **i32),
                          torch.full((S,), 48, **i32), ones, ones, torch.ones((S,)), ones,
                          torch.ones((S,)), 2, sampling=False, history=True)
    start[1].active.fill_(True)

    def copy(src):
        dst = state()
        for a, b in zip((dst[0].k, dst[0].v, dst[0].lengths), (src[0].k, src[0].v,
                                                               src[0].lengths)):
            a.copy_(b)
        for f in ("tokens", "nsteps", "seeds", "active", "history"):
            getattr(dst[1], f).copy_(getattr(src[1], f))
        return dst

    st = copy(start)
    plain = torch.cat([pg.spec_window(params, st[0], cfg, rope, st[1], flags, k, G, 2,
                                      sampling=False) for _ in range(m)], dim=1)
    counts = plain[2 * G + 2].long()  # [m·k, S]

    def delivered(w, i):
        return [int(plain[j, t, i]) for t in range(w * k, (w + 1) * k)
                for j in range(int(counts[t, i]))]

    def rejected(i):
        return {int(plain[j, t, i]) for t in range(m * k)
                for j in range(int(counts[t, i]), G + 1)}

    def exit_after(remaining, stop, eos):
        rem, w = list(remaining), 0
        while w < m and any(x > 0 for x in rem):
            rem = [0 if stop[i] and eos in delivered(w, i)
                   else max(0, x - len(delivered(w, i))) for i, x in enumerate(rem)]
            w += 1
        return w

    two, fast = max((len(delivered(0, i)) + len(delivered(1, i)), i) for i in range(S))
    assert two > 2 * k  # drafts were accepted: two windows deliver more than 2k
    only_rejected = next((t, i) for i in range(S)
                         for t in sorted(rejected(i) - {x for w in range(m)
                                                        for x in delivered(w, i)}))
    cases = [(tuple(two if i == fast else 0 for i in range(S)), (False,) * S, -1, 2),
             (tuple(10**6 if i == only_rejected[1] else 0 for i in range(S)),
              tuple(i == only_rejected[1] for i in range(S)), only_rejected[0], m)]
    for remaining, stop, eos, want_w in cases:
        assert exit_after(remaining, stop, eos) == want_w
        st = copy(start)
        mega = pg.MegaState.create(S, k, m, 0, "cpu", spec_tokens=G)
        mega.remaining.copy_(torch.tensor(remaining))
        mega.eos_stop.copy_(torch.tensor(stop))
        emitted, w = pg.mega_window(params, st[0], cfg, rope, st[1], flags, k, m, 2, eos,
                                    mega, sampling=False, spec_tokens=G)
        assert int(w) == want_w
        assert torch.equal(emitted[:, : want_w * k], plain[:, : want_w * k])
        assert not emitted[:, want_w * k:].any()
