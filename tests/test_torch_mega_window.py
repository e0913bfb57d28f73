"""The port's mega window against the reference's (``mega_windows``: up to
m k-step windows in one dispatch with the reference's device-side exit),
on ``llama-tiny-f32`` with the same weights: the cases of the reference's
``tests/test_mega_window.py`` without speculation (greedy parity, exact
budgets over several dispatches, uneven budgets, a stop string mid-mega,
the paged pool, the sampled path, the device EOS exit), the windows each
dispatch runs against the reference's, the program's exit against its
formula and against m plain windows, a sliding-window model under mega 0
and 4 (``tests/test_sliding_window.py``'s mega parity), and a slot driven
past ``max_len`` inside a mega window, whose writes park.

The port's remaining budget counts the tokens its windows still have to
produce (the prompt's first token comes from the prefill), the
reference's the tokens its windows still have to emit (its first window
repeats the first token); at budgets N with N - 1 not a multiple of k the
two give the same windows.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import registry as ref_registry
from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import TransformerConfig as RefConfig
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models import registry
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.models.transformer import TransformerConfig, rope_tables
from gofr_tpu_torch.ops.kv_cache import KVCache
from gofr_tpu_torch.serving import programs
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax

MODEL = "llama-tiny-f32"
GEOMETRY = dict(n_slots=4, max_len=128, window_k=4)
PROMPT = "the quick brown fox"


@pytest.fixture(scope="module")
def jax_params():
    return init_transformer(jax.random.PRNGKey(11), ref_get_model(MODEL).config)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_params), get_model(MODEL).config,
        device="cpu",
    )


def _gate(eng, method: str) -> threading.Event:
    """Hold the scheduler at its admission until the event is set, so the
    requests submitted before are admitted in one pass."""
    gate = threading.Event()
    orig = getattr(eng, method)

    def gated(*a, **kw):
        gate.wait(timeout=60)
        return orig(*a, **kw)

    setattr(eng, method, gated)
    return gate


def _ref_run(params, budgets, **kw):
    """The reference engine on PROMPT at each budget, admitted in one
    pass: (token ids per request, windows run per mega dispatch)."""
    ref = RefEngine(MODEL, params=params, tokenizer=RefByteTokenizer(), **GEOMETRY, **kw)
    ref.start_sync()
    wruns = []
    orig = ref._mega_window

    def recorded(*a, **kwa):
        out = orig(*a, **kwa)
        wruns.append(int(np.asarray(out[2])))
        return out

    ref._mega_window = recorded
    try:
        gate = _gate(ref, "_dispatch_prefill_chunk")
        reqs = [ref.submit_generate(PROMPT, max_new_tokens=n, temperature=0.0,
                                    stop_on_eos=False) for n in budgets]
        gate.set()
        return [r.future.result(timeout=120).token_ids for r in reqs], wruns
    finally:
        ref.stop_sync()


def _port(params, **kw):
    kw.setdefault("mega_windows", 4)
    kw.setdefault("tokenizer", ByteTokenizer())
    return InferenceEngine(MODEL, params=params, device="cpu", **{**GEOMETRY, **kw})


def _port_run(eng, budgets):
    gate = _gate(eng, "_admit")
    reqs = [eng.submit_generate(PROMPT, max_new_tokens=n, temperature=0.0,
                                stop_on_eos=False) for n in budgets]
    gate.set()
    return [r.future.result(timeout=120) for r in reqs]


@pytest.fixture(scope="module")
def base_tokens(jax_params):
    """The reference's windowed greedy stream of PROMPT, 24 tokens."""
    return _ref_run(jax_params, [24])[0][0]


def test_mega_matches_windowed_greedy(port_params, base_tokens):
    eng = _port(port_params)
    try:
        assert [r.token_ids for r in _port_run(eng, [24])] == [base_tokens]
        assert eng.mega_dispatches >= 1
    finally:
        eng.close()


def test_mega_budget_exact_over_dispatches_and_windows_run(port_params, jax_params,
                                                           base_tokens):
    """24 tokens at k = 4 and m = 2: three mega dispatches of two windows
    each, on both engines; the budget comes out exact."""
    want, ref_wruns = _ref_run(jax_params, [24], mega_windows=2)
    eng = _port(port_params, mega_windows=2)
    try:
        (r,) = _port_run(eng, [24])
        assert r.token_ids == want[0] == base_tokens
        assert r.finish_reason == "length"
        assert list(eng.windows_run) == ref_wruns == [2, 2, 2]
    finally:
        eng.close()


def test_mega_uneven_budgets_and_windows_run(port_params, jax_params):
    """Budgets 3, 10, 17, 24 admitted together: each request gets exactly
    its own; the device exit covers the longest, and each dispatch runs
    the reference's number of windows."""
    budgets = [3, 10, 17, 24]
    want, ref_wruns = _ref_run(jax_params, budgets, mega_windows=4)
    eng = _port(port_params)
    try:
        got = _port_run(eng, budgets)
        assert [len(r.token_ids) for r in got] == budgets
        assert [r.token_ids for r in got] == want
        assert list(eng.windows_run) == ref_wruns
    finally:
        eng.close()


def test_mega_windows_run_where_the_port_is_one_window_ahead(port_params, jax_params):
    """Budget 9 at k = 4: the port's windows produce tokens 2..9 (8, two
    windows); the reference's emit tokens 1..9 (its first window repeats
    the prefill token: three windows). Both streams are the same."""
    want, ref_wruns = _ref_run(jax_params, [9], mega_windows=4)
    eng = _port(port_params)
    try:
        (r,) = _port_run(eng, [9])
        assert r.token_ids == want[0]
        assert list(eng.windows_run) == [2] and ref_wruns == [3]
    finally:
        eng.close()


def test_mega_stop_string_retires_mid_mega(port_params):
    eng = _port(port_params)
    try:
        base = eng.generate_sync(PROMPT, max_new_tokens=24, stop_on_eos=False).text
        stop = base[2:6]
        r = eng.generate_sync(PROMPT, max_new_tokens=24, stop_on_eos=False, stop=[stop])
        assert stop not in r.text and r.finish_reason == "stop"
        # The engine still serves after the mid-mega retirement.
        again = [eng.generate_sync(PROMPT, max_new_tokens=8).token_ids for _ in range(2)]
        assert again[0] == again[1]
    finally:
        eng.close()


def test_mega_with_paged_kv(port_params, base_tokens):
    eng = _port(port_params, kv_block=32, kv_pool_blocks=24)
    try:
        assert [r.token_ids for r in _port_run(eng, [24])] == [base_tokens]
        assert eng.kv_pool_counts()[1] == 0
    finally:
        eng.close()


def test_mega_sampled_path_runs(port_params):
    eng = _port(port_params)
    try:
        r = eng.generate_sync(PROMPT, max_new_tokens=12, temperature=0.8, seed=3,
                              stop_on_eos=False)
        assert len(r.token_ids) == 12
        windowed = _port(port_params, mega_windows=0)
        try:
            # Counter-based noise: the same seeded stream whatever the dispatch.
            assert windowed.generate_sync(PROMPT, max_new_tokens=12, temperature=0.8, seed=3,
                                          stop_on_eos=False).token_ids == r.token_ids
        finally:
            windowed.close()
    finally:
        eng.close()


def test_mega_device_eos_early_exit(port_params, base_tokens):
    """A tokenizer whose EOS is a token the greedy stream emits: the
    stop_on_eos request stops at it ("stop"), a concurrent stop_on_eos=False
    request keeps its whole budget (the exit zeroes only the opted-in
    slot's remaining)."""
    eos_tok = int(base_tokens[5])

    class EosTokenizer(ByteTokenizer):
        eos_id = eos_tok

    eng = _port(port_params, tokenizer=EosTokenizer())
    try:
        stopping = eng.submit_generate(PROMPT, max_new_tokens=24, stop_on_eos=True)
        free = eng.submit_generate(PROMPT, max_new_tokens=24, stop_on_eos=False)
        r_stop, r_free = stopping.future.result(timeout=120), free.future.result(timeout=120)
        first_eos = base_tokens.index(eos_tok)
        assert r_stop.token_ids == base_tokens[: first_eos + 1]
        assert r_stop.finish_reason == "stop"
        assert r_free.token_ids == base_tokens
    finally:
        eng.close()


@pytest.mark.parametrize("remaining,eos_slot,want", [
    ([0, 5, 9, 17], -1, 4),  # min(m, ceil(17 / 4)) = 4 (5 needed)
    ([3, 0, 0, 0], -1, 1),
    ([0, 0, 0, 0], -1, 0),
    ([8, 0, 0, 0], -1, 2),
    ([17, 0, 0, 0], 0, None),  # EOS in slot 0 ends the loop after its window
])
def test_mega_program_exit_against_formula_and_plain_windows(port_params, remaining,
                                                             eos_slot, want):
    """``programs.mega_window`` runs ``(w < m) & any(remaining > 0)``
    windows: min(m, ceil(max(remaining) / k)) without EOS; with slot 0
    stopping on EOS (the token its 2nd step produces), until the window
    that produced it. Its block equals m plain ``decode_window`` calls on a
    copy of the same state, column for column."""
    cfg = get_model(MODEL).config
    S, k, m, L = 4, 4, 4, 64
    rope = rope_tables(cfg, L, torch.device("cpu"))
    flags = programs.SamplerFlags()

    def state():
        cache = KVCache.create(cfg.n_layers, S, L, cfg.n_kv_heads, cfg.head_dim,
                               dtype=cfg.dtype, device="cpu")
        planes = programs.SlotPlanes.create(S, torch.device("cpu"), cfg.vocab_size, flags)
        planes.tokens.copy_(torch.tensor([5, 17, 99, 200]))
        planes.active.fill_(True)
        return cache, planes

    def window(st):
        return programs.decode_window(port_params, st[0], cfg, rope, st[1], flags, k, 2,
                                      sampling=False)

    plain = state()
    blocks = torch.cat([window(plain) for _ in range(m)], dim=1)  # [2, m*k, S]
    eos = int(blocks[0, 1, 0]) if eos_slot >= 0 else -1
    if want is None:
        produced = blocks[0, :, 0].tolist()
        want = min(m, produced.index(eos) // k + 1)
    mega = state()
    ms = programs.MegaState.create(S, k, m, 0, torch.device("cpu"))
    ms.remaining.copy_(torch.tensor(remaining))
    if eos_slot >= 0:
        ms.eos_stop[eos_slot] = True
    emitted, w = programs.mega_window(port_params, mega[0], cfg, rope, mega[1], flags, k, m,
                                      2, eos, ms, sampling=False)
    if eos_slot < 0:
        assert want == min(m, math.ceil(max(remaining) / k))
    assert int(w) == want
    assert torch.equal(emitted[:, : want * k], blocks[:, : want * k])
    assert not emitted[:, want * k:].any()


def test_slot_past_max_len_inside_a_mega_window_parks(port_params):
    """At max_len 64 a 50-token prompt gets a budget of 64 - 1 - 50 - 8 =
    5; beside it a short prompt with 40 tokens to go keeps the device loop
    running 8 windows of 4, so the first slot keeps stepping 32 positions
    past its budget and past the cache's end: those writes park and its
    length stops at max_len; both streams equal the windowed engine's."""
    long_p = np.random.default_rng(2).integers(0, 256, 50).tolist()
    geometry = dict(max_len=64, pipeline_depth=1)
    runs = {}
    for mega in (0, 8):
        eng = _port(port_params, mega_windows=mega, **geometry)
        try:
            gate = _gate(eng, "_admit")
            reqs = [eng.submit_generate(long_p, max_new_tokens=40, stop_on_eos=False),
                    eng.submit_generate([7, 8, 9], max_new_tokens=40, stop_on_eos=False)]
            gate.set()
            runs[mega] = [r.future.result(timeout=120).token_ids for r in reqs]
            assert int(eng.cache.lengths.max()) <= 64
            if mega:
                assert list(eng.windows_run)[0] == 8
        finally:
            eng.close()
    assert [len(t) for t in runs[0]] == [5, 40]
    assert runs[8] == runs[0]


# The reference's windowed test config (tests/test_sliding_window.py's
# SWA_CFG: f32, 2 layers, window 8).
SWA_DIMS = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                d_ff=128, max_len=128, rope_theta=10000.0, sliding_window=8)
SWA_NAME = "swa-mega-port-test"
SWA_PROMPT = [ord(ch) for ch in "abcdefghij"]


def test_sliding_window_under_mega_zero_and_four():
    """``test_engine_swa_mega_parity`` of the reference, held against it:
    the windowed model's 16-token greedy stream (generation crosses the
    window) is the reference's at mega 0 and the port's at mega 0 and 4."""
    jparams = init_transformer(jax.random.PRNGKey(4), RefConfig(dtype=jnp.float32, **SWA_DIMS))
    cfg = TransformerConfig(dtype=torch.float32, **SWA_DIMS)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    gen = dict(max_new_tokens=16, temperature=0.0, stop_on_eos=False, timeout=120)
    geometry = dict(n_slots=2, max_len=128, window_k=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ref_registry._REGISTRY, SWA_NAME, ref_registry.ModelSpec(
            name=SWA_NAME, family="llm", config=RefConfig(dtype=jnp.float32, **SWA_DIMS),
            init=lambda key, c: jparams))
        mp.setitem(registry._REGISTRY, SWA_NAME, registry.ModelSpec(
            name=SWA_NAME, family="llm", config=cfg))
        ref = RefEngine(SWA_NAME, tokenizer=RefByteTokenizer(), params=jparams, **geometry)
        ref.start_sync()
        try:
            want = ref.generate_sync(SWA_PROMPT, **gen).token_ids
        finally:
            ref.stop_sync()
        for mega in (0, 4):
            eng = InferenceEngine(SWA_NAME, tokenizer=ByteTokenizer(), params=params,
                                  device="cpu", mega_windows=mega, **geometry)
            try:
                assert eng.generate_sync(SWA_PROMPT, **gen).token_ids == want
            finally:
                eng.close()
    assert len(want) == 16
