"""The port's decode loop against the reference's, on ``llama-tiny-f32``
with the same weights (``init_transformer`` → ``params_from_jax``):
pipelined windows (``pipeline_depth`` 1, 2, 3) on the slot cache, the
paged pool and int8; the slot snapshot that keeps a re-admitted slot's
stream clean while the retired request's windows are still in flight;
``wants_more`` (no window past every live budget) and the window counts;
multi-chunk prefill (``prefill_depth``), the reference's
``TestMultiChunkPrefill`` without speculation; and the launch counters'
capture record. Greedy streams must equal the reference engine's token for
token. The mega window's cases are in ``test_torch_mega_window.py``.

The port's window emits the k tokens each step produces (the prompt's
first token comes from the prefill); the reference's emits the token
entering each step (its first window repeats the first token). So a
budget of N tokens takes the port ceil((N - 1) / k) windows and the
reference ceil(N / k): the same count unless N - 1 is a multiple of k,
where the port needs one window fewer.
"""

import collections
import math
import threading

import jax
import numpy as np
import pytest

from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.ops.cuda import _count
from gofr_tpu_torch.ops.cuda import flash_decode as fd
from gofr_tpu_torch.ops.cuda import flash_prefill as fp
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax

MODEL = "llama-tiny-f32"
GEOMETRY = dict(n_slots=2, max_len=128, window_k=4, prefill_chunk=16, prefill_batch=2)
KV = {"slot": {}, "paged": dict(kv_block=16), "int8": dict(kv_quant="int8")}


@pytest.fixture(scope="module")
def jax_params():
    return init_transformer(jax.random.PRNGKey(11), ref_get_model(MODEL).config)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_params), get_model(MODEL).config,
        device="cpu",
    )


def _prompts():
    rng = np.random.default_rng(5)
    # Three chunks, exactly one chunk, and a short prompt; three prompts
    # on two slots reuse a slot.
    return [rng.integers(0, 256, n).tolist() for n in (40, 16, 3)]


def _streams(eng, prompts, **kw):
    reqs = [eng.submit_generate(p, **kw) for p in prompts]
    return [r.future.result(timeout=120).token_ids for r in reqs]


def _port(params, **kw):
    return InferenceEngine(MODEL, params=params, tokenizer=ByteTokenizer(), device="cpu",
                           **{**GEOMETRY, **kw})


def _ref(params, **kw):
    ref = RefEngine(MODEL, params=params, tokenizer=RefByteTokenizer(), **{**GEOMETRY, **kw})
    ref.start_sync()
    return ref


@pytest.fixture(scope="module")
def ref_streams(jax_params):
    """The reference engine's greedy streams of ``_prompts()`` (12 new
    tokens) on each cache."""
    out = {}
    for name, kv in KV.items():
        ref = _ref(jax_params, **kv)
        try:
            out[name] = _streams(ref, _prompts(), max_new_tokens=12)
        finally:
            ref.stop_sync()
    return out


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipelined_streams_equal_reference_and_depth_one(port_params, ref_streams, depth, kv):
    """``pipeline_depth`` windows in flight change when the host reads
    tokens, never which: every depth's greedy streams equal the reference
    engine's (so depth 2 and 3 equal the port's depth-1 run), on the slot
    cache, a B=16 pool and int8; the pool is whole again after the run."""
    eng = _port(port_params, pipeline_depth=depth, **KV[kv])
    try:
        got = _streams(eng, _prompts(), max_new_tokens=12)
        assert got == ref_streams[kv]
        assert all(len(g) == 12 or g[-1] == ByteTokenizer.eos_id for g in got)
        assert eng.kv_pool_counts()[1] == 0
        assert not eng._inflight and not eng._prefill_emits
    finally:
        eng.close()


def _gate(eng, method: str):
    """Hold the engine's scheduler at ``method`` (its admission) until the
    returned event is set, so every request submitted before is admitted
    in one pass."""
    gate = threading.Event()
    orig = getattr(eng, method)

    def gated(*a, **kw):
        gate.wait(timeout=60)
        return orig(*a, **kw)

    setattr(eng, method, gated)
    return gate


def test_retired_slot_readmitted_while_its_windows_fly(port_params, jax_params):
    """At depth 3 a stop string retires request A while windows that hold
    A in their snapshot are still in flight; B, queued behind it, takes
    A's slot before those windows are processed. B's stream equals the
    reference engine's B, and the windows that carried A gave B nothing."""
    keep = np.random.default_rng(1).integers(0, 256, 20).tolist()
    a_prompt, b_prompt = _prompts()[0], _prompts()[2]
    solo = _port(port_params)
    try:
        a_text = solo.generate_sync(a_prompt, max_new_tokens=30, stop_on_eos=False).text
    finally:
        solo.close()
    stop = a_text[3:6]
    ref = _ref(jax_params)
    try:
        want_b = _streams(ref, [b_prompt], max_new_tokens=20, stop_on_eos=False)[0]
    finally:
        ref.stop_sync()
    eng = _port(port_params, pipeline_depth=3)
    seen = []
    orig = eng._process_window

    def watched(win):
        # Which request each slot holds now, beside the window's snapshot.
        seen.append((list(win.snapshot), list(eng._slots)))
        orig(win)

    eng._process_window = watched
    try:
        gate = _gate(eng, "_admit")
        reqs = [eng.submit_generate(keep, max_new_tokens=60, stop_on_eos=False),
                eng.submit_generate(a_prompt, max_new_tokens=30, stop_on_eos=False,
                                    stop=[stop]),
                eng.submit_generate(b_prompt, max_new_tokens=20, stop_on_eos=False)]
        gate.set()
        res = [r.future.result(timeout=120) for r in reqs]
    finally:
        eng.close()
    a_req, b_req = reqs[1], reqs[2]
    assert res[1].finish_reason == "stop" and stop not in res[1].text
    assert res[2].token_ids == want_b
    # The hazard happened: a window dispatched with A in its slot was
    # processed while that slot already held B.
    assert any(snap[1] is a_req and now[1] is b_req for snap, now in seen)


@pytest.mark.parametrize("n", [8, 9, 11])
def test_window_counts_and_no_overshoot(port_params, jax_params, n):
    """One request of budget n at k = 4, admitted alone (the scheduler is
    held until it is queued): the port dispatches ceil((n - 1) / 4)
    windows, the reference ceil(n / 4); equal but for n = 9, where the
    port's window ahead of the reference's needs one fewer. A wave of two
    requests of the same budget admitted in one pass takes the same count
    (``wants_more``: no window past every live budget)."""
    prompt = _prompts()[2]
    ref = _ref(jax_params)
    calls = collections.Counter()
    orig = ref._decode_window

    def counted(*a, **kw):
        calls["windows"] += 1
        return orig(*a, **kw)

    ref._decode_window = counted
    try:
        gate = _gate(ref, "_dispatch_prefill_chunk")
        r = ref.submit_generate(prompt, max_new_tokens=n, stop_on_eos=False)
        gate.set()
        want = r.future.result(timeout=120).token_ids
    finally:
        ref.stop_sync()
    assert calls["windows"] == math.ceil(n / 4)
    for wave in (1, 2):
        eng = _port(port_params)
        try:
            gate = _gate(eng, "_admit")
            reqs = [eng.submit_generate(prompt, max_new_tokens=n, stop_on_eos=False)
                    for _ in range(wave)]
            gate.set()
            got = [q.future.result(timeout=120).token_ids for q in reqs]
            assert got == [want] * wave
            assert eng.decode_windows == math.ceil((n - 1) / 4)
            assert eng.decode_windows == calls["windows"] - (1 if (n - 1) % 4 == 0 else 0)
        finally:
            eng.close()


LONG = "a quick brown fox jumps over the lazy dog " * 3  # 129 bytes


def _long_tokens(params, reference=False, **kw):
    geometry = dict(n_slots=4, max_len=256, window_k=4, prefill_chunk=16)
    if not reference:
        eng = InferenceEngine(MODEL, params=params, tokenizer=ByteTokenizer(), device="cpu",
                              **geometry, **kw)
        stop = eng.close
    else:
        eng = RefEngine(MODEL, params=params, tokenizer=RefByteTokenizer(), **geometry, **kw)
        eng.start_sync()
        stop = eng.stop_sync
    try:
        return eng, eng.generate_sync(LONG, max_new_tokens=12, stop_on_eos=False,
                                      timeout=120).token_ids
    finally:
        stop()


@pytest.fixture(scope="module")
def long_ref(jax_params):
    return _long_tokens(jax_params, reference=True)[1]


@pytest.mark.parametrize("kw", [{}, dict(kv_block=32, kv_pool_blocks=40),
                                dict(mega_windows=4)], ids=["slot", "paged", "mega"])
def test_multi_chunk_prefill_equals_reference(port_params, long_ref, kw):
    """The reference's TestMultiChunkPrefill without speculation: a
    129-token prompt at chunk 16 through prefill_depth 4 (two dispatches of
    4 and 3 full chunks, then the finalize chunk) gives the reference's
    single-chunk stream, also on a pool and with mega windows."""
    eng, got = _long_tokens(port_params, prefill_depth=4, **kw)
    assert got == long_ref
    assert eng.prefill_steps == 3  # 8 chunks in 3 dispatches


def test_multi_chunk_prefill_mixed_lengths(port_params, jax_params):
    """A short prompt admitted beside a long one does not turn the
    amortizer off for the long row, and both streams equal the
    reference's."""
    geometry = dict(n_slots=4, max_len=256, window_k=4, prefill_chunk=16)
    ref = RefEngine(MODEL, params=jax_params, tokenizer=RefByteTokenizer(), **geometry)
    ref.start_sync()
    try:
        want = _streams(ref, [LONG, "hi there"], max_new_tokens=8, stop_on_eos=False)
    finally:
        ref.stop_sync()
    eng = InferenceEngine(MODEL, params=port_params, tokenizer=ByteTokenizer(), device="cpu",
                          prefill_depth=4, **geometry)
    try:
        gate = _gate(eng, "_admit")
        reqs = [eng.submit_generate(p, max_new_tokens=8, stop_on_eos=False)
                for p in (LONG, "hi there")]
        gate.set()
        assert [r.future.result(timeout=120).token_ids for r in reqs] == want
        assert eng.prefill_steps < 9  # the long row took multi-chunk dispatches
    finally:
        eng.close()


@pytest.mark.parametrize("mega", [0, 4])
def test_dry_pool_failing_every_slot_dispatches_no_window(port_params, monkeypatch, mega):
    """A lone request outgrows a pool of three blocks of 16 mid-generation:
    it fails with the reference's error, and no window (k-step or mega) is
    dispatched once the top-up has released every slot."""
    from gofr_tpu_torch.serving import engine as engine_mod

    eng = _port(port_params, kv_block=16, kv_pool_blocks=4, mega_windows=mega)
    live_at_dispatch = []
    eager, plain_mega = eng._window_eager, engine_mod.mega_window

    def window(*a, **kw):
        live_at_dispatch.append(any(s is not None for s in eng._slots))
        return eager(*a, **kw)

    def mega_window(*a, **kw):
        live_at_dispatch.append(any(s is not None for s in eng._slots))
        return plain_mega(*a, **kw)

    monkeypatch.setattr(eng, "_window_eager", window)
    monkeypatch.setattr(engine_mod, "mega_window", mega_window)
    try:
        prompt = np.random.default_rng(4).integers(0, 256, 20).tolist()
        r = eng.submit_generate(prompt, max_new_tokens=30, stop_on_eos=False)
        with pytest.raises(RuntimeError, match="exhausted mid-generation"):
            r.future.result(timeout=120)
    finally:
        eng.close()  # joins the scheduler: the pass that failed it is over
    assert live_at_dispatch and all(live_at_dispatch)
    assert len(live_at_dispatch) == (eng.mega_dispatches if mega else eng.decode_windows)
    assert eng.kv_pool_counts() == (3, 0, 0)


def test_capture_records_launches_and_replay_counts_them():
    """Under ``recording()`` a wrapper's launch is kept for the graph, not
    counted; each replay adds the record, ``times`` over for a loop that
    ran the body that often."""
    before = (fd.launches, fp.launches)
    with _count.recording() as rec:
        _count.launched(fd.__name__)
        _count.launched(fd.__name__)
        _count.launched(fp.__name__)
    assert (fd.launches, fp.launches) == before
    assert rec == {fd.__name__: 2, fp.__name__: 1}
    _count.replayed(rec)
    _count.replayed(rec, 3)
    assert (fd.launches, fp.launches) == (before[0] + 8, before[1] + 4)
    _count.launched(fd.__name__)
    assert fd.launches == before[0] + 9


def test_spec_tokens_still_raises_naming_speculative_decoding():
    from gofr_tpu_torch.config import MockConfig

    cfg = MockConfig({"TPU_MODEL": MODEL, "TPU_DEVICE": "cpu", "TPU_SPEC_TOKENS": "2"})
    with pytest.raises(NotImplementedError, match="speculative decoding"):
        InferenceEngine.from_config(cfg)


def test_decode_loop_keys_serve_at_other_values(port_params):
    """The three reference keys build an engine at values other than the
    defaults, and it serves the reference's stream."""
    from gofr_tpu_torch.config import MockConfig

    eng = InferenceEngine.from_config(MockConfig({
        "TPU_MODEL": MODEL, "TPU_DEVICE": "cpu", "TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "128",
        "TPU_DECODE_WINDOW": "4", "TPU_PREFILL_CHUNK": "16", "TPU_PIPELINE_DEPTH": "3",
        "TPU_MEGA_WINDOWS": "2", "TPU_PREFILL_DEPTH": "4"}))
    try:
        assert (eng.pipeline_depth, eng.mega_windows, eng.prefill_depth) == (3, 2, 4)
        r = eng.generate_sync(LONG[:60], max_new_tokens=10, stop_on_eos=False)
        assert len(r.token_ids) == 10 and eng.mega_dispatches >= 1
    finally:
        eng.close()
