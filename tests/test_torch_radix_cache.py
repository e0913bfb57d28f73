"""The port's radix prefix cache against the reference's.

* A differential fuzz: one seeded sequence of ``lookup`` / ``peek`` /
  ``insert`` / ``evict`` / ``purge_aid`` / ``clear`` and of the caller's
  own allocations and releases drives the reference's ``RadixPrefixIndex``
  + ``BlockAllocator`` and the port's together; every return value, every
  refcount and the free list (in order) agree after every step.
* Engines on the same ``llama-tiny-f32`` weights (``init_transformer`` →
  ``params_from_jax``) at the reference's test geometry
  (``tests/test_radix_cache.py``: 4 slots, max_len 256, k 4, chunk 32,
  blocks of 32, ``auto_prefix``), at pipeline depth 1 and again at depth 2
  with prefill depth 3: greedy and seeded warm hits, the whole-prompt hit
  that copies the boundary block on write, and a hit followed by
  multi-chunk prefill; a warm hit at G = 2 (speculative decoding); on a
  2-slot engine with 8 usable blocks: pool pressure, the eviction
  watermark and prefix-aware admission order. Greedy token ids are
  identical to the reference engine's (logprobs within 1e-5, the port's
  f32 engine tolerance; the packages draw sampling noise from different
  generators, so a seeded sampled stream is held warm against cold within
  each), warm streams equal cold ones, the ``_prefix_lookups`` /
  ``_prefix_hit_tokens`` counters equal the reference's, and the block
  invariant (every pool block free or held by exactly its tables plus the
  index) holds after every case.
"""

import random
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from gofr_tpu.container.container import Container as RefContainer
from gofr_tpu.metrics import new_metrics_manager as ref_new_metrics_manager
from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.ops.kv_cache import BlockAllocator as RefAllocator
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.lifecycle import ClassPriorityQueue as RefQueue
from gofr_tpu.serving.radix_cache import RadixPrefixIndex as RefIndex
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.metrics import new_metrics_manager
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.ops.kv_cache import BlockAllocator
from gofr_tpu_torch.serving import engine as engine_mod
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.lifecycle import ClassPriorityQueue
from gofr_tpu_torch.serving.radix_cache import RadixPrefixIndex
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax

MODEL = "llama-tiny-f32"
LOGPROB_TOL = 1e-5
# The reference's engine geometry (tests/test_radix_cache.py::_ENGINE_KW).
GEOMETRY = dict(n_slots=4, max_len=256, window_k=4, prefill_chunk=32, kv_block=32,
                auto_prefix=True)
# Its pressure / watermark geometry: 2 slots, 8 usable blocks.
SMALL = dict(n_slots=2, max_len=128, window_k=4, prefill_chunk=32, kv_block=32,
             kv_pool_blocks=9, auto_prefix=True, queue_prefix_aware=True)
PREAMBLE = list(range(10, 80))  # 70 tokens: 2 full blocks and a tail
GREEDY = dict(max_new_tokens=6, temperature=0.0, stop_on_eos=False, timeout=120)


# -- the index, differentially --------------------------------------------

def _state(alloc, idx):
    return ([alloc.refcount(b) for b in range(alloc.n_blocks)], list(alloc.free_blocks),
            idx.n_cached_blocks, sorted(idx.cached_block_ids()))


@pytest.mark.parametrize("max_blocks", [0, 6], ids=["pool-bounded", "cap 6"])
def test_index_differential_fuzz(max_blocks):
    """600 seeded steps over both (allocator, index) pairs: prompts share
    prefixes (a few bases of 3 blocks of 4 tokens, tails over 3 letters),
    two adapter slots, a caller that aliases what it looks up, grows rows
    from the free list (evicting one block when it is dry), retires rows
    into the index and drops its non-adopted references."""
    rng = random.Random(max_blocks + 7)
    B, n_blocks = 4, 28
    sides = []
    for alloc_cls, idx_cls in ((RefAllocator, RefIndex), (BlockAllocator, RadixPrefixIndex)):
        alloc = alloc_cls(n_blocks)
        sides.append((alloc, idx_cls(B, alloc, max_blocks=max_blocks)))
    bases = [[rng.randrange(3) for _ in range(12)] for _ in range(4)]
    rows: list = []  # (ids, aid, blocks): identical on both sides
    counts = dict.fromkeys(("lookup", "insert", "evict", "adopted", "grow_evict"), 0)

    def both(fn):
        out = [fn(alloc, idx) for alloc, idx in sides]
        assert out[0] == out[1]
        return out[0]

    for step in range(600):
        op = rng.choices(["admit", "retire", "peek", "evict", "drop", "purge", "clear"],
                         weights=[30, 25, 10, 10, 8, 2, 1])[0]
        ids = rng.choice(bases)[: rng.choice([4, 8, 12])] + [
            rng.randrange(3) for _ in range(rng.randrange(10))]
        aid = rng.choice([0, 0, 0, 1])
        if op == "admit" and len(rows) < 6:
            blocks, matched = both(lambda a, i: i.lookup(ids, aid))
            counts["lookup"] += bool(blocks)
            assert matched == len(blocks) * B
            row = list(blocks)
            ok = True
            while len(row) < len(ids) // B + 1:
                bid = both(lambda a, i: a.alloc())
                if bid is None:
                    counts["grow_evict"] += both(lambda a, i: i.evict(1))
                    bid = both(lambda a, i: a.alloc())
                if bid is None:
                    ok = False
                    break
                row.append(bid)
            if ok:
                rows.append((ids, aid, row))
            else:
                for bid in row:
                    both(lambda a, i: a.decref(bid))
        elif op == "retire" and rows:
            r_ids, r_aid, row = rows.pop(rng.randrange(len(rows)))
            n_full = len(r_ids) // B
            flags = both(lambda a, i: i.insert(r_ids, row[:n_full], r_aid))
            counts["insert"] += 1
            counts["adopted"] += sum(flags)
            for j, bid in enumerate(row):
                if not (j < len(flags) and flags[j]):
                    both(lambda a, i: a.decref(bid))
        elif op == "peek":
            both(lambda a, i: i.peek(ids, aid))
        elif op == "evict":
            n = rng.randint(1, 4)
            counts["evict"] += both(lambda a, i: i.evict(n))
        elif op == "drop":  # a lookup whose references the caller gives back
            blocks, _ = both(lambda a, i: i.lookup(ids, aid))
            for bid in blocks:
                both(lambda a, i: a.decref(bid))
        elif op == "purge":
            both(lambda a, i: i.purge_aid(aid))
        elif op == "clear":
            both(lambda a, i: i.clear())
        both(_state)
    # The walk reached every path it means to.
    assert counts["lookup"] > 20 and counts["adopted"] > 20 and counts["evict"] > 0
    assert counts["grow_evict"] > 0
    # With nothing held, every block is free or cached.
    for _, _, row in rows:
        for bid in row:
            both(lambda a, i: a.decref(bid))
    alloc, idx = sides[1]
    assert alloc.n_free + idx.n_cached_blocks == n_blocks - 1
    assert idx.evicted >= counts["evict"] + counts["grow_evict"]


def test_prefix_probe_pop_order_equals_reference():
    """The admission queue's prefix-aware tie-break on both packages'
    queues, one clock: a hit pops ahead of its class's earlier misses,
    only within the first PREFIX_SCAN entries, never ahead of a promoted
    (over-age) head, and a probe that raises counts as a miss."""
    def probe(req):
        if req.hit is None:
            raise RuntimeError("probe fault")
        return req.hit

    orders = []
    for cls in (RefQueue, ClassPriorityQueue):
        now = [0.0]
        q = cls(maxsize=64, promote_after_s=5.0, clock=lambda: now[0], prefix_probe=probe)
        reqs = [SimpleNamespace(name=f"s{i}", slo_class="standard", hit=(i in (3, 20)))
                for i in range(22)]
        reqs.insert(1, SimpleNamespace(name="x", slo_class="standard", hit=None))
        reqs += [SimpleNamespace(name="b0", slo_class="batch", hit=False),
                 SimpleNamespace(name="b1", slo_class="batch", hit=True)]
        for r in reqs:
            q.put_nowait(r)
        out = [q.get_nowait().name for _ in range(3)]
        now[0] = 6.0  # every head is now over age: the oldest pops, in order
        out += [q.get_nowait().name for _ in range(q.qsize())]
        orders.append(out)
    assert orders[0] == orders[1]
    assert orders[1][:3] == ["s3", "s0", "x"]


# -- engines ----------------------------------------------------------------

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


def _pair(jax_params, port_params, **kw):
    ref = RefEngine(MODEL, params=jax_params, tokenizer=RefByteTokenizer(),
                    metrics=_metrics(RefContainer, ref_new_metrics_manager), **kw)
    ref.start_sync()
    port = InferenceEngine(MODEL, params=port_params, tokenizer=ByteTokenizer(),
                           device="cpu", metrics=_metrics(Container, new_metrics_manager),
                           **kw)
    return ref, port


@pytest.fixture(scope="module", params=[dict(pipeline_depth=1),
                                        dict(pipeline_depth=2, prefill_depth=3)],
                ids=["depth 1", "depth 2, prefill depth 3"])
def pair(request, jax_params, port_params):
    ref, port = _pair(jax_params, port_params, **GEOMETRY, **request.param)
    yield ref, port
    ref.stop_sync()
    port.close()


@pytest.fixture(scope="module", params=[1, 2], ids=["depth 1", "depth 2"])
def small_pair(request, jax_params, port_params):
    ref, port = _pair(jax_params, port_params, **SMALL, pipeline_depth=request.param)
    yield ref, port
    ref.stop_sync()
    port.close()


def _wait_idle(eng, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if (all(s is None for s in eng._slots) and not eng._prefilling
                and eng._pending.empty()):
            return
        time.sleep(0.01)
    raise AssertionError("engine did not go idle")


def _invariant(eng):
    """Every pool block is free, or held by exactly its slot tables plus
    the radix index (the reference's _engine_block_invariant)."""
    _wait_idle(eng)
    refs: dict[int, int] = {}
    for row in eng._slot_blocks:
        for bid in row:
            refs[bid] = refs.get(bid, 0) + 1
    for bid in eng._radix.cached_block_ids():
        refs[bid] = refs.get(bid, 0) + 1
    alloc = eng._allocator
    free = set(alloc.free_blocks)
    assert len(free) == len(alloc.free_blocks)
    for bid in range(1, alloc.n_blocks):
        assert alloc.refcount(bid) == refs.get(bid, 0), bid
        assert (bid in free) == (refs.get(bid, 0) == 0), bid


def _same(got, want):
    assert got.token_ids == want.token_ids
    np.testing.assert_allclose(got.token_logprobs, want.token_logprobs, atol=LOGPROB_TOL)


def _run(pair, prompts, **kw):
    """Each prompt through both engines in turn (sequential: admission sees
    the same cache on both); returns (reference results, port results)."""
    out = ([], [])
    for p in prompts:
        for side, eng in zip(out, pair):
            side.append(eng.generate_sync(p, **{**GREEDY, **kw}))
            _wait_idle(eng)
    return out


def _clear(pair):
    for eng in pair:
        _wait_idle(eng)
        eng._radix.clear()


def _counters_equal(pair, lookups=True):
    """The counters and the cached block count equal the reference's
    (``lookups=False`` where a dry pool deferred admissions: each deferral
    walks the index again, as many times as the scheduler's timing
    takes), and the block invariant holds on both."""
    ref, port = pair
    assert port._prefix_hit_tokens == ref._prefix_hit_tokens
    if lookups:
        assert port._prefix_lookups == ref._prefix_lookups
    assert port._radix.n_cached_blocks == ref._radix.n_cached_blocks
    _invariant(port)
    _invariant(ref)


def test_warm_greedy_hit_skips_chunks_and_equals_cold(pair):
    """The reference's warm-hit case: 64 tokens aliased, strictly fewer
    prefill dispatches, the warm stream equal to a cold run of the same
    prompt, both equal to the reference engine's."""
    ref, port = pair
    _clear(pair)
    hit0 = port._prefix_hit_tokens
    s0 = port.prefill_steps
    want, got = _run(pair, [PREAMBLE + [100, 101, 102]])
    cold_steps = port.prefill_steps - s0
    assert port._radix.n_cached_blocks == 2 and port._prefix_hit_tokens == hit0
    s1 = port.prefill_steps
    w_warm, g_warm = _run(pair, [PREAMBLE + [120, 121, 122]])
    assert port._prefix_hit_tokens - hit0 == 64
    assert port.prefill_steps - s1 < cold_steps
    _counters_equal(pair)
    _clear(pair)
    w_cold, g_cold = _run(pair, [PREAMBLE + [120, 121, 122]])
    assert g_warm[0].token_ids == g_cold[0].token_ids
    for g, w in zip(got + g_warm + g_cold, want + w_warm + w_cold):
        _same(g, w)
    _counters_equal(pair)


def test_whole_prompt_hit_copies_the_boundary_block(pair, monkeypatch):
    """A prompt of exactly two blocks, twice: the second aliases 63 tokens,
    copies the boundary block on write (once), and the copy is not indexed
    again (2 cached blocks)."""
    copies = []
    real = engine_mod.paged_copy_block
    monkeypatch.setattr(engine_mod, "paged_copy_block",
                        lambda cache, src, dst: (copies.append((src, dst)), real(cache, src, dst)))
    ref, port = pair
    _clear(pair)
    prompt = list(range(5, 69))  # 64 tokens
    hit0 = port._prefix_hit_tokens
    want, got = _run(pair, [prompt, prompt])
    assert port._prefix_hit_tokens - hit0 == 63
    assert len(copies) == 1 and copies[0][0] != copies[0][1]
    assert got[1].token_ids == got[0].token_ids
    assert port._radix.n_cached_blocks == 2
    for g, w in zip(got, want):
        _same(g, w)
    _counters_equal(pair)


def test_seeded_sampled_warm_hit_equals_cold(pair):
    """A seeded sampled prompt, cold then as a whole-prompt hit: the warm
    stream equals the cold one on each engine (the two packages draw
    their noise from different generators, so sampled streams are held
    within each)."""
    _clear(pair)
    prompt = list(range(30, 100))  # 70 tokens; the second run is a whole-prompt hit
    want, got = _run(pair, [prompt, prompt], temperature=0.9, seed=1234)
    assert got[1].token_ids == got[0].token_ids
    assert want[1].token_ids == want[0].token_ids
    np.testing.assert_allclose(got[1].token_logprobs, got[0].token_logprobs,
                               atol=LOGPROB_TOL)
    _counters_equal(pair)


def test_hit_then_multi_chunk_prefill(pair, monkeypatch):
    """A 200-token prompt over a cached 64-token prefix: the prefill starts
    at 64, a block multiple that is no chunk multiple of the depth-3
    engine's multi-chunk dispatch, which then takes its chunks."""
    multi = []
    real = engine_mod.prefill_multi_chunk
    monkeypatch.setattr(engine_mod, "prefill_multi_chunk",
                        lambda *a, **k: (multi.append(1), real(*a, **k)))
    ref, port = pair
    _clear(pair)
    tail = [int(t) for t in np.random.default_rng(3).integers(0, 256, 130)]
    prompt = PREAMBLE + tail
    want, got = _run(pair, [PREAMBLE + [7, 7], prompt])
    assert bool(multi) == (port.prefill_depth > 1)
    _clear(pair)
    w_cold, g_cold = _run(pair, [prompt])
    assert got[1].token_ids == g_cold[0].token_ids
    for g, w in zip(got + g_cold, want + w_cold):
        _same(g, w)
    _counters_equal(pair)


_PREFIX_METRICS = ("app_tpu_prefix_lookup_total", "app_tpu_prefix_hit_tokens_total",
                   "app_tpu_prefix_cached_blocks")


def _observed(eng):
    """The prefix instruments' series and health's prefix_cache block."""
    inst = {i.name: i for i in eng._metrics.instruments()}
    return ({n: dict(inst[n].collect()) for n in _PREFIX_METRICS},
            eng.health_check()["details"]["prefix_cache"])


def test_metrics_and_health_report_the_cache(pair):
    """A miss then a 64-token hit: the lookup counter (result=hit|miss),
    the hit-token counter, the cached-blocks gauge and health's
    prefix_cache block move as the reference's do."""
    _clear(pair)
    before = [_observed(e) for e in pair]
    _run(pair, [PREAMBLE + [1, 2], PREAMBLE + [3, 4]])
    after = [_observed(e) for e in pair]
    moved = []
    for (m0, h0), (m1, h1) in zip(before, after):
        moved.append((
            {n: {ls: v - m0[n].get(ls, 0.0) for ls, v in m1[n].items()}
             for n in _PREFIX_METRICS[:2]},
            m1["app_tpu_prefix_cached_blocks"],
            {k: h1[k] - h0[k] for k in ("lookups", "hit_tokens")}, h1["cached_blocks"]))
    assert moved[1] == moved[0]
    model = (("model", MODEL),)
    counters, gauge, health, cached = moved[1]
    assert counters["app_tpu_prefix_lookup_total"] == {
        model + (("result", "hit"),): 1.0, model + (("result", "miss"),): 1.0}
    assert counters["app_tpu_prefix_hit_tokens_total"] == {model: 64.0}
    assert gauge == {model: 2.0} and cached == 2
    assert health == {"lookups": 2, "hit_tokens": 64}


def test_request_reaped_mid_prefill_is_not_indexed(pair):
    """Only a request that finished its prefill is indexed: a 200-token
    prompt cancelled after its first chunk (its blocks hold a partial
    prefill) releases every block and leaves the index as it was."""
    port = pair[1]
    _clear(pair)
    prefill, seen = port._prefill_step, []

    def cancel_after_first(*a, **k):
        if seen:  # no further chunk: the next pass reaps it mid-prefill
            return False
        out = prefill(*a, **k)
        if out:
            seen.append(1)
            req.cancel_request()
        return out

    port._prefill_step = cancel_after_first
    try:
        req = port.submit_generate(PREAMBLE * 3, max_new_tokens=4, stop_on_eos=False)
        with pytest.raises(Exception):
            req.future.result(timeout=60)
        _wait_idle(port)
    finally:
        del port._prefill_step
    assert seen and port._radix.n_cached_blocks == 0
    assert port.kv_pool_counts()[1] == 0
    _invariant(port)


def test_stop_with_requests_in_flight_then_restart(port_params):
    """A hard stop fails the requests in flight; their table rows go back
    to the pool (a row must be empty when admission aliases cached blocks
    into it from position 0), the index keeps its blocks, and after a
    restart a warm request still equals a cold one."""
    eng = InferenceEngine(MODEL, params=port_params, tokenizer=ByteTokenizer(),
                          device="cpu", **GEOMETRY)
    try:
        cold = eng.generate_sync(PREAMBLE + [5], **GREEDY)
        reqs = [eng.submit_generate([40 + i] + PREAMBLE, max_new_tokens=200,
                                    stop_on_eos=False) for i in range(4)]
        while not any(eng._slots):
            time.sleep(0.001)
        eng.stop_sync()
        assert all(r.future.done() for r in reqs)
        assert all(row == [] for row in eng._slot_blocks)
        _invariant(eng)
        eng.start_sync()
        for _ in range(2):  # every slot once: rows come back empty
            warm = [eng.submit_generate(PREAMBLE + [5], max_new_tokens=6,
                                        stop_on_eos=False) for _ in range(4)]
            for w in warm:
                assert w.future.result(timeout=120).token_ids == cold.token_ids
        _invariant(eng)
    finally:
        eng.close()


def test_warm_hit_at_two_drafts(jax_params, port_params):
    """Speculative decoding (G = 2) over a hit: the prefill skips the
    cached blocks (the history plane keeps the slot's old tokens there),
    the exact verify keeps the stream the cold one and the reference's."""
    pair = _pair(jax_params, port_params, **GEOMETRY, spec_tokens=2)
    try:
        want, got = _run(pair, [PREAMBLE + [100, 101], PREAMBLE + [120, 121]])
        _clear(pair)
        w_cold, g_cold = _run(pair, [PREAMBLE + [120, 121]])
        assert pair[1]._prefix_hit_tokens == 64
        assert got[1].token_ids == g_cold[0].token_ids
        for g, w in zip(got + g_cold, want + w_cold):
            _same(g, w)
        _counters_equal(pair)
    finally:
        pair[0].stop_sync()
        pair[1].close()


def test_pool_pressure_evicts_cached_blocks_not_requests(small_pair):
    """The reference's pressure case, heavier: 6 requests at once on 2
    slots and 8 usable blocks, each prompt 2 full blocks and a tail (3
    retirements cache 6 blocks while 2 live rows hold 3 each), so cached
    prefixes must yield to admissions; nothing fails and nothing leaks."""
    outs = []
    for eng in small_pair:
        _wait_idle(eng)
        eng._radix.clear()
        reqs = [eng.submit_generate([200 + i] + list(range(70)), max_new_tokens=3,
                                    temperature=0.0, stop_on_eos=False) for i in range(6)]
        outs.append([r.future.result(timeout=180) for r in reqs])
        _wait_idle(eng)
        assert eng._allocator.n_free + eng._radix.n_cached_blocks == 8
    for g, w in zip(outs[1], outs[0]):
        assert len(g.token_ids) == 3
        _same(g, w)
    _counters_equal(small_pair, lookups=False)
    assert small_pair[1]._radix.evicted > 0


def test_eviction_watermark_sweeps_ahead_of_admission(small_pair):
    """``prefix_evict_watermark``: the loop trims LRU cached blocks until
    the watermark's blocks are free (set on both engines here; the loop
    reads it each pass)."""
    for eng in small_pair:
        _wait_idle(eng)
        eng._radix.clear()
        eng.effective_evict_watermark = 5
    try:
        want, got = _run(small_pair, [[base] + list(range(60)) for base in (300, 400)],
                         max_new_tokens=2)
        for eng in small_pair:
            deadline = time.monotonic() + 10
            while eng._allocator.n_free < 5 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert eng._allocator.n_free >= 5
        for g, w in zip(got, want):
            _same(g, w)
        _counters_equal(small_pair)
    finally:
        for eng in small_pair:
            eng.effective_evict_watermark = 0


def _held(eng, method):
    """Hold ``eng``'s scheduler at its next call of ``method`` until the
    returned event is set (the method then runs as usual)."""
    gate = threading.Event()
    real = getattr(eng, method)

    def wait_then_run(*a, **k):
        gate.wait(30)
        return real(*a, **k)

    setattr(eng, method, wait_then_run)
    return gate


def test_prefix_aware_admission_pops_the_hit_first(small_pair):
    """With ``queue_prefix_aware`` a queued request whose prompt hits the
    cache is admitted ahead of earlier misses of its class: B, C (misses)
    then D (a hit) on 2 slots admit D and B together and C last, on both
    engines."""
    for eng in small_pair:
        _wait_idle(eng)
        eng._radix.clear()
    _run(small_pair, [PREAMBLE])  # caches 2 blocks
    order = []
    for eng, method in zip(small_pair, ("_dispatch_prefill_chunk", "_admit")):
        gate = _held(eng, method)
        time.sleep(0.05)
        reqs = [eng.submit_generate(p, max_new_tokens=3, temperature=0.0, stop_on_eos=False)
                for p in ([150 + i for i in range(35)], [190 + i for i in range(35)],
                          PREAMBLE[:64] + [9, 9, 9])]
        gate.set()
        res = [r.future.result(timeout=120) for r in reqs]
        delattr(eng, method)
        _wait_idle(eng)
        order.append(sorted(range(3), key=lambda i: res[i].ttft_s))
    assert order[0] == order[1]
    assert order[1][-1] == 1  # C, the second miss, waited for a slot
    _counters_equal(small_pair)
