"""The port's request lifecycle against the reference's: the primitives
(``Deadline`` on a fake clock, ``coalesce_deadline``, the cancel-token
latch, ``AggregateThroughput``, ``ClassPriorityQueue`` ordering and
promotion, the SLO-class rules) on both packages' classes, and the engine
scenarios of the reference's resilience tests on both engines over a
paged pool (``llama-tiny-f32``, the same weights): cancel and deadline
reaps mid-stream (slot and KV blocks freed), a request cancelled or
expired while queued never admitted, the submit-time sheds (projected
wait, an expired deadline, queue full, queue tokens, tenant cap) with the
reference's error classes, status codes and messages, and class-ordered
admission.
"""

import queue as queue_mod
import time

import jax
import numpy as np
import pytest

from gofr_tpu.errors import ErrorDeadlineExceeded as RefDeadline
from gofr_tpu.errors import ErrorRequestCancelled as RefCancelled
from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.serving import brownout as ref_brownout
from gofr_tpu.serving import lifecycle as ref_lifecycle
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu_torch.errors import ErrorDeadlineExceeded, ErrorRequestCancelled
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.serving import lifecycle
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax

MODEL = "llama-tiny-f32"
GEOMETRY = dict(n_slots=2, max_len=128, window_k=4, prefill_chunk=16, prefill_batch=2,
                kv_block=16)
LONG = 100  # a budget no scenario lets a request finish

BOTH = pytest.mark.parametrize("lc", [lifecycle, ref_lifecycle], ids=["port", "reference"])


# ----------------------------------------------------------------------
# primitives, on both packages' classes
# ----------------------------------------------------------------------


@BOTH
def test_deadline_fake_clock_and_coalesce(lc):
    now = [0.0]
    d = lc.Deadline(10.0, clock=lambda: now[0])
    assert not d.expired() and d.remaining() == 10.0
    now[0] = 10.0
    assert d.expired() and d.remaining() == 0.0
    assert lc.coalesce_deadline(d, 99.0) is d  # an explicit Deadline wins
    assert lc.coalesce_deadline(None, None) is None
    rel = lc.coalesce_deadline(None, 60.0)
    assert rel is not None and 0 < rel.remaining() <= 60.0
    assert lc.Deadline.after(5.0, clock=lambda: 100.0).expires_at == 105.0


@BOTH
def test_cancel_token_latches(lc):
    tok = lc.CancelToken()
    assert not tok.cancelled
    tok.cancel()
    tok.cancel()  # idempotent
    assert tok.cancelled


@BOTH
def test_aggregate_throughput_sliding_window(lc):
    now = [0.0]
    tput = lc.AggregateThroughput(window_s=10.0, clock=lambda: now[0])
    assert tput.rate() == 0.0
    for step in range(1, 101):  # 4 streams x 50 tok/s
        now[0] = step * 0.02
        tput.note(4)
    assert 180.0 <= tput.rate() <= 220.0
    now[0] += 11.0
    assert tput.rate() == 0.0
    tput.note(4)
    assert tput.rate() > 0
    tput.reset()
    assert tput.rate() == 0.0


class _Req:
    def __init__(self, name, slo_class):
        self.name = name
        self.slo_class = slo_class


@BOTH
def test_class_dequeue_ordering_and_promotion(lc):
    """Interactive jumps standard jumps batch, FIFO within a class; a head
    past the promotion window pops first, the oldest first; off is strict
    FIFO; unknown classes rank standard; maxsize bounds the queue."""
    now = [0.0]
    q = lc.ClassPriorityQueue(promote_after_s=10.0, clock=lambda: now[0])
    for name, cls in (("b0", "batch"), ("s0", "standard"), ("i0", "interactive"),
                      ("b1", "batch"), ("i1", "interactive"), ("s1", "standard")):
        q.put_nowait(_Req(name, cls))
        now[0] += 1.0
    assert [q.get_nowait().name for _ in range(q.qsize())] == [
        "i0", "i1", "s0", "s1", "b0", "b1"]
    with pytest.raises(queue_mod.Empty):
        q.get_nowait()

    now = [0.0]
    q = lc.ClassPriorityQueue(promote_after_s=5.0, clock=lambda: now[0])
    q.put_nowait(_Req("b0", "batch"))
    now[0] = 2.0
    q.put_nowait(_Req("s0", "standard"))
    now[0] = 8.0
    q.put_nowait(_Req("i0", "interactive"))
    assert [q.get_nowait().name for _ in range(3)] == ["b0", "s0", "i0"]

    q = lc.ClassPriorityQueue(promote_after_s=0.0)
    q.put_nowait(_Req("b", "batch"))
    q.put_nowait(_Req("i", "interactive"))
    assert [q.get_nowait().name, q.get_nowait().name] == ["b", "i"]
    q = lc.ClassPriorityQueue(promote_after_s=10.0)
    q.put_nowait(_Req("w", "weird-class"))
    q.put_nowait(_Req("i", "interactive"))
    assert [q.get_nowait().name, q.get_nowait().name] == ["i", "w"]

    q = lc.ClassPriorityQueue(maxsize=2)
    q.put_nowait(_Req("a", "standard"))
    q.put_nowait(_Req("b", "standard"))
    with pytest.raises(queue_mod.Full):
        q.put_nowait(_Req("c", "standard"))
    assert q.qsize() == 2 and not q.empty() and q.maxsize == 2


def test_slo_class_rules_equal_reference():
    for value in ("interactive", " Batch ", "STANDARD", "weird", "", None):
        assert lifecycle.normalize_slo_class(value) == ref_brownout.normalize_slo_class(value)
    for spec in ("acme=batch,ops=interactive", "ACME=Batch; x=bogus;=batch;noeq", ""):
        assert dict(lifecycle.parse_tenant_class_map(spec)) == (
            ref_brownout.parse_tenant_class_map(spec))


# ----------------------------------------------------------------------
# engine scenarios, on both engines
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return init_transformer(jax.random.PRNGKey(11), ref_get_model(MODEL).config)


@pytest.fixture(scope="module")
def port_engine(jax_params):
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             get_model(MODEL).config, device="cpu")
    eng = InferenceEngine(MODEL, params=params, tokenizer=ByteTokenizer(), device="cpu",
                          tenant_slo_class="bulk=batch", **GEOMETRY)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def ref_engine(jax_params):
    ref = RefEngine(MODEL, params=jax_params, tokenizer=RefByteTokenizer(),
                    tenant_slo_class="bulk=batch", **GEOMETRY)
    ref.start_sync()
    yield ref
    ref.stop_sync()


@pytest.fixture(params=["port", "reference"])
def eng(request, port_engine, ref_engine):
    return port_engine if request.param == "port" else ref_engine


def _lc(e):
    return lifecycle if isinstance(e, InferenceEngine) else ref_lifecycle


def _free_blocks(e):
    return e._allocator.n_free if isinstance(e, InferenceEngine) else len(e._free_blocks)


def _idle(e):
    """Wait until no request holds a slot or waits in the queue."""
    deadline = time.time() + 30
    while time.time() < deadline:
        if (all(s is None for s in e._slots) and not e._prefilling
                and e._pending.qsize() == 0):
            return True
        time.sleep(0.01)
    return False


def _drain(req, timeout=60):
    toks = []
    while (tok := req.stream.get(timeout=timeout)) is not None:
        toks.append(tok)
    return toks


def _errors(e):
    return ((ErrorDeadlineExceeded, ErrorRequestCancelled) if isinstance(e, InferenceEngine)
            else (RefDeadline, RefCancelled))


def _long(e, prompt="occupant", **kw):
    return e.submit_generate(prompt, max_new_tokens=LONG, stop_on_eos=False, **kw)


class _Occupied:
    """Both slots held by long requests, so whatever is submitted inside
    stays queued; on exit the occupants are cancelled and the engine
    drains back to idle."""

    def __init__(self, e):
        self.e = e

    def __enter__(self):
        self.held = [_long(self.e, f"occupant {i}") for i in range(2)]
        for r in self.held:
            assert r.stream.get(timeout=60) is not None  # admitted, decoding
        return self

    def __exit__(self, *exc):
        for r in self.held:
            r.cancel.cancel()
            _drain(r)
        assert _idle(self.e)


def test_cancel_mid_stream_frees_slot_and_blocks(eng):
    assert _idle(eng)
    free0 = _free_blocks(eng)
    req = _long(eng)
    assert req.stream.get(timeout=60) is not None
    req.cancel.cancel()
    toks = _drain(req)
    with pytest.raises(_errors(eng)[1]):
        req.future.result(timeout=30)
    assert len(toks) + 1 < LONG
    assert _idle(eng) and _free_blocks(eng) == free0
    if isinstance(eng, InferenceEngine):
        assert eng.kv_pool_counts() == (16, 0, 0)


def test_shared_cancel_token_disconnect(eng):
    """The transport's token is the object the engine reaps on."""
    token = _lc(eng).CancelToken()
    req = _long(eng, cancel=token)
    assert req.cancel is token
    assert req.stream.get(timeout=60) is not None
    token.cancel()
    _drain(req)
    with pytest.raises(_errors(eng)[1]):
        req.future.result(timeout=30)
    assert _idle(eng)


def test_queued_cancelled_request_never_admitted(eng):
    with _Occupied(eng):
        req = eng.submit_generate("never runs", max_new_tokens=50, stop_on_eos=False)
        req.cancel.cancel()
    assert _drain(req) == []
    with pytest.raises(_errors(eng)[1]):
        req.future.result(timeout=30)
    assert req.token_ids == []


def test_deadline_exceeded_mid_stream(eng):
    assert _idle(eng)
    free0 = _free_blocks(eng)
    now = [0.0]
    req = _long(eng, deadline=_lc(eng).Deadline(3600.0, clock=lambda: now[0]))
    assert req.stream.get(timeout=60) is not None
    now[0] = 7200.0  # the clock statement that expires the deadline
    _drain(req)
    with pytest.raises(_errors(eng)[0], match=r"after \d+ generated token"):
        req.future.result(timeout=30)
    assert 1 <= len(req.token_ids) < LONG
    assert _idle(eng) and _free_blocks(eng) == free0


def test_deadline_expired_while_queued_never_admitted(eng):
    now = [0.0]
    with _Occupied(eng):
        req = eng.submit_generate("late", max_new_tokens=8,
                                  deadline=_lc(eng).Deadline(3600.0, clock=lambda: now[0]))
        now[0] = 7200.0
    assert _drain(req) == []
    with pytest.raises(_errors(eng)[0], match="after 0 generated token"):
        req.future.result(timeout=30)


def test_projected_wait_and_expired_deadline_shed_at_submit(eng):
    old = eng._expected_tps
    eng._expected_tps = 1.0  # 1 tok/s: this request "takes" ~60 s
    try:
        with pytest.raises(_errors(eng)[0], match="projected queue wait") as exc:
            eng.submit_generate("too slow for this deadline", max_new_tokens=40,
                                deadline_s=1.0)
        assert exc.value.status_code == 504
    finally:
        eng._expected_tps = old
    now = [100.0]
    with pytest.raises(_errors(eng)[0]):
        eng.submit_generate("late", max_new_tokens=4,
                            deadline=_lc(eng).Deadline(50.0, clock=lambda: now[0]))
    if isinstance(eng, InferenceEngine):
        assert eng.shed_counts["deadline"] >= 2


def _shed(e, prompt, **kw):
    with pytest.raises(Exception) as info:
        e.submit_generate(prompt, **kw)
    err = info.value
    assert type(err).__name__ == "ErrorTooManyRequests"
    assert err.status_code == 429 and int(err.headers["Retry-After"]) >= 1
    return str(err).split("; retry after")[0]


def test_queue_full_and_queue_tokens_shed_like_reference(port_engine, ref_engine):
    """With the slots held, one queued request fills a queue of one and
    a second sheds; a 40-token budget takes one 30-token request and
    sheds the next — the same messages from both engines."""
    messages = []
    for e in (port_engine, ref_engine):
        with _Occupied(e):
            old_max = e._pending.maxsize
            e._pending.maxsize = 1
            try:
                queued = e.submit_generate("a" * 9, max_new_tokens=20)
                full = _shed(e, "b" * 9, max_new_tokens=20)
            finally:
                e._pending.maxsize = old_max
            e.queue_max_tokens = 40
            try:
                tokens = _shed(e, "c" * 9, max_new_tokens=20)
            finally:
                e.queue_max_tokens = 0
            queued.cancel.cancel()
        messages.append((full, tokens))
    assert messages[0] == messages[1]
    assert "submit queue full (1 requests" in messages[0][0]
    assert "(30 queued + 30 requested > 40" in messages[0][1]
    assert port_engine.shed_counts["queue_full"] >= 1
    assert port_engine.shed_counts["queue_tokens"] >= 1


def test_tenant_cap_sheds_per_tenant_like_reference(port_engine, ref_engine):
    messages = []
    for e in (port_engine, ref_engine):
        e.tenant_queue_max = 2
        try:
            with _Occupied(e):
                reqs = [e.submit_generate("t", max_new_tokens=4, tenant="acme")
                        for _ in range(2)]
                messages.append(_shed(e, "t again", max_new_tokens=4, tenant="acme"))
                reqs.append(e.submit_generate("other", max_new_tokens=4, tenant="globex"))
                reqs.append(e.submit_generate("none", max_new_tokens=4))
                for r in reqs:
                    r.cancel.cancel()
        finally:
            e.tenant_queue_max = 0
        assert e._tenant_queued == {}
    assert messages[0] == messages[1]
    assert "tenant 'acme' has 2 queued request(s)" in messages[0]
    assert port_engine.shed_counts["tenant_quota"] >= 1


def test_class_ordered_admission(eng):
    """Queued behind held slots: a batch request (the tenant's default
    class) submitted first is admitted after a standard and an
    interactive one submitted later."""
    with _Occupied(eng) as occ:
        reqs = {
            "batch": eng.submit_generate("b", max_new_tokens=4, stop_on_eos=False,
                                         tenant="Bulk"),
            "standard": eng.submit_generate("s", max_new_tokens=4, stop_on_eos=False),
            "interactive": eng.submit_generate("i", max_new_tokens=4, stop_on_eos=False,
                                               slo_class="Interactive"),
        }
        assert reqs["batch"].slo_class == "batch"
        for r in occ.held:  # free both slots in one pass
            r.cancel.cancel()
        results = {k: r.future.result(timeout=60) for k, r in reqs.items()}
    first = {k: r.enqueued_at + r.ttft_s for k, r in reqs.items()}
    assert first["batch"] > max(first["standard"], first["interactive"])
    for res in results.values():
        assert len(res.token_ids) == 4
