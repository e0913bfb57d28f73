"""The port's lock-discipline validator (``gofr_tpu_torch/analysis/lockcheck``)
against the reference's: the reference suite's twelve cases, each run on
both modules, and the port's serving locks armed with ``TPU_LOCKCHECK=1``
— an engine serving from four threads records no violation, its locks
are instrumented under the reference's names, and the window-fetch seam
is reached.

Interleavings are stated, not raced: the order graph persists for the
registry's lifetime, so the two halves of an inversion run one after the
other on their own threads.
"""

import threading

import numpy as np
import pytest

from gofr_tpu.analysis import lockcheck as ref_lockcheck
from gofr_tpu_torch.analysis import lockcheck as port_lockcheck

_PLAIN_LOCK_TYPE = type(threading.Lock())
MODULES = [ref_lockcheck, port_lockcheck]
IDS = ["reference", "port"]


@pytest.fixture(params=MODULES, ids=IDS)
def lc(request, monkeypatch):
    """The module under test, armed with a FRESH registry (the module
    global would otherwise leak one test's order graph into the next)."""
    mod = request.param
    monkeypatch.setenv("TPU_LOCKCHECK", "1")
    monkeypatch.setattr(mod, "_registry", None)
    yield mod
    monkeypatch.setattr(mod, "_registry", None)


def _run(fn):
    """Run fn on its own thread to completion (distinct thread ident)."""
    exc = []

    def wrapped():
        try:
            fn()
        except BaseException as e:  # surfaced below
            exc.append(e)

    t = threading.Thread(target=wrapped)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    if exc:
        raise exc[0]


def test_disabled_make_lock_returns_plain_lock(lc, monkeypatch):
    for off in ("0", "", "false", "no"):
        monkeypatch.setenv("TPU_LOCKCHECK", off)
        lock = lc.make_lock("Engine._submit_lock")
        assert type(lock) is _PLAIN_LOCK_TYPE
    assert lc._registry is None  # not even the registry exists
    lc.note_device_sync("window_fetch")  # one is-None test, no-op
    assert lc.violations() == []
    assert lc.order_graph() == {"enabled": False, "edges": {}, "witnesses": {}}


def test_enabled_make_lock_returns_instrumented_wrapper(lc):
    lock = lc.make_lock("Pool._lock")
    assert isinstance(lock, lc.InstrumentedLock)
    assert lock.name == "Pool._lock"
    with lock:
        assert lock.locked()
    assert not lock.locked()
    assert lc.violations() == []


def test_inversion_detected_across_sequential_threads(lc):
    a = lc.make_lock("Engine._submit_lock")
    b = lc.make_lock("Pool._lock")

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    _run(forward)
    assert lc.violations() == []  # one order alone is fine
    _run(backward)
    (v,) = lc.violations()
    assert v.kind == "order-inversion"
    assert "Engine._submit_lock" in v.message
    assert "Pool._lock" in v.message
    assert v.held == ("Pool._lock",)
    with pytest.raises(AssertionError, match="order-inversion"):
        lc.assert_clean()
    graph = lc.order_graph()
    assert graph["enabled"]
    assert graph["edges"] == {"Engine._submit_lock": ["Pool._lock"],
                              "Pool._lock": ["Engine._submit_lock"]}


def test_transitive_inversion_through_a_middle_lock(lc):
    a, b, c = lc.make_lock("A"), lc.make_lock("B"), lc.make_lock("C")

    def one():
        with a, b:
            pass

    def two():
        with b, c:
            pass

    def three():
        with c, a:
            pass

    _run(one)
    _run(two)
    assert lc.violations() == []
    _run(three)
    assert "order-inversion" in [v.kind for v in lc.violations()]


def test_consistent_global_order_stays_clean(lc):
    a, b = lc.make_lock("A"), lc.make_lock("B")
    for _ in range(3):
        _run(lambda: a.acquire() and b.acquire())
        # release from the main thread (also exercises tolerance)
        b.release()
        a.release()
    lc.assert_clean()


def test_blocking_self_reacquisition_raises_instead_of_hanging(lc):
    lock = lc.make_lock("Ledger._lock")
    with lock:
        with pytest.raises(lc.LockCheckError, match="would deadlock"):
            lock.acquire()
    assert [v.kind for v in lc.violations()] == ["self-deadlock"]


def test_nonblocking_reacquisition_just_fails_like_a_lock(lc):
    lock = lc.make_lock("Ledger._lock")
    with lock:
        assert lock.acquire(blocking=False) is False
    assert lc.violations() == []


def test_device_sync_under_lock_is_recorded(lc):
    lock = lc.make_lock("SchedulerMixin._submit_lock")
    lc.note_device_sync("decode_window_fetch")
    assert lc.violations() == []  # nothing held: fine
    with lock:
        lc.note_device_sync("decode_window_fetch")
    (v,) = lc.violations()
    assert v.kind == "device-sync-under-lock"
    assert "decode_window_fetch" in v.message
    assert v.held == ("SchedulerMixin._submit_lock",)


def test_cross_thread_release_is_tolerated(lc):
    busy = lc.make_lock("ProfilerCapture._busy")
    other = lc.make_lock("ProfilerCapture._state_lock")
    assert busy.acquire(blocking=False)
    _run(busy.release)
    with other:
        with busy:
            pass
    lc.assert_clean()


def test_reset_drops_violations_and_learned_order(lc):
    a, b = lc.make_lock("A"), lc.make_lock("B")
    _run(lambda: (a.acquire(), b.acquire(), b.release(), a.release()))
    lc.reset()
    _run(lambda: (b.acquire(), a.acquire(), a.release(), b.release()))
    lc.assert_clean()


def test_reset_keeps_preexisting_locks_connected(lc):
    a, b = lc.make_lock("A"), lc.make_lock("B")
    lc.reset()
    with a:
        lc.note_device_sync("post_reset_sync")
    assert [v.kind for v in lc.violations()] == ["device-sync-under-lock"]
    lc.reset()
    _run(lambda: (a.acquire(), b.acquire(), b.release(), a.release()))
    _run(lambda: (b.acquire(), a.acquire(), a.release(), b.release()))
    assert [v.kind for v in lc.violations()] == ["order-inversion"]


def test_assert_clean_lists_every_violation(lc):
    a, b = lc.make_lock("A"), lc.make_lock("B")
    _run(lambda: (a.acquire(), b.acquire(), b.release(), a.release()))
    _run(lambda: (b.acquire(), a.acquire(), a.release(), b.release()))
    with a:
        lc.note_device_sync("window")
    with pytest.raises(AssertionError) as err:
        lc.assert_clean()
    text = str(err.value)
    assert "order-inversion" in text and "device-sync-under-lock" in text


# ----------------------------------------------------------------------
# the port's serving locks under TPU_LOCKCHECK=1
# ----------------------------------------------------------------------


@pytest.fixture
def armed_port(monkeypatch):
    monkeypatch.setenv("TPU_LOCKCHECK", "1")
    monkeypatch.setattr(port_lockcheck, "_registry", None)
    yield port_lockcheck
    monkeypatch.setattr(port_lockcheck, "_registry", None)


def test_engine_serving_from_four_threads_records_no_violation(armed_port, monkeypatch):
    from gofr_tpu_torch.serving import engine as engine_mod
    from gofr_tpu_torch.serving.engine import InferenceEngine
    from gofr_tpu_torch.serving.prefix_cache import PrefixPool

    syncs = []
    real_note = armed_port.note_device_sync
    monkeypatch.setattr(armed_port, "note_device_sync",
                        lambda what: (syncs.append(what), real_note(what)))
    eng = InferenceEngine("llama-tiny-f32", device="cpu", n_slots=2, max_len=128,
                          window_k=4, prefill_chunk=16, kv_block=16,
                          auto_prefix=True, queue_prefix_aware=True)
    try:
        names = {
            "InferenceEngine._submit_lock": eng._submit_lock,
            "ClassPriorityQueue._lock": eng._pending._lock,
            "AggregateThroughput._lock": eng._tput._lock,
            "RadixPrefixIndex._lock": eng._radix._lock,
            "CompileTracker._lock": eng._compiles._lock,
        }
        for name, lock in names.items():
            assert isinstance(lock, armed_port.InstrumentedLock), name
            assert lock.name == name
        # The device lock is the one lock outside the validator.
        assert not isinstance(eng._device_lock, armed_port.InstrumentedLock)
        pool = PrefixPool(1, eng.cache)
        assert isinstance(pool._lock, armed_port.InstrumentedLock)
        assert pool._lock.name == "PrefixPool._lock"

        rng = np.random.default_rng(5)
        prompts = [[int(t) for t in rng.integers(1, 500, size=n)]
                   for n in (40, 7, 33, 21, 40, 12, 5, 33)]
        results, errors = {}, []

        def client(i):
            try:
                for j in range(2):
                    p = prompts[(2 * i + j) % len(prompts)]
                    results[(i, j)] = eng.generate_sync(
                        p, max_new_tokens=6, temperature=0.0, stop_on_eos=False
                    ).token_ids
            except BaseException as exc:  # surfaced below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert len(results) == 8 and all(len(v) == 6 for v in results.values())
        eng.health_check()
        armed_port.assert_clean()
        assert "decode_window_fetch" in syncs
        graph = armed_port.order_graph()
        assert graph["enabled"] and graph["edges"]  # the locks were watched
        # Positive control: an engine lock minted before a reset still
        # reports into the registry.
        armed_port.reset()
        with eng._submit_lock:
            engine_mod.lockcheck.note_device_sync("control")
        assert [v.kind for v in armed_port.violations()] == ["device-sync-under-lock"]
    finally:
        eng.close()
