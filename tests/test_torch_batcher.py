"""The port's dynamic batcher (``gofr_tpu_torch/serving/batcher.py``)
against the reference's (``gofr_tpu/serving/batcher.py``): ``pad_bucket``,
the size and deadline flushes, results in order, a failing flush failing
every future of it, and the bounded queue's shed — a 429 whose
``Retry-After`` grows with the backlog and the measured flush time — with
the reference's metrics. Each scenario runs on both packages' batchers and
their observables are held equal, but for the two deliberate differences,
held apart: under a backlog (each flush longer than ``max_wait_s``) the
port's flushes take what is queued, up to ``max_batch``, where the
reference's take one request each; and a stopped batcher starts again.
"""

from __future__ import annotations

import threading
import time

import pytest

from gofr_tpu.errors import ErrorTooManyRequests as RefTooMany
from gofr_tpu.serving import batcher as ref_batcher
from gofr_tpu_torch.errors import ErrorTooManyRequests
from gofr_tpu_torch.serving import batcher

PACKAGES = {"port": (batcher, ErrorTooManyRequests), "reference": (ref_batcher, RefTooMany)}


class _Metrics:
    """Records the batcher's metric calls."""

    def __init__(self):
        self.calls = []

    def increment_counter(self, name, *labels):
        self.calls.append(("counter", name, labels))

    def set_gauge(self, name, value, *labels):
        self.calls.append(("gauge", name, labels))

    def record_histogram(self, name, value, *labels):
        self.calls.append(("histogram", name, value, labels))


@pytest.mark.parametrize("n", [0, 1, 16, 17, 100, 4096, 5000])
def test_pad_bucket_matches_the_reference(n):
    buckets = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
    assert batcher.pad_bucket(n, buckets) == ref_batcher.pad_bucket(n, buckets)


def _size_then_deadline(mod):
    batches = []

    def execute(payloads):
        batches.append(list(payloads))
        return [p * 2 for p in payloads]

    metrics = _Metrics()
    b = mod.DynamicBatcher(execute, max_batch=4, max_wait_s=0.05, metrics=metrics, name="t")
    futures = [b.submit(i) for i in range(6)]  # queued before the worker starts
    b.start()
    try:
        results = [f.result(timeout=10) for f in futures]
        late = b.submit(10).result(timeout=10)
    finally:
        b.stop()
    sizes = [h[2] for h in metrics.calls if h[0] == "histogram"]
    return results, late, [len(x) for x in batches], batches, sizes


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_flush_by_size_then_deadline_in_order(pkg):
    """6 queued before the worker starts: one size flush of 4, then a
    deadline flush of the 2 left, then a lone late request flushed by its
    deadline; results in submission order; app_tpu_batch_size per flush."""
    results, late, sizes, batches, hist = _size_then_deadline(PACKAGES[pkg][0])
    assert results == [0, 2, 4, 6, 8, 10] and late == 20
    assert sizes == [4, 2, 1] and hist == [4, 2, 1]
    assert batches == [[0, 1, 2, 3], [4, 5], [10]]


def test_flushes_equal_the_reference():
    assert _size_then_deadline(batcher) == _size_then_deadline(ref_batcher)


def test_a_deadline_flush_waits_for_the_oldest_request():
    """A lone request waits out max_wait_s (not longer than a few times
    it) before its flush."""
    out = {}
    for pkg, (mod, _) in PACKAGES.items():
        b = mod.DynamicBatcher(lambda xs: xs, max_batch=8, max_wait_s=0.2)
        b.start()
        try:
            t0 = time.monotonic()
            assert b.submit("x").result(timeout=10) == "x"
            out[pkg] = time.monotonic() - t0
        finally:
            b.stop()
    for pkg, waited in out.items():
        assert 0.15 <= waited < 2.0, (pkg, waited)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_a_failing_flush_fails_every_future_of_it(pkg):
    mod = PACKAGES[pkg][0]
    gate = threading.Event()

    def execute(payloads):
        gate.wait(5)
        if 3 in payloads:
            raise RuntimeError("device on fire")
        return payloads

    # A deadline no scheduling delay reaches: the first flush is by size on
    # both packages (at 0.01 s the reference's worker, reaching the queue
    # late on a loaded host, flushed [0] alone by its deadline).
    b = mod.DynamicBatcher(execute, max_batch=4, max_wait_s=0.5)
    futures = [b.submit(i) for i in range(6)]  # [0..3] fails, [4, 5] does not
    b.start()
    gate.set()
    try:
        for f in futures[:4]:
            with pytest.raises(RuntimeError, match="device on fire"):
                f.result(timeout=10)
        assert [f.result(timeout=10) for f in futures[4:]] == [4, 5]
    finally:
        b.stop()


def _shed(mod, err_type, flush_s: float):
    """A queue of 4 filled behind one slow flush: the fifth submit sheds.
    Returns the Retry-After seconds, the message and the metric calls."""
    release = threading.Event()
    started = threading.Event()

    def execute(payloads):
        started.set()
        time.sleep(flush_s)
        release.wait(10)
        return payloads

    metrics = _Metrics()
    b = mod.DynamicBatcher(execute, max_batch=2, max_wait_s=0.001, metrics=metrics,
                           name="embed", max_queue=4)
    b.start()
    try:
        first = b.submit("a")
        assert started.wait(10)
        for i in range(4):
            b.submit(i)
        with pytest.raises(err_type) as err:
            b.submit("shed")
        release.set()
        assert first.result(timeout=10) == "a"
    finally:
        release.set()
        b.stop()
    sheds = [c for c in metrics.calls if c[0] == "counter"]
    return err.value, sheds


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_a_full_queue_sheds_429_with_retry_after(pkg):
    """The shed is a 429 with a Retry-After of at least 1 s, counted as
    app_tpu_requests_shed_total{model, reason="queue_full"}."""
    mod, err_type = PACKAGES[pkg]
    exc, sheds = _shed(mod, err_type, 0.0)
    assert exc.status_code == 429
    assert int(exc.headers["Retry-After"]) >= 1
    assert "embed batch queue full (4 pending)" in str(exc)
    assert sheds == [("counter", "app_tpu_requests_shed_total",
                      ("model", "embed", "reason", "queue_full"))]


def test_retry_after_grows_with_the_flush_time():
    """Retry-After is the backlog in flushes times the flush-time EWMA:
    after slow flushes (1.2 s each) a backlog of 2 flushes asks for
    ceil(2 x 1.2) = 3 s, on both packages; before any flush, 1 s."""
    out = {}
    for pkg, (mod, err_type) in PACKAGES.items():
        b = mod.DynamicBatcher(lambda xs: xs, max_batch=2, max_wait_s=0.001, max_queue=4)
        for i in range(4):
            b.submit(i)
        with pytest.raises(err_type) as cold:
            b.submit("x")
        b._flush_ewma_s = 1.2
        with pytest.raises(err_type) as warm:
            b.submit("x")
        out[pkg] = (cold.value.headers["Retry-After"], warm.value.headers["Retry-After"])
    assert out["port"] == out["reference"] == ("1", "3")


def _backlog(mod) -> list:
    """20 requests queued at once behind flushes of 30 ms (6x the 5 ms
    window): the flush sizes."""
    sizes = []

    def execute(payloads):
        sizes.append(len(payloads))
        time.sleep(0.03)
        return payloads

    b = mod.DynamicBatcher(execute, max_batch=8, max_wait_s=0.005)
    futures = [b.submit(i) for i in range(20)]
    b.start()
    try:
        assert [f.result(timeout=30) for f in futures] == list(range(20))
    finally:
        b.stop()
    return sizes


def test_a_backlog_flushes_full_batches():
    """Past the oldest request's deadline the port's flush still takes
    the queued requests (8, 8, 4); every flush of the reference's after
    its first holds one request (8 then 12 of 1, when its worker starts
    within the first request's 5 ms)."""
    assert _backlog(batcher) == [8, 8, 4]
    ref = _backlog(ref_batcher)
    assert sum(ref) == 20 and set(ref[1:]) == {1}


def test_a_stopped_batcher_starts_again():
    """The port's worker serves after stop and start; the reference's
    restarted worker exits at once (its stop flag stays set)."""
    b = batcher.DynamicBatcher(lambda xs: xs, max_batch=2, max_wait_s=0.001)
    b.start()
    assert b.submit(1).result(timeout=10) == 1
    b.stop()
    b.start()
    try:
        assert b.submit(2).result(timeout=10) == 2
    finally:
        b.stop()
    ref = ref_batcher.DynamicBatcher(lambda xs: xs, max_batch=2, max_wait_s=0.001)
    ref.start()
    ref.stop()
    ref.start()
    try:
        with pytest.raises(Exception):
            ref.submit(2).result(timeout=0.5)
    finally:
        ref.stop()
