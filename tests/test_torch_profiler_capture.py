"""The port's profiler capture singleton (``gofr_tpu_torch/serving/
profiler_capture``) against the reference's: ``trigger``, the busy slot,
the cooldown, manual captures and ``snapshot`` agree step for step under
an injected clock and synchronous spawns, a failed capture is recorded
and frees the slot in both, and a real ``torch.profiler`` capture on the
CPU writes its Chrome trace into ``trace_dir``. While an engine serves, a
capture's start and stop run on its scheduler thread between passes (the
port's repair of a capture under CUDA graph replays).
"""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from gofr_tpu.serving import profiler_capture as ref_pc
from gofr_tpu_torch.serving import profiler_capture as pc


class _World:
    """A stated clock, a recorded sleep, and start/stop recorders."""

    def __init__(self):
        self.now = 0.0
        self.events = []
        self.pending = []  # spawned captures not run yet

    def kw(self, fail=False):
        def start(d):
            if fail:
                raise RuntimeError("profiler unavailable")
            self.events.append(("start", os.path.basename(d) != ""))

        return dict(
            cooldown_s=10.0, clock=lambda: self.now,
            sleep=lambda s: self.events.append(("sleep", s)),
            starter=start, stopper=lambda: self.events.append(("stop",)),
            spawn=self.pending.append,
        )


def _snap(cap):
    s = cap.snapshot()
    s.pop("trace_dir")
    return s


def _drive(mod, fail=False):
    """One scripted run; returns every observable after each step."""
    w = _World()
    cap = mod.ProfilerCapture(**w.kw(fail=fail))
    seen = []

    def note(label, value=None):
        seen.append((label, value, _snap(cap), list(w.events)))

    note("trigger-1", cap.trigger(200, reason="loop-stall"))
    note("busy-while-pending", cap.busy)
    w.now = 1.0
    note("trigger-inside-cooldown", cap.trigger(50))
    w.pending.pop(0)()  # the capture thread runs
    note("after-run", cap.busy)
    w.now = 11.0
    note("try-acquire", cap.try_acquire())
    note("trigger-while-busy", cap.trigger(10))
    cap.release()
    cap.note_manual_capture()
    note("manual")
    w.now = 15.0
    note("trigger-after-manual", cap.trigger(10))
    w.now = 21.5
    note("trigger-after-cooldown", cap.trigger(0, reason="x"))
    while w.pending:
        w.pending.pop(0)()
    note("end", cap.busy)
    return seen


@pytest.mark.parametrize("fail", [False, True], ids=["ok", "failing-profiler"])
def test_trigger_busy_and_cooldown_agree_with_the_reference(fail):
    assert _drive(pc, fail) == _drive(ref_pc, fail)
    final = _drive(pc, fail)[-1][2]
    assert final["captures"] == 3 and final["suppressed"] == 3
    assert final["last_reason"] == "x"
    assert (final["last_error"] != "") == fail


def test_get_capture_is_one_singleton(monkeypatch):
    monkeypatch.setattr(pc, "_capture", None)
    a = pc.get_capture()
    b = pc.get_capture(cooldown_s=5)
    assert a is b and a.cooldown_s == 5.0
    assert os.path.isdir(a.trace_dir)


def test_a_cpu_trace_lands_in_the_trace_dir():
    cap = pc.ProfilerCapture(cooldown_s=0, spawn=lambda fn: fn(),
                             sleep=lambda s: torch.randn(64, 64) @ torch.randn(64, 64))
    assert cap.trigger(5, reason="test")
    assert not cap.busy and cap.snapshot()["last_error"] == ""
    assert os.path.dirname(cap.trace_file) == cap.trace_dir
    with open(cap.trace_file) as fp:
        trace = json.load(fp)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    # A second capture overwrites the same file: the dir never grows.
    assert cap.trigger(5)
    assert os.listdir(cap.trace_dir) == ["trace.json"]


def test_a_capture_is_refused_while_cuda_graphs_replay(monkeypatch):
    """The capture once refused while an engine's scheduler replayed CUDA
    graphs; it now hands its start and stop to that thread. A capture
    triggered from another thread while a CPU engine serves starts and
    stops on the engine's scheduler thread, between two passes (an
    injected clock and sleep; the trace itself written on the capture's
    thread); the engine's requests complete. After the engine closes, a
    capture runs on its own thread, and an owner collected without
    deregistering does not hold it."""
    import threading

    from gofr_tpu_torch.serving.engine import InferenceEngine

    monkeypatch.setattr(pc, "_device_owners", type(pc._device_owners)())
    w = _World()
    seen = []
    kw = w.kw()
    kw.update(starter=lambda d: seen.append(("start", threading.current_thread().name)),
              stopper=lambda: seen.append(("stop", threading.current_thread().name)))
    cap = pc.ProfilerCapture(**kw)
    eng = InferenceEngine("llama-tiny-f32", n_slots=2, max_len=128, window_k=4, device="cpu")
    try:
        assert pc.device_owner() is eng
        reqs = [eng.submit_generate([1, 2, 3, 4], max_new_tokens=40, stop_on_eos=False)
                for _ in range(2)]
        assert cap.trigger(200) is True
        capture = threading.Thread(target=w.pending.pop(0), name="capture")
        capture.start()
        capture.join(timeout=60)
        assert not capture.is_alive()
        sched = eng._thread.name
        assert seen == [("start", sched), ("stop", sched)]
        assert ("sleep", 0.2) in w.events
        snap = cap.snapshot()
        assert snap["captures"] == 1 and snap["last_error"] == "" and not snap["busy"]
        assert all(len(r.future.result(timeout=60).token_ids) == 40 for r in reqs)
    finally:
        eng.close()
    assert pc.device_owner() is None
    w.now = 100.0
    assert cap.trigger(10) is True
    w.pending.pop(0)()
    assert seen[-2:] == [("start", threading.current_thread().name),
                         ("stop", threading.current_thread().name)]

    class Owner:
        def run_between_passes(self, fn, timeout):
            raise AssertionError("a collected owner must not be used")

    pc.note_device_owner(Owner(), True)
    import gc

    gc.collect()
    assert pc.device_owner() is None


def test_a_handoff_the_scheduler_never_takes_times_out():
    """run_between_passes withdraws a call its scheduler has not taken
    within the timeout (the capture then records the error and frees its
    slot); a call handed to a stopped engine runs on the caller."""
    import threading

    from gofr_tpu_torch.serving.engine import InferenceEngine

    eng = InferenceEngine("llama-tiny-f32", n_slots=2, max_len=128, window_k=4, device="cpu")
    try:
        ran = []
        with eng._device_lock:  # the scheduler waits between passes
            with pytest.raises(TimeoutError):
                eng.run_between_passes(lambda: ran.append(1), timeout=0.2)
        time.sleep(0.2)
        assert ran == []  # withdrawn, never run
        assert eng.run_between_passes(lambda: threading.current_thread().name,
                                      timeout=30) == eng._thread.name
    finally:
        eng.close()
    assert eng.run_between_passes(lambda: threading.current_thread().name) == \
        threading.current_thread().name
