"""The port's profiler capture singleton (``gofr_tpu_torch/serving/
profiler_capture``) against the reference's: ``trigger``, the busy slot,
the cooldown, manual captures and ``snapshot`` agree step for step under
an injected clock and synchronous spawns, a failed capture is recorded
and frees the slot in both, and a real ``torch.profiler`` capture on the
CPU writes its Chrome trace into ``trace_dir``.
"""

from __future__ import annotations

import json
import os

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
    """While an owner (an engine's scheduler thread on the card) replays
    CUDA graphs, trigger refuses and says why, and start_trace raises; the
    slot and the cooldown anchor stay untouched, and the capture starts
    once the owner is gone."""
    monkeypatch.setattr(pc, "_graph_replayers", type(pc._graph_replayers)())
    w = _World()
    cap = pc.ProfilerCapture(**w.kw())

    class Engine:
        pass

    eng = Engine()
    pc.note_graph_replays(eng, True)
    assert pc.graph_replays_live()
    assert cap.trigger(200) is False
    snap = cap.snapshot()
    assert snap["suppressed"] == 1 and snap["captures"] == 0 and not snap["busy"]
    assert snap["last_error"] == pc.REFUSED_GRAPHS
    assert cap.last_capture_at is None and w.pending == []
    with pytest.raises(RuntimeError, match="replays CUDA graphs"):
        cap.start_trace()
    assert w.events == []

    pc.note_graph_replays(eng, False)
    assert not pc.graph_replays_live()
    assert cap.trigger(200) is True
    w.pending.pop(0)()
    snap = cap.snapshot()
    assert snap["captures"] == 1 and snap["last_error"] == ""
    assert w.events == [("start", True), ("sleep", 0.2), ("stop",)]

    # An owner that is collected without deregistering does not hold it.
    pc.note_graph_replays(Engine(), True)
    import gc

    gc.collect()
    assert not pc.graph_replays_live()
