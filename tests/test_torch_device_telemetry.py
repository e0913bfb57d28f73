"""The port's device services (``gofr_tpu_torch/serving/device_telemetry``
and the engine's ledger, headroom shed and compile tracker) against the
reference's.

* ``HBMLedger`` gives the reference class's budget, source, headroom,
  watermark and snapshot on the same components;
* on the same weights and geometry, the engine's ``params``, ``lora``,
  ``kv_pool`` and ``prefix_pool`` bytes and the derived eviction
  watermark equal the reference engine's ``hbm_ledger()`` — slot cache,
  pool, int8 weights, adapters and the explicit prefix pool; on an int8
  KV pool the reference's scale planes are replicated 8x (its TPU
  sublane layout), which is the whole difference;
* the watermark's precedence in both orders, admission shedding below
  the headroom floor with the reference's reason, and the health detail;
* the compile tracker counts and flags a steady-state compile through a
  counting program and through the signature fallback, emits
  ``tpu.compile`` spans under the boot trace, and the engine's graph
  captures go through it.
"""

from __future__ import annotations

import threading

import jax
import numpy as np
import pytest

from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.serving import device_telemetry as ref_dt
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.container import Container
from gofr_tpu_torch.errors import ErrorTooManyRequests
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.ops.quant import quantized_bytes
from gofr_tpu_torch.serving import device_telemetry as dt
from gofr_tpu_torch.serving import engine as engine_mod
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.tracing import Tracer, get_tracer, set_tracer
from gofr_tpu_torch.weights import params_from_jax

MODEL = "llama-tiny-f32"
BASE = dict(n_slots=2, max_len=128, window_k=4)


@pytest.fixture(scope="module")
def weights():
    jp = init_transformer(jax.random.PRNGKey(3), ref_get_model(MODEL).config)
    return jax.tree_util.tree_map(np.asarray, jp)


def _pair(weights, **kw):
    """A reference engine (not started) and a port engine on the same
    weights and geometry."""
    ref = RefEngine(MODEL, params=jax.tree_util.tree_map(jax.numpy.asarray, weights),
                    **BASE, **kw)
    port = InferenceEngine(MODEL, params=params_from_jax(weights, get_model(MODEL).config,
                                                         device="cpu"),
                           device="cpu", **BASE, **kw)
    return ref, port


# -- the ledger class ---------------------------------------------------


@pytest.mark.parametrize("components,kw,free", [
    ({"params": 600, "kv_pool": 100}, dict(block_bytes=50, n_blocks=10, budget_bytes=1000), 2),
    ({"params": 600, "kv_pool": 100, "workspace": 7}, dict(block_bytes=50, n_blocks=10), 3),
    ({"params": 10_000, "kv_pool": 4_000, "lora": 300},
     dict(block_bytes=400, n_blocks=11, budget_bytes=20_000), 5),
    ({"params": 600, "kv_pool": 100}, dict(budget_bytes=500), 0),
    ({"params": 600, "kv_pool": 100, "prefix_pool": 64},
     dict(block_bytes=50, n_blocks=10, device_stats=lambda: {"bytes_limit": 4000,
                                                             "bytes_in_use": 900}), 1),
])
def test_ledger_class_equals_the_reference(components, kw, free):
    ref, port = ref_dt.HBMLedger(components, **kw), dt.HBMLedger(components, **kw)
    assert (port.budget_bytes, port.budget_source) == (ref.budget_bytes, ref.budget_source)
    assert port.per_device_bytes == ref.per_device_bytes
    assert port.headroom_ratio(free) == ref.headroom_ratio(free)
    for frac in (0.0, 0.1, 0.3, 0.5, 0.9, 1.0, 5.0):
        assert port.derive_block_watermark(frac) == ref.derive_block_watermark(frac)
    assert port.snapshot(free) == ref.snapshot(free)


def test_ledger_arithmetic():
    ledger = dt.HBMLedger({"params": 600, "kv_pool": 100},
                          block_bytes=50, n_blocks=10, budget_bytes=1000)
    assert ledger.derive_block_watermark(0.5) == 4
    assert ledger.derive_block_watermark(0.3) == 0
    assert ledger.derive_block_watermark(5.0) == 9
    assert ledger.headroom_ratio(free_blocks=2) == pytest.approx(0.4)


def test_tree_device_bytes_walks_tensors_quantized_and_dataclasses():
    import torch

    from gofr_tpu_torch.ops.quant import quantize_params

    t = torch.zeros((3, 4), dtype=torch.bfloat16)
    q = quantize_params({"w": torch.ones((2, 8, 16))}, "int8")["w"]
    assert dt.tree_device_bytes([t, {"a": t, "b": None}, (t,)]) == 3 * 24
    assert dt.tree_device_bytes(q) == q.nbytes
    planes = engine_mod.SlotPlanes.create(2, torch.device("cpu"), 512,
                                          engine_mod.SamplerFlags())
    assert dt.tree_device_bytes(planes) == sum(
        v.numel() * v.element_size() for v in vars(planes).values()
        if isinstance(v, torch.Tensor))


# -- the engine's ledger against the reference engine's ------------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(kv_block=16, auto_prefix=True),
    dict(kv_block=16, quant="int8"),
    dict(kv_block=16, lora_slots=2, lora_rank=4),
    dict(prefix_slots=2),
], ids=["slot", "pool", "int8", "lora", "prefix_pool"])
def test_engine_ledger_equals_the_reference(weights, kw):
    ref, port = _pair(weights, **kw)
    try:
        a, b = ref.hbm_ledger(), port.hbm_ledger()
        for name in ("params", "lora", "kv_pool", "prefix_pool"):
            assert b["components"].get(name) == a["components"].get(name), name
        assert b.get("block_bytes") == a.get("block_bytes")
        # The port's own accounting, exactly.
        assert b["components"]["kv_pool"] == port.cache.hbm_bytes()
        assert (b["components"]["params"] + b["components"].get("lora", 0)
                == quantized_bytes(port.params))
        assert b["total_bytes"] == sum(b["components"].values())
        assert b["components"]["workspace"] > 0
        assert b["budget_source"] == a["budget_source"] == "ledger"
        assert 0.0 <= b["headroom_ratio"] <= 1.0
    finally:
        port.close()
        ref.close()


def test_int8_kv_pool_differs_only_by_the_references_scale_replication(weights):
    ref, port = _pair(weights, kv_block=16, kv_quant="int8")
    try:
        a, b = ref.hbm_ledger()["components"], port.hbm_ledger()["components"]
        scales = sum(t.numel() * t.element_size() for t in (port.cache.k_s, port.cache.v_s))
        assert a["kv_pool"] == b["kv_pool"] + 7 * scales
    finally:
        port.close()
        ref.close()


def test_derived_watermark_equals_the_reference(weights):
    # An explicit budget 20 pool blocks above the reference's footprint
    # and a fraction asking 5.5 blocks beyond that slack: the derived
    # count (6) is unclamped, and the port's workspace (a few KB apart
    # from the reference's) moves the target by under half a block.
    probe = RefEngine(MODEL, params=jax.tree_util.tree_map(jax.numpy.asarray, weights),
                      **BASE, kv_block=16, auto_prefix=True)
    snap = probe.hbm_ledger()
    probe.close()
    bb = snap["block_bytes"]
    budget = snap["per_device_bytes"] + 20 * bb
    frac = 25.5 * bb / budget
    ref, port = _pair(weights, kv_block=16, auto_prefix=True,
                      hbm_budget_bytes=budget, prefix_evict_hbm_frac=frac)
    try:
        assert ref.effective_evict_watermark == 6
        assert port.effective_evict_watermark == ref.effective_evict_watermark
        assert port.hbm_ledger()["budget_source"] == "env"
        assert abs(port.hbm_headroom_ratio() - ref.hbm_headroom_ratio()) < 0.5 * bb / budget
    finally:
        port.close()
        ref.close()


def test_watermark_precedence_both_orders(weights):
    for kw, want in ((dict(prefix_evict_watermark=3), 3),
                     (dict(prefix_evict_watermark=2, prefix_evict_hbm_frac=1.0), 2),
                     (dict(), 0)):
        eng = InferenceEngine(MODEL, device="cpu", **BASE, kv_block=16, auto_prefix=True, **kw)
        try:
            assert eng.effective_evict_watermark == want, kw
        finally:
            eng.close()
    eng = InferenceEngine(MODEL, device="cpu", **BASE, kv_block=16, auto_prefix=True,
                          prefix_evict_hbm_frac=1.0)
    try:
        # frac 1.0 of a ledger-sized budget: every allocatable block.
        assert eng.effective_evict_watermark == eng.cache.n_blocks - 1
        eng.generate_sync(list(range(2, 60)), max_new_tokens=4, temperature=0.0,
                          stop_on_eos=False)
        eng.stop_sync()
        eng._radix_watermark_sweep()
        assert eng._radix.n_cached_blocks == 0
        assert eng._allocator.n_free == eng.cache.n_blocks - 1
        assert eng.hbm_headroom_ratio() == pytest.approx(
            eng._ledger.headroom_ratio(eng.cache.n_blocks - 1))
    finally:
        eng.close()


def test_admission_sheds_below_the_headroom_floor():
    metrics = Container.create(MockConfig({"APP_NAME": "devtel"})).metrics
    eng = InferenceEngine.from_config(MockConfig({
        "TPU_MODEL": MODEL, "TPU_DEVICE": "cpu", "TPU_KV_SLOTS": "2",
        "TPU_MAX_LEN": "128", "TPU_KV_BLOCK": "16", "TPU_ADMIT_MIN_HEADROOM": "1.1",
        "TPU_HBM_BYTES": str(1 << 30),
    }), metrics=metrics)
    try:
        assert eng.hbm_ledger()["budget_source"] == "env"
        with pytest.raises(ErrorTooManyRequests, match="hbm_headroom|HBM headroom") as err:
            eng.submit_generate([1, 2, 3], max_new_tokens=4)
        assert err.value.retry_after_s >= 0.5
        assert eng.shed_counts["hbm_headroom"] == 1
        inst = {i.name: i for i in metrics.instruments()}
        shed = inst["app_tpu_requests_shed_total"].collect()
        assert sum(v for k, v in shed.items() if ("reason", "hbm_headroom") in k) == 1
        gauges = inst["app_tpu_hbm_bytes"].collect()
        assert any(("component", "kv_pool") in k and v == eng.cache.hbm_bytes()
                   for k, v in gauges.items())
        # Above the floor it admits.
        eng.admit_min_headroom = 0.5
        assert len(eng.generate_sync([1, 2, 3], max_new_tokens=2).token_ids) == 2
        details = eng.health_check()["details"]
        assert details["hbm_ledger"]["budget_bytes"] == 1 << 30
        assert details["compiles"] == {"total": 0, "steady_state_recompiles": 0}
    finally:
        eng.close()


# -- the compile tracker ------------------------------------------------


class _Capture:
    def __init__(self):
        self.spans, self._lock = [], threading.Lock()

    def export(self, span, service_name):
        with self._lock:
            self.spans.append(span)


@pytest.mark.parametrize("mod", [ref_dt, dt], ids=["reference", "port"])
def test_tracker_counts_and_flags_steady_state_compiles(mod):
    clock = iter(float(i) for i in range(1000))
    tracker = mod.CompileTracker("m", clock=lambda: next(clock), wall_ns=lambda: 0)

    class Program:  # a program whose cache grows when it compiles
        def __init__(self):
            self.n = 0

        def _cache_size(self):
            return self.n

        def __call__(self, x, compile_=False):
            self.n += int(compile_)
            return x

    prog = tracker.wrap("prog", Program())
    assert prog(1, compile_=True) == 1
    prog(2)
    sig = tracker.wrap("sig", lambda x: x)  # no _cache_size: the signature fallback
    sig(np.zeros((2, 3)))
    sig(np.ones((2, 3)))
    assert tracker.total == 2 and tracker.steady_state_recompiles == 0
    tracker.mark_warm()
    prog(3)
    sig(np.zeros((4, 3)))  # a new shape after the fence
    prog(4, compile_=True)
    snap = tracker.snapshot()
    assert snap["steady_state_recompiles"] == 2 and snap["total"] == 4
    assert snap["programs"]["prog"]["compiles"] == 2
    assert snap["programs"]["sig"]["compiles"] == 2
    assert snap["warm"]


def test_counting_call_makes_every_capture_a_compile():
    metrics = Container.create(MockConfig({"APP_NAME": "devtel"})).metrics
    tracker = dt.CompileTracker("m", metrics=metrics)
    capture = tracker.wrap("window[sampling=0,bias=0]", dt.CountingCall(lambda: "graph"))
    assert capture() == "graph"
    tracker.mark_warm()
    capture()
    assert tracker.snapshot()["programs"]["window[sampling=0,bias=0]"]["compiles"] == 2
    assert tracker.steady_state_recompiles == 1
    steady = {i.name: i for i in metrics.instruments()}[
        "app_tpu_steady_state_recompiles_total"].collect()
    assert sum(steady.values()) == 1


def test_compile_span_parents_under_the_boot_trace():
    old = get_tracer()
    cap = _Capture()
    set_tracer(Tracer(service_name="devtel", exporter=cap))
    try:
        boot = get_tracer().start_span("tpu.boot")
        try:
            tracker = dt.CompileTracker("m")
        finally:
            boot.end()
        prog = tracker.wrap("p", dt.CountingCall(lambda: None))
        out = []
        t = threading.Thread(target=lambda: out.append(prog()))  # no ambient span
        t.start()
        t.join()
        (span,) = [s for s in cap.spans if s.name == "tpu.compile"]
        assert (span.trace_id, span.parent_id) == (boot.trace_id, boot.span_id)
        assert span.attributes["tpu.program"] == "p"
        assert span.attributes["tpu.steady_state"] is False
        assert span.end_ns >= span.start_ns
    finally:
        set_tracer(old)


def test_engine_captures_go_through_the_tracker(monkeypatch, tmp_path):
    eng = InferenceEngine(MODEL, device="cpu", **BASE)
    try:
        made = []

        class FakeCaptured:  # stands in for a CUDA graph capture on the CPU
            def __init__(self, fn, pool, keep_graph=False):
                made.append((fn(), pool, keep_graph))

        monkeypatch.setattr(engine_mod, "Captured", FakeCaptured)
        eng._capture("window[sampling=0,bias=0]", lambda: 1, "pool")
        eng._capture("window[sampling=1,bias=0]", lambda: 2, "pool")
        stats = eng.compile_stats()
        assert stats["total"] == 2 and not stats["warm"]
        assert "kernel_library" not in stats["programs"]  # never loaded on the CPU
        eng.mark_steady_state()
        eng._capture("window[sampling=0,bias=0]", lambda: 3, "pool")  # a recapture
        stats = eng.compile_stats()
        assert stats["steady_state_recompiles"] == 1
        assert stats["programs"]["window[sampling=0,bias=0]"]["compiles"] == 2
        assert [m[0] for m in made] == [1, 2, 3]
        assert eng.health_check()["details"]["compiles"]["steady_state_recompiles"] == 1
    finally:
        eng.close()
