"""The port's LoRA adapter lifecycle while serving, against the reference
engine where both can run the same case (``llama-tiny-f32``, the same
weights and adapters; the cases are the reference's ``tests/test_lora.py``
and ``tests/test_radix_cache.py::test_lora_unload_purges_adapter_entries``):
slot management and its errors, the prefix pool per adapter and its purge
on reload and unload, the radix index's purge on unload, in-flight
requests failed by a reload (the reference's messages), a fresh load
preferring an idle slot, boot-time adapters from config, the OpenAI
routes, churn under load, health and the adapter gauge; and the port's
own contract for its CUDA graphs: every adapter leaf keeps its storage
(``data_ptr``) through load, reload and unload.
"""

import json
import threading
import time

import numpy as np
import pytest

import gofr_tpu
import gofr_tpu.serving.openai_compat as ref_oai
import gofr_tpu_torch
import gofr_tpu_torch.serving.openai_compat as port_oai
from gofr_tpu.errors import ErrorInvalidParam as RefErrorInvalidParam
from gofr_tpu_torch.errors import ErrorInvalidParam
from gofr_tpu_torch.models.transformer import LORA_TARGETS
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.types import GenRequest
from tests.test_torch_lora import write_peft
from tests.test_torch_lora_engine import (  # noqa: F401 (fixtures)
    CFG,
    LORA,
    MODEL,
    adapter,
    gen,
    jax_params,
    merged,
    np_tree,
    port_engine,
    port_params,
    ref_engine,
)
from tests.test_torch_openai import Harness, _strip
from tests.test_torch_radix_cache import _invariant, _wait_idle


def _raises(calls, exc=Exception) -> list:
    """The exception each call raises (type and message compared by the
    caller)."""
    out = []
    for fn in calls:
        with pytest.raises(exc) as err:
            fn()
        out.append(err.value)
    return out


def _same_error(calls, exc=Exception) -> str:
    a, b = _raises(calls, exc)
    assert type(a).__name__ == type(b).__name__
    assert str(a) == str(b)
    return str(b)


def test_leaf_storage_survives_load_reload_unload(port_params):
    """Every adapter leaf (and every other param) keeps its storage through
    a load, a reload with fewer targets, a second load and both unloads —
    the captured decode graphs read the leaves by address — and the slot
    holds what was loaded: the values, then zeros."""
    eng = port_engine(port_params, lora_slots=2, lora_rank=4,
                      lora_targets=",".join(LORA_TARGETS))
    try:
        ptrs = {k: v.data_ptr() for k, v in eng.params.items()}
        lora_keys = [k for k in ptrs if k.endswith(("_lora_a", "_lora_b"))]
        assert len(lora_keys) == 2 * len(LORA_TARGETS)
        v1 = adapter(1, LORA_TARGETS)
        assert eng.load_lora("x", v1) == 1
        np.testing.assert_array_equal(eng.params["w_down_lora_b"][:, 1].numpy(), v1["w_down"][1])
        assert eng.load_lora("x", {"wq": v1["wq"]}) == 1  # reload, fewer targets
        assert not eng.params["w_down_lora_b"][:, 1].any()
        np.testing.assert_array_equal(eng.params["wq_lora_a"][:, 1].numpy(), v1["wq"][0])
        assert eng.load_lora("y", adapter(2, LORA_TARGETS)) == 2
        eng.unload_lora("x")
        eng.unload_lora("y")
        assert {k: v.data_ptr() for k, v in eng.params.items()} == ptrs
        assert not any(eng.params[k].any() for k in lora_keys)
        assert gen(eng, "hello") == gen(eng, "hello", n=10)
    finally:
        eng.close()


def test_adapter_slot_management(jax_params, port_params):
    """Names, the full-slots error, an unknown adapter at submit, unload of
    an unknown name, a freed slot reused, base streams unchanged — against
    the reference's."""
    ref, eng = ref_engine(jax_params, **LORA), port_engine(port_params, **LORA)
    try:
        for e in (ref, eng):
            assert e.lora_names() == []
            e.load_lora("x", adapter(1))
            e.load_lora("y", adapter(2))
            assert e.lora_names() == ["x", "y"]
        assert "slots in use" in _same_error(
            [lambda: ref.load_lora("z", adapter(3)), lambda: eng.load_lora("z", adapter(3))],
            RuntimeError)
        base, x_out = gen(eng, "hi"), gen(eng, "hi", adapter="x")
        assert (base, x_out) == (gen(ref, "hi"), gen(ref, "hi", adapter="x"))
        for e in (ref, eng):
            e.unload_lora("x")
            assert e.lora_names() == ["y"]
        errs = _raises([lambda: ref.submit_generate("hi", adapter="x"),
                        lambda: eng.submit_generate("hi", adapter="x")])
        assert isinstance(errs[0], RefErrorInvalidParam) and isinstance(errs[1], ErrorInvalidParam)
        assert str(errs[0]) == str(errs[1])
        _same_error([lambda: ref.unload_lora("x"), lambda: eng.unload_lora("x")], KeyError)
        _same_error([lambda: ref.register_prefix("hi", adapter="x"),
                     lambda: eng.register_prefix("hi", adapter="x")], KeyError)
        for e in (ref, eng):
            e.load_lora("z", adapter(3))
            assert e.lora_names() == ["y", "z"] and e._lora_names["z"] == 1
        assert gen(eng, "hi") == base and x_out != base
        assert gen(eng, "hi", adapter="z") == gen(ref, "hi", adapter="z")
    finally:
        ref.stop_sync()
        eng.close()


def test_prefix_pool_per_adapter(jax_params, port_params):
    """A prefix registered under an adapter is reused only by that
    adapter's requests: both engines' streams equal those of engines
    without a pool, and unload purges the adapter's prefix."""
    prefix, suffix = "system: answer briefly. ", "hello there"
    outs = {}
    for name, eng in (("ref", ref_engine(jax_params, prefix_slots=2, **LORA)),
                      ("port", port_engine(port_params, prefix_slots=2, **LORA)),
                      ("plain", port_engine(port_params, **LORA))):
        try:
            eng.load_lora("t", adapter(91))
            if name != "plain":
                eng.register_prefix_sync(prefix)
                eng.register_prefix_sync(prefix, adapter="t")
                assert len(eng._prefix_pool) == 2
            outs[name] = (gen(eng, prefix + suffix), gen(eng, prefix + suffix, adapter="t"))
            if name != "plain":
                eng.unload_lora("t")
                assert len(eng._prefix_pool) == 1
        finally:
            eng.stop_sync()
    assert outs["port"] == outs["ref"] == outs["plain"]
    assert outs["port"][0] != outs["port"][1]


def test_prefix_pool_purged_on_adapter_reload(jax_params, port_params, np_tree):
    """Reloading a name drops the prefix pooled under its old weights, and
    a registration in flight across the reload resolves -1 or is purged:
    no stale entry survives."""
    kw = dict(prefix_slots=2, **LORA)
    v1, v2 = adapter(95), adapter(96)
    outs = []
    for eng in (ref_engine(jax_params, **kw), port_engine(port_params, **kw)):
        try:
            eng.load_lora("t", v1)
            eng.register_prefix_sync("shared preamble. ", adapter="t")
            assert len(eng._prefix_pool) == 1
            eng.load_lora("t", v2)
            assert len(eng._prefix_pool) == 0
            outs.append(gen(eng, "shared preamble. hi", adapter="t"))
        finally:
            eng.stop_sync()
    assert outs[1] == outs[0]
    eng = port_engine(port_params, **kw)
    try:
        eng.load_lora("t", v1)
        req = eng.register_prefix("stale preamble. ", adapter="t")
        eng.load_lora("t", v2)
        res = req.future.result(timeout=120)
        assert res == -1 or len(eng._prefix_pool) == 0
        assert len(eng._prefix_pool) == 0
    finally:
        eng.close()


def test_radix_purge_on_unload(jax_params, port_params):
    """The automatic prefix cache under an adapter (the reference's
    ``test_lora_unload_purges_adapter_entries``, on both engines): the
    adapter's prompt blocks are cached under its slot, base requests never
    hit them, a same-adapter repeat does, and unload purges them while the
    base entries stay; cached counts, hits and streams equal the
    reference's; the block invariant holds."""
    kw = dict(n_slots=4, max_len=256, window_k=4, pipeline_depth=1, prefill_chunk=32,
              kv_block=32, auto_prefix=True, lora_slots=1, lora_rank=4)
    prompt = list(range(40, 110))  # 70 tokens: 2 full blocks
    seen = []
    for eng in (ref_engine(jax_params, **kw), port_engine(port_params, **kw)):
        try:
            eng.load_lora("radix-ad", adapter(9))
            run = []
            for name in ("radix-ad", "", "radix-ad"):
                hits0 = eng._prefix_hit_tokens
                run.append(gen(eng, prompt, n=4, adapter=name))
                _wait_idle(eng)
                run.append((eng._radix.n_cached_blocks, eng._prefix_hit_tokens - hits0))
            eng.unload_lora("radix-ad")
            run.append(eng._radix.n_cached_blocks)
            seen.append(run)
            if isinstance(eng, InferenceEngine):
                _invariant(eng)
        finally:
            eng.stop_sync()
    assert seen[1] == seen[0]
    assert seen[1][1] == (2, 0) and seen[1][3] == (4, 0) and seen[1][5][1] > 0
    assert seen[1][6] == 2  # the base's two blocks survive


def test_reload_fails_inflight_instead_of_mixing(port_params, np_tree):
    """A same-name reload fails the adapter's decoding request with the
    reference's message while a base request in the same batch runs on to
    its solo stream; the reloaded adapter serves the new weights; a
    request queued across a reload fails at admission; every slot frees."""
    eng = port_engine(port_params, **LORA)
    try:
        a1, a2 = adapter(31), adapter(32)
        eng.load_lora("tuned", a1)
        solo = gen(eng, "hold", n=60)
        base = eng.submit_generate("hold", max_new_tokens=60, temperature=0.0,
                                   stop_on_eos=False)
        req = eng.submit_generate("hello", max_new_tokens=100, temperature=0.0,
                                  stop_on_eos=False, adapter="tuned")
        deadline = time.time() + 60
        while not req.token_ids and time.time() < deadline:
            time.sleep(0.001)
        assert req.token_ids, "request never started decoding"
        eng.load_lora("tuned", a2)
        with pytest.raises(RuntimeError) as err:
            req.future.result(timeout=120)
        assert str(err.value) == (
            "LoRA adapter slot 1 is being overwritten by a load of 'tuned' while this "
            "request was generating; resubmit")
        assert base.future.result(timeout=120).token_ids == solo
        got = gen(eng, "hello", adapter="tuned")
        ref = port_engine(merged(np_tree, a2))
        try:
            assert got == gen(ref, "hello")
        finally:
            ref.close()

        blockers = [eng.submit_generate("hold", max_new_tokens=100, temperature=0.0,
                                        stop_on_eos=False) for _ in range(4)]
        queued = eng.submit_generate("hello", max_new_tokens=4, temperature=0.0,
                                     stop_on_eos=False, adapter="tuned")
        eng.load_lora("tuned", a1)
        with pytest.raises(RuntimeError, match="queued|overwritten"):
            queued.future.result(timeout=120)
        for b in blockers:
            b.future.result(timeout=120)
        _wait_idle(eng)
        assert all(s is None for s in eng._slots)
    finally:
        eng.close()


def test_stale_request_and_prefix_rejected_at_admission(port_params):
    """A generate request and a prefix registration stamped under an
    adapter's older generation: admission fails the first with the
    reference's message and resolves the second -1, taking no slot."""
    eng = port_engine(port_params, prefix_slots=1, **LORA)
    try:
        eng.load_lora("t", adapter(5))
        stale = [GenRequest(prompt_ids=[1, 2, 3], max_new_tokens=2, temperature=0.0,
                            stop_on_eos=False, seed=0, aid=1, lora_gen=0, prefix_store=p)
                 for p in (False, True)]
        for r in stale:
            eng._enqueue(r)
        with pytest.raises(RuntimeError) as err:
            stale[0].future.result(timeout=60)
        assert str(err.value) == (
            "LoRA adapter slot 1 was reloaded or unloaded while this request was queued; "
            "resubmit against the current adapter set")
        assert stale[1].future.result(timeout=60) == -1
        assert len(eng._prefix_pool) == 0
    finally:
        eng.close()


def test_fresh_load_prefers_idle_slot(port_params):
    """A fresh load after an unload takes the free slot nothing still
    generates against; forced to reuse the draining slot, it fails the
    draining request (white-box: the engine is stopped and the request
    pinned into a slot, as in the reference's test)."""
    eng = port_engine(port_params, **LORA)
    eng.close()
    eng.load_lora("old", adapter(41))
    assert eng._lora_names["old"] == 1
    req = GenRequest(prompt_ids=[1, 2], max_new_tokens=8, temperature=0.0, stop_on_eos=False,
                     seed=0, aid=1, lora_gen=eng._lora_gen[1])
    eng._slots[0] = req
    eng.unload_lora("old")  # the in-flight request finishes on the base
    eng.load_lora("new", adapter(42))
    assert eng._lora_names["new"] == 2
    assert not req.future.done()
    eng.load_lora("third", adapter(43))
    assert eng._lora_names["third"] == 1
    with pytest.raises(RuntimeError, match="overwritten"):
        req.future.result(timeout=5)


def test_engines_that_refuse_adapters(jax_params, port_params):
    """No adapter slots: load_lora raises the reference's RuntimeError. A
    MoE model refuses adapter slots with init_lora's ValueError."""
    from gofr_tpu.serving.engine import InferenceEngine as RefEngine

    ref, eng = ref_engine(jax_params), port_engine(port_params)
    try:
        assert "TPU_LORA_SLOTS" in _same_error(
            [lambda: ref.load_lora("x", adapter(1)), lambda: eng.load_lora("x", adapter(1))],
            RuntimeError)
        assert eng.lora_names() == [] and eng.health_check()["details"]["lora_adapters"] == []
    finally:
        ref.stop_sync()
        eng.close()
    assert _same_error([
        lambda: RefEngine("moe-tiny", n_slots=2, max_len=64, lora_slots=1),
        lambda: InferenceEngine("moe-tiny", n_slots=2, max_len=64, lora_slots=1, device="cpu"),
    ], ValueError) == "LoRA serving does not support MoE models"


def test_boot_time_adapters_from_config(tmp_path):
    """TPU_LORA_SLOTS / RANK / TARGETS shape the slots and
    TPU_LORA_ADAPTERS=name=path loads a PEFT directory at boot; a
    malformed entry raises the reference's error."""
    from gofr_tpu.config import MockConfig as RefMockConfig
    from gofr_tpu.serving.engine import InferenceEngine as RefEngine
    from gofr_tpu_torch.config import MockConfig

    write_peft(tmp_path, 4, 4.0, {"q_proj": "wq", "v_proj": "wv"})
    cfg = {"TPU_MODEL": MODEL, "TPU_DEVICE": "cpu", "TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "128",
           "TPU_LORA_SLOTS": "2", "TPU_LORA_RANK": "4", "TPU_LORA_TARGETS": "wq,wk,wv,wo",
           "TPU_LORA_ADAPTERS": f"boot={tmp_path}"}
    eng = InferenceEngine.from_config(MockConfig(cfg))
    try:
        assert eng.lora_names() == ["boot"]
        assert (eng.lora_slots, eng.lora_rank, eng._lora_targets) == (
            2, 4, ("wq", "wk", "wv", "wo"))
        base = gen(eng, "hi", n=6)
        assert gen(eng, "hi", n=6, adapter="boot") != base
    finally:
        eng.close()
    bad = {**cfg, "TPU_LORA_ADAPTERS": "not-an-assignment"}
    assert "name=path" in _same_error([
        lambda: RefEngine.from_config(RefMockConfig(bad)),
        lambda: InferenceEngine.from_config(MockConfig(bad)),
    ], ValueError)


def _app(pkg, engine):
    mod = {"port": gofr_tpu_torch, "reference": gofr_tpu}[pkg]
    app = mod.App(config=mod.config.MockConfig(
        {"APP_NAME": "lora-test", "HTTP_PORT": "0", "METRICS_PORT": "0"}))
    app.container.tpu = engine
    {"port": port_oai, "reference": ref_oai}[pkg].add_openai_routes(app)
    return Harness(app)


def test_openai_surface_routes_adapters(jax_params, port_params):
    """/v1/models lists a loaded adapter as a model id; a completion routes
    by it; an unknown model is 404 — both Apps on the same weights and
    adapter give equal bodies."""
    import gofr_tpu.config  # noqa: F401
    import gofr_tpu_torch.config  # noqa: F401

    engines = {"port": port_engine(port_params, **LORA),
               "reference": ref_engine(jax_params, **LORA)}
    apps = {}
    try:
        for pkg, eng in engines.items():
            eng.load_lora("tuned", adapter(51))
            apps[pkg] = _app(pkg, eng)
        out = {}
        for pkg, h in apps.items():
            _, _, models = h.request("GET", "/v1/models")
            ids = {m["id"] for m in json.loads(models)["data"]}
            assert "tuned" in ids
            body = {"model": "tuned", "prompt": "hello", "max_tokens": 6, "temperature": 0}
            st, _, tuned = h.request("POST", "/v1/completions", body)
            assert st == 200
            st, _, base = h.request("POST", "/v1/completions", {**body, "model": MODEL})
            assert st == 200
            st, _, _ = h.request("POST", "/v1/completions", {**body, "model": "missing"})
            assert st == 404
            tuned, base = _strip(json.loads(tuned)), _strip(json.loads(base))
            assert tuned["choices"][0]["text"] != base["choices"][0]["text"]
            out[pkg] = (tuned["choices"][0]["text"], base["choices"][0]["text"])
        assert out["port"] == out["reference"]
    finally:
        for h in apps.values():
            h.close()
        for eng in engines.values():
            eng.stop_sync()


def test_adapter_churn_under_load(port_params):
    """load_lora/unload_lora in a loop on another thread while base
    requests decode: every base stream equals the solo one, every request
    completes, and the engine ends idle with no adapter."""
    eng = port_engine(port_params, **LORA)
    try:
        expected = gen(eng, "hello", n=24)
        stop = threading.Event()
        errs = []

        def churn():
            i = 0
            try:
                while not stop.is_set():
                    name = f"churn-{i % 2}"
                    eng.load_lora(name, adapter(100 + i % 3))
                    eng.unload_lora(name)
                    i += 1
            except Exception as exc:  # noqa: BLE001 (reported below)
                errs.append(exc)

        t = threading.Thread(target=churn)
        t.start()
        try:
            reqs = [eng.submit_generate("hello", max_new_tokens=24, temperature=0.0,
                                        stop_on_eos=False) for _ in range(8)]
            outs = [r.future.result(timeout=120).token_ids for r in reqs]
        finally:
            stop.set()
            t.join(timeout=30)
        assert not errs, errs
        assert all(o == expected for o in outs)
        assert eng.lora_names() == []
        _wait_idle(eng)
        assert all(s is None for s in eng._slots)
    finally:
        eng.close()


def test_health_and_adapter_gauge(port_params):
    """health's lora_adapters and the app_tpu_lora_adapters gauge follow
    loads and unloads (the container registers the gauge, as the
    reference's)."""
    from gofr_tpu_torch.container.container import Container
    from gofr_tpu_torch.metrics import new_metrics_manager

    metrics = new_metrics_manager()
    Container.register_framework_metrics(type("C", (), {"metrics": metrics})())

    def gauge() -> dict:
        inst = next(i for i in metrics.instruments() if i.name == "app_tpu_lora_adapters")
        return inst.collect()

    eng = port_engine(port_params, metrics=metrics, **LORA)
    try:
        eng.load_lora("b", adapter(1))
        eng.load_lora("a", adapter(2))
        assert eng.health_check()["details"]["lora_adapters"] == ["a", "b"]
        assert gauge() == {(("model", MODEL),): 2.0}
        eng.unload_lora("b")
        assert eng.health_check()["details"]["lora_adapters"] == ["a"]
        assert gauge() == {(("model", MODEL),): 1.0}
    finally:
        eng.close()
