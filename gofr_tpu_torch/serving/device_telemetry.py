"""Device-resource observability: the HBM ledger and the compile tracker —
the port's copy of ``gofr_tpu/serving/device_telemetry.py``.

* :class:`HBMLedger` — a per-engine byte ledger over the components the
  engine allocated on the card: ``params`` (the weight tree, quantized
  leaves at their stored bytes, minus the adapter leaves), ``lora`` (the
  stacked adapter planes), ``kv_pool`` (the slot cache or the paged
  pool, exactly ``cache.hbm_bytes()``), the optional ``prefix_pool``,
  and ``workspace`` (the cache's lengths and block table, the slots'
  request planes, the mega window's buffers). It resolves a **budget**
  (operator ``TPU_HBM_BYTES`` > the device's own ``bytes_limit`` > the
  ledger's own total) and derives the **headroom ratio** — budget slack
  plus free paged blocks over the budget — the saturation signal
  admission (``TPU_ADMIT_MIN_HEADROOM``) and the eviction watermark
  (``TPU_PREFIX_EVICT_HBM_FRAC``) read. Exported as
  ``app_tpu_hbm_bytes{component}`` plus ``app_tpu_hbm_headroom_ratio``.
  The port serves on one device, so ``per_device_bytes`` is the total.

* :class:`CompileTracker` — wraps every program the engine builds and
  counts its compiles. The port has no XLA: its programs are the CUDA
  graphs captured per decode variant (``programs.DecodeGraphs``; every
  capture is one compile, :class:`CountingCall` counts them) and the
  process's first load of the nvcc kernel library (``ops/cuda/_build.py``;
  the engine notes it). Each compile increments
  ``app_tpu_compiles_total{program}``, records its seconds in
  ``app_tpu_compile_seconds`` and emits a deferred ``tpu.compile`` span.
  After :meth:`CompileTracker.mark_warm` any further compile bumps
  ``app_tpu_steady_state_recompiles_total`` and logs a warning.

Clocks are injectable and nothing here sleeps or touches device state.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Optional

from gofr_tpu_torch.analysis import lockcheck
from gofr_tpu_torch.ops.quant import is_quantized
from gofr_tpu_torch.tracing import get_tracer
from gofr_tpu_torch.tracing.tracer import _rand_hex, current_span, tracer_active


def tree_device_bytes(tree: Any) -> int:
    """Total bytes of every tensor in a (possibly nested) structure:
    dicts, lists, tuples, dataclasses and the quantized containers
    (``Q8``/``Q4``: their ``q`` and ``s``). A tensor counts ``numel() *
    element_size()``; reading those is metadata only, no device
    traffic."""
    total = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if node is None:
            continue
        numel = getattr(node, "numel", None)
        element_size = getattr(node, "element_size", None)
        if callable(numel) and callable(element_size):
            total += int(numel()) * int(element_size())
        elif is_quantized(node):
            stack.extend((node.q, node.s))
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            stack.extend(getattr(node, f.name) for f in dataclasses.fields(node))
    return total


class HBMLedger:
    """Byte accounting of one engine's device-resident components plus
    the derived headroom signal. Component sizes are fixed per engine
    (buffers are preallocated); the only dynamic input is the paged
    pool's free-block count, passed into :meth:`headroom_ratio` by the
    caller so the ledger itself holds no engine reference. The port
    serves on one device: every component is resident there whole."""

    def __init__(
        self,
        components: dict[str, int],
        *,
        block_bytes: int = 0,
        n_blocks: int = 0,
        budget_bytes: int = 0,
        budget_source: str = "",
        device_stats: Optional[Callable[[], Optional[dict]]] = None,
    ) -> None:
        self.components = {k: int(v) for k, v in components.items()}
        #: Bytes of ONE paged pool block across every layer's K/V (and
        #: scale) planes — the unit the eviction watermark converts HBM
        #: fractions into.
        self.block_bytes = int(block_bytes)
        self.n_blocks = int(n_blocks)
        self._device_stats = device_stats
        self.budget_bytes, self.budget_source = self._resolve_budget(
            int(budget_bytes)
        )

    # -- totals --------------------------------------------------------

    @property
    def total_bytes(self) -> int:
        return sum(self.components.values())

    @property
    def per_device_bytes(self) -> int:
        """Bytes resident on the one device: the total."""
        return self.total_bytes

    def _resolve_budget(self, explicit: int) -> tuple[int, str]:
        """The per-device budget headroom is measured against: the
        operator's explicit bytes, else the device's ``bytes_limit``,
        else the ledger's own per-device total."""
        if explicit > 0:
            return explicit, "env"
        stats = self.device_memory_stats()
        limit = (stats or {}).get("bytes_limit")
        if limit:
            return int(limit), "memory_stats"
        return self.per_device_bytes, "ledger"

    def device_memory_stats(self) -> Optional[dict]:
        """The device's own accounting when it provides one (the card
        does; the CPU returns None) — the cross-check against the
        ledger."""
        if self._device_stats is None:
            return None
        try:
            stats = self._device_stats()
        except Exception:  # noqa: BLE001 — a gauge-only cross-check
            return None
        return dict(stats) if stats else None

    # -- the saturation signal -----------------------------------------

    def headroom_ratio(self, free_blocks: int = 0) -> float:
        """Fraction of the per-device budget currently free: budget slack
        beyond the ledger's allocations plus the bytes of free paged-KV
        blocks. In [0, 1]."""
        budget = self.budget_bytes
        if budget <= 0:
            return 1.0
        slack = max(0, budget - self.per_device_bytes)
        free = slack + free_blocks * self.block_bytes
        return max(0.0, min(1.0, free / budget))

    def derive_block_watermark(self, hbm_frac: float) -> int:
        """``TPU_PREFIX_EVICT_HBM_FRAC`` → a free-block watermark: the
        paged pool blocks that must stay free so free HBM (budget slack +
        free blocks) covers ``hbm_frac`` of the budget. Clamped to the
        pool minus the parking block; 0 when the fraction is unset or the
        pool has no blocks."""
        if hbm_frac <= 0 or self.block_bytes <= 0 or self.n_blocks <= 1:
            return 0
        budget = self.budget_bytes
        slack = max(0, budget - self.per_device_bytes)
        want = hbm_frac * budget - slack
        blocks = math.ceil(want / self.block_bytes)
        return max(0, min(blocks, self.n_blocks - 1))

    # -- rendering -----------------------------------------------------

    def snapshot(self, free_blocks: int = 0) -> dict[str, Any]:
        """Components, totals, budget provenance, headroom, and the
        device's cross-check when it has one."""
        out: dict[str, Any] = {
            "components": dict(self.components),
            "total_bytes": self.total_bytes,
            "per_device_bytes": self.per_device_bytes,
            "mesh_devices": 1,
            "budget_bytes": self.budget_bytes,
            "budget_source": self.budget_source,
            "headroom_ratio": round(self.headroom_ratio(free_blocks), 6),
        }
        stats = self.device_memory_stats()
        if stats is not None:
            out["device"] = {
                "bytes_in_use": stats.get("bytes_in_use"),
                "bytes_limit": stats.get("bytes_limit"),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            }
        if self.block_bytes:
            out["block_bytes"] = self.block_bytes
        return out

    def publish(self, metrics: Any, model_name: str) -> None:
        """Export the per-component gauges (sizes are fixed per engine)
        and the headroom gauge."""
        if metrics is None:
            return
        for component, size in self.components.items():
            metrics.set_gauge(
                "app_tpu_hbm_bytes", float(size),
                "model", model_name, "component", component,
            )
        metrics.set_gauge(
            "app_tpu_hbm_headroom_ratio", self.headroom_ratio(),
            "model", model_name,
        )


class CountingCall:
    """``fn`` whose ``_cache_size()`` is the number of calls made: wrapped
    by :meth:`CompileTracker.wrap`, every call counts as one compile (a
    CUDA graph capture compiles on every call)."""

    def __init__(self, fn: Callable[..., Any]) -> None:
        self._fn = fn
        self.calls = 0

    def _cache_size(self) -> int:
        return self.calls

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        out = self._fn(*args, **kwargs)
        self.calls += 1
        return out


class CompileTracker:
    """Counts the compiles of each program an engine builds and polices
    the steady-state contract. See the module docstring."""

    def __init__(
        self,
        model_name: str,
        *,
        metrics: Any = None,
        logger: Any = None,
        clock: Callable[[], float] = time.perf_counter,
        wall_ns: Callable[[], int] = time.time_ns,
    ) -> None:
        self.model_name = model_name
        self._metrics = metrics
        self._logger = logger
        self._clock = clock
        self._wall_ns = wall_ns
        self._lock = lockcheck.make_lock("CompileTracker._lock")
        self._programs: dict[str, dict[str, Any]] = {}
        self.total = 0
        self.steady_state_recompiles = 0
        self._warm = False
        # The build directory's provenance (TPU_COMPILE_CACHE_DIR), set by
        # the engine at construction.
        self.cache_info: Optional[dict[str, Any]] = None
        # Compiles fire on the scheduler thread (no ambient span there),
        # so the trace ambient when the ENGINE was constructed parents
        # the warm-up compile spans.
        span = current_span()
        self._boot_ctx: Optional[tuple[str, str]] = (
            (span.trace_id, span.span_id) if span is not None else None
        )

    # -- warm-up fence -------------------------------------------------

    def mark_warm(self) -> None:
        """Arm the steady-state fence: every compile after this call
        counts (and warns) as a steady-state recompile."""
        self._warm = True

    @property
    def warm(self) -> bool:
        return self._warm

    # -- instrumentation -----------------------------------------------

    def wrap(self, program: str, fn: Any) -> Any:
        """Wrap a program's callable: each call that grows its
        ``_cache_size()`` counts as one compile of ``program``.
        Transparent to callers (same signature, same return).

        Without ``_cache_size``, a shape/dtype signature of the call
        never seen by THIS wrapper counts as the first compile of that
        variant."""
        with self._lock:
            self._programs.setdefault(
                program, {"compiles": 0, "seconds_total": 0.0}
            )
        signatures: set = set()
        sig_lock = lockcheck.make_lock("CompileTracker.sig_lock")

        def cache_size() -> Optional[int]:
            probe = getattr(fn, "_cache_size", None)
            if probe is None:
                return None
            try:
                return int(probe())
            except Exception:  # noqa: BLE001 — the signature fallback takes over
                return None

        def wrapped(*args: Any, **kwargs: Any) -> Any:
            before = cache_size()
            w0 = self._wall_ns()
            t0 = self._clock()
            out = fn(*args, **kwargs)
            after = cache_size()
            if before is not None and after is not None:
                compiled = after > before
            else:
                sig = _call_signature(args, kwargs)
                with sig_lock:
                    compiled = sig not in signatures
                    signatures.add(sig)
            if compiled:
                self._note_compile(program, self._clock() - t0, w0)
            return out

        return wrapped

    def _note_compile(
        self, program: str, duration_s: float, start_wall_ns: int
    ) -> None:
        steady = False
        with self._lock:
            entry = self._programs.setdefault(
                program, {"compiles": 0, "seconds_total": 0.0}
            )
            entry["compiles"] += 1
            entry["seconds_total"] += duration_s
            self.total += 1
            if self._warm:
                steady = True
                self.steady_state_recompiles += 1
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_tpu_compiles_total",
                "model", self.model_name, "program", program,
            )
            self._metrics.record_histogram(
                "app_tpu_compile_seconds", duration_s,
                "model", self.model_name,
            )
            if steady:
                self._metrics.increment_counter(
                    "app_tpu_steady_state_recompiles_total",
                    "model", self.model_name, "program", program,
                )
        if steady and self._logger is not None:
            self._logger.warnf(
                "STEADY-STATE RECOMPILE of %s (%.2fs): a capture or build "
                "after the warm-up fence — the engine dropped its captured "
                "programs (a re-quantize) or a new program variant ran",
                program, duration_s,
            )
        self._emit_span(program, duration_s, start_wall_ns, steady)

    def _emit_span(
        self,
        program: str,
        duration_s: float,
        start_wall_ns: int,
        steady: bool,
    ) -> None:
        """Deferred ``tpu.compile`` span: joins the calling thread's
        ambient trace when one exists, else the boot trace captured at
        construction, else mints its own."""
        tracer = get_tracer()
        if not tracer_active(tracer):
            return
        span = current_span()
        if span is not None:
            trace_id: str = span.trace_id
            parent_id: Optional[str] = span.span_id
        elif self._boot_ctx is not None:
            trace_id, parent_id = self._boot_ctx
        else:
            trace_id, parent_id = _rand_hex(16), None
        tracer.emit_span(
            "tpu.compile",
            trace_id=trace_id,
            parent_span_id=parent_id,
            start_ns=start_wall_ns,
            end_ns=start_wall_ns + int(duration_s * 1e9),
            attributes={
                "tpu.model": self.model_name,
                "tpu.program": program,
                "tpu.steady_state": steady,
            },
            status="ERROR" if steady else "OK",
        )

    # -- rendering -----------------------------------------------------

    def set_cache_info(self, info: dict[str, Any]) -> None:
        """Record the build directory's provenance (dir, enabled, error);
        :meth:`snapshot` adds a live entry count where it is readable."""
        self.cache_info = dict(info)

    def _cache_snapshot(self) -> Optional[dict[str, Any]]:
        if self.cache_info is None:
            return None
        out = dict(self.cache_info)
        try:
            out["entries"] = len(os.listdir(str(out.get("dir", ""))))
        except OSError:
            pass  # not created yet or unreadable: provenance still reports
        return out

    def snapshot(self) -> dict[str, Any]:
        cache = self._cache_snapshot()
        with self._lock:
            out: dict[str, Any] = {
                "total": self.total,
                "steady_state_recompiles": self.steady_state_recompiles,
                "warm": self._warm,
                "programs": {
                    name: {
                        "compiles": entry["compiles"],
                        "seconds_total": round(entry["seconds_total"], 6),
                    }
                    for name, entry in sorted(self._programs.items())
                },
            }
        if cache is not None:
            out["compile_cache"] = cache
        return out


def _call_signature(args: tuple, kwargs: dict) -> tuple:
    """Shape/dtype signature of a call's operands (the fallback compile
    detector): tensor-likes key by (shape, dtype), dict/tuple structures
    recurse, scalars by value. Attribute reads only: nothing here may
    read a tensor's values (that would wait on the device)."""

    def sig(x: Any) -> Any:
        shape = getattr(x, "shape", None)
        if shape is not None:
            return (tuple(shape), str(getattr(x, "dtype", "")))
        if isinstance(x, dict):
            return tuple(sorted((k, sig(v)) for k, v in x.items()))
        if isinstance(x, (list, tuple)):
            return tuple(sig(i) for i in x)
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        return type(x).__name__

    return (
        tuple(sig(a) for a in args),
        tuple(sorted((k, sig(v)) for k, v in kwargs.items())),
    )
