"""Metrics manager and instrument registry.

Capability parity with the reference's ``metrics/register.go:15-270``:

* ``new_counter`` / ``new_updown_counter`` / ``new_histogram`` / ``new_gauge``
  register instruments by name (duplicate registration logs an error);
* ``increment_counter`` / ``delta_updown_counter`` / ``record_histogram`` /
  ``set_gauge`` record by name with key=value labels;
* labels must come in pairs and recording on an unregistered name logs an
  error instead of raising (reference ``register.go:168-247``);
* a cardinality warning fires when a metric exceeds 20 distinct label sets
  (reference ``register.go:249-270``);
* gauges are *settable* synchronous gauges keyed by label set — the reference
  built a custom callback gauge for exactly this (``register.go:41-43``).

TPU-first deltas: locking is per-instrument so unrelated metrics never
contend on the request/decode hot path, and the serving engine registers
per-chip gauges (queue depth, HBM used) on the same registry.

This module is in the strict-mypy scope (pyproject ``[tool.mypy]``).

The port's copy of ``gofr_tpu/metrics/manager.py``.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Optional, Sequence

_CARDINALITY_WARN_AT = 20

DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 7.5, 10.0,
)

#: A recorded label set: sorted ((key, value), ...) pairs.
LabelSet = tuple[tuple[str, str], ...]

#: One histogram series: (per-bucket counts, [sum, count]).
HistogramSeries = tuple[list[int], list[float]]


def _labelset(labels: tuple) -> LabelSet:
    if len(labels) % 2 != 0:
        raise ValueError("labels must be key/value pairs")
    pairs = [(str(labels[i]), str(labels[i + 1])) for i in range(0, len(labels), 2)]
    pairs.sort()
    return tuple(pairs)


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, description: str) -> None:
        self.name = name
        self.description = description
        self._lock = threading.Lock()
        self._series: dict[LabelSet, Any] = {}

    def labelsets(self) -> list[LabelSet]:
        with self._lock:
            return list(self._series.keys())


class Counter(_Instrument):
    kind = "counter"

    def add(self, value: float, labels: tuple) -> None:
        key = _labelset(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def collect(self) -> dict[LabelSet, float]:
        with self._lock:
            return dict(self._series)


class UpDownCounter(Counter):
    kind = "gauge"  # prometheus has no signed counter; exposed as gauge


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, labels: tuple) -> None:
        key = _labelset(labels)
        with self._lock:
            self._series[key] = float(value)

    def collect(self) -> dict[LabelSet, float]:
        with self._lock:
            return dict(self._series)


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name: str, description: str, buckets: Sequence[float]) -> None:
        super().__init__(name, description)
        self.buckets: tuple[float, ...] = tuple(sorted(buckets))

    def record(self, value: float, labels: tuple) -> None:
        key = _labelset(labels)
        with self._lock:
            series: Optional[HistogramSeries] = self._series.get(key)
            if series is None:
                # bucket counts, (sum, count)
                series = [0] * (len(self.buckets) + 1), [0.0, 0]
                self._series[key] = series
            counts, agg = series
            # Prometheus `le` is inclusive: first bucket with bound >= value.
            idx = bisect_left(self.buckets, value)
            counts[min(idx, len(counts) - 1)] += 1
            agg[0] += value
            agg[1] += 1

    def collect(self) -> dict[LabelSet, tuple[list[int], tuple[float, float]]]:
        with self._lock:
            return {
                key: ([*counts], (agg[0], agg[1]))
                for key, (counts, agg) in self._series.items()
            }


class Manager:
    """Thread-safe instrument registry (reference ``metrics/register.go:15-25``)."""

    def __init__(self, logger: Any = None) -> None:
        self._logger = logger
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}
        self._warned: set[str] = set()

    # -- registration (reference register.go:62-145) ---------------------

    def _register(self, inst: _Instrument) -> None:
        with self._lock:
            if inst.name in self._instruments:
                self._log_error(f"metrics {inst.name} already registered")
                return
            self._instruments[inst.name] = inst

    def new_counter(self, name: str, description: str = "") -> None:
        self._register(Counter(name, description))

    def new_updown_counter(self, name: str, description: str = "") -> None:
        self._register(UpDownCounter(name, description))

    def new_histogram(
        self, name: str, description: str = "", buckets: Sequence[float] = DEFAULT_BUCKETS
    ) -> None:
        self._register(Histogram(name, description, buckets))

    def new_gauge(self, name: str, description: str = "") -> None:
        self._register(Gauge(name, description))

    # -- recording (reference register.go:168-247) -----------------------

    def _get(self, name: str, cls: type) -> Optional[_Instrument]:
        inst = self._instruments.get(name)
        if inst is None:
            self._log_error(f"metrics {name} is not registered")
            return None
        # Exact-type match: an UpDownCounter may not be used as a Counter.
        if type(inst) is not cls:
            self._log_error(f"metrics {name} is not of type {cls.__name__}")
            return None
        return inst

    def increment_counter(self, name: str, *labels: Any) -> None:
        inst = self._get(name, Counter)
        if not isinstance(inst, Counter):
            return
        try:
            inst.add(1.0, labels)
        except ValueError as exc:
            self._log_error(f"metrics {name}: {exc}")
            return
        self._check_cardinality(inst)

    def add_counter(self, name: str, value: float, *labels: Any) -> None:
        """Increment a counter by ``value`` (>0) — token-denominated
        counters (e.g. prefix hit tokens) add per-request amounts in one
        call instead of N increments."""
        inst = self._get(name, Counter)
        if not isinstance(inst, Counter):
            return
        try:
            inst.add(float(value), labels)
        except ValueError as exc:
            self._log_error(f"metrics {name}: {exc}")
            return
        self._check_cardinality(inst)

    def delta_updown_counter(self, name: str, value: float, *labels: Any) -> None:
        inst = self._get(name, UpDownCounter)
        if not isinstance(inst, UpDownCounter):
            return
        try:
            inst.add(value, labels)
        except ValueError as exc:
            self._log_error(f"metrics {name}: {exc}")
            return
        self._check_cardinality(inst)

    def record_histogram(self, name: str, value: float, *labels: Any) -> None:
        inst = self._get(name, Histogram)
        if not isinstance(inst, Histogram):
            return
        try:
            inst.record(value, labels)
        except ValueError as exc:
            self._log_error(f"metrics {name}: {exc}")
            return
        self._check_cardinality(inst)

    def set_gauge(self, name: str, value: float, *labels: Any) -> None:
        inst = self._get(name, Gauge)
        if not isinstance(inst, Gauge):
            return
        try:
            inst.set(value, labels)
        except ValueError as exc:
            self._log_error(f"metrics {name}: {exc}")
            return
        self._check_cardinality(inst)

    def _check_cardinality(self, inst: _Instrument) -> None:
        # Reference register.go:249-270 warns above 20 distinct label sets.
        if inst.name in self._warned:
            return
        if len(inst._series) > _CARDINALITY_WARN_AT:
            self._warned.add(inst.name)
            if self._logger is not None:
                self._logger.warnf(
                    "metric %s has high cardinality: %d label sets",
                    inst.name,
                    len(inst._series),
                )

    def _log_error(self, msg: str) -> None:
        if self._logger is not None:
            self._logger.error(msg)

    # -- collection ------------------------------------------------------

    def instruments(self) -> list[_Instrument]:
        with self._lock:
            return list(self._instruments.values())


def new_metrics_manager(logger: Any = None) -> Manager:
    """Reference ``metrics/register.go:49-55``."""
    return Manager(logger=logger)
