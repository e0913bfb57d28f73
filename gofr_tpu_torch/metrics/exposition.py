"""Prometheus text-format exposition.

Renders a :class:`gofr_tpu_torch.metrics.manager.Manager` registry in Prometheus
text format v0.0.4 — the role the reference delegates to the OTel prometheus
reader + promhttp (``metrics/exporters/exporter.go:14-29``,
``metrics/handler.go:12-19``). Includes per-scrape process/runtime gauges,
mirroring ``metrics/handler.go:21-35`` (goroutines/heap/GC there; here
threads, RSS, GC stats, plus accelerator device count).

The port's copy of ``gofr_tpu/metrics/exposition.py``.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from typing import Iterable

from gofr_tpu_torch.metrics.manager import Counter, Gauge, Histogram, Manager, UpDownCounter
from gofr_tpu_torch.version import FRAMEWORK_VERSION

_START_TIME = time.time()


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(pairs: Iterable[tuple[str, str]], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in pairs]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as fp:
            return int(fp.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        return 0


def render_prometheus(manager: Manager, app_name: str = "gofr-tpu-app") -> str:
    out: list[str] = []
    # Per-scrape runtime stats (reference metrics/handler.go:21-35).
    gc_counts = gc.get_count()
    runtime: dict[str, float] = {
        "process_threads": threading.active_count(),
        "process_resident_memory_bytes": _rss_bytes(),
        "process_uptime_seconds": time.time() - _START_TIME,
        "python_gc_gen0_collections": gc.get_stats()[0].get("collections", 0),
        "python_gc_objects_tracked": sum(gc_counts),
    }
    out.append(
        f'# HELP app_info build/runtime info\n# TYPE app_info gauge\n'
        f'app_info{{app="{_escape(app_name)}",framework_version="{FRAMEWORK_VERSION}"}} 1\n'
    )
    for name, val in runtime.items():
        out.append(f"# TYPE {name} gauge\n{name} {val}\n")

    for inst in manager.instruments():
        if inst.description:
            out.append(f"# HELP {inst.name} {_escape(inst.description)}\n")
        out.append(f"# TYPE {inst.name} {inst.kind}\n")
        if isinstance(inst, Histogram):
            for key, (counts, (total, count)) in inst.collect().items():
                cumulative = 0
                for bound, c in zip(inst.buckets, counts):
                    cumulative += c
                    le = 'le="' + str(bound) + '"'
                    out.append(f"{inst.name}_bucket{_fmt_labels(key, le)} {cumulative}\n")
                cumulative += counts[-1]
                # NB: hoisted out of the f-string — a backslash inside an
                # f-string expression is a SyntaxError before Python 3.12.
                le_inf = 'le="+Inf"'
                out.append(
                    f"{inst.name}_bucket{_fmt_labels(key, le_inf)} {cumulative}\n"
                )
                out.append(f"{inst.name}_sum{_fmt_labels(key)} {total}\n")
                out.append(f"{inst.name}_count{_fmt_labels(key)} {count}\n")
        elif isinstance(inst, (Counter, UpDownCounter, Gauge)):
            for key, val in inst.collect().items():
                out.append(f"{inst.name}{_fmt_labels(key)} {val}\n")
    return "".join(out)
