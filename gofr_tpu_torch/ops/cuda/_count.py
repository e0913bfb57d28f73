"""Launch counters that count the launches the device runs.

A wrapper calls ``launched(__name__)`` where it launches its kernel. Run
eagerly, that adds one to the module's ``launches``. Under a CUDA graph
capture nothing runs, so ``recording()`` collects the capture's launches
per module instead, and whoever replays the graph adds them back with
``replayed(counts, times)`` once per replay (``times``: how often a
device-side loop ran the captured body). A launch captured outside
``recording()`` raises: its replays could not be counted.
"""

from __future__ import annotations

import collections
import sys
import threading
from contextlib import contextmanager
from typing import Iterator

import torch

_tls = threading.local()


def launched(module: str) -> None:
    """One launch of the kernel of wrapper module ``module``."""
    record = getattr(_tls, "record", None)
    if record is not None:
        record[module] += 1
    elif torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{module} launched under a CUDA graph capture outside "
            "ops.cuda.recording(): the graph's replays would not be counted"
        )
    else:
        sys.modules[module].launches += 1


@contextmanager
def recording() -> Iterator["collections.Counter[str]"]:
    """The launches this thread makes inside the block, by wrapper module,
    in place of counting them (a graph capture's)."""
    prev = getattr(_tls, "record", None)
    record: collections.Counter[str] = collections.Counter()
    _tls.record = record
    try:
        yield record
    finally:
        _tls.record = prev


def replayed(record: "collections.Counter[str]", times: int = 1) -> None:
    """Count ``times`` runs of a captured graph whose launches ``record``
    holds."""
    for module, n in record.items():
        sys.modules[module].launches += n * int(times)
