"""Deterministic fault-injection harness (``gofr_tpu_torch.faults``).

Named injection points at the serving core's failure seams — device
step raises, stalled step, tokenizer failure, submit-path exception —
armed per-test so every resilience behavior is exercised without a TPU
and without sleeps. See ``injector.py`` for the point catalog and
``docs/advanced-guide/resilience.md`` for usage. The port's copy of
``gofr_tpu/faults``.
"""

from gofr_tpu_torch.faults.injector import (
    FaultInjector,
    arm,
    armed,
    default_injector,
    disarm,
    fire,
    fired,
    reset,
)

__all__ = [
    "FaultInjector",
    "arm",
    "armed",
    "default_injector",
    "disarm",
    "fire",
    "fired",
    "reset",
]
