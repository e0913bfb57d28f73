"""Metrics layer (reference: ``pkg/gofr/metrics``).

A name→instrument registry with counter / up-down counter / histogram /
settable gauge, label validation, cardinality warnings, and Prometheus text
exposition — the capability set of the reference's ``metrics/register.go`` +
``metrics/exporters/exporter.go``, implemented natively (no OTel SDK on the
hot path).

The port's copy of ``gofr_tpu/metrics/__init__.py``.
"""

from gofr_tpu_torch.metrics.manager import Manager, new_metrics_manager
from gofr_tpu_torch.metrics.exposition import render_prometheus

__all__ = ["Manager", "new_metrics_manager", "render_prometheus"]
