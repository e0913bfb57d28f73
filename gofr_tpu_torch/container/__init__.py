"""Dependency-injection container (reference: ``pkg/gofr/container``).

The port's copy of ``gofr_tpu/container/__init__.py``.
"""

from gofr_tpu_torch.container.container import Container

__all__ = ["Container"]
