"""Versioned data migrations (reference: ``pkg/gofr/migration``).

The port's copy of ``gofr_tpu/migration/__init__.py``.
"""

from gofr_tpu_torch.migration.migration import Migrate, MigrationDatasources, run

__all__ = ["Migrate", "MigrationDatasources", "run"]
