"""Structured leveled logging (reference: ``pkg/gofr/logging``).

Leveled JSON logger with terminal pretty-printing, stdout/stderr split at
ERROR, file logger for CLI apps, and hot-swappable level — the capability set
of the reference's ``logging/logger.go`` + ``logging/dynamicLevelLogger.go``.

The port's copy of ``gofr_tpu/logging/__init__.py``.
"""

from gofr_tpu_torch.logging.level import Level, level_from_string
from gofr_tpu_torch.logging.logger import (
    Logger,
    PrettyPrint,
    new_file_logger,
    new_logger,
    new_logger_from_env,
)
from gofr_tpu_torch.logging.remote import RemoteLevelLogger

__all__ = [
    "Level",
    "level_from_string",
    "Logger",
    "PrettyPrint",
    "new_logger",
    "new_logger_from_env",
    "new_file_logger",
    "RemoteLevelLogger",
]
