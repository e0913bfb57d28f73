"""Log levels (reference ``logging/level.go:8-17,52-66``).

The port's copy of ``gofr_tpu/logging/level.py``.
"""

from __future__ import annotations

import enum


class Level(enum.IntEnum):
    DEBUG = 1
    INFO = 2
    NOTICE = 3
    WARN = 4
    ERROR = 5
    FATAL = 6

    @property
    def color(self) -> int:
        """ANSI 256-color code for terminal pretty printing
        (reference ``logging/level.go:33-50``)."""
        return {
            Level.DEBUG: 7,  # light grey
            Level.INFO: 6,  # cyan
            Level.NOTICE: 6,
            Level.WARN: 3,  # yellow
            Level.ERROR: 160,  # red
            Level.FATAL: 160,
        }[self]


def level_from_string(s: str | None, default: Level = Level.INFO) -> Level:
    """Parse LOG_LEVEL-style strings case-insensitively
    (reference ``logging/level.go:52-66``)."""
    if not s:
        return default
    try:
        return Level[s.strip().upper()]
    except KeyError:
        return default
