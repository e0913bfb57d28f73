"""Leveled JSON/pretty logger.

Capability parity with the reference's ``logging/logger.go:17-196``:

* 6 levels × plain + ``*f`` formatting variants;
* JSON lines when the sink is not a TTY, colorized human format when it is;
* messages below ERROR go to stdout, ERROR+ to stderr
  (reference ``logging/logger.go:54-85``);
* structured payloads implementing :class:`PrettyPrint` render themselves in
  terminal mode (reference ``logging/logger.go:17-19,146-160``);
* ``change_level`` hot-swaps the level (used by the remote level poller,
  reference ``logging/dynamicLevelLogger.go:52-71``);
* ``new_file_logger`` for CLI apps (reference ``logging/logger.go:177-196``).

The port's copy of ``gofr_tpu/logging/logger.py``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Optional, Protocol, TextIO, runtime_checkable

from gofr_tpu_torch.logging.level import Level, level_from_string


@runtime_checkable
class PrettyPrint(Protocol):
    """Structured log payloads render themselves on terminals
    (reference ``logging/logger.go:17-19``)."""

    def pretty_print(self, fp: TextIO) -> None: ...


def _is_terminal(fp: TextIO) -> bool:
    try:
        return fp.isatty()
    except (AttributeError, ValueError):
        return False


def _jsonable(value: Any) -> Any:
    if value is None or isinstance(value, (str, int, float, bool)):
        return value
    if isinstance(value, BaseException):
        return f"{type(value).__name__}: {value}"
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if hasattr(value, "to_log_dict"):
        return _jsonable(value.to_log_dict())
    if hasattr(value, "__dict__"):
        return {k: _jsonable(v) for k, v in vars(value).items() if not k.startswith("_")}
    return str(value)


class Logger:
    """Concrete leveled logger. Thread-safe; level is hot-swappable."""

    def __init__(
        self,
        level: Level = Level.INFO,
        out: TextIO | None = None,
        err: TextIO | None = None,
        is_terminal: Optional[bool] = None,
    ) -> None:
        self.level = level
        self._out = out if out is not None else sys.stdout
        self._err = err if err is not None else sys.stderr
        self._lock = threading.Lock()
        self._is_terminal = (
            is_terminal if is_terminal is not None else _is_terminal(self._out)
        )

    # -- core ------------------------------------------------------------

    def change_level(self, level: Level) -> None:
        self.level = level

    def _logf(self, level: Level, args: tuple, fmt: Optional[str] = None) -> None:
        if level < self.level:
            return
        fp = self._err if level >= Level.ERROR else self._out
        if fmt is not None:
            # Never let a bad format string crash the caller (Go's Sprintf
            # contract: formatting errors degrade, they don't panic).
            try:
                message: Any = (fmt % args) if args else fmt
            except (TypeError, ValueError):
                message = f"{fmt} {args!r}"
        elif len(args) == 1:
            message = args[0]
        else:
            message = " ".join(str(a) for a in args)

        now = time.time()
        with self._lock:
            if self._is_terminal:
                self._pretty(fp, level, now, message)
            else:
                record = {
                    "level": level.name,
                    "time": time.strftime(
                        "%Y-%m-%dT%H:%M:%S", time.localtime(now)
                    )
                    + f".{int((now % 1) * 1e6):06d}",
                    "message": _jsonable(message),
                }
                # dumps + ONE write, not json.dump's token-at-a-time
                # streaming (~46 TextIOWrapper.write calls per record —
                # profiled as the hot-path cost of the per-request log).
                fp.write(json.dumps(record, default=str) + "\n")
            try:
                fp.flush()
            except (ValueError, OSError):
                pass

    def _pretty(self, fp: TextIO, level: Level, now: float, message: Any) -> None:
        # "LEVL [ts] message" with ANSI color, mirroring
        # reference logging/logger.go:146-160.
        ts = time.strftime("%H:%M:%S", time.localtime(now))
        fp.write(f"\x1b[38;5;{level.color}m{level.name[:4]}\x1b[0m [{ts}] ")
        if isinstance(message, PrettyPrint) and not isinstance(message, str):
            message.pretty_print(fp)
        elif isinstance(message, (dict, list)):
            fp.write(json.dumps(_jsonable(message)))
            fp.write("\n")
        else:
            fp.write(f"{message}\n")

    # -- leveled methods (reference logging/logger.go:21-38) -------------

    def debug(self, *args: Any) -> None:
        self._logf(Level.DEBUG, args)

    def debugf(self, fmt: str, *args: Any) -> None:
        self._logf(Level.DEBUG, args, fmt)

    def log(self, *args: Any) -> None:
        self._logf(Level.INFO, args)

    def logf(self, fmt: str, *args: Any) -> None:
        self._logf(Level.INFO, args, fmt)

    def info(self, *args: Any) -> None:
        self._logf(Level.INFO, args)

    def infof(self, fmt: str, *args: Any) -> None:
        self._logf(Level.INFO, args, fmt)

    def notice(self, *args: Any) -> None:
        self._logf(Level.NOTICE, args)

    def noticef(self, fmt: str, *args: Any) -> None:
        self._logf(Level.NOTICE, args, fmt)

    def warn(self, *args: Any) -> None:
        self._logf(Level.WARN, args)

    def warnf(self, fmt: str, *args: Any) -> None:
        self._logf(Level.WARN, args, fmt)

    def error(self, *args: Any) -> None:
        self._logf(Level.ERROR, args)

    def errorf(self, fmt: str, *args: Any) -> None:
        self._logf(Level.ERROR, args, fmt)

    def fatal(self, *args: Any) -> None:
        """Log at FATAL and raise SystemExit(1) (Go's ``log.Fatal`` contract)."""
        self._logf(Level.FATAL, args)
        raise SystemExit(1)

    def fatalf(self, fmt: str, *args: Any) -> None:
        self._logf(Level.FATAL, args, fmt)
        raise SystemExit(1)


def new_logger(level: Level = Level.INFO, **kw: Any) -> Logger:
    """Reference ``logging/logger.go:163-168``."""
    return Logger(level=level, **kw)


def new_logger_from_env(config: Any = None) -> Logger:
    """Build a logger from ``LOG_LEVEL`` (reference ``container/container.go:66``)."""
    raw = config.get("LOG_LEVEL") if config is not None else os.environ.get("LOG_LEVEL")
    return Logger(level=level_from_string(raw))


def new_file_logger(path: str) -> Logger:
    """File-sink logger for CLI apps (reference ``logging/logger.go:177-196``).

    An empty path yields a silent logger, matching the reference's behavior of
    discarding output when ``CMD_LOGS_FILE`` is unset.
    """
    if not path:
        sink: TextIO = open(os.devnull, "w", encoding="utf-8")
    else:
        sink = open(path, "a", encoding="utf-8")
    return Logger(level=Level.INFO, out=sink, err=sink, is_terminal=False)
