"""Dotenv-layered env config.

Behavioral contract (from the reference, re-implemented from scratch):

* ``Config`` is a two-method seam — ``get`` / ``get_or_default``
  (reference ``config/config.go:3-6``).
* ``EnvLoader`` reads ``<dir>/.env`` into the process environment, then
  overlays ``<dir>/.<APP_ENV>.env`` when ``APP_ENV`` is set, else
  ``<dir>/.local.env`` when present; overlay files *override* earlier values
  (reference ``config/godotenv.go:32-67``). Reads always come from the live
  process env so externally-set variables win at lookup time
  (reference ``config/godotenv.go:69-79``).

The port's copy of ``gofr_tpu/config/env.py``.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional, Protocol


class Config(Protocol):
    """Two-method config seam (reference ``config/config.go:3-6``)."""

    def get(self, key: str) -> Optional[str]: ...

    def get_or_default(self, key: str, default: str) -> str: ...


def _parse_dotenv(path: str) -> dict[str, str]:
    """Parse a dotenv file: KEY=VALUE lines, '#' comments, optional quotes."""
    out: dict[str, str] = {}
    try:
        with open(path, "r", encoding="utf-8") as fp:
            for raw in fp:
                line = raw.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                if line.startswith("export "):
                    line = line[len("export ") :]
                key, _, value = line.partition("=")
                key = key.strip()
                value = value.strip()
                # Strip one matching layer of quotes.
                if len(value) >= 2 and value[0] == value[-1] and value[0] in "'\"":
                    value = value[1:-1]
                else:
                    # Trailing inline comment (only outside quotes).
                    if " #" in value:
                        value = value.split(" #", 1)[0].rstrip()
                if key:
                    out[key] = value
    except FileNotFoundError:
        pass
    return out


class EnvLoader:
    """Loads dotenv files into ``os.environ`` and reads keys from it."""

    def __init__(self, config_dir: str, logger: Any = None) -> None:
        self._dir = config_dir
        self._logger = logger
        self._read()

    def _read(self) -> None:
        base = os.path.join(self._dir, ".env")
        base_vals = _parse_dotenv(base)
        # Base file must not override already-exported process env
        # (godotenv.Load semantics, reference config/godotenv.go:41).
        loaded = False
        for k, v in base_vals.items():
            loaded = True
            os.environ.setdefault(k, v)

        app_env = os.environ.get("APP_ENV", "")
        if app_env:
            overlay = os.path.join(self._dir, f".{app_env}.env")
        else:
            overlay = os.path.join(self._dir, ".local.env")
        overlay_vals = _parse_dotenv(overlay)
        # Overlay files DO override (godotenv.Overload semantics,
        # reference config/godotenv.go:50-63).
        for k, v in overlay_vals.items():
            loaded = True
            os.environ[k] = v

        if self._logger is not None:
            if overlay_vals:
                self._logger.info(f"Loaded config from {base} overlaid by {overlay}")
            elif loaded:
                self._logger.info(f"Loaded config from {base}")

    def get(self, key: str) -> Optional[str]:
        return os.environ.get(key)

    def get_or_default(self, key: str, default: str) -> str:
        val = os.environ.get(key)
        if val is None or val == "":
            return default
        return val


def new_env_file(config_dir: str, logger: Any = None) -> EnvLoader:
    """Factory mirroring the reference's ``config.NewEnvFile`` (``config/godotenv.go:25``)."""
    return EnvLoader(config_dir, logger)


class MockConfig:
    """Static map config for tests (reference ``config/mock_config.go:6-12``)."""

    def __init__(self, values: Mapping[str, str] | None = None) -> None:
        self._values = dict(values or {})

    def get(self, key: str) -> Optional[str]:
        return self._values.get(key)

    def get_or_default(self, key: str, default: str) -> str:
        val = self._values.get(key)
        if val is None or val == "":
            return default
        return val
