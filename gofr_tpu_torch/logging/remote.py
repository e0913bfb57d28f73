"""Remote log-level hot reload (reference ``logging/dynamicLevelLogger.go:23-106``).

A background daemon thread polls ``REMOTE_LOG_URL`` every
``REMOTE_LOG_FETCH_INTERVAL`` seconds (default 15) and hot-swaps the wrapped
logger's level. The endpoint is expected to return
``{"data": [{"serviceName": ..., "logLevel": {"LOG_LEVEL": "DEBUG"}}]}`` —
the same shape the reference parses (``dynamicLevelLogger.go:84-106``).

The port's copy of ``gofr_tpu/logging/remote.py``. The reference fetches
through its instrumented service client (``gofr_tpu/service/client.py``),
which the port does not have yet (ROADMAP Queue 1 item 7); until then the
poll is a plain ``urllib`` GET with the same 5 s timeout, and records no
span and no ``app_http_service_response`` sample.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Any

from gofr_tpu_torch.logging.level import level_from_string
from gofr_tpu_torch.logging.logger import Logger

_FETCH_TIMEOUT_S = 5.0


class RemoteLevelLogger:
    """Wraps a :class:`Logger` and keeps its level in sync with a remote URL."""

    def __init__(
        self, logger: Logger, url: str, interval_s: float = 15.0,
        metrics: Any = None,
    ) -> None:
        self.logger = logger
        self._url = url
        self._interval = interval_s
        self._metrics = metrics
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None or not self._url:
            return
        self._thread = threading.Thread(
            target=self._run, name="remote-log-level", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.fetch_and_update()

    def fetch_and_update(self) -> None:
        """One poll cycle (reference ``dynamicLevelLogger.go:73-106``)."""
        try:
            with urllib.request.urlopen(self._url, timeout=_FETCH_TIMEOUT_S) as resp:
                body = json.loads(resp.read() or b"{}")
            data = body.get("data") or []
            if not data:
                return
            raw = (data[0].get("logLevel") or {}).get("LOG_LEVEL")
            if raw:
                new_level = level_from_string(raw, default=self.logger.level)
                if new_level != self.logger.level:
                    self.logger.change_level(new_level)
                    self.logger.infof("log level changed to %s remotely", new_level.name)
        except Exception as exc:  # polling must never kill the app
            self.logger.debugf("remote log level fetch failed: %s", exc)
