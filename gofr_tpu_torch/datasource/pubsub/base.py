"""Message model + shared pub/sub logging.

Reference: ``pubsub/message.go:8-52`` (Message implements the Request
interface so subscription handlers get a normal Context) and
``pubsub/log.go:8-22`` (shared PUB/SUB structured log).

The port's copy of ``gofr_tpu/datasource/pubsub/base.py``.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Optional


class Message:
    """A consumed message; presented to handlers as the Request."""

    def __init__(
        self,
        topic: str,
        value: bytes,
        metadata: Optional[dict] = None,
        committer: Optional[Callable[[], None]] = None,
    ) -> None:
        self.topic = topic
        self.value = value
        self.metadata = metadata or {}
        self._committer = committer
        self.committed = False

    # -- Request interface (reference message.go:30-52) -------------------

    def param(self, key: str) -> str:
        if key == "topic":
            return self.topic
        return str(self.metadata.get(key, ""))

    def path_param(self, key: str) -> str:
        return self.param(key)

    @property
    def body(self) -> bytes:
        return self.value

    def json(self) -> Any:
        return json.loads(self.value or b"null")

    def bind(self, target: Any) -> Any:
        from gofr_tpu_torch.http.request import _fill

        data = self.json()
        if not isinstance(data, dict):
            raise ValueError("message body is not a JSON object")
        return _fill(target, data)

    def host_name(self) -> str:
        return ""

    def commit(self) -> None:
        """Ack the message after successful handling
        (reference ``subscriber.go:51-52`` → ``kafka/message.go:26-31``)."""
        if self._committer is not None and not self.committed:
            self._committer()
        self.committed = True


class PubSubLog:
    """Structured PUB/SUB log line (reference ``pubsub/log.go:8-22``)."""

    def __init__(self, mode: str, topic: str, value: bytes, host: str = "inproc") -> None:
        self.mode = mode  # "PUB" or "SUB"
        self.topic = topic
        self.value = value[:128].decode("utf-8", "replace")
        self.host = host

    def to_log_dict(self) -> dict:
        return {
            "mode": self.mode,
            "topic": self.topic,
            "host": self.host,
            "value": self.value,
        }

    def pretty_print(self, fp) -> None:
        fp.write(f"\x1b[38;5;8m{self.mode}\x1b[0m topic={self.topic} {self.value}\n")
