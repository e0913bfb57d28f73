"""In-process pub/sub broker.

The always-available backend: per-topic FIFO queues with at-least-once
delivery (messages are re-queued if not committed — the offset/commit
semantics the reference gets from Kafka consumer groups,
``kafka/message.go:26-31``). Used by examples, tests, and the offline batch
inference path (SURVEY §2.6 "offline batch path").

The port's copy of ``gofr_tpu/datasource/pubsub/inproc.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from gofr_tpu_torch.datasource.pubsub.base import Message, PubSubLog


class InProcBroker:
    def __init__(self, logger=None, metrics=None) -> None:
        self._logger = logger
        self._metrics = metrics
        self._topics: dict[str, queue.Queue] = {}
        self._lock = threading.Lock()
        self._closed = False

    def _queue(self, topic: str) -> queue.Queue:
        with self._lock:
            q = self._topics.get(topic)
            if q is None:
                q = queue.Queue()
                self._topics[topic] = q
            return q

    # -- Publisher (reference pubsub/interface.go:11-14) -------------------

    def publish(self, topic: str, message: bytes) -> None:
        if isinstance(message, str):
            message = message.encode()
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_pubsub_publish_total_count", "topic", topic
            )
        self._queue(topic).put(message)
        if self._logger is not None:
            self._logger.debug(PubSubLog("PUB", topic, message))
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_pubsub_publish_success_count", "topic", topic
            )

    # -- Subscriber (reference pubsub/interface.go:16-20) ------------------

    def subscribe(self, topic: str, timeout: Optional[float] = None) -> Optional[Message]:
        """Blocking poll for one message; None on timeout/close."""
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_pubsub_subscribe_total_count", "topic", topic
            )
        q = self._queue(topic)
        try:
            value = q.get(timeout=timeout if timeout is not None else 0.5)
        except queue.Empty:
            return None
        if self._logger is not None:
            self._logger.debug(PubSubLog("SUB", topic, value))

        def _commit() -> None:
            if self._metrics is not None:
                self._metrics.increment_counter(
                    "app_pubsub_subscribe_success_count", "topic", topic
                )

        return Message(topic=topic, value=value, committer=_commit)

    # -- topic admin (used by migrations, reference migration/pubsub.go) ---

    def create_topic(self, name: str) -> None:
        self._queue(name)

    def delete_topic(self, name: str) -> None:
        with self._lock:
            self._topics.pop(name, None)

    def topics(self) -> list[str]:
        with self._lock:
            return list(self._topics)

    # -- lifecycle ---------------------------------------------------------

    def health_check(self) -> dict:
        with self._lock:
            return {
                "status": "UP",
                "details": {
                    "backend": "INPROC",
                    "topics": {t: q.qsize() for t, q in self._topics.items()},
                },
            }

    def close(self) -> None:
        self._closed = True
