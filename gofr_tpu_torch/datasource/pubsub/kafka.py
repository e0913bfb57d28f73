"""Kafka pub/sub backend behind driver-interface seams.

Reference: ``pkg/gofr/datasource/pubsub/kafka`` — single shared writer,
per-topic readers in a mutex-guarded map (``kafka.go:23-28,45-96``),
consumer-group offsets committed after successful handling
(``message.go:26-31``), topic admin via the controller connection
(``kafka.go:204-235``), health = controller ping + stats (``health.go:9-26``).

The reference builds on a driver library (segmentio/kafka-go) and tests by
mocking the ``Reader``/``Writer``/``Connection`` interfaces
(``kafka/interfaces.go:9-24``, SURVEY §4); this port does the same: the
client is written against :class:`Reader`/:class:`Writer`/:class:`Admin`
protocols, and tests inject in-memory fakes.

The port's copy of ``gofr_tpu/datasource/pubsub/kafka.py``. The port
imports no driver: where the reference wires ``kafka-python`` when it is
installed, :func:`new_kafka_from_config` here always raises
:class:`PubSubBackendUnavailable`, as the reference's does without the
driver.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Protocol

from gofr_tpu_torch.datasource.pubsub.base import Message, PubSubLog


class PubSubBackendUnavailable(RuntimeError):
    """Raised when a broker backend's driver library is not installed."""


class Writer(Protocol):
    def write(self, topic: str, value: bytes) -> None: ...
    def close(self) -> None: ...


class Reader(Protocol):
    def read(self, timeout: Optional[float]) -> Optional[tuple[bytes, Callable[[], None]]]:
        """Return (value, commit_fn) or None on timeout."""
    def close(self) -> None: ...


class Admin(Protocol):
    def create_topic(self, name: str) -> None: ...
    def delete_topic(self, name: str) -> None: ...
    def ping(self) -> bool: ...


class KafkaClient:
    """Framework pub/sub surface over injected Reader/Writer/Admin."""

    def __init__(
        self,
        writer: Writer,
        reader_factory: Callable[[str], Reader],
        admin: Admin,
        brokers: str = "",
        logger=None,
        metrics=None,
    ) -> None:
        self._writer = writer
        self._reader_factory = reader_factory
        self._admin = admin
        self._brokers = brokers
        self._logger = logger
        self._metrics = metrics
        # Per-topic readers, created lazily (reference kafka.go:23-28 keeps
        # them in a mutex-guarded map).
        self._readers: dict[str, Reader] = {}
        self._lock = threading.Lock()

    # -- Publisher ----------------------------------------------------------

    def publish(self, topic: str, message: bytes) -> None:
        if isinstance(message, str):
            message = message.encode()
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_pubsub_publish_total_count", "topic", topic
            )
        self._writer.write(topic, message)
        if self._logger is not None:
            self._logger.debug(PubSubLog("PUB", topic, message, host=self._brokers))
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_pubsub_publish_success_count", "topic", topic
            )

    # -- Subscriber ---------------------------------------------------------

    def _reader(self, topic: str) -> Reader:
        with self._lock:
            r = self._readers.get(topic)
            if r is None:
                r = self._readers[topic] = self._reader_factory(topic)
            return r

    def subscribe(self, topic: str, timeout: Optional[float] = None) -> Optional[Message]:
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_pubsub_subscribe_total_count", "topic", topic
            )
        got = self._reader(topic).read(timeout if timeout is not None else 0.5)
        if got is None:
            return None
        value, commit_fn = got
        if self._logger is not None:
            self._logger.debug(PubSubLog("SUB", topic, value, host=self._brokers))

        def _commit() -> None:
            commit_fn()
            if self._metrics is not None:
                self._metrics.increment_counter(
                    "app_pubsub_subscribe_success_count", "topic", topic
                )

        return Message(topic=topic, value=value, committer=_commit)

    # -- topic admin (reference kafka.go:204-235) ---------------------------

    def create_topic(self, name: str) -> None:
        self._admin.create_topic(name)

    def delete_topic(self, name: str) -> None:
        self._admin.delete_topic(name)

    # -- lifecycle ----------------------------------------------------------

    def health_check(self) -> dict:
        up = False
        try:
            up = self._admin.ping()
        except Exception:  # noqa: BLE001 — any driver error means DOWN
            pass
        return {
            "status": "UP" if up else "DOWN",
            "details": {
                "backend": "KAFKA",
                "brokers": self._brokers,
                "readers": sorted(self._readers),
            },
        }

    def close(self) -> None:
        with self._lock:
            readers, self._readers = list(self._readers.values()), {}
        for r in readers:
            r.close()
        self._writer.close()
        if hasattr(self._admin, "close"):
            self._admin.close()


def new_kafka_from_config(config, logger=None, metrics=None) -> KafkaClient:
    """``PUBSUB_BACKEND=KAFKA``: the port bundles no Kafka driver, so this
    raises :class:`PubSubBackendUnavailable` with the reference's message
    for a missing driver, and the container boots without pub/sub. An app
    with its own driver injects ``KafkaClient(writer, reader_factory,
    admin)`` through ``app.use_pubsub``.
    """
    raise PubSubBackendUnavailable(
        "PUBSUB_BACKEND=KAFKA needs the 'kafka-python' driver, which is "
        "not installed in this environment. Use PUBSUB_BACKEND=INPROC or "
        "MQTT, or inject a custom client via app.use_pubsub(...)."
    )
