"""Google Cloud Pub/Sub backend behind a driver seam.

Reference: ``pkg/gofr/datasource/pubsub/google`` — GCP client with topic
auto-create on publish/subscribe (``google.go:73-113``), subscription name
``${SUB}-${topic}`` auto-created per topic (``google.go:115-166``), receive
callback delivering one message per ``Subscribe`` call
(``google.go:168-205``).

Like the Kafka client, it is written against a small seam
(:class:`GooglePubSubDriver`); tests inject an in-memory fake.

The port's copy of ``gofr_tpu/datasource/pubsub/google.py``. The port
imports no driver: :func:`new_google_from_config` always raises
:class:`PubSubBackendUnavailable`, as the reference's does without
``google-cloud-pubsub``.
"""

from __future__ import annotations

from typing import Optional, Protocol

from gofr_tpu_torch.datasource.pubsub.base import Message, PubSubLog
from gofr_tpu_torch.datasource.pubsub.kafka import PubSubBackendUnavailable


class GooglePubSubDriver(Protocol):
    """Thin driver surface the client needs (auto-create included)."""

    def ensure_topic(self, topic: str) -> None: ...
    def ensure_subscription(self, topic: str, subscription: str) -> None: ...
    def publish(self, topic: str, value: bytes) -> None: ...
    def pull_one(
        self, subscription: str, timeout: float
    ) -> Optional[tuple[bytes, "object"]]:
        """Return (value, ack_handle) or None on timeout."""
    def ack(self, subscription: str, ack_handle: "object") -> None: ...
    def delete_topic(self, topic: str) -> None: ...
    def ping(self) -> bool: ...
    def close(self) -> None: ...


class GooglePubSubClient:
    def __init__(
        self,
        driver: GooglePubSubDriver,
        subscription_name: str = "gofr-tpu",
        project: str = "",
        logger=None,
        metrics=None,
    ) -> None:
        self._driver = driver
        self._sub_name = subscription_name
        self._project = project
        self._logger = logger
        self._metrics = metrics
        self._known_topics: set[str] = set()
        self._known_subs: set[str] = set()

    def _sub_for(self, topic: str) -> str:
        # Reference naming: ${SUBSCRIPTION}-${topic} (google.go:115-166).
        return f"{self._sub_name}-{topic}"

    def _ensure(self, topic: str, with_sub: bool) -> None:
        if topic not in self._known_topics:
            self._driver.ensure_topic(topic)
            self._known_topics.add(topic)
        if with_sub:
            sub = self._sub_for(topic)
            if sub not in self._known_subs:
                self._driver.ensure_subscription(topic, sub)
                self._known_subs.add(sub)

    # -- Publisher ----------------------------------------------------------

    def publish(self, topic: str, message: bytes) -> None:
        if isinstance(message, str):
            message = message.encode()
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_pubsub_publish_total_count", "topic", topic
            )
        self._ensure(topic, with_sub=False)
        self._driver.publish(topic, message)
        if self._logger is not None:
            self._logger.debug(PubSubLog("PUB", topic, message, host=self._project))
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_pubsub_publish_success_count", "topic", topic
            )

    # -- Subscriber ---------------------------------------------------------

    def subscribe(self, topic: str, timeout: Optional[float] = None) -> Optional[Message]:
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_pubsub_subscribe_total_count", "topic", topic
            )
        self._ensure(topic, with_sub=True)
        sub = self._sub_for(topic)
        got = self._driver.pull_one(sub, timeout if timeout is not None else 0.5)
        if got is None:
            return None
        value, handle = got
        if self._logger is not None:
            self._logger.debug(PubSubLog("SUB", topic, value, host=self._project))

        def _commit() -> None:
            self._driver.ack(sub, handle)
            if self._metrics is not None:
                self._metrics.increment_counter(
                    "app_pubsub_subscribe_success_count", "topic", topic
                )

        return Message(topic=topic, value=value, committer=_commit)

    # -- topic admin --------------------------------------------------------

    def create_topic(self, name: str) -> None:
        self._ensure(name, with_sub=False)

    def delete_topic(self, name: str) -> None:
        self._driver.delete_topic(name)
        self._known_topics.discard(name)

    # -- lifecycle ----------------------------------------------------------

    def health_check(self) -> dict:
        up = False
        try:
            up = self._driver.ping()
        except Exception:  # noqa: BLE001
            pass
        return {
            "status": "UP" if up else "DOWN",
            "details": {"backend": "GOOGLE", "project": self._project},
        }

    def close(self) -> None:
        self._driver.close()


def new_google_from_config(config, logger=None, metrics=None) -> GooglePubSubClient:
    """``PUBSUB_BACKEND=GOOGLE``: the port bundles no Google Cloud driver,
    so this raises :class:`PubSubBackendUnavailable` with the reference's
    message for a missing driver, and the container boots without pub/sub.
    An app with its own driver injects ``GooglePubSubClient(driver)``
    through ``app.use_pubsub``.
    """
    raise PubSubBackendUnavailable(
        "PUBSUB_BACKEND=GOOGLE needs the 'google-cloud-pubsub' driver, "
        "which is not installed in this environment. Use "
        "PUBSUB_BACKEND=INPROC or MQTT, or inject a custom client."
    )
