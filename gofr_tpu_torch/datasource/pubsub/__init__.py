"""Pub/Sub datasource (reference: ``pkg/gofr/datasource/pubsub``).

``Message`` doubles as the request object for subscription handlers exactly
like the reference (``pubsub/message.go:8-52``): ``bind`` JSON-decodes the
payload and ``param("topic")`` returns the topic. Backends, selected via
``PUBSUB_BACKEND`` (reference ``container/container.go:85-130``):

* ``INPROC`` — always-available in-process broker (tests/examples/offline
  batch path);
* ``MQTT`` — dependency-free MQTT 3.1.1 wire-protocol client
  (``mqtt.py``); tested against ``testutil.mqtt_broker``;
* ``KAFKA`` / ``GOOGLE`` — clients written against driver seams
  (``kafka.py`` / ``google.py``); they raise
  :class:`PubSubBackendUnavailable` when the driver library isn't
  installed, mirroring how the reference's CI gates broker tests on
  service containers (SURVEY §4).

The port's copy of ``gofr_tpu/datasource/pubsub/__init__.py``.
"""

from gofr_tpu_torch.datasource.pubsub.base import Message, PubSubLog
from gofr_tpu_torch.datasource.pubsub.inproc import InProcBroker
from gofr_tpu_torch.datasource.pubsub.kafka import (
    KafkaClient,
    PubSubBackendUnavailable,
    new_kafka_from_config,
)
from gofr_tpu_torch.datasource.pubsub.google import (
    GooglePubSubClient,
    new_google_from_config,
)
from gofr_tpu_torch.datasource.pubsub.mqtt import MQTTClient, new_mqtt_from_config

__all__ = [
    "Message",
    "PubSubLog",
    "InProcBroker",
    "MQTTClient",
    "KafkaClient",
    "GooglePubSubClient",
    "PubSubBackendUnavailable",
    "new_pubsub_from_config",
]


def new_pubsub_from_config(config, logger=None, metrics=None):
    """Backend switch (reference ``container/container.go:85-130``)."""
    backend = (config.get_or_default("PUBSUB_BACKEND", "") or "").upper()
    if not backend:
        return None
    try:
        if backend == "INPROC":
            return InProcBroker(logger=logger, metrics=metrics)
        if backend == "MQTT":
            return new_mqtt_from_config(config, logger=logger, metrics=metrics)
        if backend == "KAFKA":
            return new_kafka_from_config(config, logger=logger, metrics=metrics)
        if backend == "GOOGLE":
            return new_google_from_config(config, logger=logger, metrics=metrics)
    except Exception as exc:  # noqa: BLE001
        # Boot must not crash on a missing driver/broker, malformed numeric
        # config, or driver-native connect errors (kafka NoBrokersAvailable,
        # google DefaultCredentialsError, …) — log and run without pub/sub,
        # like the reference logs datasource connect errors and continues.
        if logger is not None:
            logger.errorf("pub/sub backend %s unavailable: %s", backend, exc)
        return None
    if logger is not None:
        logger.errorf("unsupported PUBSUB_BACKEND %s", backend)
    return None
