"""MQTT pub/sub backend — a dependency-free MQTT 3.1.1 client.

Reference: ``pkg/gofr/datasource/pubsub/mqtt/mqtt.go`` (paho-based client:
per-topic buffered channels ``mqtt.go:30-53``, QoS/order/retain config
``:57-78``, extended API ``SubscribeWithFunction``/``Unsubscribe``/
``Disconnect``/``Ping`` ``:233-335``). This environment has no MQTT driver
library, so the client speaks the MQTT 3.1.1 wire protocol directly over a
TCP socket — CONNECT/CONNACK, PUBLISH (QoS 0/1), PUBACK, SUBSCRIBE/SUBACK,
UNSUBSCRIBE/UNSUBACK, PINGREQ/PINGRESP, DISCONNECT.

At-least-once semantics: inbound QoS-1 PUBLISHes are acked on
``Message.commit()`` (the handler-succeeded ack the reference implements
with Kafka commits, ``subscriber.go:51-52``), not on receipt.

``gofr_tpu_torch.testutil.mqtt_broker.InProcMQTTBroker`` is the in-process server
used by tests — the miniredis of this backend (SURVEY §4).

The port's copy of ``gofr_tpu/datasource/pubsub/mqtt.py``.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from typing import Callable, Optional

from gofr_tpu_torch.datasource.pubsub.base import Message, PubSubLog

# Packet types (<<4 in the fixed header).
CONNECT, CONNACK = 1, 2
PUBLISH, PUBACK = 3, 4
SUBSCRIBE, SUBACK = 8, 9
UNSUBSCRIBE, UNSUBACK = 10, 11
PINGREQ, PINGRESP = 12, 13
DISCONNECT = 14


def encode_varint(n: int) -> bytes:
    """MQTT 'remaining length' variable-byte integer."""
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        out.append(byte | 0x80 if n else byte)
        if not n:
            return bytes(out)


def decode_varint(read: Callable[[int], bytes]) -> int:
    mult, value = 1, 0
    for _ in range(4):
        (byte,) = read(1)
        value += (byte & 0x7F) * mult
        if not byte & 0x80:
            return value
        mult *= 128
    raise ValueError("malformed remaining-length varint")


def encode_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


def topic_matches(filter_: str, topic: str) -> bool:
    """MQTT topic-filter matching with ``+`` and ``#`` wildcards."""
    fparts, tparts = filter_.split("/"), topic.split("/")
    for i, fp in enumerate(fparts):
        if fp == "#":
            return True
        if i >= len(tparts):
            return False
        if fp != "+" and fp != tparts[i]:
            return False
    return len(fparts) == len(tparts)


class _Packet:
    __slots__ = ("ptype", "flags", "payload")

    def __init__(self, ptype: int, flags: int, payload: bytes) -> None:
        self.ptype, self.flags, self.payload = ptype, flags, payload


def read_packet(sock: socket.socket) -> Optional[_Packet]:
    """Read one MQTT control packet; None on clean EOF."""

    def readn(n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("MQTT peer closed")
            buf += chunk
        return buf

    try:
        first = sock.recv(1)
    except OSError:
        return None
    if not first:
        return None
    length = decode_varint(readn)
    return _Packet(first[0] >> 4, first[0] & 0x0F, readn(length) if length else b"")


def write_packet(
    sock: socket.socket, ptype: int, payload: bytes, flags: int = 0
) -> None:
    sock.sendall(
        bytes([(ptype << 4) | flags]) + encode_varint(len(payload)) + payload
    )


class MQTTClient:
    """Blocking MQTT 3.1.1 client exposing the framework pub/sub surface.

    Config keys mirror the reference (``mqtt.go:57-78``): MQTT_HOST,
    MQTT_PORT, MQTT_CLIENT_ID, MQTT_QOS (0|1), MQTT_KEEP_ALIVE (seconds).
    The reference falls back to a public broker when no host is configured
    (``mqtt.go:19-22``); here the fallback is localhost:1883 — this image
    has no egress, pointing at a public broker would only hang.
    """

    def __init__(
        self,
        host: str = "localhost",
        port: int = 1883,
        client_id: str = "gofr-tpu",
        qos: int = 1,
        keep_alive: int = 30,
        logger=None,
        metrics=None,
        connect_timeout: float = 5.0,
    ) -> None:
        self.host, self.port = host, int(port)
        self.client_id = client_id
        self.qos = int(qos)
        self.keep_alive = int(keep_alive)
        self._logger = logger
        self._metrics = metrics
        self._sock = socket.create_connection((host, self.port), connect_timeout)
        # create_connection leaves the connect timeout on the socket; the
        # reader thread must block indefinitely or it dies on idle links.
        self._sock.settimeout(None)
        self._write_lock = threading.Lock()
        self._packet_id = 0
        self._pid_lock = threading.Lock()
        self._acks: dict[int, threading.Event] = {}
        # Per-topic-filter inbound queues (reference's buffered chans,
        # mqtt.go:30-53) + optional callback subscriptions.
        self._queues: dict[str, queue.Queue] = {}
        self._callbacks: dict[str, Callable[[Message], None]] = {}
        self._sub_lock = threading.Lock()
        self._pong = threading.Event()
        self._closed = False

        self._connect()
        self._reader = threading.Thread(
            target=self._read_loop, name="mqtt-reader", daemon=True
        )
        self._reader.start()
        # Callbacks run off-reader so handlers may publish (QoS-1 publish
        # waits for a PUBACK only the reader thread can process).
        self._cb_queue: queue.Queue = queue.Queue()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="mqtt-dispatch", daemon=True
        )
        self._dispatcher.start()
        if self.keep_alive > 0:
            threading.Thread(
                target=self._keepalive_loop, name="mqtt-keepalive", daemon=True
            ).start()

    # -- wire ---------------------------------------------------------------

    def _next_pid(self) -> int:
        with self._pid_lock:
            self._packet_id = self._packet_id % 65535 + 1
            return self._packet_id

    def _connect(self) -> None:
        var = encode_str("MQTT") + bytes([4]) + bytes([0x02])  # clean session
        var += struct.pack(">H", self.keep_alive)
        write_packet(self._sock, CONNECT, var + encode_str(self.client_id))
        pkt = read_packet(self._sock)
        if pkt is None or pkt.ptype != CONNACK or pkt.payload[1] != 0:
            raise ConnectionError(
                f"MQTT CONNACK refused: {pkt.payload[1] if pkt else 'EOF'}"
            )

    def _read_loop(self) -> None:
        while not self._closed:
            try:
                pkt = read_packet(self._sock)
            except (ConnectionError, OSError):
                pkt = None
            if pkt is None:
                # Transient socket death must not silently end the
                # subscription world (the reference's paho client
                # auto-reconnects and re-subscribes): reconnect with backoff
                # and replay SUBSCRIBEs for every registered filter.
                if self._closed or not self._reconnect():
                    return
                continue
            if pkt.ptype == PUBLISH:
                self._on_publish(pkt)
            elif pkt.ptype in (PUBACK, SUBACK, UNSUBACK):
                (pid,) = struct.unpack(">H", pkt.payload[:2])
                ev = self._acks.pop(pid, None)
                if ev is not None:
                    ev.set()
            elif pkt.ptype == PINGRESP:
                self._pong.set()

    def _reconnect(self) -> bool:
        """Re-dial + CONNECT + replay SUBSCRIBEs. Runs on the reader thread,
        so re-subscribes are fire-and-forget (the reader can't wait on its
        own SUBACK processing). Retries with backoff until closed."""
        import time as _time

        try:
            self._sock.close()
        except OSError:
            pass
        delay = 0.2
        while not self._closed:
            try:
                sock = socket.create_connection((self.host, self.port), 5.0)
                sock.settimeout(None)
                self._sock = sock
                self._connect()
                with self._sub_lock:
                    topics = set(self._queues) | set(self._callbacks)
                for t in topics:
                    pid = self._next_pid()
                    payload = (
                        struct.pack(">H", pid) + encode_str(t) + bytes([self.qos])
                    )
                    with self._write_lock:
                        write_packet(self._sock, SUBSCRIBE, payload, flags=0x02)
                if self._logger is not None:
                    self._logger.infof(
                        "mqtt reconnected to %s:%d (%d subscriptions replayed)",
                        self.host, self.port, len(topics),
                    )
                return True
            except OSError:
                _time.sleep(delay)
                delay = min(delay * 2, 5.0)
        return False

    def _on_publish(self, pkt: _Packet) -> None:
        qos = (pkt.flags >> 1) & 0x03
        (tlen,) = struct.unpack(">H", pkt.payload[:2])
        topic = pkt.payload[2 : 2 + tlen].decode("utf-8")
        rest = pkt.payload[2 + tlen :]
        pid = 0
        if qos:
            (pid,) = struct.unpack(">H", rest[:2])
            rest = rest[2:]

        def _commit(pid=pid, qos=qos) -> None:
            if qos:
                with self._write_lock:
                    write_packet(self._sock, PUBACK, struct.pack(">H", pid))
            if self._metrics is not None:
                self._metrics.increment_counter(
                    "app_pubsub_subscribe_success_count", "topic", topic
                )

        msg = Message(
            topic=topic, value=rest, metadata={"qos": str(qos)}, committer=_commit
        )
        if self._logger is not None:
            self._logger.debug(PubSubLog("SUB", topic, rest, host=self.host))
        # Deliver to EVERY matching subscription (overlapping filters each
        # get the message, like the reference's per-topic channels).
        with self._sub_lock:
            cbs = [f for flt, f in self._callbacks.items() if topic_matches(flt, topic)]
            qs = [q for flt, q in self._queues.items() if topic_matches(flt, topic)]
        for cb in cbs:
            self._cb_queue.put((cb, msg))
        for q in qs:
            q.put(msg)

    def _dispatch_loop(self) -> None:
        while not self._closed:
            try:
                cb, msg = self._cb_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                cb(msg)
            except Exception:  # noqa: BLE001 — handler errors must not kill dispatch
                if self._logger is not None:
                    self._logger.errorf("mqtt callback for %s raised", msg.topic)

    def _keepalive_loop(self) -> None:
        import time as _time

        interval = max(self.keep_alive / 2.0, 1.0)
        while not self._closed:
            _time.sleep(interval)
            if self._closed:
                return
            try:
                with self._write_lock:
                    write_packet(self._sock, PINGREQ, b"")
            except OSError:
                return

    def _register_ack(self, pid: int) -> threading.Event:
        """Must be called BEFORE the packet is written, or a fast broker's
        ack can race the registration and be dropped. The caller holds the
        returned event (the reader thread pops it from the dict on ack)."""
        ev = self._acks[pid] = threading.Event()
        return ev

    def _await_ack(self, ev: threading.Event, pid: int, timeout: float = 5.0) -> None:
        if not ev.wait(timeout):
            self._acks.pop(pid, None)
            raise TimeoutError(f"MQTT ack for packet {pid} timed out")

    # -- Publisher ----------------------------------------------------------

    def publish(self, topic: str, message: bytes) -> None:
        if isinstance(message, str):
            message = message.encode()
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_pubsub_publish_total_count", "topic", topic
            )
        var = encode_str(topic)
        pid, ev = 0, None
        if self.qos:
            pid = self._next_pid()
            var += struct.pack(">H", pid)
            ev = self._register_ack(pid)
        with self._write_lock:
            write_packet(self._sock, PUBLISH, var + message, flags=self.qos << 1)
        if ev is not None:
            self._await_ack(ev, pid)
        if self._logger is not None:
            self._logger.debug(PubSubLog("PUB", topic, message, host=self.host))
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_pubsub_publish_success_count", "topic", topic
            )

    # -- Subscriber ---------------------------------------------------------

    def _send_subscribe(self, topic: str) -> None:
        pid = self._next_pid()
        ev = self._register_ack(pid)
        payload = struct.pack(">H", pid) + encode_str(topic) + bytes([self.qos])
        with self._write_lock:
            write_packet(self._sock, SUBSCRIBE, payload, flags=0x02)
        self._await_ack(ev, pid)

    def subscribe(self, topic: str, timeout: Optional[float] = None) -> Optional[Message]:
        """Blocking poll for one message on ``topic`` (subscribes lazily)."""
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_pubsub_subscribe_total_count", "topic", topic
            )
        with self._sub_lock:
            q = self._queues.get(topic)
            new = q is None
            if new:
                q = self._queues[topic] = queue.Queue()
        if new:
            try:
                self._send_subscribe(topic)
            except Exception:
                # Roll back the registration: leaving it would make every
                # retry see new=False and poll a queue the broker never
                # heard about — silent permanent message loss.
                with self._sub_lock:
                    self._queues.pop(topic, None)
                raise
        try:
            return q.get(timeout=timeout if timeout is not None else 0.5)
        except queue.Empty:
            return None

    def subscribe_with_function(
        self, topic: str, fn: Callable[[Message], None]
    ) -> None:
        """Callback-per-message subscription (reference ``mqtt.go:233-258``)."""
        with self._sub_lock:
            had = topic in self._callbacks
            prev = self._callbacks.get(topic)
            self._callbacks[topic] = fn
        try:
            self._send_subscribe(topic)
        except Exception:
            with self._sub_lock:  # roll back so a retry re-sends SUBSCRIBE
                if had:
                    self._callbacks[topic] = prev
                else:
                    self._callbacks.pop(topic, None)
            raise

    def unsubscribe(self, topic: str) -> None:
        pid = self._next_pid()
        ev = self._register_ack(pid)
        with self._write_lock:
            write_packet(
                self._sock, UNSUBSCRIBE, struct.pack(">H", pid) + encode_str(topic),
                flags=0x02,
            )
        self._await_ack(ev, pid)
        with self._sub_lock:
            self._queues.pop(topic, None)
            self._callbacks.pop(topic, None)

    # -- topic admin (inproc parity; MQTT topics need no creation) ----------

    def create_topic(self, name: str) -> None:  # noqa: ARG002 — broker-side no-op
        return None

    def delete_topic(self, name: str) -> None:  # noqa: ARG002
        return None

    # -- lifecycle ----------------------------------------------------------

    def ping(self, timeout: float = 5.0) -> bool:
        """PINGREQ/PINGRESP round trip (reference ``mqtt.go:282``)."""
        self._pong.clear()
        with self._write_lock:
            write_packet(self._sock, PINGREQ, b"")
        return self._pong.wait(timeout)

    def health_check(self) -> dict:
        up = False
        try:
            up = self.ping(timeout=1.0)
        except OSError:
            pass
        return {
            "status": "UP" if up else "DOWN",
            "details": {"backend": "MQTT", "host": f"{self.host}:{self.port}"},
        }

    def disconnect(self) -> None:
        self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            with self._write_lock:
                write_packet(self._sock, DISCONNECT, b"")
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def new_mqtt_from_config(config, logger=None, metrics=None) -> MQTTClient:
    return MQTTClient(
        host=config.get_or_default("MQTT_HOST", "localhost"),
        port=int(config.get_or_default("MQTT_PORT", "1883")),
        client_id=config.get_or_default("MQTT_CLIENT_ID", "gofr-tpu"),
        qos=int(config.get_or_default("MQTT_QOS", "1")),
        keep_alive=int(config.get_or_default("MQTT_KEEP_ALIVE", "30")),
        logger=logger,
        metrics=metrics,
    )
