"""In-process MQTT 3.1.1 broker for tests.

The miniredis of the MQTT backend (SURVEY §4: the reference tests Redis
against a real in-process server rather than mocks): a real TCP listener
speaking enough MQTT 3.1.1 to exercise ``MQTTClient`` end to end —
CONNECT/CONNACK, SUBSCRIBE/SUBACK (with ``+``/``#`` wildcard filters),
UNSUBSCRIBE/UNSUBACK, PUBLISH routing at QoS 0/1 (PUBACK to the sender;
inbound PUBACKs from receivers accepted), PINGREQ/PINGRESP, DISCONNECT.

The port's copy of ``gofr_tpu/testutil/mqtt_broker.py``.
"""

from __future__ import annotations

import socket
import struct
import threading

from gofr_tpu_torch.datasource.pubsub.mqtt import (
    CONNACK,
    CONNECT,
    DISCONNECT,
    PINGREQ,
    PINGRESP,
    PUBACK,
    PUBLISH,
    SUBACK,
    SUBSCRIBE,
    UNSUBACK,
    UNSUBSCRIBE,
    encode_str,
    read_packet,
    topic_matches,
    write_packet,
)


class _ClientConn:
    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.subs: dict[str, int] = {}  # filter → granted qos
        self.lock = threading.Lock()

    def send(self, ptype: int, payload: bytes, flags: int = 0) -> None:
        with self.lock:
            write_packet(self.sock, ptype, payload, flags)


class InProcMQTTBroker:
    """``with InProcMQTTBroker() as b: MQTTClient(port=b.port)``"""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen()
        self.host, self.port = self._listener.getsockname()
        self._clients: set[_ClientConn] = set()
        self._lock = threading.Lock()
        self._closed = False
        self._next_pid = 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="mqtt-broker-accept", daemon=True
        )
        self._accept_thread.start()

    # -- server loops -------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            conn = _ClientConn(sock)
            with self._lock:
                self._clients.add(conn)
            threading.Thread(
                target=self._serve, args=(conn,), name="mqtt-broker-conn",
                daemon=True,
            ).start()

    def _serve(self, conn: _ClientConn) -> None:
        try:
            while not self._closed:
                pkt = read_packet(conn.sock)
                if pkt is None or pkt.ptype == DISCONNECT:
                    return
                if pkt.ptype == CONNECT:
                    conn.send(CONNACK, bytes([0, 0]))
                elif pkt.ptype == SUBSCRIBE:
                    (pid,) = struct.unpack(">H", pkt.payload[:2])
                    rest, granted = pkt.payload[2:], bytearray()
                    while rest:
                        (flen,) = struct.unpack(">H", rest[:2])
                        filt = rest[2 : 2 + flen].decode("utf-8")
                        qos = rest[2 + flen]
                        conn.subs[filt] = min(qos, 1)
                        granted.append(min(qos, 1))
                        rest = rest[3 + flen :]
                    conn.send(SUBACK, struct.pack(">H", pid) + bytes(granted))
                elif pkt.ptype == UNSUBSCRIBE:
                    (pid,) = struct.unpack(">H", pkt.payload[:2])
                    rest = pkt.payload[2:]
                    while rest:
                        (flen,) = struct.unpack(">H", rest[:2])
                        conn.subs.pop(rest[2 : 2 + flen].decode("utf-8"), None)
                        rest = rest[2 + flen :]
                    conn.send(UNSUBACK, struct.pack(">H", pid))
                elif pkt.ptype == PUBLISH:
                    self._route(conn, pkt)
                elif pkt.ptype == PINGREQ:
                    conn.send(PINGRESP, b"")
                # inbound PUBACK (receiver acking qos1 delivery): accepted, no state
        except (ConnectionError, OSError):
            pass
        finally:
            with self._lock:
                self._clients.discard(conn)
            try:
                conn.sock.close()
            except OSError:
                pass

    def _route(self, sender: _ClientConn, pkt) -> None:
        qos = (pkt.flags >> 1) & 0x03
        (tlen,) = struct.unpack(">H", pkt.payload[:2])
        topic = pkt.payload[2 : 2 + tlen].decode("utf-8")
        rest = pkt.payload[2 + tlen :]
        if qos:
            (pid,) = struct.unpack(">H", rest[:2])
            rest = rest[2:]
            sender.send(PUBACK, struct.pack(">H", pid))
        with self._lock:
            clients = list(self._clients)
        for client in clients:
            granted = max(
                (q for f, q in client.subs.items() if topic_matches(f, topic)),
                default=None,
            )
            if granted is None:
                continue
            out_qos = min(qos, granted)
            var = encode_str(topic)
            if out_qos:
                self._next_pid = self._next_pid % 65535 + 1
                var += struct.pack(">H", self._next_pid)
            try:
                client.send(PUBLISH, var + rest, flags=out_qos << 1)
            except OSError:
                pass

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        self._closed = True
        # shutdown() BEFORE close(): the accept thread is blocked inside
        # accept(), and closing the fd alone leaves the kernel socket
        # alive (still in LISTEN) until that syscall returns — which is
        # never without a new connection. shutdown wakes it, so the port
        # actually frees and a same-port restart can bind.
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            try:
                c.sock.close()
            except OSError:
                pass

    def __enter__(self) -> "InProcMQTTBroker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
