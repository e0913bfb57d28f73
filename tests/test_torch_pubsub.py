"""The port's pub/sub layer against the reference's: ``Message``, the
in-process broker, the ``SubscriptionManager`` (commit only on success, a
panic logged and not committed, a 0.1 s backoff on a broker error, a 1 s
wait with no subscriber, cancellation), the MQTT 3.1.1 client over a real
socket (each package's client against the other package's broker, the
bytes each client writes held equal, the remaining-length varint, QoS 1
with PUBACK and packet ids, PINGREQ at ``keep_alive``, reconnect and
resubscribe), the Kafka and Google clients over the reference tests' fake
drivers, and the ``PUBSUB_BACKEND`` switch. Each scenario runs on both
packages and their observables are held equal.

Then config 4, offline batch inference over pub/sub (``examples/
using-subscriber``): a port App built from config (``TPU_MODEL=
llama-tiny-f32``, ``TPU_DEVICE=cpu``, the reference's
``init_transformer(PRNGKey(11))`` weights through ``params_from_jax`` and
``TPU_CHECKPOINT``) and a reference App serving the same weights consume
the same requests; the published ``{"id", "text"}`` bytes and the commit
counts must be equal, over INPROC and over MQTT.
"""

from __future__ import annotations

import asyncio
import dataclasses
import http.client
import json
import random
import socket
import struct
import threading
import time

import jax
import numpy as np
import pytest

import gofr_tpu
import gofr_tpu.config
import gofr_tpu.datasource.pubsub as ref_pubsub
import gofr_tpu.datasource.pubsub.mqtt as ref_mqtt
import gofr_tpu.subscriber as ref_subscriber
import gofr_tpu.testutil.mqtt_broker as ref_broker
import gofr_tpu_torch
import gofr_tpu_torch.config
import gofr_tpu_torch.datasource.pubsub as port_pubsub
import gofr_tpu_torch.datasource.pubsub.mqtt as port_mqtt
import gofr_tpu_torch.subscriber as port_subscriber
import gofr_tpu_torch.testutil.mqtt_broker as port_broker
from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import ByteTokenizer as RefByteTokenizer
from gofr_tpu.testutil.mock_logger import MockLogger
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.serving.checkpoint import save_checkpoint
from gofr_tpu_torch.weights import params_from_jax

PUBSUB = {"port": port_pubsub, "reference": ref_pubsub}
MQTT = {"port": port_mqtt, "reference": ref_mqtt}
BROKER = {"port": port_broker, "reference": ref_broker}
SUBSCRIBER = {"port": port_subscriber, "reference": ref_subscriber}
PKGS = {"port": gofr_tpu_torch, "reference": gofr_tpu}
# Each package's MQTT client against the other package's broker.
CROSS = [("port", "reference"), ("reference", "port")]


class _Metrics:
    """Records counter calls (the brokers' app_pubsub_* counters)."""

    def __init__(self):
        self.calls = []

    def increment_counter(self, name, *labels):
        self.calls.append((name, labels))


# ---------------------------------------------------------------------------
# Message and the in-process broker
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Order:
    id: int = 0
    item: str = ""


def _message_observables(mod):
    commits = []
    m = mod.Message("orders", b'{"id": 7, "item": "tea"}', metadata={"qos": "1"},
                    committer=lambda: commits.append(1))
    out = [m.param("topic"), m.param("qos"), m.param("nope"), m.path_param("topic"),
           m.body, m.json(), dataclasses.asdict(m.bind(_Order())), m.host_name(),
           m.committed]
    m.commit()
    m.commit()  # a second commit does not call the committer again
    out += [m.committed, len(commits)]
    try:
        mod.Message("t", b"[1, 2]").bind(_Order())
    except ValueError as exc:
        out.append(str(exc))
    out.append(mod.Message("t", b"").json())
    log = mod.PubSubLog("PUB", "t", b"x" * 200, host="h")
    out.append(log.to_log_dict())
    return out


def test_message_matches_the_reference():
    assert _message_observables(port_pubsub) == _message_observables(ref_pubsub)
    assert _message_observables(port_pubsub)[-2:-1] == [None]


def _inproc_observables(mod):
    metrics = _Metrics()
    logger = MockLogger()
    b = mod.InProcBroker(logger=logger, metrics=metrics)
    out = [b.subscribe("a", timeout=0.01)]
    b.publish("a", b"one")
    b.publish("a", "two")  # a str is encoded
    b.create_topic("b")
    m1 = b.subscribe("a", timeout=1)
    m1.commit()
    m2 = b.subscribe("a", timeout=1)  # not committed
    out += [m1.value, m2.value, m1.topic, sorted(b.topics()), b.health_check()]
    b.delete_topic("b")
    out += [sorted(b.topics()), metrics.calls,
            [(log.level, log.message.to_log_dict()) for log in logger.logs]]
    b.close()
    return out


def test_inproc_broker_matches_the_reference():
    port = _inproc_observables(port_pubsub)
    assert port == _inproc_observables(ref_pubsub)
    assert port[1:3] == [b"one", b"two"]


# ---------------------------------------------------------------------------
# The subscription manager (scripted fakes, as tests/test_subscriber.py)
# ---------------------------------------------------------------------------


class FakeMsg:
    def __init__(self, topic: str, data: bytes = b"x") -> None:
        self.topic = topic
        self.data = data
        self.committed = 0

    def commit(self) -> None:
        self.committed += 1


class FakeSubscriber:
    """Returns scripted items per subscribe() call: a FakeMsg, None (poll
    timeout), or an Exception (raised)."""

    def __init__(self, script: list) -> None:
        self.script = list(script)

    def subscribe(self, topic: str, timeout: float):
        if not self.script:
            return None
        item = self.script.pop(0)
        if isinstance(item, Exception):
            raise item
        return item


class FakeContainer:
    def __init__(self, sub) -> None:
        self._sub = sub
        self.logger = MockLogger()

    def get_subscriber(self):
        return self._sub


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def _drive(manager, until, timeout=10.0):
    manager.start()
    deadline = asyncio.get_running_loop().time() + timeout
    while not until():
        if asyncio.get_running_loop().time() > deadline:
            await manager.stop()
            raise AssertionError("condition never reached")
        await asyncio.sleep(0.01)
    await manager.stop()


@pytest.mark.parametrize("pkg", list(SUBSCRIBER))
def test_commit_only_on_success_sync_and_async(pkg):
    mod = SUBSCRIBER[pkg]
    ok1, ok2, rejected = FakeMsg("t"), FakeMsg("t"), FakeMsg("t")
    sub = FakeSubscriber([ok1, rejected, None, ok2])
    container = FakeContainer(sub)
    manager = mod.SubscriptionManager(container)
    seen, threads = [], []

    async def handler(ctx):
        seen.append(ctx.request)
        threads.append(threading.current_thread())
        return ctx.request is not rejected  # False: not committed

    manager.register("t", handler)
    assert manager.topics == ["t"]
    _run(_drive(manager, lambda: ok2.committed))
    assert (ok1.committed, ok2.committed, rejected.committed) == (1, 1, 0)
    assert seen == [ok1, rejected, ok2]

    # A sync handler runs in the loop's executor, not on the loop's thread.
    ok3 = FakeMsg("t")
    sub.script.append(ok3)
    manager2 = mod.SubscriptionManager(container)
    manager2.register("t", lambda ctx: threads.append(threading.current_thread()) or True)
    _run(_drive(manager2, lambda: ok3.committed))
    assert ok3.committed == 1
    assert threads[0] is threading.current_thread()  # the async handler: the loop's
    assert threads[-1] is not threading.current_thread()


@pytest.mark.parametrize("pkg", list(SUBSCRIBER))
def test_handler_panic_logs_its_traceback_without_commit(pkg):
    boom, ok = FakeMsg("t"), FakeMsg("t")
    container = FakeContainer(FakeSubscriber([boom, ok]))
    manager = SUBSCRIBER[pkg].SubscriptionManager(container)

    async def handler(ctx):
        if ctx.request is boom:
            raise RuntimeError("handler exploded")
        return None  # a bare return commits

    manager.register("t", handler)
    _run(_drive(manager, lambda: ok.committed))
    assert boom.committed == 0 and ok.committed == 1
    logs = [str(r.message) for r in container.logger.logs]
    assert any("subscriber handler for topic t panicked" in m
               and "Traceback" in m and "handler exploded" in m for m in logs), logs


@pytest.mark.parametrize("pkg", list(SUBSCRIBER))
def test_broker_error_backs_off_and_no_subscriber_waits(pkg, monkeypatch):
    """A read error logs and sleeps 0.1 s before the next poll; a container
    with no subscriber sleeps 1 s a turn; stop() cancels both loops."""
    sleeps = []
    real_sleep = asyncio.sleep

    async def recording_sleep(delay, *a, **kw):
        sleeps.append(delay)
        return await real_sleep(min(delay, 0.01), *a, **kw)

    monkeypatch.setattr(asyncio, "sleep", recording_sleep)
    mod = SUBSCRIBER[pkg]
    ok = FakeMsg("t")
    container = FakeContainer(FakeSubscriber([ConnectionError("broker away"), ok]))
    manager = mod.SubscriptionManager(container)
    manager.register("t", lambda ctx: True)
    _run(_drive(manager, lambda: ok.committed))
    assert ok.committed == 1
    assert 0.1 in sleeps and 1.0 not in sleeps
    assert any("error while reading from topic t: broker away" in str(r.message)
               for r in container.logger.logs)

    sleeps.clear()
    idle = FakeContainer(None)
    manager = mod.SubscriptionManager(idle)
    manager.register("t", lambda ctx: True)

    async def scenario():
        manager.start()
        while 1.0 not in sleeps:
            await real_sleep(0.01)
        await manager.stop()  # cancels cleanly, does not hang

    _run(asyncio.wait_for(scenario(), 10))
    assert manager._tasks == [] and set(sleeps) <= {1.0, 0.01}


# ---------------------------------------------------------------------------
# MQTT over a real socket
# ---------------------------------------------------------------------------


@pytest.fixture(params=CROSS, ids=["port-client-ref-broker", "ref-client-port-broker"])
def mqtt_pair(request):
    client_pkg, broker_pkg = request.param
    with BROKER[broker_pkg].InProcMQTTBroker() as b:
        yield MQTT[client_pkg], b


def _client(mod, broker, **kw):
    return mod.MQTTClient(host=broker.host, port=broker.port, **kw)


def test_mqtt_publish_subscribe_qos1(mqtt_pair):
    mod, broker = mqtt_pair
    sub, pub = _client(mod, broker, client_id="sub"), _client(mod, broker, client_id="pub")
    try:
        assert sub.subscribe("orders", timeout=0.05) is None  # subscribes lazily
        pub.publish("orders", b'{"id": 1}')
        msg = sub.subscribe("orders", timeout=2.0)
        assert msg is not None and msg.value == b'{"id": 1}'
        assert msg.param("topic") == "orders" and msg.metadata["qos"] == "1"
        msg.commit()  # sends PUBACK
        # A payload whose remaining length takes three varint bytes.
        big = bytes(random.Random(0).randrange(256) for _ in range(20000))
        pub.publish("orders", big)
        msg = sub.subscribe("orders", timeout=2.0)
        assert msg is not None and msg.value == big
    finally:
        sub.close()
        pub.close()


def test_mqtt_qos0_wildcards_and_overlap(mqtt_pair):
    mod, broker = mqtt_pair
    sub = _client(mod, broker, client_id="sub0", qos=0)
    pub = _client(mod, broker, client_id="pub0", qos=0)
    got, done = [], threading.Event()
    try:
        assert sub.subscribe("sensors/+/temp", timeout=0.05) is None
        sub.subscribe_with_function("#", lambda m: (got.append(m), done.set()))
        pub.publish("sensors/a1/temp", b"21")
        msg = sub.subscribe("sensors/+/temp", timeout=2.0)
        assert msg is not None and msg.topic == "sensors/a1/temp"
        assert msg.metadata["qos"] == "0"
        assert done.wait(2.0) and got[0].value == b"21"
        sub.unsubscribe("#")
        pub.publish("other", b"after-unsub")
        time.sleep(0.2)
        assert len(got) == 1
    finally:
        sub.close()
        pub.close()


def test_mqtt_callback_may_publish_and_health(mqtt_pair):
    mod, broker = mqtt_pair
    sub, pub = _client(mod, broker, client_id="replier"), _client(mod, broker, client_id="req")
    done = threading.Event()

    def handler(m):
        sub.publish("replies", b"pong")  # QoS 1: waits for PUBACK off the reader
        done.set()

    try:
        sub.subscribe_with_function("requests", handler)
        assert pub.subscribe("replies", timeout=0.05) is None
        pub.publish("requests", b"ping")
        assert done.wait(5.0), "callback publish deadlocked"
        reply = pub.subscribe("replies", timeout=2.0)
        assert reply is not None and reply.value == b"pong"
        assert sub.ping()
        assert sub.health_check() == {
            "status": "UP", "details": {"backend": "MQTT", "host": f"{broker.host}:{broker.port}"}}
    finally:
        sub.close()
        pub.close()


@pytest.mark.parametrize("n", [0, 1, 127, 128, 16383, 16384, 2097151, 2097152, 268435455])
def test_mqtt_varint_matches_the_reference(n):
    enc = port_mqtt.encode_varint(n)
    assert enc == ref_mqtt.encode_varint(n)
    buf = iter(enc)
    assert port_mqtt.decode_varint(lambda k: bytes([next(buf)])) == n


def test_mqtt_topic_matches_the_reference():
    cases = [("a/b", "a/b"), ("a/+", "a/b"), ("a/+", "a/b/c"), ("a/#", "a/b/c"),
             ("#", "anything/at/all"), ("a/b", "a"), ("+/+", "a/b"), ("a/+/c", "a/x/d")]
    assert [port_mqtt.topic_matches(f, t) for f, t in cases] == [
        ref_mqtt.topic_matches(f, t) for f, t in cases]


class _RecordingSocket:
    """A client socket that records every byte the client writes."""

    def __init__(self, sock, sink):
        self._sock, self._sink = sock, sink

    def sendall(self, data):
        self._sink.append(bytes(data))
        return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def _wire_script(mod, broker, monkeypatch):
    """The same calls on one client of ``mod``: the bytes it writes."""
    sent = []
    real = socket.create_connection
    peer = mod.MQTTClient(host=broker.host, port=broker.port, client_id="peer", qos=1,
                          keep_alive=0)
    monkeypatch.setattr(mod.socket, "create_connection",
                        lambda *a, **kw: _RecordingSocket(real(*a, **kw), sent))
    c = mod.MQTTClient(host=broker.host, port=broker.port, client_id="wire", keep_alive=2)
    try:
        assert c.subscribe("in", timeout=0.05) is None
        c.publish("out", b"hello")
        peer.publish("in", b"q1")
        msg = c.subscribe("in", timeout=2.0)
        msg.commit()
        time.sleep(1.3)  # one PINGREQ at keep_alive / 2
        assert c.ping()
        c.unsubscribe("in")
    finally:
        c.close()
        peer.close()
        monkeypatch.undo()
    return sent


def test_mqtt_clients_write_the_same_bytes(monkeypatch):
    """CONNECT, SUBSCRIBE (packet id 1, QoS 1), PUBLISH QoS 1 (id 2),
    PUBACK of the inbound message on commit, PINGREQ from the keep-alive
    loop and from ping(), UNSUBSCRIBE, DISCONNECT: byte for byte equal."""
    with ref_broker.InProcMQTTBroker() as b:  # a fresh broker each: its packet ids
        port = _wire_script(port_mqtt, b, monkeypatch)
    with ref_broker.InProcMQTTBroker() as b:
        ref = _wire_script(ref_mqtt, b, monkeypatch)
    assert port == ref
    kinds = [s[0] >> 4 for s in port]
    assert kinds[0] == port_mqtt.CONNECT and kinds[-1] == port_mqtt.DISCONNECT
    assert port_mqtt.PUBACK in kinds and kinds.count(port_mqtt.PINGREQ) >= 2
    pub = next(s for s in port if s[0] >> 4 == port_mqtt.PUBLISH)
    assert pub[0] & 0x06 == 0x02  # QoS 1
    assert pub[2:] == struct.pack(">H", 3) + b"out" + struct.pack(">H", 2) + b"hello"


@pytest.mark.parametrize("client_pkg,broker_pkg", CROSS)
def test_mqtt_reconnect_replays_subscriptions(client_pkg, broker_pkg):
    """A dropped broker: the client re-dials with backoff, replays its
    SUBSCRIBEs, and deliveries resume on a broker restarted on the same
    port (below the ephemeral range, so the reconnect loop cannot
    self-connect to it)."""
    mod, bmod = MQTT[client_pkg], BROKER[broker_pkg]
    b1 = None
    for _ in range(20):
        try:
            b1 = bmod.InProcMQTTBroker(port=random.randint(20000, 28000))
            break
        except OSError:
            continue
    assert b1 is not None
    port = b1.port
    # keep_alive 2: a PINGREQ a second. The broker's close leaves the
    # client's read blocked until the next write on the dead link.
    sub = mod.MQTTClient(host=b1.host, port=port, client_id="rc-sub", keep_alive=2)
    pub = None
    try:
        assert sub.subscribe("orders", timeout=0.05) is None
        b1.close()
        b2, deadline = None, time.time() + 10
        while b2 is None:
            try:
                b2 = bmod.InProcMQTTBroker(port=port)
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        try:
            pub = mod.MQTTClient(host=b2.host, port=port, client_id="rc-pub")
            msg, deadline = None, time.time() + 20
            while msg is None and time.time() < deadline:
                pub.publish("orders", b"after-reconnect")
                msg = sub.subscribe("orders", timeout=1.0)
            assert msg is not None and msg.value == b"after-reconnect"
        finally:
            b2.close()
    finally:
        sub.close()
        if pub is not None:
            pub.close()


# ---------------------------------------------------------------------------
# Kafka and Google over the reference tests' fake drivers
# ---------------------------------------------------------------------------


class _FakeKafka:
    def __init__(self):
        self.topics: dict[str, list[bytes]] = {}
        self.commits: list[str] = []

    def writer(self):
        fake = self

        class W:
            def write(self, topic, value):
                fake.topics.setdefault(topic, []).append(value)

            def close(self):
                pass

        return W()

    def reader_factory(self, topic):
        fake = self

        class R:
            def read(self, timeout):
                q = fake.topics.get(topic) or []
                if not q:
                    return None
                value = q.pop(0)
                return value, lambda: fake.commits.append(topic)

            def close(self):
                pass

        return R()

    def admin(self):
        fake = self

        class A:
            def create_topic(self, name):
                fake.topics.setdefault(name, [])

            def delete_topic(self, name):
                fake.topics.pop(name, None)

            def ping(self):
                return True

        return A()


def _kafka_observables(mod):
    fake, metrics = _FakeKafka(), _Metrics()
    client = mod.KafkaClient(fake.writer(), fake.reader_factory, fake.admin(),
                             brokers="fake:9092", metrics=metrics)
    client.create_topic("orders")
    client.publish("orders", b"o1")
    msg = client.subscribe("orders")
    out = [msg.value, list(fake.commits)]
    msg.commit()
    out += [list(fake.commits), client.subscribe("orders", timeout=0.01), client.health_check()]
    client.delete_topic("orders")
    out += ["orders" in fake.topics, metrics.calls]
    client.close()
    return out


def test_kafka_client_matches_the_reference():
    port = _kafka_observables(port_pubsub)
    assert port == _kafka_observables(ref_pubsub)
    assert port[:3] == [b"o1", [], ["orders"]]


class _FakeGoogleDriver:
    def __init__(self):
        self.topics: set[str] = set()
        self.subs: dict[str, str] = {}  # sub → topic
        self.pending: dict[str, list[bytes]] = {}
        self.acked: list[object] = []

    def ensure_topic(self, topic):
        self.topics.add(topic)

    def ensure_subscription(self, topic, subscription):
        self.subs[subscription] = topic

    def publish(self, topic, value):
        for sub, t in self.subs.items():
            if t == topic:
                self.pending.setdefault(sub, []).append(value)

    def pull_one(self, subscription, timeout):
        q = self.pending.get(subscription) or []
        if not q:
            return None
        value = q.pop(0)
        return value, ("handle", value)

    def ack(self, subscription, ack_handle):
        self.acked.append(ack_handle)

    def delete_topic(self, topic):
        self.topics.discard(topic)

    def ping(self):
        return True

    def close(self):
        pass


def _google_observables(mod):
    drv, metrics = _FakeGoogleDriver(), _Metrics()
    client = mod.GooglePubSubClient(drv, subscription_name="svc", project="p1", metrics=metrics)
    out = [client.subscribe("events", timeout=0.01), sorted(drv.topics), dict(drv.subs)]
    client.publish("events", b"e1")
    msg = client.subscribe("events")
    out += [msg.value, list(drv.acked)]
    msg.commit()
    out += [list(drv.acked), client.health_check(), metrics.calls]
    client.close()
    return out


def test_google_client_matches_the_reference():
    port = _google_observables(port_pubsub)
    assert port == _google_observables(ref_pubsub)
    assert port[2] == {"svc-events": "events"} and port[5] == [("handle", b"e1")]


# ---------------------------------------------------------------------------
# The PUBSUB_BACKEND switch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["", "INPROC", "inproc", "MQTT", "KAFKA", "GOOGLE",
                                     "MQTT-DEAD", "NATS"])
def test_backend_switch_matches_the_reference(backend):
    """The client each package's switch builds, or None with the same
    logged error: KAFKA and GOOGLE boot without pub/sub where the driver
    is absent (the port never has one), a dead MQTT broker and an unknown
    backend likewise."""
    out = {}
    with port_broker.InProcMQTTBroker() as b:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = s.getsockname()[1]
        for pkg, mod in PUBSUB.items():
            cfg = {"PUBSUB_BACKEND": backend.split("-")[0], "MQTT_HOST": b.host,
                   "MQTT_PORT": str(dead if "DEAD" in backend else b.port),
                   "MQTT_CLIENT_ID": f"switch-{pkg}"}
            logger = MockLogger()
            client = mod.new_pubsub_from_config(PKGS[pkg].config.MockConfig(cfg), logger=logger)
            out[pkg] = (type(client).__name__, [
                (log.level, str(log.message).split(":")[0]) for log in logger.logs])
            if client is not None:
                client.close()
    assert out["port"] == out["reference"]
    if backend in ("KAFKA", "GOOGLE"):
        assert out["port"][0] == "NoneType" and "unavailable" in out["port"][1][0][1]


@pytest.mark.parametrize("name", ["kafka", "google"])
def test_driverless_factories_raise_the_reference_error(name):
    msgs = []
    for mod in PUBSUB.values():
        factory = getattr(getattr(mod, name), f"new_{name}_from_config")
        with pytest.raises(mod.PubSubBackendUnavailable) as err:
            factory(gofr_tpu_torch.config.MockConfig({}))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# Config 4: subscriber → ctx.infer → publisher, end to end on the CPU
# ---------------------------------------------------------------------------

MODEL = "llama-tiny-f32"
GEOMETRY = dict(n_slots=2, max_len=256, window_k=4, prefill_chunk=16, prefill_batch=2)
GEOMETRY_KEYS = {"TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "256", "TPU_DECODE_WINDOW": "4",
                 "TPU_PREFILL_CHUNK": "16", "TPU_PREFILL_BATCH": "2"}
REQUESTS = [{"id": i, "prompt": p} for i, p in enumerate(
    ["offline batch", "pub/sub in, pub/sub out", "x", "the subscriber awaits ctx.infer"])]


@pytest.fixture(scope="module")
def jax_params():
    return init_transformer(jax.random.PRNGKey(11), ref_get_model(MODEL).config)


@pytest.fixture(scope="module")
def checkpoint(jax_params, tmp_path_factory):
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             get_model(MODEL).config, device="cpu")
    path = str(tmp_path_factory.mktemp("ckpt") / "llama-tiny-f32.pt")
    save_checkpoint(path, params)
    return path


def _subscriber_app(pkg, config, jax_params, checkpoint):
    """The using-subscriber example's App: the port's engine from config
    (its weights from ``TPU_CHECKPOINT``), the reference's injected with the
    same weights."""
    mod = PKGS[pkg]
    keys = {"APP_NAME": "config4", "HTTP_PORT": "0", "METRICS_PORT": "0",
            "LOG_LEVEL": "WARN", **config}
    if pkg == "port":
        keys.update(TPU_MODEL=MODEL, TPU_DEVICE="cpu", TPU_CHECKPOINT=checkpoint, **GEOMETRY_KEYS)
    app = mod.App(config=mod.config.MockConfig(keys))
    if pkg == "reference":
        app.container.tpu = RefEngine(MODEL, params=jax_params, tokenizer=RefByteTokenizer(),
                                      metrics=app.container.metrics, logger=app.logger,
                                      **GEOMETRY)

    @app.subscribe("infer-requests")
    async def handle(ctx):
        payload = ctx.request.json()
        result = await ctx.infer(payload.get("prompt", ""), max_new_tokens=16, stop_on_eos=False)
        ctx.publish("infer-responses",
                    json.dumps({"id": payload.get("id"), "text": result["text"]}).encode())

    return app


def _metric_line(app, name):
    conn = http.client.HTTPConnection("127.0.0.1", app.metrics_port, timeout=30)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    return sorted(line for line in text.splitlines() if line.startswith(name))


def _config4(pkg, backend, jax_params, checkpoint):
    """Publish REQUESTS, collect the answers; returns the published bytes
    and the commit counter's lines."""
    broker = None
    config = {"PUBSUB_BACKEND": backend}
    if backend == "MQTT":
        broker = port_broker.InProcMQTTBroker()
        config.update(MQTT_HOST=broker.host, MQTT_PORT=str(broker.port),
                      MQTT_CLIENT_ID=f"config4-{pkg}")
    app = _subscriber_app(pkg, config, jax_params, checkpoint)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    client = app.container.pubsub
    driver = None
    try:
        asyncio.run_coroutine_threadsafe(app.start(), loop).result(60)
        if backend == "MQTT":
            # Subscribe both ends before the first publish (MQTT keeps no
            # message for a topic nobody subscribed).
            driver = PUBSUB[pkg].MQTTClient(host=broker.host, port=broker.port,
                                            client_id=f"driver-{pkg}")
            assert driver.subscribe("infer-responses", timeout=0.01) is None
            assert client.subscribe("infer-requests", timeout=0.01) is None
        else:
            driver = client
        for req in REQUESTS:
            driver.publish("infer-requests", json.dumps(req).encode())
        got, deadline = [], time.time() + 120
        while len(got) < len(REQUESTS) and time.time() < deadline:
            msg = driver.subscribe("infer-responses", timeout=0.5)
            if msg is not None:
                msg.commit()
                got.append(msg.value)
        commits = _metric_line(app, "app_pubsub_subscribe_success_count")
        return got, [c for c in commits if "infer-requests" in c]
    finally:
        asyncio.run_coroutine_threadsafe(app.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(5)
        loop.close()
        if backend == "MQTT":
            driver.close()
            broker.close()


@pytest.mark.parametrize("backend", ["INPROC", "MQTT"])
def test_config4_publishes_what_the_reference_publishes(backend, jax_params, checkpoint):
    out = {pkg: _config4(pkg, backend, jax_params, checkpoint) for pkg in PKGS}
    port, ref = out["port"], out["reference"]
    assert len(port[0]) == len(REQUESTS)
    assert port[0] == ref[0]
    assert [json.loads(b)["id"] for b in port[0]] == [r["id"] for r in REQUESTS]
    # Every request committed once (the counter counts commits).
    assert port[1] == ref[1] and port[1][0].endswith(f" {float(len(REQUESTS))}"), port[1]
