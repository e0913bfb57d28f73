"""The port's gRPC wire code held against stock implementations: the proto3
codec (``grpc/protowire.py``, ``grpc/inference_pb2.py``) byte for byte
against ``google.protobuf`` on the reference's ``inference_pb2``; HPACK
(``grpc/hpack.py``) on RFC 7541's Appendix C and on what grpcio and curl
(nghttp2) send, captured on a raw socket; HTTP/2 (``grpc/h2.py``) through
1 MB echoes in each direction against the port's server and grpcio's,
ten streams on one connection, and a stalled reader beside a live one."""

from __future__ import annotations

import asyncio
import io
import json
import math
import shutil
import socket
import struct
import subprocess
import threading
import time
from fractions import Fraction

import grpc
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gofr_tpu.grpc import inference_pb2 as ref_pb
from gofr_tpu.grpc.server import GRPCServer as RefGRPCServer
from gofr_tpu.grpc.server import json_method_handlers as ref_json_handlers
from gofr_tpu.logging import Level as RefLevel
from gofr_tpu.logging import Logger as RefLogger
from gofr_tpu_torch.grpc import h2, hpack
from gofr_tpu_torch.grpc import inference_pb2 as pb
from gofr_tpu_torch.grpc.channel import RpcError, insecure_channel
from gofr_tpu_torch.grpc.protowire import BOOL, DOUBLE, FLOAT, INT32, STRING, _varint
from gofr_tpu_torch.grpc.server import GRPCServer, StatusCode, json_method_handlers
from gofr_tpu_torch.logging import Level, Logger

# -- proto3 -------------------------------------------------------------------

_SCALARS = {
    INT32: st.integers(-(2**31), 2**31 - 1),
    BOOL: st.booleans(),
    FLOAT: st.floats(width=32, allow_nan=True, allow_infinity=True),
    DOUBLE: st.floats(allow_nan=True, allow_infinity=True),
    STRING: st.text(max_size=40),
}


def _message_values(cls):
    fields = {}
    for f in cls.FIELDS:
        values = _SCALARS[f.kind]
        if f.repeated:  # empty, short and long repeated fields
            values = st.one_of(st.lists(values, max_size=6), st.lists(values, min_size=200,
                                                                      max_size=300))
        fields[f.name] = values
    return st.fixed_dictionaries({}, optional=fields)


def _same(a, b) -> bool:
    """Field values equal, NaN equal to NaN."""
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


@pytest.mark.parametrize("cls", pb.MESSAGES, ids=lambda c: c.__name__)
def test_serialize_equals_protobuf(cls):
    """Random messages of every type: the port's bytes equal protobuf's,
    each side parses the other's back to the same fields."""
    ref_cls = getattr(ref_pb, cls.__name__)
    assert [(f.number, f.name) for f in cls.FIELDS] == [
        (f.number, f.name) for f in ref_cls.DESCRIPTOR.fields]

    @settings(max_examples=60, deadline=None,
              suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
    @given(_message_values(cls))
    def check(values):
        want = ref_cls(**values).SerializeToString()
        got = cls(**values).SerializeToString()
        assert got == want
        back = cls.FromString(want)
        parsed = ref_cls.FromString(got)
        for f in cls.FIELDS:
            ref_value = getattr(parsed, f.name)
            assert _same(getattr(back, f.name), list(ref_value) if f.repeated else ref_value)

    check()


def _key(number: int, wire: int) -> bytes:
    return _varint(number << 3 | wire)


def test_parse_unpacked_repeated_and_unknown_fields():
    """Repeated scalars sent unpacked, a scalar sent twice (the last wins),
    and unknown fields of every wire type, groups included: the port
    parses what protobuf parses."""
    unknown = (_key(20, 0) + b"\x96\x01" + _key(21, 1) + bytes(8) + _key(22, 2) + b"\x03abc"
               + _key(23, 5) + bytes(4) + _key(24, 3) + _key(25, 0) + b"\x01" + _key(24, 4))
    data = (_key(5, 0) + b"\x07" + _key(5, 0) + b"\xfe\xff\xff\xff\xff\xff\xff\xff\xff\x01"
            + _key(1, 2) + b"\x02hi" + unknown + _key(1, 2) + b"\x03hey"
            + _key(5, 2) + b"\x02\x08\x09" + _key(6, 2) + b"\x01a" + _key(6, 2) + b"\x00")
    want = ref_pb.GenerateRequest.FromString(data)
    got = pb.GenerateRequest.FromString(data)
    assert got.prompt == want.prompt == "hey"
    assert got.prompt_ids == list(want.prompt_ids) == [7, -2, 8, 9]
    assert got.stop == list(want.stop) == ["a", ""]
    floats = struct.pack("<f", 1.5) + struct.pack("<f", -2.0)
    data = (_key(1, 5) + floats[:4] + _key(1, 5) + floats[4:] + _key(9, 0) + b"\x01"
            + _key(1, 2) + b"\x04" + struct.pack("<f", 3.25))
    assert pb.EmbedReply.FromString(data).embedding == list(
        ref_pb.EmbedReply.FromString(data).embedding) == [1.5, -2.0, 3.25]
    with pytest.raises(ValueError):
        pb.GenerateRequest.FromString(_key(1, 2) + b"\x05ab")


def test_assignment_rules_match_protobuf():
    """Floats round to float32 on assignment, int32 range, unknown names."""
    assert pb.GenerateRequest(temperature=0.1).temperature == ref_pb.GenerateRequest(
        temperature=0.1).temperature
    with pytest.raises(ValueError):
        pb.GenerateRequest(max_new_tokens=2**31)
    with pytest.raises(ValueError):
        pb.GenerateRequest(nope=1)
    emb = np.arange(5, dtype=np.float64) / 3
    assert pb.EmbedReply(embedding=emb).SerializeToString() == ref_pb.EmbedReply(
        embedding=emb.astype(np.float32)).SerializeToString()


# -- HPACK ---------------------------------------------------------------------

def _h(text: str) -> bytes:
    return bytes.fromhex(text.replace(" ", ""))


def test_huffman_table():
    """RFC 7541 Appendix B: a complete prefix code (the Kraft sum of the
    257 lengths is exactly 1), and codes the RFC lists."""
    assert len(hpack.HUFFMAN_LENGTHS) == 257
    assert sum(Fraction(1, 2**n) for n in hpack.HUFFMAN_LENGTHS) == 1
    for sym, code, n in ((0, 0x1FF8, 13), (ord(" "), 0x14, 6), (ord("0"), 0x0, 5),
                         (ord("A"), 0x21, 6), (ord("a"), 0x3, 5), (ord("~"), 0x1FFD, 13),
                         (255, 0x3FFFFEE, 26), (hpack.EOS, 0x3FFFFFFF, 30)):
        assert (hpack.HUFFMAN_CODES[sym], hpack.HUFFMAN_LENGTHS[sym]) == (code, n), sym
    every = bytes(range(256))
    assert hpack.huffman_decode(hpack.huffman_encode(every)) == every
    with pytest.raises(hpack.HPACKError):
        hpack.huffman_decode(b"\x00")  # padding of zeros is not EOS
    with pytest.raises(hpack.HPACKError):
        hpack.huffman_decode(b"\xff\xff\xff\xff")  # EOS itself


def test_rfc7541_appendix_c():
    """C.2 (single fields), C.3 and C.4 (requests without and with
    Huffman), C.6 (responses with eviction from a 256-byte table)."""
    d = hpack.Decoder()
    assert d.decode(_h("400a 6375 7374 6f6d 2d6b 6579 0d63 7573 746f 6d2d 6865 6164 6572")) == [
        ("custom-key", "custom-header")]
    assert d.size == 55
    d = hpack.Decoder()
    assert d.decode(_h("040c 2f73 616d 706c 652f 7061 7468")) == [(":path", "/sample/path")]
    assert d.decode(_h("1008 7061 7373 776f 7264 0673 6563 7265 74")) == [
        ("password", "secret")]
    assert d.decode(_h("82")) == [(":method", "GET")] and d.size == 0
    first = [(":method", "GET"), (":scheme", "http"), (":path", "/"),
             (":authority", "www.example.com")]
    second = first + [("cache-control", "no-cache")]
    third = [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
             (":authority", "www.example.com"), ("custom-key", "custom-value")]
    for blocks in (
        ("8286 8441 0f77 7777 2e65 7861 6d70 6c65 2e63 6f6d",
         "8286 84be 5808 6e6f 2d63 6163 6865",
         "8287 85bf 400a 6375 7374 6f6d 2d6b 6579 0c63 7573 746f 6d2d 7661 6c75 65"),
        ("8286 8441 8cf1 e3c2 e5f2 3a6b a0ab 90f4 ff",
         "8286 84be 5886 a8eb 1064 9cbf",
         "8287 85bf 4088 25a8 49e9 5ba9 7d7f 8925 a849 e95b b8e8 b4bf"),
    ):
        d = hpack.Decoder()
        assert d.decode(_h(blocks[0])) == first and d.size == 57
        assert d.decode(_h(blocks[1])) == second and d.size == 110
        assert d.decode(_h(blocks[2])) == third and d.size == 164
    d = hpack.Decoder(256)
    date = "Mon, 21 Oct 2013 20:13:2"
    assert d.decode(_h(
        "4882 6402 5885 aec3 771a 4b61 96d0 7abe 9410 54d4 44a8 2005 9504 0b81 66e0 82a6 "
        "2d1b ff6e 919d 29ad 1718 63c7 8f0b 97c8 e9ae 82ae 43d3")) == [
        (":status", "302"), ("cache-control", "private"), ("date", date + "1 GMT"),
        ("location", "https://www.example.com")]
    assert d.size == 222
    assert d.decode(_h("4883 640e ffc1 c0bf")) == [
        (":status", "307"), ("cache-control", "private"), ("date", date + "1 GMT"),
        ("location", "https://www.example.com")]
    assert d.size == 222
    assert d.decode(_h(
        "88c1 6196 d07a be94 1054 d444 a820 0595 040b 8166 e084 a62d 1bff c05a 839b d9ab "
        "77ad 94e7 821d d7f2 e6c7 b335 dfdf cd5b 3960 d5af 2708 7f36 72c1 ab27 0fb5 291f "
        "9587 3160 65c0 03ed 4ee5 b106 3d50 07")) == [
        (":status", "200"), ("cache-control", "private"), ("date", date + "2 GMT"),
        ("location", "https://www.example.com"), ("content-encoding", "gzip"),
        ("set-cookie", "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1")]
    assert d.size == 215


def test_encoder_round_trip_and_size_update():
    enc, dec = hpack.Encoder(), hpack.Decoder()
    fields = [(":method", "POST"), (":path", "/gofr.tpu.v1.Inference/Generate"),
              ("content-type", "application/grpc"), ("x-" + "k" * 300, "".join(
                  chr(c) for c in range(0x20, 0x7F)))]
    block = enc.encode(fields)
    assert block[0] == 0x20  # a size update to 0 opens the first block
    assert dec.decode(block) == fields
    assert dec.decode(enc.encode(fields)) == fields  # no update in the second
    with pytest.raises(hpack.HPACKError):
        dec.decode(b"\x82\x20")  # an update after a field


class _RawH2Server:
    """Records the header lists a peer sends on one connection, decoded by
    the port's HPACK, and answers each request with ``reply`` headers."""

    def __init__(self, reply: list) -> None:
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.reply = reply
        self.requests: list = []
        self.connections = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.connections += 1
            core = h2.H2Core(client=False)
            conn.sendall(core.preamble())
            try:
                while data := conn.recv(1 << 16):
                    for event in core.feed(data):
                        if event[0] == "headers":
                            self.requests.append(event[2])
                            core.out += core.headers(event[1], self.reply, end_stream=True)
                    conn.sendall(bytes(core.out))
                    core.out.clear()
            except OSError:
                pass
            conn.close()

    def close(self) -> None:
        self.sock.close()


# gRPC metadata keys take [0-9a-z_.-]; values printable ASCII.
_KEY_CHARS = "abcdefghijklmnopqrstuvwxyz0123456789_.-"
_VALUE = "".join(chr(c) for c in range(0x21, 0x7F)) + " inner spaces " + "~"


def _count_huffman(monkeypatch) -> dict:
    seen = {"n": 0}
    decode = hpack.huffman_decode

    def counted(data):
        seen["n"] += 1
        return decode(data)

    monkeypatch.setattr(hpack, "huffman_decode", counted)
    return seen


def test_hpack_reads_grpcio(monkeypatch):
    """grpcio's header blocks, two calls over one connection (the second
    uses grpcio's dynamic table): every printable ASCII byte in values,
    every key character, a binary ``-bin`` value."""
    seen = _count_huffman(monkeypatch)
    srv = _RawH2Server([(":status", "200"), ("content-type", "application/grpc"),
                        ("grpc-status", "12")])
    channel = grpc.insecure_channel(f"127.0.0.1:{srv.port}")
    call = channel.unary_unary("/pkg.Svc/Method")
    metadata = [("x-" + _KEY_CHARS, _VALUE), ("x-second", _VALUE[::-1]),
                ("x-blob-bin", bytes(range(256)))]
    try:
        for _ in range(2):
            with pytest.raises(grpc.RpcError) as err:
                call(b"payload", metadata=metadata, timeout=10)
            assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
    finally:
        channel.close()
        srv.close()
    assert srv.connections == 1 and len(srv.requests) == 2
    for headers in srv.requests:
        got = dict(headers)
        assert got[":path"] == "/pkg.Svc/Method" and got[":method"] == "POST"
        assert got["content-type"] == "application/grpc"
        assert got["x-" + _KEY_CHARS] == _VALUE and got["x-second"] == _VALUE[::-1]
        import base64

        blob = got["x-blob-bin"]
        assert base64.b64decode(blob + "=" * (-len(blob) % 4)) == bytes(range(256))
    assert seen["n"] > 0  # grpcio Huffman-coded some of it


@pytest.mark.skipif(shutil.which("curl") is None, reason="no curl")
def test_hpack_reads_curl(monkeypatch):
    """nghttp2 (through curl ``--http2-prior-knowledge``) Huffman-codes
    where shorter and indexes what it sends: every token character in
    names, every printable ASCII byte in values, and a field sent twice,
    whose second copy is a dynamic-table index. (curl 7.88.1 fails to
    reuse an HTTP/2 connection for a second URL, against grpcio's server
    as well; the grpcio case above takes a second request.)"""
    features = subprocess.run(["curl", "--version"], capture_output=True, text=True).stdout
    if "HTTP2" not in features:
        pytest.skip("curl was built without HTTP/2")
    seen = _count_huffman(monkeypatch)
    dynamic = {"n": 0}
    get = hpack.Decoder._get

    def counted_get(self, index):
        dynamic["n"] += index > len(hpack.STATIC_TABLE)
        return get(self, index)

    monkeypatch.setattr(hpack.Decoder, "_get", counted_get)
    srv = _RawH2Server([(":status", "200")])
    name = "x-" + "!#$%&'*+-.^_`|~" + "abcdefghijklmnopqrstuvwxyz0123456789"
    url = f"http://127.0.0.1:{srv.port}"
    try:
        out = subprocess.run(
            ["curl", "-s", "--http2-prior-knowledge", "-H", f"{name}: {_VALUE}",
             "-H", "X-Upper: MiXeD", "-H", "x-dup: twice", "-H", "x-dup: twice",
             f"{url}/first?q=1"], capture_output=True, text=True, timeout=30)
    finally:
        srv.close()
    assert out.returncode == 0, out.stderr
    assert srv.connections == 1 and len(srv.requests) == 1
    got = srv.requests[0]
    assert dict(got)[":path"] == "/first?q=1" and dict(got)[":method"] == "GET"
    assert dict(got)[name] == _VALUE and dict(got)["x-upper"] == "MiXeD"
    assert [v for k, v in got if k == "x-dup"] == ["twice", "twice"]
    assert seen["n"] > 0 and dynamic["n"] > 0


# -- HTTP/2 ------------------------------------------------------------------------

def _logger(pkg_logger=Logger, level=Level):
    return pkg_logger(level=level.WARN, out=io.StringIO(), err=io.StringIO(), is_terminal=False)


class _Echo:
    async def echo(self, request, context):
        return request

    async def chunks(self, request, context):
        for i in range(int(request["n"])):
            yield {"i": i, "blob": "z" * int(request["size"])}


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    thread = threading.Thread(target=lp.run_forever, daemon=True)
    thread.start()
    yield lp
    lp.call_soon_threadsafe(lp.stop)
    thread.join(timeout=5)


def _start(loop, server):
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(30)
    return server


@pytest.fixture(scope="module")
def servers(loop):
    """The echo service on the port's server and on the reference's."""
    echo = _Echo()
    port = GRPCServer(0, _logger())
    port.add_generic_rpc_handlers((json_method_handlers(
        "t.Echo", {"echo": echo.echo}, {"chunks": echo.chunks}),))
    ref = RefGRPCServer(0, _logger(RefLogger, RefLevel))
    ref.register(lambda server, s, c: server.add_generic_rpc_handlers((ref_json_handlers(
        "t.Echo", {"echo": s.echo}, {"chunks": s.chunks}),)), echo)
    _start(loop, port)
    _start(loop, ref)
    yield {"port": port, "reference": ref}
    for server in (port, ref):
        asyncio.run_coroutine_threadsafe(server.stop(0), loop).result(30)


def _json_calls(channel):
    ser = lambda o: json.dumps(o).encode()  # noqa: E731
    des = lambda b: json.loads(b)  # noqa: E731
    return (channel.unary_unary("/t.Echo/echo", request_serializer=ser, response_deserializer=des),
            channel.unary_stream("/t.Echo/chunks", request_serializer=ser,
                                 response_deserializer=des))


BLOB = "".join(chr(0x20 + (i * 7919) % 95) for i in range(1 << 20))  # 1 MB of printable text


@pytest.mark.parametrize("client,server", [("port", "port"), ("grpcio", "port"),
                                           ("port", "reference")])
def test_one_megabyte_echo_each_way(servers, client, server):
    """1 MB up and 1 MB back: the sender stops at the peer's windows and
    splits DATA at its frame size; the receiver grants credit as it reads."""
    addr = f"127.0.0.1:{servers[server].port}"
    channel = insecure_channel(addr) if client == "port" else grpc.insecure_channel(addr)
    try:
        echo, _ = _json_calls(channel)
        for _ in range(2):
            assert echo({"blob": BLOB}, timeout=60) == {"blob": BLOB}
    finally:
        channel.close()


def test_ten_streams_on_one_connection(servers):
    channel = insecure_channel(f"127.0.0.1:{servers['port'].port}")
    _, chunks = _json_calls(channel)
    results: dict = {}

    def run(k: int) -> None:
        results[k] = [m["i"] for m in chunks({"n": 20 + k, "size": 3000 + k}, timeout=60)]

    threads = [threading.Thread(target=run, args=(k,)) for k in range(10)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert results == {k: list(range(20 + k)) for k in range(10)}
        assert len(servers["port"]._conns) == 1
    finally:
        channel.close()


def test_stalled_reader_does_not_block_its_neighbour(servers):
    """Stream A sends 16 MB and its reader stops after one message: A holds
    its own window, stream B on the same connection runs to its end."""
    channel = insecure_channel(f"127.0.0.1:{servers['port'].port}")
    echo, chunks = _json_calls(channel)
    try:
        stalled = chunks({"n": 64, "size": 1 << 18}, timeout=60)
        assert next(stalled)["i"] == 0
        time.sleep(0.2)  # let A fill its window
        t0 = time.monotonic()
        assert [m["i"] for m in chunks({"n": 50, "size": 20_000}, timeout=30)] == list(range(50))
        assert echo({"blob": BLOB[:100_000]}, timeout=30) == {"blob": BLOB[:100_000]}
        assert time.monotonic() - t0 < 20
        assert [m["i"] for m in stalled] == list(range(1, 64))  # A resumes
    finally:
        channel.close()


def test_unknown_method_and_encoding(servers):
    """UNIMPLEMENTED for an unknown method and for a grpc-encoding the
    server does not take, on both servers."""
    for name in ("port", "reference"):
        addr = f"127.0.0.1:{servers[name].port}"
        for channel in (insecure_channel(addr), grpc.insecure_channel(addr)):
            try:
                with pytest.raises((RpcError, grpc.RpcError)) as err:
                    channel.unary_unary("/t.Echo/missing")(b"{}", timeout=10)
                assert err.value.code().name == StatusCode.UNIMPLEMENTED.name
            finally:
                channel.close()
    # An encoding the server lacks: UNIMPLEMENTED from the port's server,
    # as the gRPC protocol says. (grpcio's HPACK parser refuses a
    # grpc-encoding it cannot parse and resets the stream instead.)
    channel = insecure_channel(f"127.0.0.1:{servers['port'].port}")
    try:
        with pytest.raises(RpcError) as err:
            channel.unary_unary("/t.Echo/echo")(
                b"{}", timeout=10, metadata=[("grpc-encoding", "snappy")])
        assert err.value.code() == StatusCode.UNIMPLEMENTED
    finally:
        channel.close()


# -- limits: what a peer may make the other side hold -------------------------

_ONE_MESSAGE_MAX = 4 * 1024 * 1024  # grpc's default receive limit, both packages


def _raw_request(port: int, path: str, frames, headers: tuple = ()) -> list:
    """Open a raw HTTP/2 connection, send a request's HEADERS (no
    END_STREAM; ``headers`` added) and then ``frames(stream_id)``, and
    return the events the server sends back on stream 1 until it ends or
    resets. The client enforces no deadline of its own."""
    core = h2.H2Core(client=True)
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    events: list = []
    try:
        sock.sendall(core.preamble() + core.headers(1, [
            (":method", "POST"), (":scheme", "http"), (":path", path),
            (":authority", f"127.0.0.1:{port}"), ("content-type", "application/grpc"),
            ("te", "trailers"), *headers], end_stream=False))
        for chunk in frames(1):
            sock.sendall(chunk)
        while not any(e[0] == "reset" or (e[0] == "headers" and e[3]) for e in events):
            data = sock.recv(1 << 16)
            if not data:
                break
            events += [e for e in core.feed(data) if e[1] == 1 and e[0] != "window"]
            # A reset after the trailers comes in the same write or the next.
            if any(e[0] == "headers" and e[3] for e in events):
                sock.settimeout(1.0)
                try:
                    events += [e for e in core.feed(sock.recv(1 << 16))
                               if e[1] == 1 and e[0] != "window"]
                except socket.timeout:
                    pass
    finally:
        sock.close()
    return events


def test_unending_body_is_cut_at_the_message_limit(servers):
    """A request body that passes one message of 4 MB and never ends: the
    port's server stops holding it, answers RESOURCE_EXHAUSTED at once
    (trailers only) and resets the stream with NO_ERROR; the connection and
    the server go on serving."""
    chunk = b"\x00" * h2.DEFAULT_MAX_FRAME

    def frames(sid):
        yield h2.frame(h2.DATA, 0, sid, b"\x00" + (_ONE_MESSAGE_MAX + 1).to_bytes(4, "big"))
        for _ in range(_ONE_MESSAGE_MAX // len(chunk) + 2):
            yield h2.frame(h2.DATA, 0, sid, chunk)

    events = _raw_request(servers["port"].port, "/t.Echo/echo", frames)
    trailers = [dict(e[2]) for e in events if e[0] == "headers"]
    assert len(trailers) == 1 and trailers[0]["grpc-status"] == str(
        StatusCode.RESOURCE_EXHAUSTED.value), events
    assert "4194305 vs. 4194304" in trailers[0]["grpc-message"]
    assert ("reset", 1, h2.NO_ERROR) in events
    channel = insecure_channel(f"127.0.0.1:{servers['port'].port}")
    try:
        echo, _ = _json_calls(channel)
        assert echo({"blob": "after"}, timeout=30) == {"blob": "after"}
    finally:
        channel.close()


@pytest.mark.parametrize("client,server", [("port", "port"), ("grpcio", "port"),
                                           ("grpcio", "reference")])
def test_message_past_the_limit(servers, client, server):
    """One message of 4 MB + 1 byte: RESOURCE_EXHAUSTED from both servers."""
    addr = f"127.0.0.1:{servers[server].port}"
    channel = insecure_channel(addr) if client == "port" else grpc.insecure_channel(addr)
    try:
        echo = channel.unary_unary("/t.Echo/echo")
        with pytest.raises((RpcError, grpc.RpcError)) as err:
            echo(b" " * (_ONE_MESSAGE_MAX + 1), timeout=60)
        assert err.value.code().name == "RESOURCE_EXHAUSTED"
    finally:
        channel.close()


@pytest.mark.parametrize("server", ["port", "reference"])
def test_gzip_bomb_request(servers, server):
    """A gzip request of ~8 KB that inflates to 8 MB: RESOURCE_EXHAUSTED
    from both servers, counted after decompression as grpc counts it (the
    method answers nothing, so only the server's limit can refuse it)."""
    channel = grpc.insecure_channel(f"127.0.0.1:{servers[server].port}")
    try:
        chunks = channel.unary_stream("/t.Echo/chunks")
        with pytest.raises(grpc.RpcError) as err:
            list(chunks(b"{\"n\": 0, \"size\": 0, \"pad\": \"" + b"a" * (8 << 20) + b"\"}",
                        timeout=60, compression=grpc.Compression.Gzip))
        assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    finally:
        channel.close()


def test_gzip_bomb_reply():
    """The port's channel takes a gzip reply no further than the limit:
    RESOURCE_EXHAUSTED, and the stream is cancelled."""
    import gzip
    import queue

    from gofr_tpu_torch.grpc.channel import _Call

    class _Stream:
        def __init__(self) -> None:
            self.events: queue.Queue = queue.Queue()
            self.cancelled = False

        def consumed(self, n: int) -> None:
            pass

        def cancel(self, code: int = h2.CANCEL) -> None:
            self.cancelled = True

    bomb = gzip.compress(b"\x00" * (_ONE_MESSAGE_MAX + (1 << 20)))
    assert len(bomb) < 64 << 10
    stream = _Stream()
    for event in (("headers", [(":status", "200"), ("content-type", "application/grpc"),
                               ("grpc-encoding", "gzip")]),
                  ("data", b"\x01" + len(bomb).to_bytes(4, "big") + bomb),
                  ("headers", [("grpc-status", "0")]), ("end",)):
        stream.events.put(event)
    with pytest.raises(RpcError) as err:
        _Call(stream, None, None)._next_message()
    assert err.value.code() == StatusCode.RESOURCE_EXHAUSTED
    assert stream.cancelled


def test_header_lists_past_the_limit():
    """A header block past 64 KiB, or a small block whose indexed fields
    expand past it: the connection ends with ENHANCE_YOUR_CALM before the
    list is held."""
    core = h2.H2Core(client=False)
    core.feed(h2.PREFACE)
    big = hpack.encode_int(0, 4) + hpack.encode_str(b"x-big") + hpack.encode_str(
        b"v" * 2 * hpack.MAX_HEADER_LIST)  # Huffman codes 'v' in 7 bits
    with pytest.raises(h2.H2Error) as err:
        core.feed(h2.frame(h2.HEADERS, 0, 1, big[:h2.DEFAULT_MAX_FRAME]) + b"".join(
            h2.frame(h2.CONTINUATION, 0, 1, big[i:i + h2.DEFAULT_MAX_FRAME])
            for i in range(h2.DEFAULT_MAX_FRAME, len(big), h2.DEFAULT_MAX_FRAME)))
    assert err.value.code == h2.ENHANCE_YOUR_CALM
    # 3 KB into the dynamic table once, then 30 one-byte references to it.
    entry = hpack.encode_int(0, 6, 0x40) + hpack.encode_str(b"x-e") + hpack.encode_str(
        b"w" * 3000)
    block = entry + bytes([0x80 | 62]) * 30
    assert len(block) < 4096
    core = h2.H2Core(client=False)
    core.feed(h2.PREFACE)
    with pytest.raises(h2.H2Error) as err:
        core.feed(h2.frame(h2.HEADERS, h2.END_HEADERS | h2.END_STREAM, 1, block))
    assert err.value.code == h2.ENHANCE_YOUR_CALM
    assert len(hpack.Decoder().decode(entry + bytes([0x80 | 62]) * 5)) == 6  # within it
