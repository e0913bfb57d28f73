"""In-process mini Redis server for tests.

The reference's test strategy stands up miniredis — a real in-process Redis —
instead of mocking the client (SURVEY §4, reference ``redis/redis_test.go:8``).
This is the same seam for this framework: a threaded TCP server speaking
enough RESP2 for the framework's usage (strings, hashes, lists, sets,
expiry, MULTI/EXEC, INFO).

The port's copy of ``gofr_tpu/datasource/redis/miniredis.py``.
"""

from __future__ import annotations

import fnmatch
import socketserver
import threading
import time
from typing import Any, Optional


class _Store:
    def __init__(self) -> None:
        self.data: dict[str, Any] = {}
        self.expiry: dict[str, float] = {}
        self.lock = threading.RLock()

    def _expired(self, key: str) -> bool:
        exp = self.expiry.get(key)
        if exp is not None and time.time() > exp:
            self.data.pop(key, None)
            self.expiry.pop(key, None)
            return True
        return False

    def get(self, key: str) -> Any:
        with self.lock:
            if self._expired(key):
                return None
            return self.data.get(key)

    def set(self, key: str, value: Any) -> None:
        with self.lock:
            self.data[key] = value
            self.expiry.pop(key, None)


def _ok() -> bytes:
    return b"+OK\r\n"


def _err(msg: str) -> bytes:
    return f"-ERR {msg}\r\n".encode()


def _int(n: int) -> bytes:
    return f":{n}\r\n".encode()


def _bulk(value: Optional[str]) -> bytes:
    if value is None:
        return b"$-1\r\n"
    data = value.encode() if isinstance(value, str) else value
    return f"${len(data)}\r\n".encode() + data + b"\r\n"


def _array(items: list) -> bytes:
    out = [f"*{len(items)}\r\n".encode()]
    for item in items:
        if isinstance(item, bytes) and (item[:1] in (b"+", b"-", b":", b"$", b"*")):
            out.append(item)
        elif isinstance(item, int):
            out.append(_int(item))
        else:
            out.append(_bulk(item))
    return b"".join(out)


class MiniRedis:
    """`start()` binds an ephemeral port; point the client at `.port`."""

    def __init__(self) -> None:
        self.store = _Store()
        self.port: int = 0
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- command handlers --------------------------------------------------

    def dispatch(self, args: list[str], conn_state: dict) -> bytes:
        cmd = args[0].upper()
        s = self.store

        if conn_state.get("multi") is not None and cmd not in ("EXEC", "MULTI", "DISCARD"):
            conn_state["multi"].append(args)
            return b"+QUEUED\r\n"

        if cmd == "PING":
            return b"+PONG\r\n"
        if cmd == "SET":
            s.set(args[1], args[2])
            if len(args) >= 5 and args[3].upper() == "EX":
                s.expiry[args[1]] = time.time() + int(args[4])
            return _ok()
        if cmd == "GET":
            val = s.get(args[1])
            if val is not None and not isinstance(val, str):
                return _err("wrong type")
            return _bulk(val)
        if cmd == "DEL":
            n = 0
            with s.lock:
                for key in args[1:]:
                    if s.data.pop(key, None) is not None:
                        n += 1
                    s.expiry.pop(key, None)
            return _int(n)
        if cmd == "EXISTS":
            n = sum(1 for key in args[1:] if s.get(key) is not None)
            return _int(n)
        if cmd == "INCR":
            with s.lock:
                val = int(s.get(args[1]) or 0) + 1
                s.set(args[1], str(val))
            return _int(val)
        if cmd == "EXPIRE":
            with s.lock:
                if s.get(args[1]) is None:
                    return _int(0)
                s.expiry[args[1]] = time.time() + int(args[2])
            return _int(1)
        if cmd == "TTL":
            with s.lock:
                if s.get(args[1]) is None:
                    return _int(-2)
                exp = s.expiry.get(args[1])
                return _int(-1 if exp is None else max(0, int(exp - time.time())))
        if cmd == "KEYS":
            with s.lock:
                keys = [k for k in list(s.data) if not s._expired(k)]
            return _array([k for k in keys if fnmatch.fnmatch(k, args[1])])
        if cmd == "HSET":
            with s.lock:
                h = s.data.setdefault(args[1], {})
                if not isinstance(h, dict):
                    return _err("wrong type")
                added = 0
                for i in range(2, len(args) - 1, 2):
                    if args[i] not in h:
                        added += 1
                    h[args[i]] = args[i + 1]
            return _int(added)
        if cmd == "HGET":
            h = s.get(args[1]) or {}
            return _bulk(h.get(args[2]) if isinstance(h, dict) else None)
        if cmd == "HGETALL":
            h = s.get(args[1]) or {}
            flat: list = []
            for k, v in (h.items() if isinstance(h, dict) else []):
                flat += [k, v]
            return _array(flat)
        if cmd == "HDEL":
            with s.lock:
                h = s.data.get(args[1]) or {}
                n = sum(1 for f in args[2:] if h.pop(f, None) is not None)
            return _int(n)
        if cmd in ("LPUSH", "RPUSH"):
            with s.lock:
                lst = s.data.setdefault(args[1], [])
                if not isinstance(lst, list):
                    return _err("wrong type")
                for v in args[2:]:
                    lst.insert(0, v) if cmd == "LPUSH" else lst.append(v)
            return _int(len(lst))
        if cmd == "LRANGE":
            lst = s.get(args[1]) or []
            start, stop = int(args[2]), int(args[3])
            stop = len(lst) if stop == -1 else stop + 1
            return _array(lst[start:stop])
        if cmd == "LPOP":
            with s.lock:
                lst = s.data.get(args[1]) or []
                return _bulk(lst.pop(0) if lst else None)
        if cmd == "SADD":
            with s.lock:
                st = s.data.setdefault(args[1], set())
                if not isinstance(st, set):
                    return _err("wrong type")
                n = 0
                for v in args[2:]:
                    if v not in st:
                        st.add(v)
                        n += 1
            return _int(n)
        if cmd == "SMEMBERS":
            st = s.get(args[1]) or set()
            return _array(sorted(st))
        if cmd == "FLUSHDB":
            with s.lock:
                s.data.clear()
                s.expiry.clear()
            return _ok()
        if cmd == "INFO":
            body = (
                "# Stats\r\ntotal_connections_received:1\r\n"
                "total_commands_processed:1\r\nkeyspace_hits:0\r\nkeyspace_misses:0\r\n"
            )
            return _bulk(body)
        if cmd == "MULTI":
            conn_state["multi"] = []
            return _ok()
        if cmd == "DISCARD":
            conn_state["multi"] = None
            return _ok()
        if cmd == "EXEC":
            queued = conn_state.get("multi") or []
            conn_state["multi"] = None
            return _array([self.dispatch(q, conn_state) for q in queued])
        return _err(f"unknown command '{args[0]}'")

    # -- server loop -------------------------------------------------------

    def start(self) -> "MiniRedis":
        mini = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                buf = b""
                state: dict = {"multi": None}
                sock = self.request
                while True:
                    try:
                        chunk = sock.recv(65536)
                    except OSError:
                        return
                    if not chunk:
                        return
                    buf += chunk
                    while True:
                        parsed = _try_parse(buf)
                        if parsed is None:
                            break
                        args, buf = parsed
                        if not args:
                            continue
                        try:
                            reply = mini.dispatch(args, state)
                        except Exception as exc:
                            reply = _err(str(exc))
                        try:
                            sock.sendall(reply)
                        except OSError:
                            return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()


def _try_parse(buf: bytes):
    """Parse one RESP command array from buf; returns (args, rest) or None."""
    if not buf:
        return None
    if not buf.startswith(b"*"):
        # inline command
        if b"\r\n" not in buf:
            return None
        line, _, rest = buf.partition(b"\r\n")
        return line.decode().split(), rest
    head, _, rest = buf.partition(b"\r\n")
    if not _:
        return None
    try:
        count = int(head[1:])
    except ValueError:
        return [], rest
    args = []
    for _i in range(count):
        if not rest.startswith(b"$"):
            return None
        size_line, sep, rest2 = rest.partition(b"\r\n")
        if not sep:
            return None
        size = int(size_line[1:])
        if len(rest2) < size + 2:
            return None
        args.append(rest2[:size].decode("utf-8", "replace"))
        rest = rest2[size + 2 :]
    return args, rest
