"""RESP2 Redis client.

Implements the wire protocol natively over a socket (inline arrays out,
typed replies in), with the reference's observability contract: every command
is logged with its duration and recorded in the ``app_redis_stats`` histogram
(reference ``redis/hook.go:17-21,85-105``), ping-at-boot (``redis/redis.go:60``),
and ``INFO``-based health check (``redis/health.go:13-41``).

The port's copy of ``gofr_tpu/datasource/redis/client.py``.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Optional

from gofr_tpu_torch.config.env import Config


class RedisError(Exception):
    pass


class RedisLog:
    def __init__(self, args: tuple, duration_us: int) -> None:
        self.type = "REDIS"
        self.command = " ".join(str(a) for a in args[:2])
        self.duration = duration_us

    def to_log_dict(self) -> dict:
        return {"type": self.type, "command": self.command, "duration": self.duration}

    def pretty_print(self, fp) -> None:
        fp.write(f"\x1b[38;5;8mREDIS\x1b[0m {self.duration:>8}µs {self.command}\n")


def _encode_command(args: tuple) -> bytes:
    out = [f"*{len(args)}\r\n".encode()]
    for a in args:
        if isinstance(a, bytes):
            data = a
        else:
            data = str(a).encode("utf-8")
        out.append(f"${len(data)}\r\n".encode() + data + b"\r\n")
    return b"".join(out)


class _Reader:
    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._buf = b""

    def _readline(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RedisError("connection closed")
            self._buf += chunk
        line, _, self._buf = self._buf.partition(b"\r\n")
        return line

    def _readexact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RedisError("connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2 :]
        return data

    def read_reply(self) -> Any:
        line = self._readline()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            length = int(rest)
            if length == -1:
                return None
            return self._readexact(length).decode("utf-8", "replace")
        if kind == b"*":
            count = int(rest)
            if count == -1:
                return None
            return [self.read_reply() for _ in range(count)]
        raise RedisError(f"bad reply type {kind!r}")


class Redis:
    """Thread-safe single-connection RESP client."""

    def __init__(self, host: str, port: int, logger=None, metrics=None, timeout: float = 5.0) -> None:
        self.host, self.port = host, port
        self._logger = logger
        self._metrics = metrics
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[_Reader] = None
        self._connect()

    def _connect(self) -> None:
        sock = socket.create_connection((self.host, self.port), timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._reader = _Reader(sock)

    def command(self, *args) -> Any:
        start = time.time()
        with self._lock:
            try:
                self._sock.sendall(_encode_command(args))
                reply = self._reader.read_reply()
            except (OSError, RedisError):
                # One reconnect attempt (role of go-redis's retry).
                self._connect()
                self._sock.sendall(_encode_command(args))
                reply = self._reader.read_reply()
        elapsed = time.time() - start
        if self._metrics is not None:
            self._metrics.record_histogram(
                "app_redis_stats", elapsed * 1e3, "type", str(args[0]).upper()
            )
        if self._logger is not None:
            self._logger.debug(RedisLog(args, int(elapsed * 1e6)))
        return reply

    # -- convenience commands (go-redis Cmdable subset the reference uses) --

    def ping(self) -> str:
        return self.command("PING")

    def get(self, key: str) -> Optional[str]:
        return self.command("GET", key)

    def set(self, key: str, value, ex: Optional[int] = None) -> str:
        if ex is not None:
            return self.command("SET", key, value, "EX", ex)
        return self.command("SET", key, value)

    def delete(self, *keys: str) -> int:
        return self.command("DEL", *keys)

    def exists(self, *keys: str) -> int:
        return self.command("EXISTS", *keys)

    def incr(self, key: str) -> int:
        return self.command("INCR", key)

    def expire(self, key: str, seconds: int) -> int:
        return self.command("EXPIRE", key, seconds)

    def ttl(self, key: str) -> int:
        return self.command("TTL", key)

    def keys(self, pattern: str = "*") -> list:
        return self.command("KEYS", pattern) or []

    def hset(self, key: str, *pairs) -> int:
        return self.command("HSET", key, *pairs)

    def hget(self, key: str, field: str) -> Optional[str]:
        return self.command("HGET", key, field)

    def hgetall(self, key: str) -> dict:
        flat = self.command("HGETALL", key) or []
        return dict(zip(flat[::2], flat[1::2]))

    def hdel(self, key: str, *fields: str) -> int:
        return self.command("HDEL", key, *fields)

    def lpush(self, key: str, *values) -> int:
        return self.command("LPUSH", key, *values)

    def rpush(self, key: str, *values) -> int:
        return self.command("RPUSH", key, *values)

    def lrange(self, key: str, start: int, stop: int) -> list:
        return self.command("LRANGE", key, start, stop) or []

    def sadd(self, key: str, *members) -> int:
        return self.command("SADD", key, *members)

    def smembers(self, key: str) -> list:
        return self.command("SMEMBERS", key) or []

    def flushdb(self) -> str:
        return self.command("FLUSHDB")

    def info(self, section: str = "") -> str:
        return self.command("INFO", section) if section else self.command("INFO")

    def tx_pipeline(self) -> "TxPipeline":
        """MULTI/EXEC pipeline (the reference uses TxPipelined for migrations,
        ``migration/redis.go:53-68``)."""
        return TxPipeline(self)

    # -- lifecycle ---------------------------------------------------------

    def health_check(self) -> dict:
        try:
            info = self.info("stats")
            stats = {}
            for line in (info or "").splitlines():
                if ":" in line and not line.startswith("#"):
                    k, _, v = line.partition(":")
                    stats[k] = v
            return {
                "status": "UP",
                "details": {"host": f"{self.host}:{self.port}", "stats": stats},
            }
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}

    def close(self) -> None:
        try:
            if self._sock is not None:
                self._sock.close()
        except Exception:
            pass


class TxPipeline:
    """Queue commands client-side, send under MULTI/EXEC on exec()."""

    def __init__(self, client: Redis) -> None:
        self._client = client
        self._commands: list[tuple] = []

    def command(self, *args) -> "TxPipeline":
        self._commands.append(args)
        return self

    def set(self, key, value):
        return self.command("SET", key, value)

    def hset(self, key, *pairs):
        return self.command("HSET", key, *pairs)

    def delete(self, *keys):
        return self.command("DEL", *keys)

    def exec(self) -> list:
        c = self._client
        with c._lock:
            c._sock.sendall(_encode_command(("MULTI",)))
            c._reader.read_reply()
            for cmd in self._commands:
                c._sock.sendall(_encode_command(cmd))
                c._reader.read_reply()  # +QUEUED
            c._sock.sendall(_encode_command(("EXEC",)))
            return c._reader.read_reply()


def new_redis_from_config(config: Config, logger=None, metrics=None) -> Optional[Redis]:
    """Config-gated creation (reference ``redis/redis.go:35-77``): requires
    ``REDIS_HOST``; ``REDIS_PORT`` defaults to 6379; pings at boot and logs
    failure without killing the app."""
    host = config.get_or_default("REDIS_HOST", "")
    if not host:
        return None
    port = int(config.get_or_default("REDIS_PORT", "6379"))
    try:
        client = Redis(host, port, logger=logger, metrics=metrics)
        client.ping()
        if logger is not None:
            logger.infof("connected to redis at %s:%d", host, port)
        return client
    except Exception as exc:
        if logger is not None:
            logger.errorf("could not connect to redis at %s:%d: %s", host, port, exc)
        return None
