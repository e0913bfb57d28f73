"""Asyncio HTTP/1.1 server.

Plays the role of ``net/http.Server`` in the reference (``httpServer.go:12-36``)
but adds what the reference lacks: graceful shutdown with connection draining
(the reference's ``Run()`` blocks forever, ``gofr.go:169`` — SURVEY §3.1 flags
this as a gap the build must close, since queued batched inference makes
drain-on-shutdown mandatory).

* per-connection read deadline mirroring the reference's 5s
  ``ReadHeaderTimeout`` (``httpServer.go:27``);
* keep-alive with pipelined sequential requests;
* the handler is ``async fn(RawRequest) -> Response``;
* request lifecycle: an ``X-Request-Timeout`` header (seconds) becomes a
  :class:`Deadline` and every request carries a :class:`CancelToken` in
  ``ctx_data`` — the token trips when the connection dies mid-request,
  so a generation handler's engine work is retired instead of decoding
  for a client that is gone (docs/advanced-guide/resilience.md).

The port's copy of ``gofr_tpu/http/server.py``.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Optional

from gofr_tpu_torch.http.proto import (
    CHUNKED_TERMINATOR,
    ProtocolError,
    RawRequest,
    Response,
    chunk_encode,
    read_request,
    serialize_response,
)
from gofr_tpu_torch.serving.lifecycle import CancelToken, Deadline

Handler = Callable[[RawRequest], Awaitable[Response]]

READ_HEADER_TIMEOUT_S = 5.0  # reference httpServer.go:27
KEEPALIVE_IDLE_TIMEOUT_S = 75.0
# The reference sets only ReadHeaderTimeout; bodies may stream for as long
# as they need. Bound them generously instead of inheriting the 5s header
# budget (which would reset slow uploads mid-stream with no response).
BODY_READ_TIMEOUT_S = 300.0
# Per-request deadline header: seconds the client is willing to wait.
# Parsed here (the transport edge) so every surface — framework routes,
# OpenAI endpoints, ctx.infer — sees the same Deadline on ctx_data.
REQUEST_TIMEOUT_HEADER = "x-request-timeout"


class HTTPServer:
    def __init__(
        self,
        handler: Handler,
        port: int,
        host: str = "0.0.0.0",
        logger=None,
    ) -> None:
        self._handler = handler
        self.host = host
        self.port = port
        self._logger = logger
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set[asyncio.StreamWriter] = set()
        self._inflight: set[asyncio.StreamWriter] = set()  # mid-request conns
        self.drain_timeout_s = 30.0

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve_connection, host=self.host, port=self.port
        )
        # Port 0 → pick the bound port back up for tests.
        sock = self._server.sockets[0]
        self.port = sock.getsockname()[1]
        if self._logger is not None:
            self._logger.infof("HTTP server started on :%d", self.port)

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def shutdown(self) -> None:
        """Stop accepting, close IDLE connections, drain in-flight requests.

        Idle keep-alive connections sit in a read for up to 75s, so their
        transports close immediately; connections with a request mid-handler
        get up to ``drain_timeout_s`` to finish and flush their response
        (queued batched inference makes this drain mandatory — SURVEY §7).
        Requires Python ≥3.12 semantics for ``Server.wait_closed()`` (waits
        for handlers); on older runtimes the explicit in-flight poll below
        still provides the drain.
        """
        if self._server is None:
            return
        self._server.close()
        for writer in list(self._conns):
            if writer in self._inflight:
                continue
            try:
                writer.close()
            except Exception:
                pass
        deadline = asyncio.get_running_loop().time() + self.drain_timeout_s
        while self._inflight and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.05)
        if self._inflight:
            if self._logger is not None:
                self._logger.warnf(
                    "shutdown drain timed out with %d in-flight request(s); closing",
                    len(self._inflight),
                )
            for writer in list(self._inflight):
                try:
                    writer.close()
                except Exception:
                    pass
        try:
            await asyncio.wait_for(self._server.wait_closed(), timeout=5)
        except asyncio.TimeoutError:
            if self._logger is not None:
                self._logger.warn("wait_closed timed out; continuing shutdown")

    async def _serve_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        self._conns.add(writer)
        try:
            first = True
            while True:
                timeout = READ_HEADER_TIMEOUT_S if first else KEEPALIVE_IDLE_TIMEOUT_S
                # Read the request line here so the connection counts as
                # in-flight from the first byte of a request — a slow upload
                # mid-shutdown drains instead of being reset.
                try:
                    line = await asyncio.wait_for(reader.readline(), timeout)
                except (asyncio.TimeoutError, ConnectionResetError):
                    break
                if not line:
                    break
                self._inflight.add(writer)
                try:
                    try:
                        raw = await asyncio.wait_for(
                            read_request(reader, peer=peer, first_line=line),
                            BODY_READ_TIMEOUT_S,
                        )
                    except asyncio.TimeoutError:
                        break
                    except (asyncio.IncompleteReadError, ConnectionResetError):
                        break
                    except ProtocolError as exc:
                        writer.write(
                            serialize_response(
                                Response(
                                    status=exc.status,
                                    headers={"Content-Type": "text/plain"},
                                    body=str(exc).encode(),
                                ),
                                keep_alive=False,
                            )
                        )
                        await _safe_drain(writer)
                        break
                    if raw is None:
                        break
                    first = False
                    # Request lifecycle: a cancel token every layer below
                    # can share (the OpenAI routes hand it to the engine),
                    # tripped when this connection dies mid-request; an
                    # optional client deadline from X-Request-Timeout.
                    cancel = CancelToken()
                    raw.ctx_data["cancel"] = cancel
                    tmo = raw.headers.get(REQUEST_TIMEOUT_HEADER)
                    if tmo:
                        try:
                            raw.ctx_data["deadline"] = Deadline.after(
                                float(tmo)
                            )
                        except ValueError:
                            if self._logger is not None:
                                self._logger.warnf(
                                    "ignoring malformed %s header: %r",
                                    REQUEST_TIMEOUT_HEADER, tmo,
                                )
                    # Disconnect watch for the handler's whole run (not
                    # just the response write): a client that vanishes
                    # mid-generation must trip the cancel token NOW so
                    # the engine's lifecycle reap frees its KV slot,
                    # instead of decoding the full budget for nobody.
                    # Poll-based (at_eof/is_closing) on purpose — reading
                    # the socket to detect EOF would consume a pipelined
                    # next request's bytes.
                    watcher = asyncio.ensure_future(
                        _watch_disconnect(reader, writer, cancel)
                    )
                    try:
                        resp = await self._handler(raw)
                    except Exception as exc:  # framework-level last resort
                        if self._logger is not None:
                            self._logger.errorf("unhandled server error: %s", exc)
                        resp = Response(
                            status=500,
                            headers={"Content-Type": "application/json"},
                            body=b'{"error":{"message":"Internal Server Error"}}',
                        )
                    finally:
                        watcher.cancel()

                    keep = raw.keep_alive
                    writer.write(
                        serialize_response(
                            resp, head_only=(raw.method == "HEAD"), keep_alive=keep
                        )
                    )
                    drained = await _safe_drain(writer)
                    if (
                        drained
                        and resp.body_stream is not None
                        and raw.method != "HEAD"
                    ):
                        # Chunked streaming body (SSE): write chunks as
                        # the handler's async iterator yields them. A
                        # failed write mid-stream closes the connection
                        # (the client can't distinguish a truncated
                        # chunked body from completion otherwise).
                        try:
                            async for chunk in resp.body_stream:
                                if not chunk:
                                    continue
                                writer.write(chunk_encode(chunk))
                                if not await _safe_drain(writer):
                                    keep = False
                                    break
                            else:
                                writer.write(CHUNKED_TERMINATOR)
                                drained = await _safe_drain(writer)
                        except Exception as exc:  # noqa: BLE001
                            if self._logger is not None:
                                self._logger.errorf(
                                    "stream body failed: %s", exc
                                )
                            keep = False
                        finally:
                            # Disconnect mid-stream: close the generator
                            # NOW so GeneratorExit reaches the handler
                            # (which can cancel the generation feeding
                            # it) instead of at GC time.
                            aclose = getattr(resp.body_stream, "aclose", None)
                            if aclose is not None:
                                try:
                                    await aclose()
                                except Exception:  # noqa: BLE001
                                    pass
                finally:
                    self._inflight.discard(writer)
                if not drained:
                    # The client is gone mid-response: trip the request's
                    # cancel token so any engine work feeding it retires
                    # (the stream path's aclose above handles SSE; this
                    # covers responses that failed to flush).
                    cancel.cancel()
                if not drained or not keep:
                    break
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
            except Exception:
                pass


async def _watch_disconnect(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    cancel: CancelToken,
    poll_s: float = 0.25,
) -> None:
    """Trip ``cancel`` when the peer goes away while a handler is
    running. A FIN surfaces as ``reader.at_eof()`` (the event loop keeps
    the socket read-registered while the handler awaits), an RST as a
    closing transport. Half-close clients (shutdown(WR) then read the
    response) are treated as disconnects — pathological under HTTP/1.1
    keep-alive. Cancelled by the caller when the handler returns; fast
    handlers (health, metrics) therefore never reach the first poll, and
    the interval is sized so 64 concurrent generations cost ~256 timer
    wakeups/sec, not thousands — disconnect reaping only needs to beat
    the decode budget, not the millisecond."""
    while True:
        if reader.at_eof() or writer.is_closing():
            cancel.cancel()
            return
        await asyncio.sleep(poll_s)


async def _safe_drain(writer: asyncio.StreamWriter) -> bool:
    try:
        await writer.drain()
        return True
    except (ConnectionResetError, BrokenPipeError):
        return False
