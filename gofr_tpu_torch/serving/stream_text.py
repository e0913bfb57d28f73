"""Shared token-stream shaping for the gRPC serving surfaces.

One place owns the streaming contract both the typed-protobuf and the
JSON gRPC servicers expose (and that must match the unary replies):

* cumulative decode so multi-byte UTF-8 never splits across chunks;
* stop sequences trimmed EXACTLY like the unary path (text held back
  until a match is ruled out);
* the engine's authoritative ``finish_reason`` on the final event;
* request cancellation on ANY abnormal consumer exit (client cancel,
  generator finalization, downstream error), so the KV slot frees
  instead of decoding for nobody.

The port's copy of ``gofr_tpu/serving/stream_text.py``: ``normalize_stop``,
``stream_generation`` and ``stream_seq2seq``. No surface of the port
calls ``stream_seq2seq`` until the gRPC servicers are ported (ROADMAP
Queue 1 item 2.6).
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, AsyncIterator


def normalize_stop(stop: Any) -> list[str]:
    """OpenAI-style ``stop`` forms: None/absent, one string, or a list."""
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop]
    return list(stop)


async def stream_generation(
    engine, prompt, kw: dict, tokenizer
) -> AsyncIterator[dict]:
    """Yield ``{"type": "piece", "token", "text"}`` events followed by one
    ``{"type": "done", "tokens", "ttft_ms", "finish_reason"}``.

    ``kw`` goes to ``engine.submit_generate`` verbatim — validation errors
    (prompt too long, top_p rejected, draining) raise out of the FIRST
    ``anext`` so callers can map them before any chunk is on the wire.
    """
    stops = normalize_stop(kw.get("stop"))
    req = engine.submit_generate(prompt, **kw)
    loop = asyncio.get_running_loop()
    # Monotonic: ttft/duration are INTERVALS — an NTP step between
    # submit and first token would skew (or negate) a wall-clock diff.
    start = time.monotonic()
    first_at = None
    n = 0
    hold = max((len(s) for s in stops), default=0)
    trimming = bool(stops) and tokenizer is not None
    ids: list[int] = []
    printed = ""
    finished = False
    try:
        while True:
            tok = await loop.run_in_executor(None, req.stream.get)
            if tok is None:
                break
            if first_at is None:
                first_at = time.monotonic()
            n += 1
            ids.append(tok)
            if tokenizer is None:
                yield {"type": "piece", "token": tok, "text": ""}
                continue
            full = tokenizer.decode(ids)
            if trimming:
                at = min(
                    (p for p in (full.find(s) for s in stops) if p != -1),
                    default=-1,
                )
                if at != -1:
                    full = full[:at]
                elif full.endswith("�"):
                    continue  # incomplete UTF-8 tail — hold back
                else:
                    full = full[: max(len(printed), len(full) - hold)]
            elif full.endswith("�"):
                continue
            if len(full) > len(printed):
                piece, printed = full[len(printed):], full
                yield {"type": "piece", "token": tok, "text": piece}
        result = req.future.result(timeout=30)  # authoritative reason
        finished = True
        yield {
            "type": "done",
            "tokens": n,
            "ttft_ms": round(
                ((first_at or time.monotonic()) - start) * 1e3, 3
            ),
            "finish_reason": result.finish_reason,
        }
    finally:
        if not finished:
            # Abnormal exit — cancel so the engine stops decoding for a
            # consumer that is gone (no-op on a completed future).
            # cancel_request also trips the request's CancelToken, which
            # the scheduler's lifecycle reap retires within one window.
            req.cancel_request()


async def stream_seq2seq(engine: Any, prompt: Any, tokenizer: Any) -> AsyncIterator[dict]:
    """Stepped seq2seq streaming: ``{"type": "piece", "token", "text"}`` a
    chunk of the engine's ``seq2seq_stream``, then ``{"type": "done",
    "tokens", "ttft_ms", "finish_reason"}``. Pieces use cumulative decode,
    so multi-byte text never splits inside a chunk."""
    t0 = time.monotonic()
    all_ids: list[int] = []
    printed = ""
    ttft_ms = 0.0
    async for toks in engine.seq2seq_stream(prompt):
        if not all_ids:
            ttft_ms = round((time.monotonic() - t0) * 1e3, 2)
        all_ids.extend(toks)
        decoded = tokenizer.decode(all_ids) if tokenizer is not None else ""
        piece, printed = decoded[len(printed):], decoded
        yield {"type": "piece", "token": toks[0], "text": piece}
    yield {
        "type": "done",
        "tokens": len(all_ids),
        "ttft_ms": ttft_ms,
        "finish_reason": "stop",
    }
