"""OpenAI-compatible serving surface (net-new; no reference analog).

``add_openai_routes(app)`` registers the three endpoints LLM clients
expect, backed by the container's TPU engine:

* ``POST /v1/completions`` — prompt in, text out; ``"stream": true``
  switches to SSE chunks (``data: {...}\\n\\n`` … ``data: [DONE]``).
* ``POST /v1/chat/completions`` — messages in, assistant message out;
  same streaming contract.
* ``GET /v1/models`` — the model registry.

Responses use the OpenAI wire shapes directly (``Raw`` / ``Stream``
bypass the framework's ``{"data": ...}`` envelope), so off-the-shelf
OpenAI SDKs can point their ``base_url`` at this server. Chat messages
render through the model's OWN chat template when the configured HF
tokenizer carries one (``apply_chat_template``, token-id output so BOS
isn't doubled), falling back to a minimal role-tagged flattening; an
explicit ``chat_template`` arg to ``add_openai_routes`` overrides both.

The port's copy of ``gofr_tpu/serving/openai_compat.py``.
``/v1/models`` lists the port's registry, which holds the reference's
names; ``/v1/embeddings`` serves from the secondary encoder engine
(``TPU_EMBED_MODEL``), or from the primary when it is an encoder. A
primary of another family answers as the reference's does: a seq2seq
(T5) primary serves text through ``ctx.infer``, and the completion
routes refuse it (``submit_generate``: "not a generative LLM").
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from typing import Any, AsyncIterator, Callable, Optional, Union

from gofr_tpu_torch.errors import GofrError
from gofr_tpu_torch.http.response import Raw, Stream


class OpenAIRequestError(GofrError):
    """400 with a plain message (OpenAI clients show error.message)."""

    status_code = 400


class OpenAIModelNotFound(GofrError):
    """404 — the OpenAI wire code for requesting a model that isn't
    loaded (clients silently getting a DIFFERENT model's output would
    be worse than the error)."""

    status_code = 404


def default_chat_template(messages: list[dict]) -> str:
    """Minimal generic chat flattening (role-tagged lines + cue)."""
    lines = []
    for m in messages:
        role = m.get("role", "user")
        lines.append(f"{role}: {m.get('content', '')}")
    lines.append("assistant:")
    return "\n".join(lines)


def _completion_body(req_json: bytes) -> dict:
    try:
        body = json.loads(req_json or b"{}")
    except json.JSONDecodeError as exc:
        raise OpenAIRequestError(f"invalid JSON body: {exc}") from None
    if not isinstance(body, dict):
        raise OpenAIRequestError("request body must be a JSON object")
    return body


def _usage(prompt_tokens: int, completion_tokens: int) -> dict:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


_MAX_N = 16  # choices per request; unbounded n is a one-request DoS


def _stop_list(body: dict) -> list[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        stop = [stop]
    if not (isinstance(stop, list) and all(isinstance(s, str) for s in stop)):
        raise OpenAIRequestError("stop must be a string or list of strings")
    if len(stop) > 4:
        raise OpenAIRequestError("stop supports at most 4 sequences")
    if any(not s for s in stop):
        raise OpenAIRequestError("stop sequences must be non-empty")
    return stop


def _n_choices(body: dict, streaming: bool) -> int:
    n = body.get("n")
    n = 1 if n is None else int(n)  # NOT `or`: n=0 must reach validation
    if n < 1 or n > _MAX_N:
        raise OpenAIRequestError(f"n must be between 1 and {_MAX_N}")
    if streaming and n > 1:
        raise OpenAIRequestError("streaming supports n=1")
    return n


def _decoder(engine: Any) -> Callable[[int], str]:
    if engine.tokenizer:
        return lambda t: engine.tokenizer.decode([t])
    return lambda t: ""


def _completion_logprobs(engine: Any, result: Any) -> dict:
    """OpenAI completions logprobs block."""
    dec = _decoder(engine)
    tokens = [dec(t) for t in result.token_ids]
    top: Optional[list[dict]] = None
    if result.token_top_logprobs is not None:
        # Keyed by decoded token STRING per the completions schema; when
        # two ids decode identically, the FIRST (highest logprob — alts
        # are sorted descending) wins.
        top = []
        for alts in result.token_top_logprobs:
            d: dict = {}
            for t, lp in (alts or []):
                d.setdefault(dec(t), round(lp, 6))
            top.append(d)
    return {
        "tokens": tokens,
        "token_logprobs": [round(lp, 6) for lp in result.token_logprobs],
        "top_logprobs": top,
        "text_offset": None,
    }


def add_openai_routes(
    app: Any,
    chat_template: Optional[Callable[[list[dict]], str]] = None,
) -> None:
    """Register /v1/* OpenAI-compatible routes on a gofr_tpu_torch App."""
    template = chat_template or default_chat_template

    def _engine(ctx: Any) -> Any:
        engine = getattr(ctx.container, "tpu", None)
        if engine is None:
            raise OpenAIRequestError(
                "no TPU engine configured (set TPU_ENABLED/TPU_MODEL)"
            )
        return engine

    def _check_model(body: dict, engine: Any) -> str:
        """A request naming a model that is NOT the loaded one gets the
        OpenAI 404, not the loaded model's output. A loaded LoRA
        adapter's name IS a model here (the vLLM convention): the
        request runs on the base engine with that adapter's slot
        selected per-request — one batch serves many adapters.
        Returns the adapter name ("" = base)."""
        want = body.get("model")
        if not want or want == engine.model_name:
            return ""
        names = engine.lora_names() if hasattr(engine, "lora_names") else []
        if want in names:
            return str(want)
        raise OpenAIModelNotFound(
            f"model {want!r} is not loaded (serving "
            f"{engine.model_name!r}); GET /v1/models lists "
            f"availability"
        )

    def _lifecycle(ctx: Any) -> dict:
        """Deadline (X-Request-Timeout) + cancel token (disconnect) from
        the HTTP server, threaded into every engine submit so abandoned
        or expired requests retire mid-decode and free their KV blocks.
        X-Tenant-Id rides along for per-tenant admission quotas
        (TPU_TENANT_QUEUE_MAX), and the tracer middleware's span becomes
        the engine timeline's parent (one trace from socket to token —
        and across replicas: a pool forwards it on HTTPReplica calls)."""
        header = getattr(ctx, "header", None)
        tenant = (header("x-tenant-id") if header is not None else "") or ""
        # Brownout SLO class (X-SLO-Class: interactive|standard|batch):
        # under overload the engine sheds batch-class admissions first
        # and interactive last (serving/brownout.py). Unknown values
        # fall back to the tenant default, then "standard" — never 400.
        slo_class = (
            header("x-slo-class") if header is not None else ""
        ) or ""
        out = dict(
            deadline=ctx.deadline, cancel=ctx.cancel_token, tenant=tenant,
            slo_class=slo_class,
        )
        span = ctx.get("span") if hasattr(ctx, "get") else None
        if span is not None and hasattr(span, "traceparent"):
            out["traceparent"] = span.traceparent()
        return out

    def _params(body: dict) -> dict:
        # Explicit nulls are legal per the OpenAI spec → fall back to
        # defaults instead of int(None)/float(None) crashes.
        max_tokens = body.get("max_tokens")
        if max_tokens is None:
            max_tokens = body.get("max_completion_tokens")
        temperature = body.get("temperature")
        temperature = 1.0 if temperature is None else float(temperature)
        top_p = body.get("top_p")
        top_p = 1.0 if top_p is None else float(top_p)
        if top_p == 0.0:
            # OpenAI accepts top_p=0 (smallest nucleus = the argmax
            # token); map it to plain greedy so it works on engines
            # compiled without the nucleus sampler too. Negative values
            # stay invalid and flow through to the engine's 400.
            top_p, temperature = 1.0, 0.0
        fpen = body.get("frequency_penalty")
        ppen = body.get("presence_penalty")
        seed = body.get("seed")
        logit_bias = body.get("logit_bias")
        return dict(
            max_new_tokens=128 if max_tokens is None else int(max_tokens),
            temperature=temperature,
            top_p=top_p,
            stop_on_eos=True,
            frequency_penalty=0.0 if fpen is None else float(fpen),
            presence_penalty=0.0 if ppen is None else float(ppen),
            seed=None if seed is None else int(seed),
            logit_bias=logit_bias or None,
        )

    def _stream_response(
        engine: Any, prompt: Any, params: dict, *, rid: str, model: str,
        chat: bool,
        stop_seqs: Optional[list[str]] = None, include_usage: bool = False,
        include_tokens: bool = False,
    ) -> Stream:
        # ``stream_options.include_tokens`` (this repo's extension, the
        # replica tier's internal wire): every chunk carries the raw
        # ``token_ids`` drained since the previous chunk — even when the
        # text is held back (UTF-8 tail / stop-sequence window) — and
        # the finish chunk carries ``prompt_tokens``. A routing tier
        # consuming the stream re-decodes text itself; what it needs on
        # the wire is the exact delivered-token prefix, so a replica
        # that dies mid-stream can resume on a sibling byte-identically.
        # Submit BEFORE returning the Stream: prompt validation
        # (ErrorPromptTooLong → 413 etc.) must fail the request proper,
        # not die silently after the 200/SSE headers are on the wire.
        # Stop sequences go to the ENGINE too, so decoding halts and the
        # KV slot frees at the match instead of running out the budget.
        req = engine.submit_generate(
            prompt, stop=list(stop_seqs or []), **params
        )
        object_name = (
            "chat.completion.chunk" if chat else "text_completion"
        )
        stops = stop_seqs or []

        async def events() -> AsyncIterator[str]:
            created = int(time.time())
            loop = asyncio.get_running_loop()
            emitted_ids: list[int] = []
            sent_tokens = 0  # ids already attached to a yielded chunk
            printed = ""
            reason = "stop"

            def payload_of(text: str) -> dict:
                nonlocal sent_tokens
                payload = (
                    {"delta": {"content": text}, "index": 0}
                    if chat else {"text": text, "index": 0}
                )
                if include_tokens:
                    payload["token_ids"] = emitted_ids[sent_tokens:]
                    sent_tokens = len(emitted_ids)
                return payload

            def stop_hit(full: str) -> int:
                return min(
                    (at for at in (full.find(s) for s in stops) if at != -1),
                    default=-1,
                )

            try:
                if chat:
                    first = {"role": "assistant", "content": ""}
                    yield _sse(rid, object_name, model, created,
                               {"delta": first, "index": 0})
                # Hold back enough text that a stop sequence can never be
                # emitted before it is detected (a stop spanning two
                # deltas must still cut cleanly).
                hold = max((len(s) for s in stops), default=0)
                stopped = False
                while not stopped:
                    tok = await loop.run_in_executor(None, req.stream.get)
                    if tok is None:
                        break
                    emitted_ids.append(tok)
                    if engine.tokenizer is None:
                        if include_tokens:
                            # Token-id wire with no text surface: the
                            # consumer (a routing tier) decodes itself.
                            yield _sse(rid, object_name, model, created,
                                       payload_of(""))
                        continue
                    # Cumulative decode: per-token decode would split
                    # multi-byte UTF-8 / BPE merges.
                    full = engine.tokenizer.decode(emitted_ids)
                    at = stop_hit(full)
                    if at != -1:
                        full = full[:at]
                        stopped = True
                    elif full.endswith("�"):
                        # Possibly incomplete UTF-8 tail — hold back
                        # (the ids still flow when the consumer asked
                        # for them: delivered-prefix accounting must
                        # not lag the generation).
                        if include_tokens:
                            yield _sse(rid, object_name, model, created,
                                       payload_of(""))
                        continue
                    else:
                        full = full[: max(len(printed), len(full) - hold)]
                    if len(full) > len(printed):
                        text, printed = full[len(printed):], full
                        yield _sse(rid, object_name, model, created,
                                   payload_of(text))
                    elif include_tokens:
                        yield _sse(rid, object_name, model, created,
                                   payload_of(""))
                brownout_flag = False
                if stopped:
                    reason = "stop"
                else:
                    # The engine's retired result is authoritative: its
                    # text is already stop-trimmed, its finish_reason
                    # covers eos/budget/context-window.
                    try:
                        result = req.future.result(timeout=30)
                    except Exception as exc:  # noqa: BLE001 — mapped to a terminal SSE error event below
                        # Terminal error event: a deadline-exceeded or
                        # engine-failed stream must END with an explicit
                        # error, not silently truncate (the 200/SSE
                        # headers are long gone, so the event stream is
                        # the only error channel left).
                        err = {
                            "error": {
                                "message": str(exc),
                                "type": type(exc).__name__,
                                "code": getattr(exc, "status_code", 500),
                            }
                        }
                        yield f"data: {json.dumps(err)}\n\n"
                        yield "data: [DONE]\n\n"
                        return
                    reason = result.finish_reason
                    # The retired result is the brownout-clamp
                    # authority too: set only when the clamp actually
                    # cut the answer, and carried across replicas (a
                    # pool fronting a REMOTE engine gets the flag from
                    # the remote's finish chunk via GenerationResult,
                    # where the local handle's brownout_clamped is
                    # never stamped).
                    brownout_flag = bool(
                        getattr(result, "brownout", False)
                    )
                    if (
                        engine.tokenizer is not None
                        and len(result.text) > len(printed)
                    ):
                        yield _sse(rid, object_name, model, created,
                                   payload_of(result.text[len(printed):]))
                done = (
                    {"delta": {}, "index": 0, "finish_reason": reason}
                    if chat else
                    {"text": "", "index": 0, "finish_reason": reason}
                )
                if brownout_flag:
                    # Deliberate policy truncation rides the finish
                    # chunk.
                    done["brownout"] = True
                if include_tokens:
                    # Any ids still unattached (final flush) ride the
                    # finish chunk, plus the prompt length so the
                    # consumer can build its usage accounting without a
                    # second round trip.
                    done["token_ids"] = emitted_ids[sent_tokens:]
                    sent_tokens = len(emitted_ids)
                    done["prompt_tokens"] = len(req.prompt_ids)
                yield _sse(rid, object_name, model, created, done)
                if include_usage:
                    # stream_options.include_usage: one final chunk with
                    # empty choices and the usage block (OpenAI wire).
                    # The retired result's trimmed token list is the
                    # authoritative count (the SSE loop drains tokens
                    # past a stop cut before detecting it).
                    try:
                        n_out = len(
                            req.future.result(timeout=30).token_ids
                        )
                    except Exception:  # noqa: BLE001 — cancelled stream
                        n_out = len(emitted_ids)
                    usage_chunk = {
                        "id": rid,
                        "object": object_name,
                        "created": created,
                        "model": model,
                        "choices": [],
                        "usage": _usage(len(req.prompt_ids), n_out),
                    }
                    yield f"data: {json.dumps(usage_chunk)}\n\n"
                yield "data: [DONE]\n\n"
            finally:
                # Client disconnected (GeneratorExit via the server's
                # aclose), stop sequence hit, or completed: cancel so the
                # engine frees the KV slot instead of decoding for nobody
                # (cancel_request also trips the shared CancelToken the
                # scheduler's lifecycle reap watches).
                req.cancel_request()

        return Stream(chunks=events())

    def _sse(
        rid: str, object_name: str, model: str, created: int, choice: dict
    ) -> str:
        return "data: " + json.dumps({
            "id": rid,
            "object": object_name,
            "created": created,
            "model": model,
            "choices": [choice],
        }) + "\n\n"

    def _normalize_prompts(prompt: Any) -> list:
        """OpenAI ``prompt`` forms: str, [int] (token ids), [str] /
        [[int]] (a batch — one completion per element)."""
        if isinstance(prompt, str):
            return [prompt]
        if isinstance(prompt, list):
            if not prompt:
                raise OpenAIRequestError("prompt must not be empty")
            if all(isinstance(p, int) for p in prompt):
                return [prompt]  # one prompt as token ids
            if all(isinstance(p, str) for p in prompt) or all(
                isinstance(p, list) and all(isinstance(t, int) for t in p)
                for p in prompt
            ):
                return list(prompt)
        raise OpenAIRequestError(
            "prompt must be a string, token-id array, or batch thereof"
        )

    @app.post("/v1/completions")
    async def completions(ctx: Any) -> Union[Raw, Stream]:
        engine = _engine(ctx)
        body = _completion_body(ctx.request.raw.body)
        adapter = _check_model(body, engine)
        prompts = _normalize_prompts(body.get("prompt", ""))
        params = dict(_params(body), adapter=adapter, **_lifecycle(ctx))
        stop_seqs = _stop_list(body)
        streaming = bool(body.get("stream"))
        n = _n_choices(body, streaming)
        rid = f"cmpl-{uuid.uuid4().hex[:24]}"
        model = body.get("model", engine.model_name)
        if streaming:
            if len(prompts) > 1:
                raise OpenAIRequestError(
                    "streaming supports a single prompt per request"
                )
            if body.get("echo"):
                raise OpenAIRequestError(
                    "echo is not supported with streaming"
                )
            return _stream_response(
                engine, prompts[0], params, rid=rid, model=model, chat=False,
                stop_seqs=stop_seqs,
                include_usage=bool(
                    (body.get("stream_options") or {}).get("include_usage")
                ),
                include_tokens=bool(
                    (body.get("stream_options") or {}).get("include_tokens")
                ),
            )
        lp_req = body.get("logprobs")
        want_logprobs = lp_req not in (None, False, 0)
        if (want_logprobs and isinstance(lp_req, int)
                and not isinstance(lp_req, bool) and lp_req >= 1):
            # completions semantics: logprobs=N → N alternatives/token,
            # CLAMPED to what the engine compiled (requests that were
            # valid before TPU_TOP_LOGPROBS existed must not start
            # 400ing: engines without the feature return null
            # alternatives as before).
            eng_k = getattr(engine, "top_logprobs", 0)
            if eng_k:
                params = dict(params, top_logprobs=min(int(lp_req), eng_k))
        echo = bool(body.get("echo"))
        results = await asyncio.gather(
            *(engine.generate(p, stop=stop_seqs, **params)
              for p in prompts for _ in range(n))
        )
        choices = []
        req_prompts = [p for p in prompts for _ in range(n)]
        for i, r in enumerate(results):
            # The engine trims text/tokens at the stop match and reports
            # finish_reason itself, so logprobs stay text-aligned.
            text = r.text
            if echo:
                # OpenAI legacy `echo`: prompt text prepended to the
                # completion (logprobs stay completion-only — prompt
                # logprob capture is not supported).
                pr = req_prompts[i]
                if not isinstance(pr, str):
                    if engine.tokenizer is None:
                        raise OpenAIRequestError(
                            "echo with token-id prompts needs a tokenizer"
                        )
                    pr = engine.tokenizer.decode(pr)
                text = pr + text
            choice = {
                "text": text,
                "index": i,
                "logprobs": _completion_logprobs(engine, r)
                if want_logprobs else None,
                "finish_reason": r.finish_reason,
            }
            if getattr(r, "brownout", False):
                # Deliberate overload truncation (brownout L1 clamp):
                # advertised so clients can distinguish policy from a
                # short completion. Absent entirely outside a brownout
                # — the nominal wire shape is byte-identical.
                choice["brownout"] = True
            choices.append(choice)
        return Raw({
            "id": rid,
            "object": "text_completion",
            "created": int(time.time()),
            "model": model,
            "choices": choices,
            "usage": _usage(
                sum(r.prompt_tokens for r in results),
                sum(len(r.token_ids) for r in results),
            ),
        }, status=200)

    @app.post("/v1/chat/completions")
    async def chat_completions(ctx: Any) -> Union[Raw, Stream]:
        engine = _engine(ctx)
        body = _completion_body(ctx.request.raw.body)
        adapter = _check_model(body, engine)
        messages = body.get("messages") or []
        if not isinstance(messages, list) or not messages:
            raise OpenAIRequestError("messages must be a non-empty list")
        # Prefer the model's own chat template (HF tokenizers carry one);
        # fall back to the generic role-tagged flattening. An explicit
        # chat_template arg to add_openai_routes overrides both.
        if chat_template is None and hasattr(
            engine.tokenizer, "apply_chat_template"
        ):
            try:
                prompt = engine.tokenizer.apply_chat_template(messages)
            except Exception:  # noqa: BLE001 — template may reject roles
                prompt = template(messages)
        else:
            prompt = template(messages)
        params = dict(_params(body), adapter=adapter, **_lifecycle(ctx))
        stop_seqs = _stop_list(body)
        streaming = bool(body.get("stream"))
        n = _n_choices(body, streaming)
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        model = body.get("model", engine.model_name)
        if streaming:
            return _stream_response(
                engine, prompt, params, rid=rid, model=model, chat=True,
                stop_seqs=stop_seqs,
                include_usage=bool(
                    (body.get("stream_options") or {}).get("include_usage")
                ),
                include_tokens=bool(
                    (body.get("stream_options") or {}).get("include_tokens")
                ),
            )
        want_logprobs = bool(body.get("logprobs"))
        chat_top = body.get("top_logprobs")
        if want_logprobs and chat_top:
            # Clamp to the engine's compiled K — pre-flag requests that
            # passed top_logprobs must keep getting 200s with empty
            # alternatives on engines without the feature.
            eng_k = getattr(engine, "top_logprobs", 0)
            if eng_k:
                params = dict(
                    params, top_logprobs=min(int(chat_top), eng_k)
                )
        results = await asyncio.gather(
            *(engine.generate(prompt, stop=stop_seqs, **params)
              for _ in range(n))
        )
        choices = []
        for i, r in enumerate(results):
            choice: dict = {
                "index": i,
                "message": {"role": "assistant", "content": r.text},
                "finish_reason": r.finish_reason,
            }
            if getattr(r, "brownout", False):
                # Deliberate overload truncation (brownout L1 clamp).
                choice["brownout"] = True
            if want_logprobs:
                dec = _decoder(engine)
                tops = r.token_top_logprobs or [None] * len(r.token_ids)
                choice["logprobs"] = {"content": [
                    {
                        "token": dec(t),
                        "logprob": round(lp, 6),
                        "top_logprobs": [
                            {"token": dec(at), "logprob": round(alp, 6)}
                            for at, alp in (alts or [])
                        ],
                    }
                    for t, lp, alts in zip(
                        r.token_ids, r.token_logprobs, tops
                    )
                ]}
            choices.append(choice)
        return Raw({
            "id": rid,
            "object": "chat.completion",
            "created": int(time.time()),
            "model": model,
            "choices": choices,
            "usage": _usage(
                sum(r.prompt_tokens for r in results),
                sum(len(r.token_ids) for r in results),
            ),
        }, status=200)

    @app.post("/v1/embeddings")
    async def embeddings(ctx: Any) -> Raw:
        """OpenAI embeddings: served by the secondary encoder engine
        (``TPU_EMBED_MODEL``), or by the primary when it is an encoder."""
        engine = getattr(ctx.container, "tpu_embed", None)
        if engine is None:
            primary = getattr(ctx.container, "tpu", None)
            if primary is not None and primary.family == "encoder":
                engine = primary
        if engine is None:
            raise OpenAIRequestError(
                "no encoder engine configured (set TPU_EMBED_MODEL, or "
                "TPU_MODEL to an encoder like bert-base)"
            )
        body = _completion_body(ctx.request.raw.body)
        _check_model(body, engine)
        inputs = body.get("input")
        if isinstance(inputs, str):
            inputs = [inputs]
        if (
            not isinstance(inputs, list) or not inputs
            or not all(isinstance(t, str) for t in inputs)
        ):
            raise OpenAIRequestError(
                "input must be a string or a non-empty list of strings"
            )
        vecs = await asyncio.gather(*(engine.embed(t) for t in inputs))
        data = [
            {
                "object": "embedding",
                "embedding": [float(x) for x in v],
                "index": i,
            }
            for i, v in enumerate(vecs)
        ]
        n_tokens = sum(
            min(len(engine.tokenizer.encode(t)), engine.max_len)
            if engine.tokenizer else 0
            for t in inputs
        )
        return Raw({
            "object": "list",
            "data": data,
            "model": body.get("model", engine.model_name),
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        }, status=200)  # OpenAI wire-compat: POST answers 200

    @app.get("/v1/models")
    async def models(ctx: Any) -> Raw:
        from gofr_tpu_torch.models.registry import list_models

        engine: Any = getattr(ctx.container, "tpu", None)
        embedder: Any = getattr(ctx.container, "tpu_embed", None)
        loaded = {
            e.model_name for e in (engine, embedder) if e is not None
        }
        adapters = (
            engine.lora_names()
            if engine is not None and hasattr(engine, "lora_names") else []
        )
        return Raw({
            "object": "list",
            "data": [
                {
                    "id": name,
                    "object": "model",
                    "owned_by": "gofr-tpu",
                    "loaded": name in loaded,
                }
                for name in list_models()
            ] + [
                # Loaded LoRA adapters are servable model ids (request
                # them via the "model" field; vLLM convention).
                {
                    "id": name,
                    "object": "model",
                    "owned_by": "gofr-tpu",
                    "loaded": True,
                    "parent": engine.model_name,
                }
                for name in adapters
            ],
        })
