"""Typed protobuf implementation of ``gofr.tpu.v1.Inference``.

The production gRPC surface (VERDICT r1 missing #1): any stock gRPC client
with the generated stubs interoperates. The JSON service
(``grpc/inference.py``, ``gofr.tpu.Inference``) stays registered alongside
for curl-style exploration — the two live under different proto packages
so both can share :9000.

The port's copy of ``gofr_tpu/grpc/inference_typed.py``, on the port's
messages (``grpc/inference_pb2.py``) and server.
"""

from __future__ import annotations

import json

import numpy as np

from gofr_tpu_torch.errors import GofrError
from gofr_tpu_torch.grpc import inference_pb2 as pb
from gofr_tpu_torch.grpc.inference_pb2_grpc import (
    InferenceServicer as _Base,
)
from gofr_tpu_torch.grpc.inference_pb2_grpc import (
    add_InferenceServicer_to_server,
)

__all__ = ["TypedInferenceServicer", "add_typed_inference_service"]


class TypedInferenceServicer(_Base):
    def __init__(self, engine, tokenizer=None) -> None:
        self.engine = engine
        self.tokenizer = tokenizer or engine.tokenizer

    def _gen_kwargs(self, request, context=None) -> tuple:
        from gofr_tpu_torch.grpc.server import (
            deadline_from_context,
            slo_class_from_context,
            tenant_from_context,
        )

        prompt = (
            list(request.prompt_ids) if request.prompt_ids else request.prompt
        )
        kw = {
            "max_new_tokens": request.max_new_tokens or 128,
            "temperature": request.temperature,
            "stop_on_eos": request.stop_on_eos,
            "stop": list(request.stop),
        }
        if request.top_p:  # proto default 0 = "not set"
            kw["top_p"] = request.top_p
        if request.adapter:
            kw["adapter"] = request.adapter
        if context is not None:
            # Per-tenant admission quotas (TPU_TENANT_QUEUE_MAX): the
            # x-tenant-id metadata is the gRPC twin of the HTTP header.
            tenant = tenant_from_context(context)
            if tenant:
                kw["tenant"] = tenant
            # Brownout SLO class (x-slo-class): priority-aware shedding
            # under overload (serving/brownout.py).
            slo_class = slo_class_from_context(context)
            if slo_class:
                kw["slo_class"] = slo_class
            # Caller's gRPC deadline → engine Deadline: when it expires
            # the scheduler retires the sequence and frees its KV blocks
            # instead of decoding past an RPC nobody is waiting on.
            remaining = deadline_from_context(context)
            if remaining is not None:
                kw["deadline_s"] = remaining
        return prompt, kw

    async def Generate(self, request, context):
        from gofr_tpu_torch.grpc.server import grpc_status_code

        prompt, kw = self._gen_kwargs(request, context)
        if self.engine.family == "seq2seq":
            text, ids = await self.engine.seq2seq_text(prompt)
            return pb.GenerateReply(
                text=text, tokens=len(ids), finish_reason="stop"
            )
        try:
            result = await self.engine.generate(prompt, **kw)
        except GofrError as exc:
            await context.abort(grpc_status_code(exc), str(exc))
        return pb.GenerateReply(
            text=result.text,
            tokens=len(result.token_ids),
            ttft_ms=round(result.ttft_s * 1e3, 3),
            tokens_per_sec=round(result.tokens_per_sec, 3),
            truncated=result.truncated,
            finish_reason=result.finish_reason,
            token_logprobs=[round(lp, 6) for lp in result.token_logprobs],
        )

    async def GenerateStream(self, request, context):
        from gofr_tpu_torch.grpc.server import StatusCode, grpc_status_code
        from gofr_tpu_torch.serving.stream_text import (
            stream_generation,
            stream_seq2seq,
        )

        if self.engine.family == "seq2seq":
            # Stepped decode: chunks of tokens stream as the engine
            # produces them (r4 VERDICT weak #7), via the shared shaping
            # helper so the surfaces cannot drift.
            prompt, _ = self._gen_kwargs(request)
            async for ev in stream_seq2seq(self.engine, prompt, self.tokenizer):
                if ev["type"] == "piece":
                    yield pb.TokenChunk(token=ev["token"], text=ev["text"])
                else:
                    yield pb.TokenChunk(
                        done=True, tokens=ev["tokens"],
                        ttft_ms=ev["ttft_ms"],
                        finish_reason=ev["finish_reason"],
                    )
            return

        prompt, kw = self._gen_kwargs(request, context)
        try:
            async for ev in stream_generation(
                self.engine, prompt, kw, self.tokenizer
            ):
                if ev["type"] == "piece":
                    yield pb.TokenChunk(token=ev["token"], text=ev["text"])
                else:
                    yield pb.TokenChunk(
                        done=True,
                        tokens=ev["tokens"],
                        ttft_ms=ev["ttft_ms"],
                        finish_reason=ev["finish_reason"],
                    )
        except GofrError as exc:
            await context.abort(grpc_status_code(exc), str(exc))
        except Exception as exc:  # noqa: BLE001 — engine died mid-stream
            await context.abort(StatusCode.INTERNAL, str(exc))

    async def Embed(self, request, context):
        emb = await self.engine.embed(request.text)
        return pb.EmbedReply(embedding=np.asarray(emb, dtype=np.float32))

    async def Classify(self, request, context):
        image = np.asarray(request.image, dtype=np.float32)
        if request.shape:
            image = image.reshape(tuple(request.shape))
        logits = np.asarray(await self.engine.classify(image))
        return pb.ClassifyReply(
            label=int(np.argmax(logits)), logits=logits.astype(np.float32)
        )

    async def Health(self, request, context):
        h = self.engine.health_check()
        return pb.HealthReply(
            status=h.get("status", "DOWN"),
            details_json=json.dumps(h.get("details", {})),
        )


def add_typed_inference_service(servicer, server) -> None:
    """``App.register_service`` adapter. Two-arg (servicer, server) —
    the protoc-codegen convention, which ``GRPCServer.start`` detects by
    arity (``grpc/server.py``)."""
    add_InferenceServicer_to_server(servicer, server)
