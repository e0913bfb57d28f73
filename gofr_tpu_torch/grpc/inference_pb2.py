"""The messages of ``gofr.tpu.v1.Inference``
(``gofr_tpu/grpc/proto/inference.proto``) on the port's proto3 codec.

The port's stand-in for the protoc-generated ``gofr_tpu/grpc/inference_pb2.py``:
the same ten classes, field names and numbers, so ``pb.GenerateReply(text=...,
tokens=...)``, ``SerializeToString`` and ``FromString`` read as they do there,
and the bytes on the wire are protobuf's (``tests/test_torch_grpc_wire.py``
holds them equal).
"""

from __future__ import annotations

from gofr_tpu_torch.grpc.protowire import BOOL, DOUBLE, FLOAT, INT32, STRING, Field, Message

__all__ = [
    "GenerateRequest", "GenerateReply", "TokenChunk", "EmbedRequest", "EmbedReply",
    "ClassifyRequest", "ClassifyReply", "HealthRequest", "HealthReply", "MESSAGES",
]


class GenerateRequest(Message):
    FIELDS = (
        Field(1, "prompt", STRING),
        Field(2, "max_new_tokens", INT32),  # default 128 when 0
        Field(3, "temperature", FLOAT),  # 0 → greedy
        Field(4, "stop_on_eos", BOOL),
        Field(5, "prompt_ids", INT32, repeated=True),  # pre-tokenized alternative to prompt
        Field(6, "stop", STRING, repeated=True),  # stop sequences (result trimmed at match)
        Field(7, "top_p", FLOAT),  # 0 → disabled; needs TPU_TOP_P=true
        Field(8, "adapter", STRING),  # LoRA adapter name ("" = base model)
    )


class GenerateReply(Message):
    FIELDS = (
        Field(1, "text", STRING),
        Field(2, "tokens", INT32),
        Field(3, "ttft_ms", DOUBLE),
        Field(4, "tokens_per_sec", DOUBLE),
        Field(5, "truncated", BOOL),
        Field(6, "finish_reason", STRING),  # "stop" | "length"
        Field(7, "token_logprobs", DOUBLE, repeated=True),  # per generated token
    )


class TokenChunk(Message):
    FIELDS = (
        Field(1, "token", INT32),
        Field(2, "text", STRING),  # stop-trimmed deltas: they concatenate to the cut output
        Field(3, "done", BOOL),  # the final chunk carries totals instead of a token
        Field(4, "tokens", INT32),
        Field(5, "ttft_ms", DOUBLE),
        Field(6, "finish_reason", STRING),  # final chunk: "stop" | "length"
    )


class EmbedRequest(Message):
    FIELDS = (Field(1, "text", STRING),)


class EmbedReply(Message):
    FIELDS = (Field(1, "embedding", FLOAT, repeated=True),)


class ClassifyRequest(Message):
    FIELDS = (
        Field(1, "image", FLOAT, repeated=True),  # flattened row-major
        Field(2, "shape", INT32, repeated=True),  # e.g. [64, 64, 3]
    )


class ClassifyReply(Message):
    FIELDS = (
        Field(1, "label", INT32),
        Field(2, "logits", FLOAT, repeated=True),
    )


class HealthRequest(Message):
    FIELDS = ()


class HealthReply(Message):
    FIELDS = (
        Field(1, "status", STRING),  # "UP" | "DOWN" | "DEGRADED"
        Field(2, "details_json", STRING),  # JSON-encoded health detail map
    )


MESSAGES = (GenerateRequest, GenerateReply, TokenChunk, EmbedRequest, EmbedReply,
            ClassifyRequest, ClassifyReply, HealthRequest, HealthReply)
