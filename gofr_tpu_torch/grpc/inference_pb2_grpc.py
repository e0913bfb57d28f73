"""Stubs for ``gofr.tpu.v1.Inference`` (``gofr_tpu/grpc/proto/inference.proto``).

The port's copy of ``gofr_tpu/grpc/inference_pb2_grpc.py``, in the layout
``grpc_tools.protoc`` emits (Stub / Servicer / add_*_to_server), on the
port's channel and server:

    channel = channel.insecure_channel(addr)
    stub = inference_pb2_grpc.InferenceStub(channel)
    reply = stub.Generate(inference_pb2.GenerateRequest(prompt="hi"))
"""

from __future__ import annotations

from gofr_tpu_torch.grpc import inference_pb2
from gofr_tpu_torch.grpc.server import (
    StatusCode,
    method_handlers_generic_handler,
    unary_stream_rpc_method_handler,
    unary_unary_rpc_method_handler,
)

_SERVICE = "gofr.tpu.v1.Inference"


class InferenceStub:
    """Client stub; same surface as grpc_tools-generated code."""

    def __init__(self, channel) -> None:
        self.Generate = channel.unary_unary(
            f"/{_SERVICE}/Generate",
            request_serializer=inference_pb2.GenerateRequest.SerializeToString,
            response_deserializer=inference_pb2.GenerateReply.FromString,
        )
        self.GenerateStream = channel.unary_stream(
            f"/{_SERVICE}/GenerateStream",
            request_serializer=inference_pb2.GenerateRequest.SerializeToString,
            response_deserializer=inference_pb2.TokenChunk.FromString,
        )
        self.Embed = channel.unary_unary(
            f"/{_SERVICE}/Embed",
            request_serializer=inference_pb2.EmbedRequest.SerializeToString,
            response_deserializer=inference_pb2.EmbedReply.FromString,
        )
        self.Classify = channel.unary_unary(
            f"/{_SERVICE}/Classify",
            request_serializer=inference_pb2.ClassifyRequest.SerializeToString,
            response_deserializer=inference_pb2.ClassifyReply.FromString,
        )
        self.Health = channel.unary_unary(
            f"/{_SERVICE}/Health",
            request_serializer=inference_pb2.HealthRequest.SerializeToString,
            response_deserializer=inference_pb2.HealthReply.FromString,
        )


class InferenceServicer:
    """Service base class; override the methods you implement."""

    async def Generate(self, request, context):
        await context.abort(StatusCode.UNIMPLEMENTED, "Generate")

    async def GenerateStream(self, request, context):
        await context.abort(StatusCode.UNIMPLEMENTED, "GenerateStream")
        yield  # pragma: no cover — makes this an async generator

    async def Embed(self, request, context):
        await context.abort(StatusCode.UNIMPLEMENTED, "Embed")

    async def Classify(self, request, context):
        await context.abort(StatusCode.UNIMPLEMENTED, "Classify")

    async def Health(self, request, context):
        await context.abort(StatusCode.UNIMPLEMENTED, "Health")


def add_InferenceServicer_to_server(servicer, server) -> None:
    rpc_method_handlers = {
        "Generate": unary_unary_rpc_method_handler(
            servicer.Generate,
            request_deserializer=inference_pb2.GenerateRequest.FromString,
            response_serializer=inference_pb2.GenerateReply.SerializeToString,
        ),
        "GenerateStream": unary_stream_rpc_method_handler(
            servicer.GenerateStream,
            request_deserializer=inference_pb2.GenerateRequest.FromString,
            response_serializer=inference_pb2.TokenChunk.SerializeToString,
        ),
        "Embed": unary_unary_rpc_method_handler(
            servicer.Embed,
            request_deserializer=inference_pb2.EmbedRequest.FromString,
            response_serializer=inference_pb2.EmbedReply.SerializeToString,
        ),
        "Classify": unary_unary_rpc_method_handler(
            servicer.Classify,
            request_deserializer=inference_pb2.ClassifyRequest.FromString,
            response_serializer=inference_pb2.ClassifyReply.SerializeToString,
        ),
        "Health": unary_unary_rpc_method_handler(
            servicer.Health,
            request_deserializer=inference_pb2.HealthRequest.FromString,
            response_serializer=inference_pb2.HealthReply.SerializeToString,
        ),
    }
    generic_handler = method_handlers_generic_handler(
        _SERVICE, rpc_method_handlers
    )
    server.add_generic_rpc_handlers((generic_handler,))
