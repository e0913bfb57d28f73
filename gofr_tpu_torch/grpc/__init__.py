"""gRPC server tier (reference: ``pkg/gofr/grpc.go`` + ``grpc/log.go``).

The port's copy of ``gofr_tpu/grpc``: a gRPC server with recovery and
logging interceptors, started only when services are registered
(``gofr.go:150-157``), and the built-in inference service in two flavors
sharing :9000:

* **typed protobuf** ``gofr.tpu.v1.Inference`` — the production contract
  (``gofr_tpu/grpc/proto/inference.proto``), interoperable with any stock
  gRPC client;
* **JSON-over-bytes** ``gofr.tpu.Inference`` — codegen-free exploration
  surface.

The reference stands on ``grpcio`` and ``protobuf``; the port speaks the
protocol on the standard library: HTTP/2 framing (``h2.py``, RFC 9113),
HPACK (``hpack.py``, RFC 7541), the gRPC protocol (``server.py``,
``channel.py``) and the proto3 wire format (``protowire.py``,
``inference_pb2.py``).
"""

from gofr_tpu_torch.grpc.channel import Channel, RpcError, insecure_channel
from gofr_tpu_torch.grpc.inference import InferenceClient, add_inference_service
from gofr_tpu_torch.grpc.inference_typed import (
    TypedInferenceServicer,
    add_typed_inference_service,
)
from gofr_tpu_torch.grpc.server import GRPCServer, StatusCode, json_method_handlers

__all__ = [
    "GRPCServer",
    "StatusCode",
    "json_method_handlers",
    "add_inference_service",
    "InferenceClient",
    "TypedInferenceServicer",
    "add_typed_inference_service",
    "Channel",
    "RpcError",
    "insecure_channel",
]
