"""HTTP Responder (reference ``pkg/gofr/http/responder.go:12-80``).

Maps a handler's ``(result, error)`` into the wire response:

* success → ``{"data": <result>}`` JSON envelope;
* error → ``{"error": {"message": ...}}`` with status from the error type
  (``status_code`` attribute honored, reference ``responder.go:53-74``);
* status from method when no error: POST → 201, DELETE → 204 and
  everything else → 200 (reference ``responder.go:27-41``);
* :class:`Raw` / :class:`File` / :class:`Redirect` bypass the envelope
  (reference ``responder.go:24-26`` + ``response`` package).

The port's copy of ``gofr_tpu/http/responder.py``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import numpy as _np

from gofr_tpu_torch.http.proto import Response
from gofr_tpu_torch.http.response import File, Raw, Redirect, Stream, TypedResponse


def _default(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    if isinstance(obj, _np.ndarray):
        return obj.tolist()
    if isinstance(obj, (_np.integer,)):
        return int(obj)
    if isinstance(obj, (_np.floating,)):
        return float(obj)
    if isinstance(obj, bytes):
        return obj.decode("utf-8", "replace")
    if hasattr(obj, "tolist"):  # torch tensors
        return obj.tolist()
    if hasattr(obj, "to_dict"):
        return obj.to_dict()
    return str(obj)


def to_json_bytes(payload: Any) -> bytes:
    return json.dumps(payload, default=_default).encode("utf-8")


class Responder:
    def __init__(self, method: str = "GET") -> None:
        self._method = method

    def respond(self, result: Any, error: Optional[BaseException]) -> Response:
        if error is not None:
            status = self.status_from_error(error)
            headers = {"Content-Type": "application/json"}
            # Errors may carry wire headers (e.g. Retry-After on a shed
            # 429 — errors.ErrorTooManyRequests) so well-behaved clients
            # back off instead of hammering an overloaded engine.
            extra = getattr(error, "headers", None)
            if isinstance(extra, dict):
                headers.update({str(k): str(v) for k, v in extra.items()})
            return Response(
                status=status,
                headers=headers,
                body=to_json_bytes({"error": {"message": str(error) or "unknown error"}}),
            )

        if isinstance(result, Response):  # already wire-level
            return result
        if isinstance(result, Redirect):
            return Response(status=result.status, headers={"Location": result.url})
        if isinstance(result, File):
            return Response(
                status=200,
                headers={"Content-Type": result.content_type},
                body=result.content,
            )
        if isinstance(result, Raw):
            return Response(
                status=result.status or self._success_status(),
                headers={"Content-Type": "application/json"},
                body=to_json_bytes(result.data),
            )
        if isinstance(result, Stream):
            async def _encoded(chunks=result.chunks):
                async for chunk in chunks:
                    yield chunk.encode() if isinstance(chunk, str) else chunk

            return Response(
                status=200,
                headers={
                    "Content-Type": result.content_type,
                    "Cache-Control": "no-cache",
                    **result.headers,
                },
                body_stream=_encoded(),
            )
        if isinstance(result, TypedResponse):
            headers = {"Content-Type": "application/json", **result.headers}
            envelope: dict[str, Any] = {"data": result.data}
            if result.metadata:
                envelope["metadata"] = result.metadata
            return Response(
                status=self._success_status(),
                headers=headers,
                body=to_json_bytes(envelope),
            )

        status = self._success_status()
        body = b"" if status == 204 else to_json_bytes({"data": result})
        return Response(
            status=status, headers={"Content-Type": "application/json"}, body=body
        )

    def _success_status(self) -> int:
        # Reference responder.go:27-41.
        if self._method == "POST":
            return 201
        if self._method == "DELETE":
            return 204
        return 200

    @staticmethod
    def status_from_error(error: BaseException) -> int:
        status = getattr(error, "status_code", None)
        if callable(status):
            status = status()
        if isinstance(status, int):
            return status
        return 500
