"""Response passthrough types (reference ``pkg/gofr/http/response``).

Returning these from a handler bypasses the JSON ``{"data": ...}`` envelope:

* :class:`Raw` — serialize the wrapped value as bare JSON
  (reference ``http/response/raw.go:3-5``);
* :class:`File` — raw bytes with a content type
  (reference ``http/response/file.go:3-6``);
* :class:`Redirect` — 302 Location redirect.

The port's copy of ``gofr_tpu/http/response.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class Raw:
    data: Any
    # Override the method-derived success status (e.g. OpenAI-compat
    # POSTs answer 200, not the framework's POST→201 default).
    status: Any = None


@dataclass
class File:
    content: bytes
    content_type: str = "application/octet-stream"


@dataclass
class Redirect:
    url: str
    status: int = 302


@dataclass
class Stream:
    """Chunked streaming response (SSE by default).

    ``chunks``: an async iterator of ``bytes`` (or ``str``, encoded
    utf-8). The server sends ``Transfer-Encoding: chunked`` and writes
    each chunk as it arrives — token streaming over plain HTTP.
    """

    chunks: Any
    content_type: str = "text/event-stream"
    headers: dict[str, str] = field(default_factory=dict)


@dataclass
class TypedResponse:
    """Full-control response: data plus extra headers/metadata."""

    data: Any
    headers: dict[str, str] = field(default_factory=dict)
    metadata: dict[str, Any] = field(default_factory=dict)
