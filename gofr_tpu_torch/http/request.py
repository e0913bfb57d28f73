"""Framework HTTP Request (reference ``pkg/gofr/http/request.go:28-121``).

Wraps the wire-level :class:`~gofr_tpu_torch.http.proto.RawRequest` with the
``gofr.Request`` capability set: query/path params, JSON + form +
multipart bind into dataclasses or dicts, hostname.

The port's copy of ``gofr_tpu/http/request.py``.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Optional
from urllib.parse import parse_qs, unquote, urlsplit

from gofr_tpu_torch.errors import ErrorInvalidParam
from gofr_tpu_torch.http.proto import RawRequest


@dataclasses.dataclass
class UploadedFile:
    """A bound multipart file part (role of ``file.Zip`` /
    ``*multipart.FileHeader`` in reference ``http/multipartFileBind.go``)."""

    filename: str
    content_type: str
    data: bytes


class Request:
    def __init__(self, raw: RawRequest) -> None:
        self._raw = raw
        split = urlsplit(raw.target)
        self.path = unquote(split.path) or "/"
        self._query = parse_qs(split.query, keep_blank_values=True)

    # -- identity --------------------------------------------------------

    @property
    def method(self) -> str:
        return self._raw.method

    @property
    def raw(self) -> RawRequest:
        return self._raw

    def host_name(self) -> str:
        """Scheme+host like reference ``http/request.go`` ``HostName``."""
        proto = self._raw.headers.get("x-forwarded-proto", "http")
        return f"{proto}://{self._raw.headers.get('host', '')}"

    def header(self, key: str) -> Optional[str]:
        return self._raw.headers.get(key.lower())

    @property
    def headers(self) -> dict[str, str]:
        return dict(self._raw.headers)

    # -- params ----------------------------------------------------------

    def param(self, key: str) -> str:
        """First query-string value for ``key`` ('' when absent)."""
        vals = self._query.get(key)
        return vals[0] if vals else ""

    def params(self, key: str) -> list[str]:
        """All values for ``key``, splitting comma-separated entries
        (reference ``http/request.go`` ``Params``)."""
        out: list[str] = []
        for v in self._query.get(key, []):
            out.extend(x for x in v.split(",") if x != "")
        return out

    def path_param(self, key: str) -> str:
        return self._raw.path_params.get(key, "")

    # -- body / bind -----------------------------------------------------

    @property
    def body(self) -> bytes:
        return self._raw.body

    def json(self) -> Any:
        try:
            return json.loads(self._raw.body or b"null")
        except json.JSONDecodeError as exc:
            raise ErrorInvalidParam(["body"]) from exc

    def bind(self, target: Any) -> Any:
        """Bind the request body into ``target``.

        * JSON bodies bind into a dataclass type/instance or dict
          (reference ``http/request.go`` ``Bind``);
        * ``multipart/form-data`` binds form fields by name and file parts
          as :class:`UploadedFile` (reference ``http/multipartFileBind.go``);
        * ``application/x-www-form-urlencoded`` binds form fields by name.
        """
        ctype = self._raw.headers.get("content-type", "application/json")
        if ctype.startswith("multipart/form-data"):
            fields, files = self._parse_multipart(ctype)
            merged: dict[str, Any] = {**fields, **files}
            return _fill(target, merged)
        if ctype.startswith("application/x-www-form-urlencoded"):
            form = {
                k: v[0]
                for k, v in parse_qs(
                    self._raw.body.decode("utf-8", "replace"), keep_blank_values=True
                ).items()
            }
            return _fill(target, form)
        data = self.json()
        if not isinstance(data, dict):
            raise ErrorInvalidParam(["body"])
        return _fill(target, data)

    def _parse_multipart(self, ctype: str):
        match = re.search(r'boundary="?([^";]+)"?', ctype)
        if not match:
            raise ErrorInvalidParam(["content-type boundary"])
        boundary = b"--" + match.group(1).encode()
        fields: dict[str, str] = {}
        files: dict[str, UploadedFile] = {}
        for part in self._raw.body.split(boundary)[1:]:
            # Strip exactly the delimiter CRLFs, not all leading/trailing
            # newline bytes — file DATA may legitimately end in newlines
            # (e.g. a JSONL upload) and must round-trip byte-exact.
            if part.startswith(b"\r\n"):
                part = part[2:]
            if part.endswith(b"\r\n"):
                part = part[:-2]
            if part.strip(b"\r\n \t") in (b"", b"--"):
                continue
            header_blob, _, content = part.partition(b"\r\n\r\n")
            headers: dict[str, str] = {}
            for line in header_blob.split(b"\r\n"):
                k, _, v = line.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            disp = headers.get("content-disposition", "")
            name_m = re.search(r'name="([^"]*)"', disp)
            if not name_m:
                continue
            name = name_m.group(1)
            file_m = re.search(r'filename="([^"]*)"', disp)
            if file_m:
                files[name] = UploadedFile(
                    filename=file_m.group(1),
                    content_type=headers.get("content-type", "application/octet-stream"),
                    data=content,
                )
            else:
                fields[name] = content.decode("utf-8", "replace")
        return fields, files


def _coerce(value: Any, typ: Any) -> Any:
    # `from __future__ import annotations` stringifies dataclass field types.
    if isinstance(typ, str):
        typ = {"int": int, "float": float, "bool": bool, "str": str}.get(typ, typ)
    try:
        if typ is int and not isinstance(value, bool):
            return int(value)
        if typ is float:
            return float(value)
        if typ is bool and isinstance(value, str):
            return value.lower() in ("true", "1", "yes", "on")
        if typ is str and not isinstance(value, str):
            return str(value)
    except (TypeError, ValueError):
        return value
    return value


def _fill(target: Any, data: dict[str, Any]) -> Any:
    """Populate ``target`` (dict, dataclass type, dataclass instance, or
    plain object) from ``data`` — the reflective walk the reference does in
    ``http/multipartFileBind.go:11-130``."""
    if isinstance(target, dict):
        target.update(data)
        return target
    if isinstance(target, type) and dataclasses.is_dataclass(target):
        kwargs = {}
        for f in dataclasses.fields(target):
            if f.name in data:
                kwargs[f.name] = _coerce(data[f.name], f.type)
        return target(**kwargs)
    if dataclasses.is_dataclass(target):
        for f in dataclasses.fields(target):
            if f.name in data:
                setattr(target, f.name, _coerce(data[f.name], f.type))
        return target
    for key, value in data.items():
        if hasattr(target, key):
            setattr(target, key, value)
    return target
