"""The proto3 wire format for the port's messages (the part of
``google.protobuf`` that ``gofr_tpu/grpc/inference_pb2.py`` gets from the
library).

A message class lists its fields as :class:`Field` entries; the base
class gives it keyword construction, attribute access,
``SerializeToString`` and ``FromString``, with protobuf's rules:

* scalars hold proto3's implicit presence: a field equal to its default
  is not written (floats and doubles by bit pattern, so ``-0.0`` is);
* ``int32`` is a varint, negatives as ten bytes of two's complement;
  ``bool`` a varint; ``float`` fixed32 (values round to float32 on
  assignment, as protobuf's do); ``double`` fixed64; ``string`` UTF-8;
* repeated scalars are written packed and parsed packed or unpacked;
  repeated strings one record each;
* fields are written in field-number order; on parse the last record of
  a scalar wins, and unknown fields (groups included) are skipped.
"""

from __future__ import annotations

import struct
from typing import Any, Iterable

import numpy as np

INT32, BOOL, FLOAT, DOUBLE, STRING = "int32", "bool", "float", "double", "string"

_VARINT, _FIXED64, _LEN, _SGROUP, _EGROUP, _FIXED32 = 0, 1, 2, 3, 4, 5
_WIRE = {INT32: _VARINT, BOOL: _VARINT, FLOAT: _FIXED32, DOUBLE: _FIXED64, STRING: _LEN}
_DEFAULT = {INT32: 0, BOOL: False, FLOAT: 0.0, DOUBLE: 0.0, STRING: ""}
_NP = {FLOAT: "<f4", DOUBLE: "<f8"}
_ST = {FLOAT: "<f", DOUBLE: "<d"}
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


class Field:
    __slots__ = ("number", "name", "kind", "repeated")

    def __init__(self, number: int, name: str, kind: str, repeated: bool = False) -> None:
        self.number, self.name, self.kind, self.repeated = number, name, kind, repeated


def _check(kind: str, name: str, value: Any) -> Any:
    """Protobuf's assignment checks: a value of the field's type, floats
    rounded to float32."""
    if kind == STRING:
        if isinstance(value, bytes):
            value = value.decode("utf-8")
        if not isinstance(value, str):
            raise TypeError(f"{name}: expected str, got {type(value).__name__}")
        return value
    if kind == BOOL:
        if not isinstance(value, (bool, int, np.bool_, np.integer)):
            raise TypeError(f"{name}: expected bool, got {type(value).__name__}")
        return bool(value)
    if kind == INT32:
        if isinstance(value, (float, np.floating)) or not isinstance(value, (int, np.integer)):
            raise TypeError(f"{name}: expected int, got {type(value).__name__}")
        value = int(value)
        if not _INT32_MIN <= value <= _INT32_MAX:
            raise ValueError(f"{name}: value out of range: {value}")
        return value
    if not isinstance(value, (int, float, np.integer, np.floating)) or isinstance(value, bool):
        raise TypeError(f"{name}: expected float, got {type(value).__name__}")
    if kind == FLOAT:
        with np.errstate(over="ignore"):
            return float(np.float32(value))
    return float(value)


def _repeated(kind: str, name: str, values: Iterable) -> list:
    if kind in _NP and isinstance(values, np.ndarray):
        with np.errstate(over="ignore"):
            return np.asarray(values, dtype=_NP[kind]).ravel().tolist()
    return [_check(kind, name, v) for v in values]


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if i >= len(data):
            raise DecodeError("truncated varint")
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _int32(n: int) -> int:
    n &= 0xFFFFFFFF
    return n - (1 << 32) if n & 0x80000000 else n


def _is_default(kind: str, value: Any) -> bool:
    if kind in _NP:
        return not any(struct.pack(_ST[kind], value))
    return value == _DEFAULT[kind]


def _scalar_bytes(kind: str, value: Any) -> bytes:
    if kind == INT32:
        return _varint(value)
    if kind == BOOL:
        return b"\x01" if value else b"\x00"
    return struct.pack(_ST[kind], value)


def _skip(data: bytes, i: int, wire: int, number: int) -> int:
    if wire == _VARINT:
        return _read_varint(data, i)[1]
    if wire == _FIXED64:
        i += 8
    elif wire == _FIXED32:
        i += 4
    elif wire == _LEN:
        n, i = _read_varint(data, i)
        i += n
    elif wire == _SGROUP:
        while True:
            key, i = _read_varint(data, i)
            if key & 7 == _EGROUP:
                if key >> 3 != number:
                    raise DecodeError("mismatched end of group")
                return i
            i = _skip(data, i, key & 7, key >> 3)
    else:
        raise DecodeError(f"invalid wire type {wire}")
    if i > len(data):
        raise DecodeError("truncated field")
    return i


class Message:
    """Base of the generated-style message classes."""

    FIELDS: tuple = ()
    _BY_NAME: dict = {}
    _BY_NUMBER: dict = {}

    def __init_subclass__(cls, **kw: Any) -> None:
        super().__init_subclass__(**kw)
        cls.FIELDS = tuple(sorted(cls.FIELDS, key=lambda f: f.number))
        cls._BY_NAME = {f.name: f for f in cls.FIELDS}
        cls._BY_NUMBER = {f.number: f for f in cls.FIELDS}

    def __init__(self, **kw: Any) -> None:
        for f in self.FIELDS:
            object.__setattr__(self, f.name, [] if f.repeated else _DEFAULT[f.kind])
        for name, value in kw.items():
            if name not in self._BY_NAME:
                raise ValueError(f'Protocol message {type(self).__name__} has no "{name}" field.')
            if value is not None:
                setattr(self, name, value)

    def __setattr__(self, name: str, value: Any) -> None:
        f = self._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        value = _repeated(f.kind, name, value) if f.repeated else _check(f.kind, name, value)
        object.__setattr__(self, name, value)

    def SerializeToString(self) -> bytes:
        out = bytearray()
        for f in self.FIELDS:
            value = getattr(self, f.name)
            if not f.repeated:
                if not _is_default(f.kind, value):
                    out += _varint(f.number << 3 | _WIRE[f.kind])
                    if f.kind == STRING:
                        raw = value.encode("utf-8")
                        out += _varint(len(raw)) + raw
                    else:
                        out += _scalar_bytes(f.kind, value)
            elif value and f.kind == STRING:
                for s in value:
                    raw = s.encode("utf-8")
                    out += _varint(f.number << 3 | _LEN) + _varint(len(raw)) + raw
            elif value:
                if f.kind in _NP:
                    packed = np.asarray(value, dtype=_NP[f.kind]).tobytes()
                else:
                    packed = b"".join(_scalar_bytes(f.kind, v) for v in value)
                out += _varint(f.number << 3 | _LEN) + _varint(len(packed)) + packed
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "Message":
        msg = cls()
        values = {f.name: list() for f in cls.FIELDS if f.repeated}
        data = bytes(data)
        i = 0
        while i < len(data):
            key, i = _read_varint(data, i)
            number, wire = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            f = cls._BY_NUMBER.get(number)
            if f is None:
                i = _skip(data, i, wire, number)
                continue
            if f.repeated and wire == _LEN and f.kind != STRING:
                n, i = _read_varint(data, i)
                end = i + n
                if end > len(data):
                    raise DecodeError("truncated packed field")
                if f.kind in _NP:
                    width = 4 if f.kind == FLOAT else 8
                    if n % width:
                        raise DecodeError("packed field of a partial element")
                    values[f.name].extend(np.frombuffer(data[i:end], dtype=_NP[f.kind]).tolist())
                else:
                    while i < end:
                        v, i = _read_varint(data, i)
                        values[f.name].append(_int32(v) if f.kind == INT32 else bool(v))
                    if i != end:
                        raise DecodeError("packed varints overrun their length")
                i = end
                continue
            if wire != _WIRE[f.kind]:
                i = _skip(data, i, wire, number)
                continue
            if f.kind == STRING:
                n, i = _read_varint(data, i)
                if i + n > len(data):
                    raise DecodeError("truncated string")
                try:
                    value = data[i:i + n].decode("utf-8")
                except UnicodeDecodeError as exc:
                    raise DecodeError(f"{f.name}: invalid UTF-8") from exc
                i += n
            elif wire == _VARINT:
                v, i = _read_varint(data, i)
                value = _int32(v) if f.kind == INT32 else bool(v)
            else:
                width = 4 if wire == _FIXED32 else 8
                if i + width > len(data):
                    raise DecodeError("truncated fixed field")
                value = struct.unpack_from(_ST[f.kind], data, i)[0]
                i += width
            if f.repeated:
                values[f.name].append(value)
            else:
                object.__setattr__(msg, f.name, value)
        for name, vals in values.items():
            object.__setattr__(msg, name, vals)
        return msg

    def __eq__(self, other: Any) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return all(getattr(self, f.name) == getattr(other, f.name) for f in self.FIELDS)

    def __repr__(self) -> str:
        parts = [f"{f.name}={getattr(self, f.name)!r}" for f in self.FIELDS
                 if getattr(self, f.name) not in ([], _DEFAULT[f.kind])]
        return f"{type(self).__name__}({', '.join(parts)})"
