"""HPACK, header compression for HTTP/2 (RFC 7541).

The decoder takes everything a peer may send: indexed fields, literals
with incremental, without and never indexing, dynamic table size updates
at the start of a block, integers and string literals with or without
Huffman coding, and a dynamic table that evicts oldest-first. The
encoder keeps no dynamic table: a field that matches the static table
whole goes as an index, the rest as literals without indexing (an
indexed name where the static table has it), each string Huffman-coded
where that is shorter. It opens its first block, and the first after a
change of the peer's ``SETTINGS_HEADER_TABLE_SIZE``, with a size update
to 0, which every setting allows.

The Huffman code is RFC 7541 Appendix B. It is canonical: the codes of
one length are consecutive in symbol order, each length's first code
follows the last code of the length below, shifted. So the table below
holds each symbol's code length, and the codes follow from it.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable

DEFAULT_TABLE_SIZE = 4096
ENTRY_OVERHEAD = 32  # RFC 7541 §4.1
# The largest header list a peer may send, sized as RFC 7541 §4.1 sizes
# an entry: four times grpc's hard metadata limit of 16 KiB.
MAX_HEADER_LIST = 1 << 16

STATIC_TABLE = (
    (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
    (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"),
    (":status", "200"), (":status", "204"), (":status", "206"), (":status", "304"),
    (":status", "400"), (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""), ("accept-ranges", ""),
    ("accept", ""), ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""), ("cookie", ""),
    ("date", ""), ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""), ("location", ""),
    ("max-forwards", ""), ("proxy-authenticate", ""), ("proxy-authorization", ""),
    ("range", ""), ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""), ("transfer-encoding", ""),
    ("user-agent", ""), ("vary", ""), ("via", ""), ("www-authenticate", ""),
)
_STATIC_FIELD = {f: i + 1 for i, f in reversed(list(enumerate(STATIC_TABLE)))}
_STATIC_NAME = {f[0]: i + 1 for i, f in reversed(list(enumerate(STATIC_TABLE)))}

# Code length of each symbol, 0x00-0xff then EOS (256).
HUFFMAN_LENGTHS = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,  # 0x00-0x0f
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,  # 0x10-0x1f
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,  # 0x20-0x2f
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,  # 0x30-0x3f
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,  # 0x40-0x4f
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,  # 0x50-0x5f
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,  # 0x60-0x6f
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,  # 0x70-0x7f
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,  # 0x80-0x8f
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,  # 0x90-0x9f
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,  # 0xa0-0xaf
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,  # 0xb0-0xbf
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,  # 0xc0-0xcf
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,  # 0xd0-0xdf
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,  # 0xe0-0xef
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,  # 0xf0-0xff
    30,  # EOS
)
EOS = 256


def _canonical_codes(lengths: tuple) -> tuple:
    codes = [0] * len(lengths)
    code = prev = 0
    for i, sym in enumerate(sorted(range(len(lengths)), key=lambda s: (lengths[s], s))):
        if i:
            code = (code + 1) << (lengths[sym] - prev)
        prev = lengths[sym]
        codes[sym] = code
    return tuple(codes)


HUFFMAN_CODES = _canonical_codes(HUFFMAN_LENGTHS)

# Canonical decoding: per length, the first code and where its symbols
# start in the symbols sorted by (length, symbol).
_MAX_LEN = max(HUFFMAN_LENGTHS)
_SORTED = sorted(range(257), key=lambda s: (HUFFMAN_LENGTHS[s], s))
_FIRST = [0] * (_MAX_LEN + 1)
_COUNT = [0] * (_MAX_LEN + 1)
_OFFSET = [0] * (_MAX_LEN + 1)
for _i, _s in enumerate(_SORTED):
    _n = HUFFMAN_LENGTHS[_s]
    if not _COUNT[_n]:
        _FIRST[_n], _OFFSET[_n] = HUFFMAN_CODES[_s], _i
    _COUNT[_n] += 1


class HPACKError(Exception):
    """A header block the decoder cannot accept (a COMPRESSION_ERROR)."""


def huffman_encode(data: bytes) -> bytes:
    acc = nbits = 0
    out = bytearray()
    for b in data:
        acc = (acc << HUFFMAN_LENGTHS[b]) | HUFFMAN_CODES[b]
        nbits += HUFFMAN_LENGTHS[b]
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1
    if nbits:  # pad with the most significant bits of EOS (all ones)
        out.append(((acc << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


def huffman_length(data: bytes) -> int:
    return (sum(HUFFMAN_LENGTHS[b] for b in data) + 7) // 8


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code = n = 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            n += 1
            if _COUNT[n] and code - _FIRST[n] < _COUNT[n] and code >= _FIRST[n]:
                sym = _SORTED[_OFFSET[n] + code - _FIRST[n]]
                if sym == EOS:
                    raise HPACKError("EOS in a Huffman-coded string")
                out.append(sym)
                code = n = 0
            elif n == _MAX_LEN:
                raise HPACKError("invalid Huffman code")
    if n > 7 or code != (1 << n) - 1:
        raise HPACKError("Huffman padding is not a prefix of EOS")
    return bytes(out)


def encode_int(value: int, prefix: int, first: int = 0) -> bytes:
    """An integer on an N-bit prefix (RFC 7541 §5.1); ``first`` holds
    the bits of the first byte above the prefix."""
    limit = (1 << prefix) - 1
    if value < limit:
        return bytes([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data: bytes, i: int, prefix: int) -> tuple[int, int]:
    if i >= len(data):
        raise HPACKError("truncated integer")
    limit = (1 << prefix) - 1
    value = data[i] & limit
    i += 1
    if value < limit:
        return value, i
    shift = 0
    while True:
        if i >= len(data):
            raise HPACKError("truncated integer")
        b = data[i]
        i += 1
        value += (b & 0x7F) << shift
        if not b & 0x80:
            return value, i
        shift += 7
        if shift > 28:
            raise HPACKError("integer overflow")


def encode_str(raw: bytes) -> bytes:
    if huffman_length(raw) < len(raw):
        coded = huffman_encode(raw)
        return encode_int(len(coded), 7, 0x80) + coded
    return encode_int(len(raw), 7) + raw


def decode_str(data: bytes, i: int) -> tuple[bytes, int]:
    if i >= len(data):
        raise HPACKError("truncated string")
    huffman = data[i] & 0x80
    n, i = decode_int(data, i, 7)
    if i + n > len(data):
        raise HPACKError("truncated string")
    raw = data[i:i + n]
    return (huffman_decode(raw) if huffman else bytes(raw)), i + n


def _text(raw: bytes) -> str:
    return raw.decode("utf-8", "surrogateescape")


def _raw(text: str | bytes) -> bytes:
    return text if isinstance(text, bytes) else text.encode("utf-8", "surrogateescape")


class Encoder:
    def __init__(self) -> None:
        self._size_update = True

    def peer_table_size_changed(self) -> None:
        self._size_update = True

    def encode(self, headers: Iterable[tuple]) -> bytes:
        out = bytearray()
        if self._size_update:
            out += encode_int(0, 5, 0x20)
            self._size_update = False
        for name, value in headers:
            name, value = _text(_raw(name)).lower(), _text(_raw(value))
            index = _STATIC_FIELD.get((name, value))
            if index is not None:
                out += encode_int(index, 7, 0x80)
                continue
            index = _STATIC_NAME.get(name)
            if index is not None:
                out += encode_int(index, 4)
            else:
                out += b"\x00" + encode_str(_raw(name))
            out += encode_str(_raw(value))
        return bytes(out)


class HeaderListTooLarge(HPACKError):
    """A header list past :data:`MAX_HEADER_LIST`: indexed fields can
    expand a small block far past its own size."""


class Decoder:
    def __init__(self, max_table_size: int = DEFAULT_TABLE_SIZE,
                 max_list_size: int = MAX_HEADER_LIST) -> None:
        self.settings_max = max_table_size  # our SETTINGS_HEADER_TABLE_SIZE
        self.max_list_size = max_list_size
        self.max_size = max_table_size  # the limit the peer's updates set
        self.table: deque = deque()  # newest first
        self.size = 0

    def _evict(self) -> None:
        while self.size > self.max_size:
            name, value = self.table.pop()
            self.size -= len(name) + len(value) + ENTRY_OVERHEAD

    def _add(self, name: bytes, value: bytes) -> None:
        self.table.appendleft((name, value))
        self.size += len(name) + len(value) + ENTRY_OVERHEAD
        self._evict()  # an entry larger than the table empties it

    def _get(self, index: int) -> tuple[bytes, bytes]:
        if index == 0:
            raise HPACKError("index 0")
        if index <= len(STATIC_TABLE):
            name, value = STATIC_TABLE[index - 1]
            return name.encode(), value.encode()
        index -= len(STATIC_TABLE) + 1
        if index >= len(self.table):
            raise HPACKError("index past the dynamic table")
        return self.table[index]

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        headers: list[tuple[str, str]] = []
        i = total = 0
        while i < len(block):
            b = block[i]
            if b & 0x80:  # indexed field
                index, i = decode_int(block, i, 7)
                name, value = self._get(index)
            elif b & 0xE0 == 0x20:  # dynamic table size update
                if headers:
                    raise HPACKError("table size update after a field")
                size, i = decode_int(block, i, 5)
                if size > self.settings_max:
                    raise HPACKError("table size update above the setting")
                self.max_size = size
                self._evict()
                continue
            else:
                prefix, incremental = (6, True) if b & 0xC0 == 0x40 else (4, False)
                index, i = decode_int(block, i, prefix)
                if index:
                    name = self._get(index)[0]
                else:
                    name, i = decode_str(block, i)
                value, i = decode_str(block, i)
                if incremental:
                    self._add(name, value)
            total += len(name) + len(value) + ENTRY_OVERHEAD
            if total > self.max_list_size:
                raise HeaderListTooLarge(f"header list past {self.max_list_size} bytes")
            headers.append((_text(name), _text(value)))
        return headers
