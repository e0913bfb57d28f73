"""Byte-level BPE tokenizer: native C++ core with a pure-Python fallback —
the port's copy of ``gofr_tpu/serving/native_tokenizer.py``.

The serving engine's only CPU-bound ingress work is prompt encoding; the
C++ core (``gofr_tpu_torch/native/bpe_tokenizer.cpp``, C ABI via ctypes)
runs it off the GIL. The pure-Python :class:`PyBPE` implements the
identical greedy lowest-rank-first merge and doubles as the test oracle;
:func:`load_bpe` prefers the native core and falls back when no compiler
is available.

The core is built with ``g++ -O2 -shared -fPIC`` into the port's build
directory (``gofr_tpu_torch/_build/``, or ``TPU_COMPILE_CACHE_DIR``
through ``build_cache``) under a name that hashes the source and flags,
so a later process on the same tree loads it without compiling. The
compile writes a temporary file that ``os.replace`` moves into place:
several processes may build at once (a lock only covers this one).

Vocab/merges file formats are hex-per-line (see :func:`write_bpe_files`),
chosen so the C++ side needs no JSON/unicode handling.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Any, Optional, Sequence

from gofr_tpu_torch import build_cache
from gofr_tpu_torch.analysis import lockcheck

_SRC = Path(__file__).resolve().parents[1] / "native" / "bpe_tokenizer.cpp"
_FLAGS = ["-O2", "-shared", "-fPIC"]
_build_lock = lockcheck.make_lock("native_tokenizer._build_lock")
#: What the last :func:`build_native` call did in this process: the
#: library's path, whether it ran g++ (False: the hashed library was
#: there already) and its seconds.
last_build: dict[str, Any] = {}


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return build_cache.build_dir() / f"libbpe_{h.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> Optional[str]:
    """Compile the C++ core once (g++ -O2 -shared); None if unavailable."""
    with _build_lock:
        t0 = time.perf_counter()
        if not _SRC.exists():
            return None
        so = _so_path()
        if not force and so.exists():
            last_build.update(path=str(so), compiled=False,
                              seconds=time.perf_counter() - t0)
            return str(so)
        try:
            so.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
            os.close(fd)
            try:
                # Single-flight within the process by the lock held across
                # the compile; across processes, the os.replace below makes
                # the last finisher's identical library win atomically.
                subprocess.run(
                    ["g++", *_FLAGS, "-o", tmp, str(_SRC)],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        except (OSError, subprocess.SubprocessError):
            return None
        last_build.update(path=str(so), compiled=True,
                          seconds=time.perf_counter() - t0)
        return str(so)


def write_bpe_files(
    vocab: Sequence[bytes], merges: Sequence[tuple[bytes, bytes]], directory: str
) -> tuple[str, str]:
    """Write hex-per-line vocab/merges files both cores load."""
    os.makedirs(directory, exist_ok=True)
    vocab_path = os.path.join(directory, "vocab.hex")
    merges_path = os.path.join(directory, "merges.hex")
    with open(vocab_path, "w") as fp:
        for tok in vocab:
            fp.write(tok.hex() + "\n")
    with open(merges_path, "w") as fp:
        for a, b in merges:
            fp.write(f"{a.hex()} {b.hex()}\n")
    return vocab_path, merges_path


def byte_vocab_with_merges(
    merges: Sequence[tuple[bytes, bytes]], specials: int = 3
) -> list[bytes]:
    """Standard byte-level vocab: 256 single bytes, then one token per merge
    (its concatenation), then ``specials`` reserved ids (BOS/EOS/PAD)."""
    vocab = [bytes([i]) for i in range(256)]
    vocab += [a + b for a, b in merges]
    vocab += [f"<special{i}>".encode() for i in range(specials)]
    return vocab


class PyBPE:
    """Pure-Python reference implementation (and no-compiler fallback)."""

    def __init__(self, vocab_path: str, merges_path: str) -> None:
        self.id_to_token: list[bytes] = []
        self.vocab: dict[bytes, int] = {}
        with open(vocab_path) as fp:
            for i, line in enumerate(fp):
                tok = bytes.fromhex(line.strip())
                self.id_to_token.append(tok)
                self.vocab[tok] = i
        self.merge_rank: dict[tuple[bytes, bytes], int] = {}
        if os.path.exists(merges_path):
            with open(merges_path) as fp:
                for rank, line in enumerate(fp):
                    a, _, b = line.strip().partition(" ")
                    self.merge_rank[(bytes.fromhex(a), bytes.fromhex(b))] = rank

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_token)

    def encode_bytes(self, data: bytes) -> list[int]:
        symbols = [bytes([b]) for b in data]
        while len(symbols) > 1:
            best_rank, best_i = None, -1
            for i in range(len(symbols) - 1):
                rank = self.merge_rank.get((symbols[i], symbols[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_rank is None:
                break
            symbols[best_i : best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        ids: list[int] = []
        for s in symbols:
            if s in self.vocab:
                ids.append(self.vocab[s])
            else:
                ids.extend(self.vocab.get(bytes([c]), 0) for c in s)
        return ids

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        return b"".join(
            self.id_to_token[i] for i in ids if 0 <= i < len(self.id_to_token)
        )


class NativeBPE:
    """ctypes binding over the C++ core; API-identical to :class:`PyBPE`."""

    def __init__(self, vocab_path: str, merges_path: str, so_path: str) -> None:
        lib = ctypes.CDLL(so_path)
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_vocab_size.restype = ctypes.c_int32
        lib.bpe_vocab_size.argtypes = [ctypes.c_void_p]
        lib.bpe_encode.restype = ctypes.c_int32
        lib.bpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.bpe_decode.restype = ctypes.c_int32
        lib.bpe_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32,
        ]
        self._lib = lib
        self._h = lib.bpe_create(vocab_path.encode(), merges_path.encode())
        if not self._h:
            raise OSError(f"bpe_create failed for {vocab_path}")

    @property
    def vocab_size(self) -> int:
        return int(self._lib.bpe_vocab_size(self._h))

    def encode_bytes(self, data: bytes) -> list[int]:
        cap = max(len(data), 1)
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.bpe_encode(self._h, data, len(data), buf, cap)
        if n < -1:  # buffer too small (cannot happen: merges only shrink)
            cap = -n
            buf = (ctypes.c_int32 * cap)()
            n = self._lib.bpe_encode(self._h, data, len(data), buf, cap)
        if n < 0:
            raise OSError("bpe_encode failed")
        return list(buf[:n])

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        arr = (ctypes.c_int32 * len(ids))(*ids)
        cap = 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.bpe_decode(self._h, arr, len(ids), buf, cap)
            if n >= 0:
                return buf.raw[:n]
            if n == -1:
                raise OSError("bpe_decode failed")
            cap = -n

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.bpe_free(h)
            self._h = None


class BPETokenizer:
    """Serving-engine tokenizer over either core. Special ids default to
    the last three vocab slots (the layout :func:`byte_vocab_with_merges`
    produces)."""

    def __init__(
        self,
        core,
        bos_id: Optional[int] = None,
        eos_id: Optional[int] = None,
        pad_id: Optional[int] = None,
    ) -> None:
        self._core = core
        size = core.vocab_size
        self.bos_id = bos_id if bos_id is not None else size - 3
        self.eos_id = eos_id if eos_id is not None else size - 2
        self.pad_id = pad_id if pad_id is not None else size - 1
        self.vocab_size = size

    @property
    def is_native(self) -> bool:
        return isinstance(self._core, NativeBPE)

    def encode(self, text: str) -> list[int]:
        return [self.bos_id] + self._core.encode_bytes(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        specials = {self.bos_id, self.eos_id, self.pad_id}
        return self._core.decode_bytes(
            [i for i in ids if i not in specials]
        ).decode("utf-8", "replace")


def load_core(vocab_path: str, merges_path: str, prefer_native: bool = True):
    """The native core over the files, else :class:`PyBPE`."""
    if prefer_native:
        so = build_native()
        if so is not None:
            try:
                return NativeBPE(vocab_path, merges_path, so)
            except OSError:
                pass
    return PyBPE(vocab_path, merges_path)


def load_bpe(
    vocab_path: str, merges_path: str, prefer_native: bool = True, **kw
) -> BPETokenizer:
    """Load a BPE tokenizer, native core first, pure Python otherwise."""
    return BPETokenizer(load_core(vocab_path, merges_path, prefer_native), **kw)
