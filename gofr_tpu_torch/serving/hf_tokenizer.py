"""A reader for Hugging Face ``tokenizer.json`` files of byte-level BPE
tokenizers, in the standard library only — the port's counterpart of the
reference's ``AutoTokenizer`` branch of ``tokenizer_from_config`` (the
port may not import ``transformers`` or ``tokenizers``).

Scope: ``model.type == "BPE"`` over GPT-2's byte-level alphabet, the
tokenizers of the byte-level families the port serves:

* GPT-2 and GPT-NeoX/Pythia: the ``ByteLevel`` pre-tokenizer with its
  regex;
* Llama-3: ``Split`` with its pattern, then ``ByteLevel(use_regex=false)``,
  ``ignore_merges``, and a ``TemplateProcessing`` post-processor that
  adds BOS;
* Qwen2: an ``NFC`` normalizer, ``Split`` and ``ByteLevel``, no BOS.

The pipeline is HF's: the ``added_tokens`` are matched in the text first
(leftmost-longest; those with ``normalized: false`` on the raw text, the
others after the normalizer), the rest is normalized, pre-tokenized
(``Split`` with ``Isolated`` behavior, ``ByteLevel`` with or without its
regex), each piece is mapped through GPT-2's
``bytes_to_unicode`` and merged lowest rank first (a piece already in the
vocabulary is kept whole under ``ignore_merges``), and the post-processor
adds its special tokens. The merge loop itself runs in the native BPE
core (``native_tokenizer``) over the vocabulary and merges converted to
bytes, or in ``PyBPE`` without a compiler.

HF's patterns use Oniguruma's ``\\p{L}``, ``\\p{N}`` and ``\\s``; Python's
``re`` has no ``\\p{..}`` and a wider ``\\s``, so the patterns are
rewritten with explicit character classes built once a process from
``unicodedata`` (``\\s`` as Unicode White_Space).

``tokenizer_config.json`` gives the special tokens as ``transformers``
resolves them: the class's defaults (``PreTrainedTokenizerFast``,
``GPT2Tokenizer``, ``Qwen2Tokenizer``, ``GPTNeoXTokenizer``; the class
comes from ``tokenizer_class`` or ``config.json``'s ``model_type``), then
the config's ``bos_token``/``eos_token``/``pad_token``/``unk_token``
(an explicit ``null`` clears one), ``special_tokens_map.json`` when the
config has no ``added_tokens_decoder``, ``add_bos_token``/
``add_eos_token`` for GPT-NeoX, and ``clean_up_tokenization_spaces``.
A named special token from the vocabulary becomes a special added token.

Anything else raises :class:`UnsupportedTokenizer` — SentencePiece-style
files (``Metaspace``, ``byte_fallback``: Llama-2, Mistral-7B, Gemma),
other models, normalizers, pre-tokenizers, post-processors and decoders,
``add_prefix_space``, added tokens with ``single_word``, ``lstrip`` or
``rstrip``, a named special token outside the vocabulary — and
``tokenizer_from_config`` then serves
the byte tokenizer, as the reference does when its load fails. There is
no ``apply_chat_template``: chat templates are Jinja, which the standard
library lacks.
"""

from __future__ import annotations

import functools
import json
import os
import re
import tempfile
import unicodedata
from typing import Any, Optional, Sequence

from gofr_tpu_torch.serving.native_tokenizer import NativeBPE, load_core, write_bpe_files


class UnsupportedTokenizer(ValueError):
    """A tokenizer file outside the reader's scope (see the module
    docstring)."""


# -- GPT-2's byte <-> unicode map ----------------------------------------


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible map of the 256 bytes onto printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.lru_cache(maxsize=1)
def _unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


def _byte_level(text: str) -> str:
    table = bytes_to_unicode()
    return "".join(table[b] for b in text.encode("utf-8"))


def _token_bytes(token: str) -> Optional[bytes]:
    """A token's bytes under the byte-level map; None when a character is
    outside it."""
    table = _unicode_to_bytes()
    try:
        return bytes(table[c] for c in token)
    except KeyError:
        return None


def _decode_token(token: str) -> bytes:
    """HF's ``ByteLevel`` decoder on one token: its bytes under the map, or
    its own UTF-8 when a character is outside the map."""
    raw = _token_bytes(token)
    return raw if raw is not None else token.encode("utf-8")


# -- Oniguruma-style classes for Python's re -----------------------------

# Unicode White_Space (Oniguruma's \s). Python's \s also takes \x1c-\x1f.
_WHITE_SPACE = [(0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000)]


@functools.lru_cache(maxsize=1)
def _category_ranges() -> dict[str, list[tuple[int, int]]]:
    """Code point ranges of the general categories L and N (once a
    process: one pass over the code space)."""
    out: dict[str, list[tuple[int, int]]] = {"L": [], "N": []}
    for cp in range(0x110000):
        major = unicodedata.category(chr(cp))[0]
        ranges = out.get(major)
        if ranges is None:
            continue
        if ranges and ranges[-1][1] == cp - 1:
            ranges[-1] = (ranges[-1][0], cp)
        else:
            ranges.append((cp, cp))
    return out


def _complement(ranges: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out, lo = [], 0
    for a, b in ranges:
        if a > lo:
            out.append((lo, a - 1))
        lo = b + 1
    if lo <= 0x10FFFF:
        out.append((lo, 0x10FFFF))
    return out


def _esc(cp: int) -> str:
    return f"\\u{cp:04x}" if cp <= 0xFFFF else f"\\U{cp:08x}"


def _class_body(ranges: list[tuple[int, int]]) -> str:
    return "".join(_esc(a) if a == b else f"{_esc(a)}-{_esc(b)}" for a, b in ranges)


def translate_pattern(pattern: str) -> str:
    """An Oniguruma pattern of a tokenizer file as a Python ``re`` pattern:
    ``\\p{L}``, ``\\p{N}``, ``\\s`` and ``\\S`` become explicit classes.
    Raises :class:`UnsupportedTokenizer` on escapes whose meaning differs
    (``\\w``, ``\\b``, other properties) or a negated property in a
    class."""
    cats = _category_ranges()
    out: list[str] = []
    in_class = False
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            e = pattern[i + 1]
            if e in "pP":
                m = re.match(r"\{(\w+)\}", pattern[i + 2:])
                name = m.group(1) if m else ""
                if name not in cats or (e == "P" and in_class):
                    raise UnsupportedTokenizer(f"pattern escape \\{e}{{{name}}}")
                body = _class_body(cats[name])
                neg = e == "P"
                out.append(body if in_class else f"[{'^' if neg else ''}{body}]")
                i += 2 + len(m.group(0))
                continue
            if e in "sS":
                ws = _WHITE_SPACE if e == "s" else _complement(_WHITE_SPACE)
                if in_class:
                    out.append(_class_body(ws))
                else:
                    out.append(f"[{_class_body(_WHITE_SPACE)}]" if e == "s"
                               else f"[^{_class_body(_WHITE_SPACE)}]")
                i += 2
                continue
            if e in "wWbBdDhHRXK":
                raise UnsupportedTokenizer(f"pattern escape \\{e}")
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            if pattern[i + 1:i + 2] == "^":
                out.append("^")
                i += 1
            if pattern[i + 1:i + 2] == "]":  # a literal ] first in a class
                out.append("\\]")
                i += 1
        elif c == "[" and in_class:
            raise UnsupportedTokenizer("nested character class")
        elif c == "]" and in_class:
            in_class = False
            out.append(c)
        else:
            out.append(c)
        i += 1
    return "".join(out)


# GPT-2's pre-tokenizer pattern (HF's ByteLevel with use_regex).
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                r"|\s+(?!\S)|\s+")


def _split_isolated(rx: "re.Pattern[str]", text: str) -> list[str]:
    """HF's ``Split`` with ``Isolated`` behavior: matches and the gaps
    between them, in order, empty ones dropped."""
    out, pos = [], 0
    for m in rx.finditer(text):
        if m.start() == m.end():
            continue
        if m.start() > pos:
            out.append(text[pos:m.start()])
        out.append(m.group())
        pos = m.end()
    if pos < len(text):
        out.append(text[pos:])
    return out


# -- the pipeline's stages -----------------------------------------------


def _pre_tokenizer(spec: Optional[dict]) -> list:
    """The pre-tokenizer as a list of stages, each a function from one
    piece to its pieces."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [s for sub in spec.get("pretokenizers", []) for s in _pre_tokenizer(sub)]
    if kind == "Split":
        if spec.get("behavior") != "Isolated" or spec.get("invert"):
            raise UnsupportedTokenizer(
                f"Split behavior {spec.get('behavior')!r} invert={spec.get('invert')}")
        pat = spec.get("pattern", {})
        if "Regex" not in pat:
            raise UnsupportedTokenizer(f"Split pattern {pat!r}")
        rx = re.compile(translate_pattern(pat["Regex"]))
        return [lambda piece, rx=rx: _split_isolated(rx, piece)]
    if kind == "ByteLevel":
        if spec.get("add_prefix_space", False):
            raise UnsupportedTokenizer("ByteLevel add_prefix_space")
        if not spec.get("use_regex", True):
            return []
        rx = re.compile(translate_pattern(GPT2_PATTERN))
        return [lambda piece, rx=rx: _split_isolated(rx, piece)]
    raise UnsupportedTokenizer(f"pre-tokenizer {kind!r}")


def _is_byte_level(spec: Optional[dict]) -> bool:
    if spec is None:
        return False
    if spec.get("type") == "Sequence":
        return any(_is_byte_level(s) for s in spec.get("pretokenizers", []))
    return spec.get("type") == "ByteLevel"


def _normalizer(spec: Optional[dict]):
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    if kind == "Sequence" and not spec.get("normalizers"):
        return lambda s: s
    raise UnsupportedTokenizer(f"normalizer {kind!r}")


def _post_processor(spec: Optional[dict]) -> tuple[list[int], list[int]]:
    """The ids the post-processor puts before and after a single
    sequence."""
    if spec is None or spec.get("type") == "ByteLevel":
        return [], []
    kind = spec.get("type")
    if kind == "Sequence":
        pre: list[int] = []
        post: list[int] = []
        for sub in spec.get("processors", []):
            a, b = _post_processor(sub)
            pre, post = a + pre, post + b
        return pre, post
    if kind == "TemplateProcessing":
        specials = spec.get("special_tokens", {})
        pre, post, seen = [], [], False
        for item in spec.get("single", []):
            if "Sequence" in item:
                seen = True
            elif "SpecialToken" in item:
                ids = specials[item["SpecialToken"]["id"]]["ids"]
                (post if seen else pre).extend(int(i) for i in ids)
        return pre, post
    raise UnsupportedTokenizer(f"post-processor {kind!r}")


def _merges(raw: list) -> list[tuple[str, str]]:
    out = []
    for m in raw:
        if isinstance(m, str):
            parts = m.split(" ")
        else:
            parts = list(m)
        if len(parts) != 2:
            raise UnsupportedTokenizer(f"merge {m!r}")
        out.append((parts[0], parts[1]))
    return out


# -- special tokens, as transformers resolves them -----------------------

_EOT = "<|endoftext|>"
# Per tokenizer class: its special-token defaults, and whether it replaces
# the post-processor from add_bos_token / add_eos_token.
_CLASSES = {
    "PreTrainedTokenizerFast": ({}, False),
    "GPT2Tokenizer": ({"unk_token": _EOT, "bos_token": _EOT, "eos_token": _EOT}, False),
    "Qwen2Tokenizer": ({"unk_token": _EOT, "bos_token": None, "eos_token": _EOT,
                        "pad_token": _EOT}, False),
    "GPTNeoXTokenizer": ({"unk_token": _EOT, "bos_token": _EOT, "eos_token": _EOT,
                          "pad_token": None}, True),
}
_MODEL_TYPES = {"gpt2": "GPT2Tokenizer", "qwen2": "Qwen2Tokenizer",
                "gpt_neox": "GPTNeoXTokenizer"}
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "pad_token")


def _read_json(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fp:
        return json.load(fp)


def _token_content(value: Any) -> Optional[str]:
    if value is None:
        return None
    if isinstance(value, dict):
        return value.get("content")
    return str(value)


def _tokenizer_class(directory: str, config: dict) -> str:
    name = config.get("tokenizer_class")
    if not name:
        model_cfg = _read_json(os.path.join(directory, "config.json")) or {}
        name = _MODEL_TYPES.get(model_cfg.get("model_type", ""))
        if not name:
            raise UnsupportedTokenizer(
                "no tokenizer_class in tokenizer_config.json and no known "
                "model_type in config.json")
    base = name[:-4] if name.endswith("Fast") and name != "PreTrainedTokenizerFast" else name
    if base not in _CLASSES:
        raise UnsupportedTokenizer(f"tokenizer class {name!r}")
    return base


class HFTokenizer:
    """A byte-level BPE ``tokenizer.json`` served through the native core:
    the engine's tokenizer protocol (``bos_id``, ``eos_id``, ``pad_id``,
    ``encode``, ``decode``) with the reference's ``tokenizer_from_config``
    semantics — ``encode`` adds what the post-processor adds, ``decode``
    skips special tokens."""

    def __init__(self, directory: str, prefer_native: bool = True) -> None:
        spec = _read_json(os.path.join(directory, "tokenizer.json"))
        if spec is None:
            raise FileNotFoundError(f"no tokenizer.json in {directory!r}")
        config = _read_json(os.path.join(directory, "tokenizer_config.json")) or {}
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise UnsupportedTokenizer(f"model type {model.get('type')!r}")
        for key in ("byte_fallback", "continuing_subword_prefix", "end_of_word_suffix",
                    "dropout"):
            if model.get(key):
                raise UnsupportedTokenizer(f"BPE {key}={model[key]!r}")
        if not _is_byte_level(spec.get("pre_tokenizer")):
            raise UnsupportedTokenizer("not a byte-level pre-tokenizer")
        if (spec.get("decoder") or {}).get("type") != "ByteLevel":
            raise UnsupportedTokenizer(f"decoder {(spec.get('decoder') or {}).get('type')!r}")
        self._normalize = _normalizer(spec.get("normalizer"))
        self._stages = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._ignore_merges = bool(model.get("ignore_merges", False))
        self.vocab: dict[str, int] = {str(k): int(v) for k, v in model["vocab"].items()}
        merges = _merges(model.get("merges", []))

        # Added tokens by id: content, special, normalized.
        self._added: dict[int, dict] = {}
        for tok in spec.get("added_tokens", []):
            for flag in ("single_word", "lstrip", "rstrip"):
                if tok.get(flag):
                    raise UnsupportedTokenizer(f"{flag} added token {tok['content']!r}")
            self._added[int(tok["id"])] = dict(tok)
        for idx, tok in (config.get("added_tokens_decoder") or {}).items():
            have = self._added.get(int(idx))
            if have is None or have["content"] != tok.get("content"):
                raise UnsupportedTokenizer(
                    f"added_tokens_decoder entry {idx} differs from tokenizer.json")
            have["special"] = bool(tok.get("special", have.get("special")))

        # Special tokens: the class's defaults, the config, then the legacy
        # special_tokens_map.json.
        cls = _tokenizer_class(directory, config)
        defaults, template_from_flags = _CLASSES[cls]
        named: dict[str, Optional[str]] = {k: defaults.get(k) for k in _SPECIAL_KEYS}
        for key in _SPECIAL_KEYS:
            if key in config:
                named[key] = _token_content(config[key])
        if "added_tokens_decoder" not in config:
            legacy = _read_json(os.path.join(directory, "special_tokens_map.json")) or {}
            for key in _SPECIAL_KEYS:
                if key in legacy:
                    named[key] = _token_content(legacy[key])
        for content in named.values():
            if content is not None:
                self._add_special(content)
        self._added_by_content = {t["content"]: i for i, t in self._added.items()}

        def token_id(content: Optional[str]) -> Optional[int]:
            if content is None:
                return None
            if content in self._added_by_content:
                return self._added_by_content[content]
            return self.vocab.get(content)

        bos, eos, pad = (token_id(named["bos_token"]), token_id(named["eos_token"]),
                         token_id(named["pad_token"]))
        # The reference's explicit-None rules: id 0 is a real token, and a
        # missing eos must disable eos-stopping, not stop on id 0.
        self.bos_id = bos if bos is not None else -1
        self.eos_id = eos if eos is not None else -1
        self.pad_id = pad if pad is not None else (eos if eos is not None else -1)

        if template_from_flags:
            # GPT-NeoX's class rebuilds the post-processor from its flags.
            self._prefix = [bos] if config.get("add_bos_token", False) and bos is not None else []
            self._suffix = [eos] if config.get("add_eos_token", False) and eos is not None else []
        else:
            self._prefix, self._suffix = _post_processor(spec.get("post_processor"))
        self._clean_up = bool(config.get("clean_up_tokenization_spaces", False))
        self._specials = {i for i, t in self._added.items() if t.get("special")}
        self._raw_split, self._norm_split = self._added_patterns()

        # Id -> token string for decoding (added tokens over the model's).
        self._id_to_token: dict[int, str] = {i: s for s, i in self.vocab.items()}
        for i, t in self._added.items():
            self._id_to_token[i] = t["content"]
        self.vocab_size = max(self._id_to_token, default=-1) + 1

        # The merge loop's core over the vocabulary and merges as bytes.
        table: list[bytes] = [b""] * (max(self.vocab.values(), default=-1) + 1)
        for s, i in self.vocab.items():
            raw = _token_bytes(s)
            if raw is not None:
                table[i] = raw
        byte_merges = []
        for a, b in merges:
            ra, rb = _token_bytes(a), _token_bytes(b)
            if ra is None or rb is None or (a + b) not in self.vocab:
                raise UnsupportedTokenizer(f"merge {a!r} {b!r} outside the vocabulary")
            byte_merges.append((ra, rb))
        with tempfile.TemporaryDirectory() as tmp:
            self._core = load_core(*write_bpe_files(table, byte_merges, tmp),
                                   prefer_native=prefer_native)

    @property
    def is_native(self) -> bool:
        return isinstance(self._core, NativeBPE)

    def _add_special(self, content: str) -> None:
        """A named special token becomes a special added token, as
        transformers registers it."""
        for t in self._added.values():
            if t["content"] == content:
                t["special"] = True
                return
        idx = self.vocab.get(content)
        if idx is None:
            raise UnsupportedTokenizer(f"special token {content!r} outside the vocabulary")
        self._added[idx] = {"id": idx, "content": content, "special": True,
                            "normalized": False}

    def _added_patterns(self):
        """Leftmost-longest matchers of the added tokens on the raw text
        (``normalized: false``) and on the normalized text (the others)."""

        def matcher(tokens: list[dict]):
            if not tokens:
                return None
            return re.compile("|".join(
                f"(?P<t{t['id']}>{re.escape(t['content'])})"
                for t in sorted(tokens, key=lambda t: -len(t["content"]))))

        toks = [t for t in self._added.values() if t["content"]]
        return (matcher([t for t in toks if not t.get("normalized", True)]),
                matcher([t for t in toks if t.get("normalized", True)]))

    @staticmethod
    def _split_added(rx, text: str) -> list[tuple[str, Optional[int]]]:
        if rx is None:
            return [(text, None)] if text else []
        out: list[tuple[str, Optional[int]]] = []
        pos = 0
        for m in rx.finditer(text):
            if m.start() == m.end():
                continue
            if m.start() > pos:
                out.append((text[pos:m.start()], None))
            out.append((m.group(), int(m.lastgroup[1:])))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], None))
        return out

    def _encode_piece(self, piece: str) -> list[int]:
        pieces = [piece]
        for stage in self._stages:
            pieces = [p for q in pieces for p in stage(q)]
        ids: list[int] = []
        for p in pieces:
            if self._ignore_merges:
                whole = self.vocab.get(_byte_level(p))
                if whole is not None:
                    ids.append(whole)
                    continue
            ids.extend(self._core.encode_bytes(p.encode("utf-8")))
        return ids

    def encode(self, text: str) -> list[int]:
        ids = list(self._prefix)
        for raw, tid in self._split_added(self._raw_split, text):
            if tid is not None:
                ids.append(tid)
                continue
            for part, nid in self._split_added(self._norm_split, self._normalize(raw)):
                if nid is not None:
                    ids.append(nid)
                else:
                    ids.extend(self._encode_piece(part))
        return ids + list(self._suffix)

    def decode(self, ids: Sequence[int]) -> str:
        data = b"".join(
            _decode_token(self._id_to_token[i]) for i in ids
            if i in self._id_to_token and i not in self._specials
        )
        text = data.decode("utf-8", "replace")
        if self._clean_up:
            text = clean_up_tokenization(text)
        return text


def clean_up_tokenization(text: str) -> str:
    """transformers' ``clean_up_tokenization`` (spaces before punctuation
    and English contractions)."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                 (" 're", "'re")):
        text = text.replace(a, b)
    return text
