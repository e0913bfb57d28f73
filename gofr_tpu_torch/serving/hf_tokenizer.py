"""A reader for Hugging Face ``tokenizer.json`` files in the standard
library only — the port's counterpart of the reference's ``AutoTokenizer``
branch of ``tokenizer_from_config`` (the port may not import
``transformers`` or ``tokenizers``).

Scope, by model:

* byte-level BPE (GPT-2's alphabet): GPT-2 and GPT-NeoX/Pythia (the
  ``ByteLevel`` pre-tokenizer with its regex); Llama-3 (``Split`` with its
  pattern, then ``ByteLevel(use_regex=false)``, ``ignore_merges``, a BOS
  template); Qwen2 (``NFC``, ``Split`` and ``ByteLevel``, no BOS). The
  merge loop runs in the native BPE core (``native_tokenizer``) over the
  vocabulary and merges converted to bytes, or in ``PyBPE`` without a
  compiler;
* SentencePiece-style BPE over characters with ``<0xNN>`` byte fallback
  and the ``unk`` token: Llama-2 (``Prepend``/``Replace`` normalizers, the
  ``Replace``/``ByteFallback``/``Fuse``/``Strip`` decoders), Mistral-7B
  (the ``Metaspace`` pre-tokenizer and decoder), Gemma;
* Unigram (T5: ``WhitespaceSplit`` and ``Metaspace``, the ``$A </s>``
  template) and WordPiece (BERT: ``BertNormalizer``, ``BertPreTokenizer``,
  ``##`` continuations, the ``[CLS] $A [SEP]`` template, the ``WordPiece``
  decoder).

Their stages live in ``hf_pipeline``. The pipeline is HF's: the
``added_tokens`` are matched in the text first (leftmost-longest; those
with ``normalized: false`` on the raw text, the others after the
normalizer), the rest is normalized a piece at a time, pre-tokenized
(``Metaspace``'s ``first`` scheme prepends only at the text's start),
run through the model, and the post-processor adds its special tokens.

HF's patterns use Oniguruma's ``\\p{L}``, ``\\p{N}`` and ``\\s``; Python's
``re`` has no ``\\p{..}`` and a wider ``\\s``, so the patterns are
rewritten with explicit character classes built once a process from
``unicodedata`` (``\\s`` as Unicode White_Space).

``tokenizer_config.json`` gives the special tokens as ``transformers``
resolves them: the class's defaults (``PreTrainedTokenizerFast``,
``GPT2Tokenizer``, ``Qwen2Tokenizer``, ``GPTNeoXTokenizer``,
``LlamaTokenizer``, ``GemmaTokenizer``, ``T5Tokenizer`` with its
``<extra_id_N>`` sentinels, ``BertTokenizer`` with its ``do_lower_case``
/ ``strip_accents`` / ``tokenize_chinese_chars`` over the file's
``BertNormalizer``; the class comes from ``tokenizer_class`` or
``config.json``'s ``model_type``), then the config's named tokens (an
explicit ``null`` clears one), ``special_tokens_map.json`` when the config
has no ``added_tokens_decoder``, ``add_bos_token``/``add_eos_token`` for
the classes that rebuild their template from them (GPT-NeoX, Llama,
Gemma), and ``clean_up_tokenization_spaces``. A named special token
becomes a special added token: its vocabulary id, or a new id after the
vocabulary as transformers adds it.

Anything else raises :class:`UnsupportedTokenizer` — the ``Precompiled``
normalizer (a SentencePiece charsmap, which real T5 files carry: ROADMAP
Queue 1 item 6.4), other models, normalizers, pre-tokenizers,
post-processors and decoders, ``add_prefix_space``, added tokens with
``single_word``, ``lstrip`` or ``rstrip`` — and ``tokenizer_from_config``
then serves the byte tokenizer, as the reference does when its load
fails. There is no ``apply_chat_template``: chat templates are Jinja,
which the standard library lacks.
"""

from __future__ import annotations

import functools
import json
import os
import re
import tempfile
import unicodedata
from typing import Any, Optional, Sequence

from gofr_tpu_torch.serving import hf_pipeline as pipeline
from gofr_tpu_torch.serving.hf_pipeline import UnsupportedTokenizer
from gofr_tpu_torch.serving.native_tokenizer import NativeBPE, load_core, write_bpe_files


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


def _is_byte_level(spec: Optional[dict]) -> bool:
    if spec is None:
        return False
    if spec.get("type") == "Sequence":
        return any(_is_byte_level(s) for s in spec.get("pretokenizers", []))
    return spec.get("type") == "ByteLevel"


def _uses(spec: Any, kind: str) -> bool:
    """Whether a stage of ``kind`` appears anywhere in ``spec``."""
    if isinstance(spec, dict):
        return spec.get("type") == kind or any(_uses(v, kind) for v in spec.values())
    if isinstance(spec, list):
        return any(_uses(v, kind) for v in spec)
    return False


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
    if kind == "BertProcessing":
        return [int(spec["cls"][1])], [int(spec["sep"][1])]
    raise UnsupportedTokenizer(f"post-processor {kind!r}")


# -- special tokens, as transformers resolves them -----------------------

_EOT = "<|endoftext|>"
# Per tokenizer class: its special-token defaults, and the defaults of
# add_bos_token / add_eos_token when the class rebuilds the
# post-processor from them (None: it keeps the file's).
_CLASSES: dict[str, tuple[dict, Optional[tuple[bool, bool]]]] = {
    "PreTrainedTokenizerFast": ({}, None),
    "GPT2Tokenizer": ({"unk_token": _EOT, "bos_token": _EOT, "eos_token": _EOT}, None),
    "Qwen2Tokenizer": ({"unk_token": _EOT, "bos_token": None, "eos_token": _EOT,
                        "pad_token": _EOT}, None),
    "GPTNeoXTokenizer": ({"unk_token": _EOT, "bos_token": _EOT, "eos_token": _EOT,
                          "pad_token": None}, (False, False)),
    "LlamaTokenizer": ({"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>",
                        "pad_token": None}, (True, False)),
    "GemmaTokenizer": ({"unk_token": "<unk>", "bos_token": "<bos>", "eos_token": "<eos>",
                        "pad_token": "<pad>"}, (True, False)),
    "T5Tokenizer": ({"eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>"}, None),
    "BertTokenizer": ({"unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
                       "cls_token": "[CLS]", "mask_token": "[MASK]"}, None),
}
_MODEL_TYPES = {"gpt2": "GPT2Tokenizer", "qwen2": "Qwen2Tokenizer",
                "gpt_neox": "GPTNeoXTokenizer", "llama": "LlamaTokenizer",
                "mistral": "LlamaTokenizer", "gemma": "GemmaTokenizer", "t5": "T5Tokenizer",
                "bert": "BertTokenizer"}
# transformers' SPECIAL_TOKENS_ATTRIBUTES order (the order it adds them).
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                 "cls_token", "mask_token")


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


def _additional_specials(cls: str, config: dict, legacy: dict) -> list[str]:
    """The additional special tokens: the config's (or the legacy map's),
    and T5's ``<extra_id_N>`` for ``extra_ids`` (default 100) when none is
    named."""
    extra = config.get("additional_special_tokens", legacy.get("additional_special_tokens"))
    out = [_token_content(t) for t in (extra or [])]
    if cls == "T5Tokenizer":
        n = int(config.get("extra_ids", 100))
        named = [t for t in out if "<extra_id_" in str(t)]
        if not named:
            out += [f"<extra_id_{i}>" for i in range(n)]
        elif n > 0 and n != len(named):
            raise UnsupportedTokenizer(f"extra_ids={n} but {len(named)} extra tokens named")
    return [t for t in out if t is not None]


class HFTokenizer:
    """A ``tokenizer.json`` directory as the engine's tokenizer protocol
    (``bos_id``, ``eos_id``, ``pad_id``, ``encode``, ``decode``) with the
    reference's ``tokenizer_from_config`` semantics — ``encode`` adds what
    the post-processor adds, ``decode`` skips special tokens. Byte-level
    BPE goes through the native core; the other models through
    ``hf_pipeline``."""

    def __init__(self, directory: str, prefer_native: bool = True) -> None:
        spec = _read_json(os.path.join(directory, "tokenizer.json"))
        if spec is None:
            raise FileNotFoundError(f"no tokenizer.json in {directory!r}")
        config = _read_json(os.path.join(directory, "tokenizer_config.json")) or {}
        model = spec.get("model") or {}
        if _uses(spec.get("normalizer"), "Precompiled"):
            raise UnsupportedTokenizer(
                "normalizer 'Precompiled' (ROADMAP Queue 1 item 6.4: the Precompiled "
                "normalizer, a SentencePiece charsmap)")
        cls = _tokenizer_class(directory, config)
        defaults, flag_defaults = _CLASSES[cls]
        self.byte_level = (model.get("type") == "BPE"
                           and _is_byte_level(spec.get("pre_tokenizer")))
        if self.byte_level:
            for key in ("byte_fallback", "continuing_subword_prefix", "end_of_word_suffix",
                        "dropout"):
                if model.get(key):
                    raise UnsupportedTokenizer(f"BPE {key}={model[key]!r}")
            if (spec.get("decoder") or {}).get("type") != "ByteLevel":
                raise UnsupportedTokenizer(
                    f"decoder {(spec.get('decoder') or {}).get('type')!r}")
        else:
            self._model = pipeline.model_for(model)
            self._decoder = pipeline.decoder(spec.get("decoder"), translate_pattern)
        # BertTokenizerFast rebuilds its normalizer from its own arguments.
        bert = None
        if cls == "BertTokenizer" and (spec.get("normalizer") or {}).get("type") == "BertNormalizer":
            bert = {"lowercase": bool(config.get("do_lower_case", True)),
                    "strip_accents": config.get("strip_accents"),
                    "chinese": bool(config.get("tokenize_chinese_chars", True))}
        self._normalize = pipeline.normalizer(spec.get("normalizer"), translate_pattern, bert)
        self._stages = pipeline.pre_tokenizer(spec.get("pre_tokenizer"), translate_pattern,
                                              GPT2_PATTERN)
        self._ignore_merges = bool(model.get("ignore_merges", False))
        if model.get("type") == "Unigram":
            self.vocab = {p: i for i, p in enumerate(self._model.pieces)}
        else:
            self.vocab = {str(k): int(v) for k, v in model["vocab"].items()}
        self._model_size = (len(self._model.pieces) if model.get("type") == "Unigram"
                            else len(self.vocab))

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
        # special_tokens_map.json; added in transformers' order.
        named: dict[str, Optional[str]] = {k: defaults.get(k) for k in _SPECIAL_KEYS}
        for key in _SPECIAL_KEYS:
            if key in config:
                named[key] = _token_content(config[key])
        legacy: dict = {}
        if "added_tokens_decoder" not in config:
            legacy = _read_json(os.path.join(directory, "special_tokens_map.json")) or {}
            for key in _SPECIAL_KEYS:
                if key in legacy:
                    named[key] = _token_content(legacy[key])
        for content in [*named.values(), *_additional_specials(cls, config, legacy)]:
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

        if flag_defaults is not None:
            # The class rebuilds the post-processor from its flags.
            add_bos = config.get("add_bos_token", flag_defaults[0])
            add_eos = config.get("add_eos_token", flag_defaults[1])
            if (add_bos and bos is None) or (add_eos and eos is None):
                raise UnsupportedTokenizer("add_bos_token/add_eos_token without the token")
            self._prefix = [bos] if add_bos else []
            self._suffix = [eos] if add_eos else []
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

        if self.byte_level:
            self._build_core(model, prefer_native)

    def _build_core(self, model: dict, prefer_native: bool) -> None:
        """The byte-level merge loop's core over the vocabulary and merges
        as bytes."""
        table: list[bytes] = [b""] * (max(self.vocab.values(), default=-1) + 1)
        for s, i in self.vocab.items():
            raw = _token_bytes(s)
            if raw is not None:
                table[i] = raw
        byte_merges = []
        for a, b in pipeline.parse_merges(model.get("merges", [])):
            ra, rb = _token_bytes(a), _token_bytes(b)
            if ra is None or rb is None or (a + b) not in self.vocab:
                raise UnsupportedTokenizer(f"merge {a!r} {b!r} outside the vocabulary")
            byte_merges.append((ra, rb))
        with tempfile.TemporaryDirectory() as tmp:
            self._core = load_core(*write_bpe_files(table, byte_merges, tmp),
                                   prefer_native=prefer_native)

    @property
    def is_native(self) -> bool:
        return self.byte_level and isinstance(self._core, NativeBPE)

    def _add_special(self, content: str) -> None:
        """A named special token becomes a special added token, as
        transformers registers it: its vocabulary id, or a new id after the
        model's vocabulary and the added tokens when it has none."""
        for t in self._added.values():
            if t["content"] == content:
                t["special"] = True
                return
        idx = self.vocab.get(content)
        if idx is None:
            top = max(self._added, default=None)
            idx = (self._model_size if top is None or top < self._model_size else top + 1)
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
    def _split_added(rx, text: str) -> list[tuple[str, Optional[int], int]]:
        """(piece, added token id or None, start) over ``text``."""
        if rx is None:
            return [(text, None, 0)] if text else []
        out: list[tuple[str, Optional[int], int]] = []
        pos = 0
        for m in rx.finditer(text):
            if m.start() == m.end():
                continue
            if m.start() > pos:
                out.append((text[pos:m.start()], None, pos))
            out.append((m.group(), int(m.lastgroup[1:]), m.start()))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], None, pos))
        return out

    def _encode_piece(self, piece: str, at0: bool) -> list[int]:
        pieces = [(piece, at0)]
        for stage in self._stages:
            pieces = [p for q in pieces for p in stage(q)]
        ids: list[int] = []
        if not self.byte_level:
            for p, _ in pieces:
                ids.extend(self._model.tokenize(p))
            return ids
        for p, _ in pieces:
            if self._ignore_merges:
                whole = self.vocab.get(_byte_level(p))
                if whole is not None:
                    ids.append(whole)
                    continue
            ids.extend(self._core.encode_bytes(p.encode("utf-8")))
        return ids

    def encode(self, text: str) -> list[int]:
        ids = list(self._prefix)
        for raw, tid, start in self._split_added(self._raw_split, text):
            if tid is not None:
                ids.append(tid)
                continue
            for part, nid, nstart in self._split_added(self._norm_split, self._normalize(raw)):
                if nid is not None:
                    ids.append(nid)
                else:
                    ids.extend(self._encode_piece(part, start == 0 and nstart == 0))
        return ids + list(self._suffix)

    def decode(self, ids: Sequence[int]) -> str:
        tokens = [self._id_to_token[i] for i in ids
                  if i in self._id_to_token and i not in self._specials]
        if self.byte_level:
            text = b"".join(_decode_token(t) for t in tokens).decode("utf-8", "replace")
        else:
            text = "".join(self._decoder(tokens)) if tokens else ""
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
