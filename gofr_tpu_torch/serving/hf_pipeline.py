"""The stages of a Hugging Face ``tokenizer.json`` beyond byte-level BPE, in
the standard library only: the normalizers, pre-tokenizers, models and
decoders of SentencePiece-style BPE (Llama-2, Mistral-7B, Gemma), Unigram
(T5) and WordPiece (BERT) files, each as ``tokenizers`` defines it.
``hf_tokenizer.HFTokenizer`` assembles them.

* Normalizers (``str -> str``): ``NFC``/``NFD``/``NFKC``/``NFKD``,
  ``Lowercase``, ``Prepend`` (non-empty pieces only), ``Replace`` (a string
  or a regex), ``Strip``, ``BertNormalizer`` (clean_text, CJK padding,
  ``strip_accents`` following ``lowercase`` when unset) and ``Sequence``.
  ``Precompiled`` (a SentencePiece charsmap, which real T5 files carry)
  raises :class:`UnsupportedTokenizer`: nothing here can build one to
  test against (ROADMAP Queue 1 item 6.4).
* Pre-tokenizers map a piece and whether it starts the text to pieces:
  ``Split`` (``Isolated``), ``ByteLevel``, ``Metaspace`` (``replacement``,
  ``prepend_scheme`` always/first/never, ``split`` merged with the next
  piece), ``WhitespaceSplit``, ``BertPreTokenizer`` and ``Sequence``.
* Models map a piece to ids: :class:`CharBPE` (merges over characters,
  lowest rank then leftmost; ``<0xNN>`` byte fallback; fused ``unk``),
  :class:`Unigram` (Viterbi over the pieces' scores; an unknown character
  costs the lowest score less 10; fused ``unk``; byte fallback) and
  :class:`WordPiece` (greedy longest match, ``##`` continuations, a word
  over ``max_input_chars_per_word`` or with an unmatched rest is one
  ``[UNK]``).
* Decoders map the token strings to text: ``Replace``, ``ByteFallback``
  (an invalid UTF-8 run gives one U+FFFD a byte), ``Fuse``, ``Strip``,
  ``Metaspace`` (every replacement dropped from the first token unless the
  scheme is ``never``), ``WordPiece`` (its per-token cleanup) and
  ``Sequence``.
"""

from __future__ import annotations

import heapq
import re
import unicodedata
from typing import Callable, Optional

SPACE = "▁"  # SentencePiece's word boundary, the files' replacement

_PRECOMPILED = "ROADMAP Queue 1 item 6.4: the Precompiled normalizer"


class UnsupportedTokenizer(ValueError):
    """A tokenizer file outside the reader's scope (see
    ``hf_tokenizer``'s docstring)."""


# Rust's char::is_whitespace (Unicode White_Space), which Python's
# str.isspace exceeds (\x1c-\x1f).
WHITE_SPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B)))
_WS_RUNS = re.compile("[" + "".join(re.escape(c) for c in sorted(WHITE_SPACE)) + "]+")


def _is_punct(c: str) -> bool:
    """BERT's punctuation: ASCII punctuation or a Unicode P* character."""
    return ("!" <= c <= "/" or ":" <= c <= "@" or "[" <= c <= "`" or "{" <= c <= "~"
            or unicodedata.category(c).startswith("P"))


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B920 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def bert_normalize(text: str, clean_text: bool, chinese: bool, strip_accents: Optional[bool],
                   lowercase: bool) -> str:
    """``BertNormalizer``, step for step: drop NUL, U+FFFD and C*
    characters (tab, newline and CR are whitespace) and map whitespace to
    a space; pad CJK ideographs with spaces; strip accents (NFD, then no
    Mn), by default when lowercasing; lowercase."""
    if clean_text:
        out = []
        for c in text:
            if c in "\t\n\r" or c in WHITE_SPACE:
                out.append(" ")
            elif c == "\0" or c == "�" or unicodedata.category(c).startswith("C"):
                continue
            else:
                out.append(c)
        text = "".join(out)
    if chinese:
        text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
    if lowercase if strip_accents is None else strip_accents:
        text = "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")
    if lowercase:
        text = text.lower()
    return text


def _pattern(spec: dict, translate: Callable[[str], str]):
    """A ``{"String": s}`` or ``{"Regex": r}`` pattern as a compiled regex."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return re.compile(translate(spec["Regex"]))
    raise UnsupportedTokenizer(f"pattern {spec!r}")


def normalizer(spec: Optional[dict], translate: Callable[[str], str],
               bert: Optional[dict] = None) -> Callable[[str], str]:
    """The normalizer of ``spec``; ``bert`` overrides a ``BertNormalizer``'s
    flags (``BertTokenizerFast`` rebuilds it from its own arguments)."""
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "Sequence":
        stages = [normalizer(s, translate) for s in spec.get("normalizers", [])]

        def seq(s: str) -> str:
            for f in stages:
                s = f(s)
            return s

        return seq
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Lowercase":
        return str.lower
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        rx, content = _pattern(spec["pattern"], translate), spec["content"]
        return lambda s: rx.sub(lambda _m: content, s)
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)
        ws = "".join(WHITE_SPACE)

        def strip(s: str) -> str:
            s = s.lstrip(ws) if left else s
            return s.rstrip(ws) if right else s

        return strip
    if kind == "BertNormalizer":
        flags = {"clean_text": spec.get("clean_text", True),
                 "chinese": spec.get("handle_chinese_chars", True),
                 "strip_accents": spec.get("strip_accents"),
                 "lowercase": spec.get("lowercase", True)}
        flags.update(bert or {})
        return lambda s: bert_normalize(s, **flags)
    if kind == "Precompiled":
        raise UnsupportedTokenizer(f"normalizer 'Precompiled' ({_PRECOMPILED})")
    raise UnsupportedTokenizer(f"normalizer {kind!r}")


# -- pre-tokenizers: (piece, starts the text) -> pieces ------------------


def _split_isolated(rx: "re.Pattern[str]", text: str) -> list[str]:
    """``Split`` with ``Isolated`` behavior: matches and the gaps between
    them, in order, empty ones dropped."""
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


Piece = tuple[str, bool]  # (text, its first character is the input's first)


def _at0(parent_at0: bool, pieces_with_start: list[tuple[str, int]]) -> list[Piece]:
    return [(p, parent_at0 and start == 0) for p, start in pieces_with_start]


def _isolated_stage(rx):
    def stage(piece: Piece) -> list[Piece]:
        text, at0 = piece
        out, pos = [], 0
        for part in _split_isolated(rx, text):
            start = text.index(part, pos)
            out.append((part, start))
            pos = start + len(part)
        return _at0(at0, out)

    return stage


def metaspace_stage(replacement: str, scheme: str, split: bool):
    def stage(piece: Piece) -> list[Piece]:
        text, at0 = piece
        text = text.replace(" ", replacement)
        if not text.startswith(replacement) and (scheme == "always" or
                                                 (scheme == "first" and at0)):
            text = replacement + text
        if not split:
            return [(text, at0)]
        out, start = [], 0
        for i in range(1, len(text)):
            if text[i] == replacement:
                out.append((text[start:i], start))
                start = i
        if text:
            out.append((text[start:], start))
        return _at0(at0, out)

    return stage


def _whitespace_split(piece: Piece) -> list[Piece]:
    text, at0 = piece
    out, pos = [], 0
    for m in _WS_RUNS.finditer(text):
        if m.start() > pos:
            out.append((text[pos:m.start()], pos))
        pos = m.end()
    if pos < len(text):
        out.append((text[pos:], pos))
    return _at0(at0, out)


def _bert_pre_tokenize(piece: Piece) -> list[Piece]:
    out = []
    for word, at0 in _whitespace_split(piece):
        start = 0
        for i, c in enumerate(word):
            if _is_punct(c):
                if i > start:
                    out.append((word[start:i], at0 and start == 0))
                out.append((c, at0 and i == 0))
                start = i + 1
        if start < len(word):
            out.append((word[start:], at0 and start == 0))
    return out


def pre_tokenizer(spec: Optional[dict], translate: Callable[[str], str],
                  byte_level_regex: str) -> list:
    """The pre-tokenizer as a list of stages, each from one piece to its
    pieces."""
    if spec is None:
        return []
    kind = spec.get("type")
    if kind == "Sequence":
        return [s for sub in spec.get("pretokenizers", [])
                for s in pre_tokenizer(sub, translate, byte_level_regex)]
    if kind == "Split":
        if spec.get("behavior") != "Isolated" or spec.get("invert"):
            raise UnsupportedTokenizer(
                f"Split behavior {spec.get('behavior')!r} invert={spec.get('invert')}")
        pat = spec.get("pattern", {})
        if "Regex" not in pat:
            raise UnsupportedTokenizer(f"Split pattern {pat!r}")
        return [_isolated_stage(re.compile(translate(pat["Regex"])))]
    if kind == "ByteLevel":
        if spec.get("add_prefix_space", False):
            raise UnsupportedTokenizer("ByteLevel add_prefix_space")
        if not spec.get("use_regex", True):
            return []
        return [_isolated_stage(re.compile(translate(byte_level_regex)))]
    if kind == "Metaspace":
        return [metaspace_stage(spec.get("replacement", SPACE), metaspace_scheme(spec),
                                bool(spec.get("split", True)))]
    if kind == "WhitespaceSplit":
        return [_whitespace_split]
    if kind == "BertPreTokenizer":
        return [_bert_pre_tokenize]
    raise UnsupportedTokenizer(f"pre-tokenizer {kind!r}")


def metaspace_scheme(spec: dict) -> str:
    """``prepend_scheme``, or the older files' ``add_prefix_space``."""
    if "prepend_scheme" in spec:
        scheme = spec["prepend_scheme"]
    else:
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    if scheme not in ("always", "first", "never"):
        raise UnsupportedTokenizer(f"Metaspace prepend_scheme {scheme!r}")
    return scheme


# -- models: piece -> ids ------------------------------------------------


def _byte_tokens(text: str, vocab: dict) -> Optional[list[int]]:
    """The ``<0xNN>`` ids of ``text``'s UTF-8 bytes, or None if one is
    missing."""
    ids = [vocab.get(f"<0x{b:02X}>") for b in text.encode("utf-8")]
    return None if any(i is None for i in ids) else ids


def parse_merges(raw: list) -> list[tuple[str, str]]:
    """A BPE model's merges, as ``"a b"`` strings or ``[a, b]`` pairs."""
    out = []
    for m in raw:
        parts = m.split(" ") if isinstance(m, str) else list(m)
        if len(parts) != 2:
            raise UnsupportedTokenizer(f"merge {m!r}")
        out.append((parts[0], parts[1]))
    return out


class CharBPE:
    """BPE over characters (SentencePiece-style files): each character is
    a symbol (its ``<0xNN>`` bytes under ``byte_fallback``, else ``unk``,
    runs of unk fused), then merges applied lowest rank first, leftmost on
    ties, as ``tokenizers``' ``Word::merge_all``."""

    def __init__(self, model: dict) -> None:
        for key in ("continuing_subword_prefix", "end_of_word_suffix", "dropout"):
            if model.get(key):
                raise UnsupportedTokenizer(f"BPE {key}={model[key]!r}")
        self.vocab: dict[str, int] = {str(k): int(v) for k, v in model["vocab"].items()}
        self.unk = model.get("unk_token")
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.fuse_unk = bool(model.get("fuse_unk", False))
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, (a, b) in enumerate(parse_merges(model.get("merges", []))):
            if a not in self.vocab or b not in self.vocab or a + b not in self.vocab:
                raise UnsupportedTokenizer(f"merge {a!r} {b!r} outside the vocabulary")
            self.merges.setdefault((self.vocab[a], self.vocab[b]), (rank, self.vocab[a + b]))

    def tokenize(self, word: str) -> list[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms: list[int] = []
        unk: Optional[int] = None  # a pending (fused) unk
        for c in word:
            idx = self.vocab.get(c)
            if idx is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(idx)
                continue
            if self.byte_fallback:
                ids = _byte_tokens(c, self.vocab)
                if ids is not None:
                    syms.extend(ids)  # a pending unk stays pending, as tokenizers
                    continue
            if self.unk is not None:
                if self.unk not in self.vocab:
                    raise UnsupportedTokenizer(f"unk token {self.unk!r} outside the vocabulary")
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = self.vocab[self.unk]
        if unk is not None:
            syms.append(unk)
        return self._merge(syms)

    def _merge(self, syms: list[int]) -> list[int]:
        n = len(syms)
        if n < 2:
            return syms
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        merges = self.merges
        heap = []
        for i in range(n - 1):
            m = merges.get((syms[i], syms[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = merges.get((syms[pos], syms[right]))
            if m is None or m[1] != new_id:
                continue  # an expired entry
            syms[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prv[nxt[pos]] = pos
            if prv[pos] >= 0:
                m = merges.get((syms[prv[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] < n:
                m = merges.get((new_id, syms[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(syms, alive) if a]


class Unigram:
    """The Unigram model: the best-scoring segmentation of a piece into
    vocabulary entries (Viterbi, sums of the entries' scores; a character
    no entry starts with costs the lowest score less 10 as ``unk``; ties
    keep the shorter entry found first), runs of unk fused, an entry-less
    unk piece spelled in ``<0xNN>`` bytes under ``byte_fallback``."""

    UNK_PENALTY = 10.0

    def __init__(self, model: dict) -> None:
        vocab = model["vocab"]
        self.pieces = [str(p) for p, _ in vocab]
        self.scores = [float(s) for _, s in vocab]
        self.ids = {p: i for i, p in enumerate(self.pieces)}
        self.unk_id = model.get("unk_id")
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.min_score = min(self.scores, default=0.0)
        # A character trie: node = (children, id of the entry ending here).
        self._trie: dict = {}
        for i, p in enumerate(self.pieces):
            node = self._trie
            for c in p:
                node = node.setdefault(c, {})
            node[""] = i

    def tokenize(self, piece: str) -> list[int]:
        n = len(piece)
        if n == 0:
            return []
        unk_score = self.min_score - self.UNK_PENALTY
        score = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        best = [0] * (n + 1)
        scores, trie = self.scores, self._trie
        for i in range(n):
            here = score[i]
            node = trie
            single = False
            j = i
            while j < n:
                node = node.get(piece[j])
                if node is None:
                    break
                j += 1
                idx = node.get("")
                if idx is not None:
                    cand = scores[idx] + here
                    if start[j] < 0 or cand > score[j]:
                        score[j], start[j], best[j] = cand, i, idx
                    if j == i + 1:
                        single = True
            if not single:
                if self.unk_id is None:
                    raise UnsupportedTokenizer("Unigram without an unk_id met an unknown piece")
                cand = unk_score + here
                if start[i + 1] < 0 or cand > score[i + 1]:
                    score[i + 1], start[i + 1], best[i + 1] = cand, i, self.unk_id
        # Back from the end; runs of unk become one string.
        strings: list[str] = []
        unk_run: list[str] = []
        end = n
        while end > 0:
            s = start[end]
            if best[end] == self.unk_id:
                unk_run.append(piece[s:end])
            else:
                if unk_run:
                    strings.append("".join(reversed(unk_run)))
                    unk_run = []
                strings.append(piece[s:end])
            end = s
        if unk_run:
            strings.append("".join(reversed(unk_run)))
        ids: list[int] = []
        for s in reversed(strings):
            idx = self.ids.get(s)
            if idx is None:
                fallback = _byte_tokens(s, self.ids) if self.byte_fallback else None
                if fallback is not None:
                    ids.extend(fallback)
                    continue
                idx = self.unk_id
            ids.append(idx)
        return ids


class WordPiece:
    """Greedy longest-match-first WordPiece: a word over
    ``max_input_chars_per_word`` characters, or one whose rest no entry
    (``##``-prefixed after the first) starts, is one unk."""

    def __init__(self, model: dict) -> None:
        self.vocab: dict[str, int] = {str(k): int(v) for k, v in model["vocab"].items()}
        self.unk = model.get("unk_token", "[UNK]")
        self.prefix = model.get("continuing_subword_prefix", "##")
        self.max_chars = int(model.get("max_input_chars_per_word", 100))
        if self.unk not in self.vocab:
            raise UnsupportedTokenizer(f"unk token {self.unk!r} outside the vocabulary")
        self.longest = max((len(t) for t in self.vocab), default=1)

    def tokenize(self, word: str) -> list[int]:
        if len(word) > self.max_chars:
            return [self.vocab[self.unk]]
        ids, start, n = [], 0, len(word)
        while start < n:
            end = min(n, start + self.longest)
            found = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = self.prefix + sub
                found = self.vocab.get(sub)
                if found is not None:
                    break
                end -= 1
            if found is None:
                return [self.vocab[self.unk]]
            ids.append(found)
            start = end
        return ids


def model_for(spec: dict):
    kind = spec.get("type")
    if kind == "BPE":
        return CharBPE(spec)
    if kind == "Unigram":
        return Unigram(spec)
    if kind == "WordPiece":
        return WordPiece(spec)
    raise UnsupportedTokenizer(f"model type {kind!r}")


# -- decoders: token strings -> text -------------------------------------


def _byte_fallback(tokens: list[str]) -> list[str]:
    out: list[str] = []
    run: list[int] = []

    def flush():
        if run:
            try:
                out.append(bytes(run).decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in run)
            run.clear()

    for t in tokens:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                run.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(t)
    flush()
    return out


def _strip(content: str, start: int, stop: int):
    def one(t: str) -> str:
        a = 0
        while a < min(start, len(t)) and t[a] == content:
            a += 1
        b = len(t)
        for _ in range(stop):
            if b > a and t[b - 1] == content:
                b -= 1
            else:
                break
        return t[a:b]

    return lambda tokens: [one(t) for t in tokens]


def _metaspace_decode(replacement: str, scheme: str):
    def dec(tokens: list[str]) -> list[str]:
        return [t.replace(replacement, "" if i == 0 and scheme != "never" else " ")
                for i, t in enumerate(tokens)]

    return dec


def wordpiece_cleanup(text: str) -> str:
    """``tokenizers``' WordPiece cleanup (applied a token at a time)."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"),
                 (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _wordpiece_decode(prefix: str, cleanup: bool):
    def dec(tokens: list[str]) -> list[str]:
        out = []
        for i, t in enumerate(tokens):
            if i:
                t = t[len(prefix):] if t.startswith(prefix) else " " + t
            out.append(wordpiece_cleanup(t) if cleanup else t)
        return out

    return dec


def decoder(spec: Optional[dict], translate: Callable[[str], str]):
    """The decoder chain of ``spec``: token strings → token strings (the
    caller joins them)."""
    if spec is None:
        raise UnsupportedTokenizer("no decoder")
    kind = spec.get("type")
    if kind == "Sequence":
        stages = [decoder(s, translate) for s in spec.get("decoders", [])]

        def seq(tokens: list[str]) -> list[str]:
            for f in stages:
                tokens = f(tokens)
            return tokens

        return seq
    if kind == "Replace":
        rx, content = _pattern(spec["pattern"], translate), spec["content"]
        return lambda tokens: [rx.sub(lambda _m: content, t) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        return _strip(spec["content"], int(spec.get("start", 0)), int(spec.get("stop", 0)))
    if kind == "Metaspace":
        return _metaspace_decode(spec.get("replacement", SPACE), metaspace_scheme(spec))
    if kind == "WordPiece":
        return _wordpiece_decode(spec.get("prefix", "##"), bool(spec.get("cleanup", True)))
    raise UnsupportedTokenizer(f"decoder {kind!r}")
