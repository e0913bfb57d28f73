"""The port's ``tokenizer.json`` reader on the files beyond byte-level BPE —
SentencePiece-style BPE (Llama-2's normalizers and decoder sequence,
Mistral's ``Metaspace``, Gemma's), Unigram (T5) and WordPiece (BERT) —
against the reference's ``tokenizer_from_config``, which loads the same
directory with ``transformers``.

The files are trained here, offline, with ``tokenizers`` on the repo's
README, small vocabularies so that rare characters take the byte fallback
(``<0x00>``..``<0xFF>`` put into the BPE vocabularies as Llama-2's are)
or the unk piece. On a corpus of README lines and cases with accents,
CJK, emoji, control characters, runs of whitespace, newlines, the empty
string, words over 100 characters and special tokens written in the
text, the ``encode`` ids, the ``decode`` text (of those ids and of
seeded id sequences) and the special ids equal the reference's;
``decode(encode(x)) == x`` on the byte-fallback file; and a file with a
``Precompiled`` normalizer still falls back to the byte tokenizer with
the logged error.
"""

from __future__ import annotations

import io
import json
import random
from pathlib import Path

import pytest

from gofr_tpu.config import MockConfig as RefMockConfig
from gofr_tpu.serving.tokenizer import tokenizer_from_config as ref_tokenizer_from_config
from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.logging import Level, Logger
from gofr_tpu_torch.serving.hf_tokenizer import HFTokenizer, UnsupportedTokenizer
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer, tokenizer_from_config

pytest.importorskip("tokenizers")
pytest.importorskip("transformers")

README = Path(__file__).resolve().parents[1] / "README.md"
EXTRA = [
    "", " ", "   ", "a", "Hello, World! It's 5pm — isn't it?", "café naïve Ærøskøbing résumé",
    "İstanbul straße ǅ ﬁ", "日本語のテキスト 中文字符 한국어", "emoji 🙂👍🏽 🚀✨ and ZWJ 👩‍💻",
    "tabs\t\tand  double  spaces   here", "line one\nline two\n\nline four\r\n",
    "x" * 150, "supercalifragilistic" * 8, "a" * 101 + " b", "ctrl\x00a\x07b\x1fc​d",
    "  leading and trailing  ", "<s> written </s> specials <unk>", "[CLS] bert [SEP] [MASK]",
    "<extra_id_5> sentinel <pad>", "▁already▁metaspaced", "<0x41> literal byte token",
    "punct!?.,;:'\"()[]{}<>/\\|@#$%^&*_+=~`", "digits 12345 3.14159 1e-9",
]


def _corpus(n: int = 120) -> list[str]:
    lines = [ln for ln in README.read_text().split("\n") if ln.strip()]
    rng = random.Random(0)
    return EXTRA + rng.sample(lines, min(n, len(lines)))


def _add_byte_tokens(path: Path, first_id: int) -> None:
    """``<0x00>``..``<0xFF>`` as ordinary vocabulary entries at ids
    ``first_id``.., the trained entries after them (Llama-2's layout)."""
    spec = json.loads(path.read_text())
    vocab = spec["model"]["vocab"]
    new = {t: (i if i < first_id else i + 256) for t, i in vocab.items()}
    new.update({f"<0x{b:02X}>": first_id + b for b in range(256)})
    spec["model"]["vocab"] = dict(sorted(new.items(), key=lambda kv: kv[1]))
    path.write_text(json.dumps(spec, ensure_ascii=False))


def _build(kind: str, out: Path) -> Path:
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, processors
    from tokenizers import trainers

    lines = README.read_text().split("\n")
    d = out / kind
    d.mkdir()
    config: dict = {}
    if kind in ("llama2", "mistral", "gemma"):
        specials = {"gemma": ["<pad>", "<eos>", "<bos>", "<unk>"]}.get(
            kind, ["<unk>", "<s>", "</s>"])
        tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
        if kind == "llama2":
            tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                                   normalizers.Replace(" ", "▁")])
            tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                             decoders.Fuse(), decoders.Strip(" ", 1, 0)])
        elif kind == "gemma":
            tok.normalizer = normalizers.Replace(" ", "▁")
            tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                             decoders.Fuse()])
        else:
            tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first",
                                                         split=False)
            tok.decoder = decoders.Sequence([decoders.ByteFallback(), decoders.Metaspace(
                replacement="▁", prepend_scheme="first", split=False)])
        tok.train_from_iterator(lines, trainers.BpeTrainer(
            vocab_size=420, special_tokens=specials, limit_alphabet=70))
        bos = "<bos>" if kind == "gemma" else "<s>"
        tok.post_processor = processors.TemplateProcessing(
            single=f"{bos} $A", pair=f"{bos} $A {bos} $B",
            special_tokens=[(bos, tok.token_to_id(bos))])
        tok.save(str(d / "tokenizer.json"))
        _add_byte_tokens(d / "tokenizer.json", len(specials))
        config = ({"tokenizer_class": "GemmaTokenizerFast"} if kind == "gemma" else
                  {"tokenizer_class": "LlamaTokenizerFast", "bos_token": "<s>",
                   "eos_token": "</s>", "unk_token": "<unk>", "add_bos_token": True,
                   "add_eos_token": kind == "mistral"})
    elif kind in ("unigram", "t5_extra", "precompiled"):
        tok = Tokenizer(models.Unigram())
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.WhitespaceSplit(),
            pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always", split=True)])
        tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always", split=True)
        tok.train_from_iterator(lines, trainers.UnigramTrainer(
            vocab_size=600, special_tokens=["<pad>", "</s>", "<unk>"], unk_token="<unk>"))
        tok.post_processor = processors.TemplateProcessing(
            single="$A </s>", pair="$A </s> $B </s>",
            special_tokens=[("</s>", tok.token_to_id("</s>"))])
        tok.save(str(d / "tokenizer.json"))
        config = {"tokenizer_class": "T5TokenizerFast"}
        if kind != "t5_extra":
            config["extra_ids"] = 0
        if kind == "precompiled":
            spec = json.loads((d / "tokenizer.json").read_text())
            spec["normalizer"] = {"type": "Sequence", "normalizers": [
                {"type": "Precompiled", "precompiled_charsmap": "AAAA"}]}
            (d / "tokenizer.json").write_text(json.dumps(spec))
    else:  # wordpiece
        tok = Tokenizer(models.WordPiece(unk_token="[UNK]", max_input_chars_per_word=100))
        tok.normalizer = normalizers.BertNormalizer(lowercase=kind == "wordpiece")
        tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
        tok.decoder = decoders.WordPiece(prefix="##")
        tok.train_from_iterator(lines, trainers.WordPieceTrainer(
            vocab_size=700, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]))
        tok.post_processor = processors.TemplateProcessing(
            single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
            special_tokens=[("[CLS]", tok.token_to_id("[CLS]")),
                            ("[SEP]", tok.token_to_id("[SEP]"))])
        tok.save(str(d / "tokenizer.json"))
        config = {"tokenizer_class": "BertTokenizerFast", "do_lower_case": True,
                  "clean_up_tokenization_spaces": True}
        if kind == "wordpiece_cased":
            # The file lowercases nothing; the class's do_lower_case (True)
            # rebuilds its normalizer.
            config = {"tokenizer_class": "BertTokenizer"}
    (d / "tokenizer_config.json").write_text(json.dumps(config))
    return d


KINDS = ["llama2", "mistral", "gemma", "unigram", "t5_extra", "wordpiece", "wordpiece_cased"]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    return {kind: _build(kind, root) for kind in KINDS + ["precompiled"]}


def _pair(directory: Path):
    port = HFTokenizer(str(directory))
    ref = ref_tokenizer_from_config(RefMockConfig({"TPU_TOKENIZER": str(directory)}))
    assert type(ref).__name__ == "_HF"
    return port, ref


@pytest.mark.parametrize("kind", KINDS)
def test_ids_and_decodes_equal_transformers(built, kind):
    """encode ids, decode text and the special ids equal the reference's
    on the whole corpus."""
    port, ref = _pair(built[kind])
    assert not port.byte_level
    assert (port.bos_id, port.eos_id, port.pad_id) == (ref.bos_id, ref.eos_id, ref.pad_id)
    for text in _corpus():
        want = ref.encode(text)
        got = port.encode(text)
        assert got == want, text
        assert port.decode(got) == ref.decode(want), text


@pytest.mark.parametrize("kind", KINDS)
def test_decodes_of_seeded_id_sequences_equal_transformers(built, kind):
    """decode of random id sequences (specials, lone and reordered
    ``<0xNN>`` bytes, ``##`` pieces first, ids past the vocabulary)."""
    port, ref = _pair(built[kind])
    rng = random.Random(1)
    top = port.vocab_size + 3
    for _ in range(200):
        ids = [rng.randrange(top) for _ in range(rng.randrange(0, 12))]
        assert port.decode(ids) == ref.decode(ids), ids


def test_byte_fallback_round_trips(built):
    """On the Llama-2-style file (byte fallback) every corpus line without a
    special token or a ``▁`` written in it comes back as it went in;
    characters outside the vocabulary took ``<0xNN>`` pieces."""
    port, ref = _pair(built["llama2"])
    byte_ids = {port.vocab[f"<0x{b:02X}>"] for b in range(256)}
    seen_bytes = False
    for text in _corpus():
        if any(t in text for t in ("<s>", "</s>", "<unk>", "▁")):
            continue  # decode skips specials and reads ▁ as a space
        ids = port.encode(text)
        seen_bytes |= bool(byte_ids & set(ids))
        assert port.decode(ids) == text, text
    assert seen_bytes


def test_precompiled_falls_back_with_the_logged_error(built):
    """A file with the ``Precompiled`` normalizer (real T5 files carry one)
    raises naming ROADMAP item 6.4, and ``tokenizer_from_config`` serves
    the byte tokenizer with the error logged."""
    with pytest.raises(UnsupportedTokenizer, match="Precompiled.*item 6.4"):
        HFTokenizer(str(built["precompiled"]))
    err = io.StringIO()
    logger = Logger(level=Level.INFO, out=io.StringIO(), err=err, is_terminal=False)
    tok = tokenizer_from_config(MockConfig({"TPU_TOKENIZER": str(built["precompiled"])}), logger)
    assert isinstance(tok, ByteTokenizer)
    assert "could not load tokenizer" in err.getvalue() and "Precompiled" in err.getvalue()


def test_t5_extra_ids_are_added_after_the_vocabulary(built):
    """T5's 100 ``<extra_id_N>`` sentinels, absent from the file, get ids
    after the vocabulary as transformers adds them, and are special."""
    port, ref = _pair(built["t5_extra"])
    text = "<extra_id_0> fill <extra_id_99> in"
    assert port.encode(text) == ref.encode(text)
    sentinel = port.encode("<extra_id_0>")[0]
    assert sentinel >= len(port.vocab) and port.decode([sentinel]) == ""
