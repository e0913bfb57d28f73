"""The port's ``tokenizer.json`` reader (``gofr_tpu_torch/serving/
hf_tokenizer``) against the reference's ``tokenizer_from_config``, which
loads the same directory with ``transformers``.

Byte-level BPE tokenizers are trained here, offline, with ``tokenizers``
on the repo's README in the shapes the reader serves — GPT-2
(``ByteLevel`` with its regex, class ``GPT2Tokenizer``; and with the
class from ``config.json``'s ``model_type``), GPT-NeoX (the same file,
``GPTNeoXTokenizer`` with ``special_tokens_map.json`` and BOS/EOS flags),
Llama-3 (``Split`` + ``ByteLevel(use_regex=false)``, ``ignore_merges``, a
BOS template, ``PreTrainedTokenizerFast``; and Llama-3.1's ``Sequence``
post-processor with ``added_tokens_decoder``) and Qwen2 (``NFC``,
``Split``, ``ByteLevel``, no BOS, ``Qwen2Tokenizer``) — with a vocabulary
under ``llama-tiny``'s 512. On a few hundred seeded strings (ASCII, accents,
CJK, emoji, digit runs, contractions in both cases, whitespace and
newline runs, special tokens written in the text) the ``encode`` ids,
the ``decode`` text and the special ids equal the reference's. A bad
path and a SentencePiece-style (``Metaspace``) file fall back to the
byte tokenizer with a logged error, and an engine built ``from_config``
with ``TPU_TOKENIZER`` serves the reference engine's greedy text.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import jax
import numpy as np
import pytest

from gofr_tpu.config import MockConfig as RefMockConfig
from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu.serving.tokenizer import tokenizer_from_config as ref_tokenizer_from_config
from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.hf_tokenizer import (
    HFTokenizer,
    UnsupportedTokenizer,
    translate_pattern,
)
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer, tokenizer_from_config
from gofr_tpu_torch.weights import params_from_jax

pytest.importorskip("tokenizers")
pytest.importorskip("transformers")

README = Path(__file__).resolve().parents[1] / "README.md"
LLAMA3_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
              r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
             r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
SPECIALS = {
    "gpt2": ["<|endoftext|>"],
    "llama3": ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"],
    "qwen2": ["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
}
# case: (trained shape, tokenizer_config.json, other files). Directory
# names are free of model-type words: transformers guesses a class from
# the path when neither tokenizer_config.json nor config.json names one.
CASES = {
    "gpt2": ("gpt2", {"tokenizer_class": "GPT2Tokenizer"}, {}),
    "gpt2_model_type": ("gpt2", {"model_max_length": 1024},
                        {"config.json": {"model_type": "gpt2"}}),
    "neox": ("gpt2", {"tokenizer_class": "GPTNeoXTokenizer", "add_bos_token": True,
                      "add_eos_token": True},
             {"special_tokens_map.json": {"bos_token": "<|endoftext|>",
                                          "eos_token": "<|endoftext|>"}}),
    "llama3": ("llama3", {"tokenizer_class": "PreTrainedTokenizerFast",
                          "bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>",
                          "clean_up_tokenization_spaces": True}, {}),
    "llama31": ("llama31", {"tokenizer_class": "PreTrainedTokenizerFast",
                            "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>"}, {}),
    "qwen2": ("qwen2", {"tokenizer_class": "Qwen2Tokenizer", "bos_token": None,
                        "eos_token": "<|im_end|>"}, {}),
}


def _train(shape: str, out: Path, config: dict, files: dict, vocab: int = 480) -> None:
    from tokenizers import (
        Regex,
        Tokenizer,
        decoders,
        models,
        normalizers,
        pre_tokenizers,
        processors,
        trainers,
    )

    llama = shape in ("llama3", "llama31")
    tok = Tokenizer(models.BPE(ignore_merges=llama))
    if shape == "gpt2":
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    else:
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(LLAMA3_PAT if llama else QWEN2_PAT),
                                 behavior="isolated", invert=False),
            pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
        ])
    if shape == "qwen2":
        tok.normalizer = normalizers.NFC()
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab, special_tokens=SPECIALS["llama3" if llama else shape],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    tok.train_from_iterator(README.read_text().split("\n"), trainer)
    if llama:
        bos = tok.token_to_id("<|begin_of_text|>")
        template = processors.TemplateProcessing(
            single="<|begin_of_text|> $A",
            pair="<|begin_of_text|> $A <|begin_of_text|> $B:1",
            special_tokens=[("<|begin_of_text|>", bos)],
        )
        tok.post_processor = (
            template if shape == "llama3" else
            processors.Sequence([processors.ByteLevel(trim_offsets=False), template]))
    else:
        tok.post_processor = processors.ByteLevel(trim_offsets=False)
    out.mkdir(parents=True, exist_ok=True)
    tok.save(str(out / "tokenizer.json"))
    if shape == "llama31":
        config = dict(config, added_tokens_decoder={
            str(t["id"]): {k: v for k, v in t.items() if k != "id"}
            for t in json.loads((out / "tokenizer.json").read_text())["added_tokens"]})
    (out / "tokenizer_config.json").write_text(json.dumps(config))
    for name, body in files.items():
        (out / name).write_text(json.dumps(body))


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokdirs")
    out = {}
    for i, (case, (shape, config, files)) in enumerate(CASES.items()):
        d = root / f"case_{i}"
        _train(shape, d, config, files)
        out[case] = str(d)
    return out


class _Log:
    def __init__(self):
        self.errors = []

    def errorf(self, fmt, *args):
        self.errors.append(fmt % args)


def _strings(n: int = 300) -> list[str]:
    rng = random.Random(1234)
    pool = ["Hello", "world", " the", "don't", "DON'T", "I'M", "we'll", "They'VE",
            "ça", "naïve", "résumé", "Straße", "日本語", "中文字", "🙂", "👍🏽", "12345",
            "3.14159", "2024", "  ", "\n\n", "\t", " \n ", "\r\n", "   \n", "é",
            "<|endoftext|>", "<|begin_of_text|>", "<|im_end|>", "<|eot_id|>",
            "x" * 7, "-->", "!?", "ſ", "　", "\x1c", "ＡＢＣ", "١٢٣", "é"]
    out = []
    for _ in range(n):
        parts = []
        for _ in range(rng.randrange(1, 10)):
            if rng.random() < 0.7:
                parts.append(rng.choice(pool))
            else:
                parts.append("".join(
                    chr(rng.choice([rng.randrange(32, 127), rng.randrange(0xA0, 0x800),
                                    rng.randrange(0x4E00, 0x9FFF),
                                    rng.randrange(0x1F300, 0x1F6FF)]))
                    for _ in range(rng.randrange(1, 6))))
        out.append(rng.choice(["", " ", "\n"]).join(parts))
    return out + README.read_text().split("\n")[:40]


@pytest.mark.parametrize("case", list(CASES))
def test_ids_text_and_special_ids_equal_the_reference(tok_dirs, case):
    d = tok_dirs[case]
    ref = ref_tokenizer_from_config(RefMockConfig({"TPU_TOKENIZER": d}), _Log())
    log = _Log()
    mine = tokenizer_from_config(MockConfig({"TPU_TOKENIZER": d}), log)
    assert isinstance(mine, HFTokenizer) and not log.errors
    assert mine.is_native
    assert (mine.bos_id, mine.eos_id, mine.pad_id) == (ref.bos_id, ref.eos_id, ref.pad_id)
    for s in _strings():
        ids = ref.encode(s)
        assert mine.encode(s) == ids, s
        assert mine.decode(ids) == ref.decode(ids), s
    # Decoding arbitrary ids (specials, every byte, split UTF-8).
    rng = random.Random(99)
    for _ in range(100):
        ids = [rng.randrange(0, mine.vocab_size) for _ in range(rng.randrange(1, 30))]
        assert mine.decode(ids) == ref.decode(ids), ids


def test_special_ids_follow_the_class_defaults(tok_dirs):
    # GPT-2's class names <|endoftext|> bos, eos and unk; Qwen2's has no
    # bos (the reference's explicit-None rule: -1) and pads with
    # <|endoftext|>; Llama-3's names them in its config and pads with eos.
    gpt2 = HFTokenizer(tok_dirs["gpt2"])
    eot = gpt2.vocab["<|endoftext|>"]
    assert (gpt2.bos_id, gpt2.eos_id, gpt2.pad_id) == (eot, eot, eot)
    qwen = HFTokenizer(tok_dirs["qwen2"])
    assert qwen.bos_id == -1 and qwen.pad_id == qwen.vocab["<|endoftext|>"]
    assert qwen.encode("hi")[0] != qwen.bos_id  # no BOS
    llama = HFTokenizer(tok_dirs["llama3"])
    assert llama.encode("hi")[0] == llama.bos_id
    assert llama.pad_id == llama.eos_id
    # GPT-NeoX's class rebuilds the post-processor from its flags.
    neox = HFTokenizer(tok_dirs["neox"])
    ids = neox.encode("hi")
    assert ids[0] == ids[-1] == eot and len(ids) > 2


def test_python_core_gives_the_native_ids(tok_dirs):
    d = tok_dirs["llama3"]
    native, py = HFTokenizer(d), HFTokenizer(d, prefer_native=False)
    assert native.is_native and not py.is_native
    for s in _strings(60):
        assert py.encode(s) == native.encode(s), s


@pytest.mark.parametrize("pattern,text", [
    (r"\p{L}+", "ab1cé"), (r"[^\s\p{L}\p{N}]+", "a!? b"), (r"\s+(?!\S)", "a   b"),
    (r"\p{N}{1,3}", "12345"),
])
def test_patterns_translate_to_python_classes(pattern, text):
    import re

    rx = re.compile(translate_pattern(pattern))
    assert rx.findall(text)
    # Python's \s takes \x1c, Unicode White_Space does not.
    assert not re.compile(translate_pattern(r"\s")).match("\x1c")
    with pytest.raises(UnsupportedTokenizer):
        translate_pattern(r"\w+")


def test_bad_path_and_metaspace_fall_back_with_an_error(tmp_path):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    log = _Log()
    tok = tokenizer_from_config(MockConfig({"TPU_TOKENIZER": str(tmp_path / "nope")}), log)
    assert isinstance(tok, ByteTokenizer)
    assert len(log.errors) == 1 and "could not load tokenizer" in log.errors[0]

    # A SentencePiece-style file (Llama-2, Mistral-7B, Gemma): Metaspace
    # pre-tokenizer and byte_fallback. The reader serves it now
    # (tests/test_torch_hf_tokenizer_sp.py holds it against transformers);
    # with a Precompiled normalizer (a SentencePiece charsmap) it still
    # falls back with the logged error.
    sp = Tokenizer(models.BPE(byte_fallback=True, unk_token="<unk>"))
    sp.pre_tokenizer = pre_tokenizers.Metaspace()
    sp.decoder = decoders.Metaspace()
    sp.train_from_iterator(README.read_text().split("\n")[:50],
                           trainers.BpeTrainer(vocab_size=300, special_tokens=["<unk>"]))
    d = tmp_path / "sp"
    d.mkdir()
    sp.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(
        json.dumps({"tokenizer_class": "PreTrainedTokenizerFast"}))
    log = _Log()
    tok = tokenizer_from_config(MockConfig({"TPU_TOKENIZER": str(d)}), log)
    assert isinstance(tok, HFTokenizer) and not log.errors
    assert tok.decode(tok.encode("read the file")) == "read the file"
    spec = json.loads((d / "tokenizer.json").read_text())
    spec["normalizer"] = {"type": "Precompiled", "precompiled_charsmap": "AAAA"}
    (d / "tokenizer.json").write_text(json.dumps(spec))
    tok = tokenizer_from_config(MockConfig({"TPU_TOKENIZER": str(d)}), log)
    assert isinstance(tok, ByteTokenizer)
    assert len(log.errors) == 1 and "Precompiled" in log.errors[0]
    with pytest.raises(UnsupportedTokenizer):
        HFTokenizer(str(d))


def test_from_config_engine_serves_the_reference_text(tok_dirs):
    model = "llama-tiny-f32"
    d = tok_dirs["llama3"]
    jp = init_transformer(jax.random.PRNGKey(5), ref_get_model(model).config)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             get_model(model).config, device="cpu")
    keys = {"TPU_MODEL": model, "TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "128",
            "TPU_DECODE_WINDOW": "4", "TPU_PREFILL_CHUNK": "16", "TPU_TOKENIZER": d}
    ref = RefEngine(model, params=jp, n_slots=2, max_len=128, window_k=4,
                    prefill_chunk=16,
                    tokenizer=ref_tokenizer_from_config(RefMockConfig(keys), _Log()))
    ref.start_sync()
    port = InferenceEngine.from_config(MockConfig(dict(keys, TPU_DEVICE="cpu")))
    try:
        assert isinstance(port.tokenizer, HFTokenizer)
        port.params.update(params)  # the reference's weights, in place
        for prompt in ("Hello world, the quick brown fox", "日本語 and 🙂 don't",
                       "<|eot_id|> x 12345"):
            kw = dict(max_new_tokens=10, temperature=0.0, stop_on_eos=False)
            a = ref.generate_sync(prompt, **kw)
            b = port.generate_sync(prompt, **kw)
            assert b.token_ids == a.token_ids, prompt
            assert b.text == a.text
            assert b.prompt_tokens == a.prompt_tokens
    finally:
        port.close()
        ref.stop_sync()
