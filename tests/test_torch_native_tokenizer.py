"""The port's byte-level BPE (``gofr_tpu_torch/serving/native_tokenizer``)
against the reference's: the reference suite's five cases on the port's
module, ids equal to the reference's ``PyBPE`` and ``NativeBPE`` on the
same files (the reference test's corpus plus seeded random UTF-8), the
build landing atomically in the port's build directory, and an engine
serving ``llama-tiny-f32`` through the port's ``BPETokenizer`` with the
reference engine's greedy text through its own.
"""

from __future__ import annotations

import os
import random

import jax
import numpy as np
import pytest

from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.serving import native_tokenizer as ref_nt
from gofr_tpu.serving.engine import InferenceEngine as RefEngine
from gofr_tpu_torch import build_cache
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.serving import native_tokenizer as nt
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.native_tokenizer import (
    NativeBPE,
    PyBPE,
    build_native,
    byte_vocab_with_merges,
    load_bpe,
    write_bpe_files,
)
from gofr_tpu_torch.weights import params_from_jax

MERGES = [
    (b"t", b"h"),
    (b"th", b"e"),
    (b" ", b"the"),
    (b"i", b"n"),
    (b"a", b"n"),
    (b"an", b"d"),
    (b" ", b"and"),
    (b"e", b"r"),
]


@pytest.fixture(scope="module")
def bpe_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    vocab = byte_vocab_with_merges(MERGES)
    return write_bpe_files(vocab, MERGES, str(d))


def _corpus():
    rng = random.Random(0)
    corpus = [
        b"the quick brown fox jumps over the lazy dog",
        b"and then there were none",
        "héllo wörld — ünïcode".encode("utf-8"),
        b"",
        b"a",
        bytes(rng.randrange(256) for _ in range(512)),
    ]
    # Seeded random UTF-8: ASCII words around the merges, accents, CJK,
    # emoji and whitespace runs.
    alphabet = list("the and in er th an ") + ["é", "ü", "日本", "🙂", "\n\n", "\t"]
    for _ in range(60):
        text = "".join(rng.choice(alphabet) for _ in range(rng.randrange(1, 60)))
        corpus.append(text.encode("utf-8"))
    return corpus


# -- the reference suite's five cases on the port's module ---------------


def test_python_core_merges(bpe_files):
    py = PyBPE(*bpe_files)
    ids = py.encode_bytes(b"the thin and")
    assert py.id_to_token[ids[0]] == b"the"
    assert b" and" in [py.id_to_token[i] for i in ids]
    assert py.decode_bytes(ids) == b"the thin and"


def test_native_builds_and_matches_python(bpe_files):
    so = build_native()
    assert so is not None, "g++ is installed here; the build must succeed"
    nat = NativeBPE(*bpe_files, so_path=so)
    py = PyBPE(*bpe_files)
    assert nat.vocab_size == py.vocab_size
    for data in _corpus():
        assert nat.encode_bytes(data) == py.encode_bytes(data), data
        assert nat.decode_bytes(py.encode_bytes(data)) == data


def test_tokenizer_protocol_roundtrip(bpe_files):
    tok = load_bpe(*bpe_files)
    ids = tok.encode("the thin and")
    assert ids[0] == tok.bos_id
    assert tok.decode(ids + [tok.eos_id, tok.pad_id]) == "the thin and"


def test_fallback_when_native_unavailable(bpe_files, monkeypatch):
    monkeypatch.setattr(nt, "build_native", lambda force=False: None)
    tok = nt.load_bpe(*bpe_files)
    assert not tok.is_native
    assert tok.decode(tok.encode("the end")) == "the end"


def test_native_tokenizer_drives_serving_engine(bpe_files):
    tok = load_bpe(*bpe_files)
    assert tok.is_native
    engine = InferenceEngine("llama-tiny", n_slots=2, max_len=64, tokenizer=tok,
                             device="cpu")
    try:
        out = engine.generate_sync(
            "the and", max_new_tokens=4, temperature=0.0, stop_on_eos=False
        )
        assert len(out.token_ids) == 4
        assert isinstance(out.text, str)
    finally:
        engine.stop_sync()


# -- the port against the reference -------------------------------------


def test_ids_equal_the_reference_cores(bpe_files):
    ref_so = ref_nt.build_native()
    so = build_native()
    assert ref_so is not None and so is not None
    cores = {
        "ref_py": ref_nt.PyBPE(*bpe_files),
        "ref_native": ref_nt.NativeBPE(*bpe_files, so_path=ref_so),
        "py": PyBPE(*bpe_files),
        "native": NativeBPE(*bpe_files, so_path=so),
    }
    for data in _corpus():
        ids = {k: c.encode_bytes(data) for k, c in cores.items()}
        assert len({tuple(v) for v in ids.values()}) == 1, (data, ids)
        dec = {k: c.decode_bytes(ids["ref_py"]) for k, c in cores.items()}
        assert set(dec.values()) == {data}
    ref_tok, tok = ref_nt.load_bpe(*bpe_files), load_bpe(*bpe_files)
    for text in ("the thin and", "héllo", "", "🙂 and the"):
        assert tok.encode(text) == ref_tok.encode(text)
        ids = ref_tok.encode(text) + [ref_tok.eos_id]
        assert tok.decode(ids) == ref_tok.decode(ids)
    assert (tok.bos_id, tok.eos_id, tok.pad_id) == (
        ref_tok.bos_id, ref_tok.eos_id, ref_tok.pad_id)


def test_build_lands_in_the_build_directory_atomically(monkeypatch, tmp_path):
    monkeypatch.setattr(build_cache, "_dir", tmp_path / "cache")
    monkeypatch.setattr(build_cache, "_used", False)
    so = build_native()
    assert so is not None and os.path.dirname(so) == str(tmp_path / "cache")
    assert nt.last_build["compiled"] is True
    # No temporary file is left beside the library, and a second call
    # reuses it without compiling.
    assert os.listdir(tmp_path / "cache") == [os.path.basename(so)]
    assert build_native() == so
    assert nt.last_build["compiled"] is False
    # Once read, the directory is fixed for the process.
    info = build_cache.use_dir(str(tmp_path / "other"))
    assert info["enabled"] is False and "before the first build" in info["error"]
    assert build_cache.use_dir(str(tmp_path / "cache"))["enabled"] is True


def test_engine_serves_the_reference_greedy_text_through_bpe(bpe_files):
    model = "llama-tiny-f32"
    jp = init_transformer(jax.random.PRNGKey(7), ref_get_model(model).config)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             get_model(model).config, device="cpu")
    geometry = dict(n_slots=2, max_len=128, window_k=4, prefill_chunk=16)
    ref_tok, tok = ref_nt.load_bpe(*bpe_files), load_bpe(*bpe_files)
    assert ref_tok.is_native and tok.is_native
    ref = RefEngine(model, params=jp, tokenizer=ref_tok, **geometry)
    ref.start_sync()
    port = InferenceEngine(model, params=params, tokenizer=tok, device="cpu",
                           **geometry)
    try:
        for prompt in ("the thin and the", "héllo and then", "in er an th"):
            kw = dict(max_new_tokens=10, temperature=0.0, stop_on_eos=False)
            a = ref.generate_sync(prompt, **kw)
            b = port.generate_sync(prompt, **kw)
            assert b.token_ids == a.token_ids, prompt
            assert b.text == a.text
    finally:
        port.close()
        ref.stop_sync()
