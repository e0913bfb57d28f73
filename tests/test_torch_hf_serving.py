"""Serving from HF safetensors checkpoints, and the port's own reader:
``from_config`` with ``TPU_CHECKPOINT`` (and ``TPU_QUANT``) in the port and
the reference, on a tiny Llama saved by ``transformers``, gives identical
greedy streams; ``hf_loader.SafetensorsFile`` reads what
``safetensors.safe_open`` reads from files written by ``safetensors.numpy``
and by ``chip_smoke.py``'s writer, whose HF directory ``transformers`` and
the port's loader both load.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")

import chip_smoke  # noqa: E402
from gofr_tpu.config import MockConfig as RefMockConfig  # noqa: E402
from gofr_tpu.models import registry as ref_registry  # noqa: E402
from gofr_tpu.serving import hf_loader as ref_loader  # noqa: E402
from gofr_tpu.serving.engine import InferenceEngine as RefEngine  # noqa: E402
from gofr_tpu_torch.config import MockConfig  # noqa: E402
from gofr_tpu_torch.models import registry  # noqa: E402
from gofr_tpu_torch.models.transformer import init_params, transformer_forward  # noqa: E402
from gofr_tpu_torch.serving import hf_loader  # noqa: E402
from gofr_tpu_torch.serving.engine import InferenceEngine  # noqa: E402
from tests.test_torch_hf_loader import _assert_params_equal  # noqa: E402


@pytest.fixture(scope="module")
def llama_checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("hf-llama")
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rms_norm_eps=1e-6, tie_word_embeddings=False,
    )).eval().save_pretrained(path, safe_serialization=True)
    return str(path)


@pytest.mark.parametrize("quant", ["", "int8"], ids=["bf16", "int8"])
def test_from_config_serves_reference_stream(llama_checkpoint, quant):
    """TPU_CHECKPOINT (+ TPU_QUANT) through both packages' from_config, an
    f32 config registered under a test-only name in both registries:
    identical greedy streams."""
    path = llama_checkpoint
    name = "hf-llama-f32-test"
    ref_cfg = dataclasses.replace(ref_loader.config_from_hf(path), dtype=jnp.float32)
    cfg = dataclasses.replace(hf_loader.config_from_hf(path), dtype=torch.float32)
    keys = {"TPU_MODEL": name, "TPU_CHECKPOINT": path, "TPU_QUANT": quant,
            "TPU_KV_SLOTS": "2", "TPU_MAX_LEN": "128", "TPU_SPEC_TOKENS": "0"}
    gen = dict(max_new_tokens=8, temperature=0.0, stop_on_eos=False)
    prompts = [[1, 5, 9], list(range(3, 20))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ref_registry._REGISTRY, name, ref_registry.ModelSpec(
            name=name, family="llm", config=ref_cfg, init=lambda key, c: (_ for _ in ()).throw(
                AssertionError("the engine must not random-init when params are given"))))
        mp.setitem(registry._REGISTRY, name, registry.ModelSpec(
            name=name, family="llm", config=cfg))
        ref = RefEngine.from_config(RefMockConfig(keys))
        ref.start_sync()
        try:
            want = [ref.generate_sync(p, **gen).token_ids for p in prompts]
        finally:
            ref.stop_sync()
        eng = InferenceEngine.from_config(MockConfig(dict(keys, TPU_DEVICE="cpu")))
        try:
            assert eng.quant == quant
            assert eng.params["embed"].dtype == torch.float32
            got = [eng.generate_sync(p, **gen).token_ids for p in prompts]
        finally:
            eng.close()
    assert got == want and all(len(w) == 8 for w in want)


def _reader_matches_safe_open(path: str) -> None:
    from safetensors import safe_open

    ours = hf_loader.SafetensorsFile(path)
    with safe_open(path, framework="pt") as h:
        assert sorted(ours.keys()) == sorted(h.keys())
        for name in h.keys():
            want, got = h.get_tensor(name), ours.get(name)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert torch.equal(got.reshape(-1).view(torch.uint8),
                               want.reshape(-1).view(torch.uint8)), name


def test_reader_matches_safetensors_package(tmp_path):
    """A file of every dtype the reader takes (bool and f64 included, an
    empty tensor, a scalar, metadata), written by safetensors.numpy: the
    same names, shapes, dtypes and bytes as safe_open reads."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    tensors = {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "f16": rng.normal(size=(7,)).astype(np.float16),
        "f64": rng.normal(size=(2, 2, 2)).astype(np.float64),
        "i64": rng.integers(-9, 9, (4,)).astype(np.int64),
        "i32": rng.integers(-9, 9, (2, 3)).astype(np.int32),
        "i16": rng.integers(-9, 9, (5,)).astype(np.int16),
        "i8": rng.integers(-9, 9, (6,)).astype(np.int8),
        "u8": rng.integers(0, 255, (3, 3)).astype(np.uint8),
        "bool": rng.integers(0, 2, (4,)).astype(bool),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.array(3.5, np.float32),
    }
    path = str(tmp_path / "all.safetensors")
    save_file(tensors, path, metadata={"format": "np"})
    _reader_matches_safe_open(path)


def test_chip_smoke_writer_is_read_alike(tmp_path):
    """chip_smoke.py's own writer (phase_loader's): a bf16/f32/int8 file
    reads the same through safe_open and the port's reader; its HF
    directory of llama-tiny loads back through the port's loader bit for
    bit, and ``transformers`` reads it as a LlamaForCausalLM whose logits
    match the port's forward."""
    rng = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn((4, 6), generator=rng).to(torch.bfloat16),
               "b": torch.randn((3,), generator=rng),
               "c": torch.randint(-100, 100, (2, 5), generator=rng).to(torch.int8),
               "d": torch.randn((5, 3), generator=rng).to(torch.bfloat16).t()}
    path = str(tmp_path / "w.safetensors")
    n = chip_smoke.write_safetensors(path, tensors)
    assert n == os.path.getsize(path)
    _reader_matches_safe_open(path)

    cfg = dataclasses.replace(registry.get_model("llama-tiny").config, vocab_size=256)
    params = init_params(cfg, 3, "cpu")
    d = tmp_path / "hf"
    d.mkdir()
    chip_smoke.write_hf_checkpoint(str(d), params, cfg, shard_bytes=200_000)
    assert len(list(d.glob("*.safetensors"))) > 1
    loaded = hf_loader.load_hf_llama(str(d), cfg, device="cpu")
    _assert_params_equal(loaded, params)
    model = transformers.LlamaForCausalLM.from_pretrained(str(d), torch_dtype=torch.float32)
    tokens = torch.tensor([[1, 5, 9, 2, 7, 3]])
    with torch.no_grad():
        want = model(tokens).logits
        f32 = {k: v.float() for k, v in params.items()}
        got = transformer_forward(f32, tokens, dataclasses.replace(cfg, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)
