"""HF safetensors checkpoints through the port's loader
(``gofr_tpu_torch/serving/hf_loader.py``) against the reference's
``load_hf_llama``: for each of the seven model types a tiny ``transformers``
model is saved with ``safe_serialization=True`` (as tests/test_hf_loader.py
does; in f32, bf16 or f16 files, tied and untied heads), and the port's
parameters equal ``params_from_jax`` of the reference's, bit for bit, in
bf16, int8 and int4. Also the reference's errors, the sliding-window
warning and the untied GPT-2 head. ``from_config`` and the port's own
safetensors reader: tests/test_torch_hf_serving.py.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")

from gofr_tpu.serving import hf_loader as ref_loader  # noqa: E402
from gofr_tpu_torch.ops.quant import is_quantized  # noqa: E402
from gofr_tpu_torch.serving import hf_loader  # noqa: E402
from gofr_tpu_torch.weights import params_from_jax  # noqa: E402
from tests.test_torch_model import _np_tree  # noqa: E402

SMALL = dict(vocab_size=128, num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=128)
# model_type → (config, model class, weights dtype in the file).
MODELS = {
    "llama": (lambda: transformers.LlamaConfig(
        hidden_size=64, intermediate_size=128, num_key_value_heads=2, rms_norm_eps=1e-6,
        tie_word_embeddings=False, **SMALL), "LlamaForCausalLM", torch.bfloat16),
    "mistral": (lambda: transformers.MistralConfig(
        hidden_size=64, intermediate_size=128, num_key_value_heads=2, sliding_window=32,
        tie_word_embeddings=True, **SMALL), "MistralForCausalLM", torch.float32),
    "mixtral": (lambda: transformers.MixtralConfig(
        hidden_size=64, intermediate_size=128, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, tie_word_embeddings=False, **SMALL),
        "MixtralForCausalLM", torch.bfloat16),
    "qwen2": (lambda: transformers.Qwen2Config(
        hidden_size=64, intermediate_size=128, num_key_value_heads=2,
        tie_word_embeddings=False, **SMALL), "Qwen2ForCausalLM", torch.float16),
    "gemma": (lambda: transformers.GemmaConfig(
        hidden_size=64, intermediate_size=128, num_key_value_heads=2, head_dim=32,
        hidden_act="gelu_pytorch_tanh", hidden_activation="gelu_pytorch_tanh", **SMALL),
        "GemmaForCausalLM", torch.float32),
    "gpt_neox": (lambda: transformers.GPTNeoXConfig(
        hidden_size=64, intermediate_size=128, rotary_pct=0.25, hidden_act="gelu",
        tie_word_embeddings=False, **SMALL), "GPTNeoXForCausalLM", torch.float32),
    "gpt2": (lambda: transformers.GPT2Config(
        vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=128),
        "GPT2LMHeadModel", torch.float32),
}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """model_type → the directory of a saved tiny model."""
    out = {}
    for i, (kind, (make, cls, dtype)) in enumerate(MODELS.items()):
        path = tmp_path_factory.mktemp(f"hf-{kind}")
        torch.manual_seed(i)
        model = getattr(transformers, cls)(make()).eval()
        model.to(dtype).save_pretrained(path, safe_serialization=True)
        out[kind] = str(path)
    return out


def _assert_params_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert type(g) is type(w), k
        pairs = ((g.q, w.q), (g.s, w.s)) if is_quantized(w) else ((g, w),)
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert torch.equal(a, b), k


@pytest.mark.parametrize("quant", ["", "int8", "int4"], ids=["bf16", "int8", "int4"])
@pytest.mark.parametrize("kind", MODELS)
def test_loader_matches_reference_bit_for_bit(checkpoints, kind, quant):
    path = checkpoints[kind]
    ref_cfg, cfg = ref_loader.config_from_hf(path), hf_loader.config_from_hf(path)
    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), f.name
    assert cfg.dtype == torch.bfloat16 and hf_loader.is_hf_checkpoint(path)
    want = params_from_jax(_np_tree(ref_loader.load_hf_llama(path, ref_cfg, quant=quant)), cfg,
                           device="cpu")
    got = hf_loader.load_hf_llama(path, cfg, quant=quant, device="cpu")
    _assert_params_equal(got, want)
    assert hf_loader.params_quant_mode(got) == quant
    assert hf_loader.params_have_q8(got) == (quant == "int8")


def test_reference_errors_word_for_word(checkpoints, tmp_path):
    """Config mismatch, an unsupported model_type, a max_len past GPT-2's
    position table, a directory with no *.safetensors, T5's loader on a
    decoder's directory; and the port's own refusals (mesh=, a tensor
    dtype its reader does not take)."""
    def both(ref_call, port_call, exc):
        with pytest.raises(exc) as want:
            ref_call()
        with pytest.raises(exc) as got:
            port_call()
        assert str(got.value) == str(want.value)

    path = checkpoints["llama"]
    ref_cfg, cfg = ref_loader.config_from_hf(path), hf_loader.config_from_hf(path)
    both(lambda: ref_loader.load_hf_llama(path, dataclasses.replace(ref_cfg, d_model=32)),
         lambda: hf_loader.load_hf_llama(path, dataclasses.replace(cfg, d_model=32),
                                         device="cpu"), ValueError)
    both(lambda: ref_loader.load_hf_llama(path, ref_cfg, quant="int3"),
         lambda: hf_loader.load_hf_llama(path, cfg, quant="int3", device="cpu"), ValueError)
    odd = tmp_path / "t5"
    odd.mkdir()
    (odd / "config.json").write_text('{"model_type": "t5"}')
    both(lambda: ref_loader.config_from_hf(str(odd)), lambda: hf_loader.config_from_hf(str(odd)),
         ValueError)
    g2 = checkpoints["gpt2"]
    both(lambda: ref_loader.load_hf_llama(g2, dataclasses.replace(
        ref_loader.config_from_hf(g2), max_len=4096)),
         lambda: hf_loader.load_hf_llama(g2, dataclasses.replace(
             hf_loader.config_from_hf(g2), max_len=4096), device="cpu"), ValueError)
    empty = tmp_path / "empty"
    empty.mkdir()
    shutil.copy(os.path.join(path, "config.json"), empty / "config.json")
    both(lambda: ref_loader.load_hf_llama(str(empty), ref_cfg),
         lambda: hf_loader.load_hf_llama(str(empty), cfg, device="cpu"), FileNotFoundError)
    assert not hf_loader.is_hf_checkpoint(str(tmp_path / "nowhere"))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        hf_loader.load_hf_llama(path, cfg, mesh=object(), device="cpu")
    # T5's loader (ported) on a decoder's directory: the reference's refusal.
    from gofr_tpu.models.t5 import load_hf_t5 as ref_load_hf_t5

    both(lambda: ref_load_hf_t5(path), lambda: hf_loader.load_hf_t5(path, device="cpu"),
         ValueError)
    from safetensors.numpy import save_file
    save_file({"x": np.zeros((2, 2), np.uint16)}, str(tmp_path / "u16.safetensors"))
    with pytest.raises(ValueError, match="dtype U16"):
        hf_loader.SafetensorsFile(str(tmp_path / "u16.safetensors"))


def test_sliding_window_mismatch_warns(checkpoints):
    """A window other than the checkpoint's warns (the engine's window
    masks) and loads, as the reference."""
    path = checkpoints["mistral"]
    cfg = dataclasses.replace(hf_loader.config_from_hf(path), sliding_window=0)
    seen = []

    class Log:
        def warnf(self, fmt, *args):
            seen.append(fmt % args)

        def infof(self, fmt, *args):
            pass

    hf_loader.load_hf_llama(path, cfg, logger=Log(), device="cpu")
    assert len(seen) == 1 and "sliding_window mismatch" in seen[0] and "declares 32" in seen[0]


def test_gpt2_untied_head_wins(checkpoints, tmp_path):
    """An untied fine-tune's own lm_head.weight overrides the wte
    transpose (tests/test_hf_loader.py's case, bit for bit against the
    reference)."""
    from safetensors import safe_open
    from safetensors.numpy import save_file

    dst = tmp_path / "untied"
    shutil.copytree(checkpoints["gpt2"], dst)
    st = next(iter(dst.glob("*.safetensors")))
    with safe_open(str(st), framework="numpy") as h:
        tensors = {name: h.get_tensor(name) for name in h.keys()}
    wte = "wte.weight" if "wte.weight" in tensors else "transformer.wte.weight"
    head = np.random.default_rng(7).standard_normal(tensors[wte].shape).astype(np.float32) * 0.02
    tensors["lm_head.weight"] = head
    save_file(tensors, str(st))
    cfg = hf_loader.config_from_hf(str(dst))
    got = hf_loader.load_hf_llama(str(dst), cfg, device="cpu")
    np.testing.assert_array_equal(got["lm_head"].float().numpy(),
                                  torch.from_numpy(head.T.copy()).to(torch.bfloat16).float())
    want = params_from_jax(_np_tree(ref_loader.load_hf_llama(
        str(dst), ref_loader.config_from_hf(str(dst)))), cfg, device="cpu")
    _assert_params_equal(got, want)


def test_leaves_own_their_storage(checkpoints, tmp_path):
    """On the CPU no leaf is a view of the mapped shard file or of another
    leaf: rewriting the file after the load changes no leaf, and a tied
    head (bf16 in the file, so no cast copies it) is not the embedding."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    dst = tmp_path / "tied"
    shutil.copytree(checkpoints["llama"], dst)
    shards = sorted(dst.glob("*.safetensors"))
    for st in shards:
        with safe_open(str(st), framework="pt") as h:
            tensors = {name: h.get_tensor(name) for name in h.keys() if name != "lm_head.weight"}
        save_file(tensors, str(st))
    cfg = hf_loader.config_from_hf(str(dst))
    got = hf_loader.load_hf_llama(str(dst), cfg, device="cpu")
    want = {k: v.clone() for k, v in got.items()}
    for st in shards:
        size = os.path.getsize(st)
        with open(st, "r+b") as f:
            f.write(b"\0" * size)
    _assert_params_equal(got, want)
    storages = [v.untyped_storage().data_ptr() for v in got.values()]
    assert len(set(storages)) == len(storages)
