"""``make_lora_train_step`` against the reference's: three steps from the
same injected factors on the same frozen base (``llama-tiny-f32``, and
that base quantized to int8 — QLoRA), losses within 1e-5 relative and the
factors after each step within 1e-5; the base untouched; gradients through
``FlashAttentionFn`` (the default attention); the train-then-serve loop
(factors trained here serve through ``load_lora`` and reproduce the text
they memorised); and the refusals: MoE and an unknown target with the
reference's messages, a mesh naming ROADMAP item 8; every dense family
builds (held against the reference in tests/test_torch_train_families.py).

The reference's step donates its factors and optimizer state, so its
inputs are fresh arrays made from the same numpy values each time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.ops import quant as ref_quant
from gofr_tpu.parallel.sharding import make_lora_train_step as ref_make_lora_train_step
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.models.transformer import lora_dims
from gofr_tpu_torch.ops.quant import Q8
from gofr_tpu_torch.parallel.sharding import make_lora_train_step
from gofr_tpu_torch.serving.engine import InferenceEngine
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.weights import params_from_jax
from tests.test_torch_model import _np_tree

MODEL = "llama-tiny-f32"
CFG, REF_CFG = get_model(MODEL).config, ref_get_model(MODEL).config
TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
RANK, LR = 4, 1e-3


@pytest.fixture(scope="module")
def tree():
    return init_transformer(jax.random.PRNGKey(3), REF_CFG)


def factors(seed: int = 8) -> dict:
    """{target: (a, b)} f32 numpy: a ~ N(0, 1)/r and, so that every factor
    has a gradient at step 1, b ~ N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in TARGETS:
        d_in, d_out = lora_dims(CFG, t)
        out[t] = (rng.standard_normal((CFG.n_layers, d_in, RANK)).astype(np.float32) / RANK,
                  rng.normal(0.0, 0.05, (CFG.n_layers, RANK, d_out)).astype(np.float32))
    return out


def _tokens(b: int = 2, s: int = 16) -> np.ndarray:
    return np.random.default_rng(4).integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


def _steps_match(ref_base, port_base, n: int = 3) -> None:
    """n steps on both sides from ``factors()``: losses and factors."""
    init = factors()
    tokens = _tokens()
    _, ref_step = ref_make_lora_train_step(REF_CFG, ref_base, RANK, TARGETS, learning_rate=LR)
    ref_lora = {t: (jnp.asarray(a), jnp.asarray(b)) for t, (a, b) in init.items()}
    ref_opt = optax.adamw(LR).init(ref_lora)
    init_state, step = make_lora_train_step(CFG, port_base, RANK, TARGETS, learning_rate=LR,
                                            device="cpu")
    lora, opt = init_state(0)
    for t, (a, b) in init.items():
        lora[t][0].copy_(torch.from_numpy(a))
        lora[t][1].copy_(torch.from_numpy(b))
    for i in range(n):
        want, ref_lora, ref_opt = ref_step(ref_lora, ref_opt, jnp.asarray(tokens))
        got, lora, opt = step(lora, opt, torch.from_numpy(tokens))
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want)), (i, got, want)
        for t in TARGETS:
            for mine, ref in zip(lora[t], ref_lora[t]):
                np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-5, rtol=0,
                                           err_msg=f"step {i + 1} {t}")


def test_lora_steps_match_reference(tree):
    """bf16-free f32 base: three steps equal the reference's; the base
    params are not touched."""
    np_base = _np_tree(tree)
    base = params_from_jax(np_base, CFG, device="cpu")
    before = {k: v.clone() for k, v in base.items()}
    _steps_match(tree, base)
    assert all(torch.equal(base[k], v) for k, v in before.items())


def test_qlora_int8_base_steps_match_reference(tree):
    """The base quantized to int8 by the reference (params_from_jax brings
    the Q8 leaves over bit for bit): the factors train through the
    quantized products as the reference's, and no gradient reaches a Q8."""
    qtree = jax.jit(lambda p: ref_quant.quantize_params(p, "int8"))(tree)
    base = params_from_jax(_np_tree(qtree), CFG, device="cpu")
    assert isinstance(base["wqkv"], Q8)
    _steps_match(qtree, base)


def test_init_state_is_the_usual_init():
    """a ~ N(0, 1)/r from the seed (the same seed, the same draws), b = 0:
    step 0 is the base model; the factors are load_lora's raw dict."""
    base = params_from_jax(_np_tree(init_transformer(jax.random.PRNGKey(0), REF_CFG)), CFG,
                           device="cpu")
    init_state, _ = make_lora_train_step(CFG, base, 8, ("wq", "w_down"), device="cpu")
    (lora, _), (again, _) = init_state(1), init_state(1)
    assert list(lora) == ["wq", "w_down"]
    for t, (a, b) in lora.items():
        d_in, d_out = lora_dims(CFG, t)
        assert a.shape == (CFG.n_layers, d_in, 8) and b.shape == (CFG.n_layers, 8, d_out)
        assert a.dtype == b.dtype == torch.float32 and not b.any()
        assert abs(a.std().item() * 8 - 1.0) < 0.1
        assert torch.equal(a, again[t][0])


def _memorize_tokens() -> list[int]:
    text = b"the quick brown fox jumps over the lazy dog. " * 3
    return list(text[:128])


def test_train_adapter_then_serve():
    """The reference's train-then-serve loop on the port: 60 steps on one
    sequence (loss below half its start, the base tree bit for bit), the
    factors loaded by load_lora, and the adapter's greedy continuation
    reproduces the memorised text where the base's does not."""
    base = params_from_jax(_np_tree(init_transformer(jax.random.PRNGKey(0), REF_CFG)), CFG,
                           device="cpu")
    before = {k: v.clone() for k, v in base.items()}
    init_state, step = make_lora_train_step(CFG, base, 8, learning_rate=3e-3, device="cpu")
    lora, opt = init_state(1)
    toks = torch.tensor([_memorize_tokens()])
    losses = [step(lora, opt, toks)[0].item() for _ in range(60)]
    assert losses[-1] < losses[0] * 0.5
    assert all(torch.equal(base[k], v) for k, v in before.items())
    eng = InferenceEngine(MODEL, n_slots=2, max_len=160, window_k=4, tokenizer=ByteTokenizer(),
                          params=base, lora_slots=1, lora_rank=8, device="cpu")
    try:
        assert eng.load_lora("memorized", lora) == 1
        prompt = bytes(_memorize_tokens()[:20]).decode()
        cont = bytes(_memorize_tokens()[20:36]).decode()
        kw = dict(max_new_tokens=16, temperature=0.0, stop_on_eos=False, timeout=120)
        assert eng.generate_sync(prompt, adapter="memorized", **kw).text == cont
        assert eng.generate_sync(prompt, **kw).text != cont
    finally:
        eng.close()


def test_refusals():
    """MoE and an unknown target: the reference's ValueErrors word for word;
    a mesh: NotImplementedError naming ROADMAP item 8; a family off the
    Llama path is not refused (the reference trains it)."""
    for model, args, msg in (("moe-tiny", (), "LoRA training does not support MoE models"),
                             (MODEL, (("wq", "embed"),), None)):
        errs = []
        for fn, cfg in ((ref_make_lora_train_step, ref_get_model(model).config),
                        (make_lora_train_step, get_model(model).config)):
            with pytest.raises(ValueError) as err:
                fn(cfg, {}, 4, *args)
            errs.append(str(err.value))
        assert errs[0] == errs[1]
        assert msg is None or errs[1] == msg
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 8"):
        make_lora_train_step(CFG, {}, 4, mesh=object(), device="cpu")
    init_state, _ = make_lora_train_step(get_model("neox-tiny").config, {}, 4, device="cpu")
    lora, _ = init_state(0)
    assert list(lora) == ["wq", "wk", "wv", "wo"]
