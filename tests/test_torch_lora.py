"""Multi-LoRA in the port's model layer, against the reference: the four
forwards with a per-row adapter plane (``aids``) on the same weights and
the same adapters, over every target and the dense families whose
projections are fused differently in the port (Q/K/V into ``wqkv``,
gate/up into ``w_gate_up``, NeoX's non-gated MLP with biases, Qwen2's QKV
bias, Gemma's head dim); rows on adapter 0 equal to the port's forward
without adapter leaves bit for bit; ``init_lora``'s errors; the leaves
across ``params_from_jax`` / ``params_to_reference``; and the PEFT loader
(``serving/lora.py``) against the reference's on a directory written here.

Weights come from the reference's ``init_transformer`` (biases noisy, as
in ``test_torch_families``) and adapters from numpy at a seed, slot 0 left
zero (the base), in the reference's ``[L, N, d_in, r]`` / ``[L, N, r,
d_out]`` layout; both reach the port through ``params_from_jax``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import transformer as ref_tf
from gofr_tpu.ops.kv_cache import KVCache as RefKVCache
from gofr_tpu.serving import lora as ref_lora
from gofr_tpu_torch.models import transformer as tf
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.ops.kv_cache import KVCache
from gofr_tpu_torch.serving import lora
from gofr_tpu_torch.weights import params_from_jax, params_to_reference
from tests.test_torch_families import TOL, family_configs, family_weights
from tests.test_torch_model import _np_tree

ALL = tf.LORA_TARGETS
N_ADAPTERS, RANK = 4, 4


def adapter_leaves(ref_cfg, targets, seed: int = 5, scale: float = 0.3,
                   n: int = N_ADAPTERS, rank: int = RANK) -> dict:
    """Reference-layout LoRA leaves (numpy, the config's dtype): slot 0
    zero, slots 1.. normal noise times ``scale``."""
    rng = np.random.default_rng(seed)
    dt = np.asarray(jnp.zeros((), ref_cfg.dtype)).dtype
    out = {}
    for t in targets:
        d_in, d_out = ref_tf.lora_dims(ref_cfg, t)
        for suffix, shape in (("_lora_a", (d_in, rank)), ("_lora_b", (rank, d_out))):
            x = rng.normal(0.0, scale, (ref_cfg.n_layers, n, *shape)).astype(np.float32)
            x[:, 0] = 0.0
            out[t + suffix] = x.astype(dt)
    return out


def with_adapters(name: str, dtype: str, targets, seed: int = 5):
    """(ref cfg, port cfg, reference params with adapters, port params with
    adapters, port params without). The adapters' std is 0.3 in f32 (each
    delta about twice its base product) and 0.1 in bf16 (about a fifth: the
    bf16 tolerance is the one stated for logits of magnitude ~1)."""
    ref_cfg, cfg = family_configs(name, dtype)
    jparams, params = family_weights(ref_cfg, cfg)
    leaves = adapter_leaves(ref_cfg, targets, seed, scale=0.3 if dtype == "f32" else 0.1)
    tree = _np_tree(jparams)
    tree = {**tree, "layers": {**tree["layers"], **leaves}}
    return (ref_cfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree, cfg, device="cpu"), params)


AIDS = np.array([2, 0, 1, 3], np.int32)


def forward_matches_reference(name: str, dtype: str, targets) -> tuple:
    """transformer_forward over four rows on adapters 2, 0, 1, 3: logits
    within the dtype's tolerance (1e-4 in f32) of the reference's with the
    same ``aids``. Returns ``with_adapters``'s tuple and the tokens."""
    ref_cfg, cfg, jparams, params, base = with_adapters(name, dtype, targets)
    tol = TOL[dtype]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)
    want = ref_tf.transformer_forward(jparams, jnp.asarray(tokens), ref_cfg,
                                      aids=jnp.asarray(AIDS))
    with torch.no_grad():
        got = tf.transformer_forward(params, torch.from_numpy(tokens).long(), cfg,
                                     aids=torch.from_numpy(AIDS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    return (ref_cfg, cfg, jparams, params, base), tokens


@pytest.mark.parametrize("target", ALL)
def test_forward_with_one_target_matches_reference(target):
    """Each target alone (its delta on its slice of a fused projection,
    the others' None) on llama-tiny in f32."""
    forward_matches_reference("llama-tiny", "f32", (target,))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forwards_with_aids_match_reference(dtype):
    """All seven targets on llama-tiny through the four forwards."""
    forwards_match_reference("llama-tiny", dtype, ALL)


def forwards_match_reference(name: str, dtype: str, targets) -> None:
    """``forward_matches_reference``, then transformer_prefill on the same
    rows, then two prefill chunks and three decode steps on a slot cache
    whose slots run adapters 3, 0, 2, against the reference's with the
    same adapter planes."""
    (ref_cfg, cfg, jparams, params, _), tokens = forward_matches_reference(
        name, dtype, targets)
    tol = TOL[dtype]
    rng = np.random.default_rng(2)

    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    lengths, slots = np.array([12, 5, 9, 1], np.int32), np.array([1, 0, 3, 2], np.int32)
    ref_cache = RefKVCache.create(L, 4, 32, KV, hd, dtype=ref_cfg.dtype)
    want, _ = ref_tf.transformer_prefill(
        jparams, jnp.asarray(tokens), jnp.asarray(lengths), ref_cache, jnp.asarray(slots),
        ref_cfg, aids=jnp.asarray(AIDS))
    got = tf.transformer_prefill(params, torch.from_numpy(tokens).long(),
                                 torch.from_numpy(lengths), KVCache.create(L, 4, 32, KV, hd,
                                                                          dtype=cfg.dtype),
                                 torch.from_numpy(slots), cfg, aids=torch.from_numpy(AIDS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)

    S, max_len, c = 3, 64, 8
    plane = np.array([3, 0, 2], np.int32)  # each slot's adapter
    ref_cache = RefKVCache.create(L, S, max_len, KV, hd, dtype=ref_cfg.dtype)
    cache = KVCache.create(L, S, max_len, KV, hd, dtype=cfg.dtype)
    rope = tf.rope_tables(cfg, max_len, "cpu")
    for rows in (([2, 0, 1], [0, 0, 0], [8, 5, 7]), ([2, 0, 1], [8, 5, 7], [6, 8, 3])):
        chunk = rng.integers(0, cfg.vocab_size, (3, c)).astype(np.int32)
        rows = [np.array(x, np.int32) for x in rows]
        row_aids = plane[rows[0]]
        want, ref_cache = ref_tf.transformer_prefill_chunk(
            jparams, jnp.asarray(chunk), ref_cache, *map(jnp.asarray, rows), ref_cfg,
            dense_attn=True, aids=jnp.asarray(row_aids))
        got = tf.prefill_chunk(params, torch.from_numpy(chunk).long(), cache,
                               *map(torch.from_numpy, rows), cfg, rope=rope,
                               aids=torch.from_numpy(row_aids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    lengths = np.array([13, 10, 14], np.int32)
    ref_cache = ref_cache._replace(lengths=jnp.asarray(lengths))
    cache.lengths.copy_(torch.from_numpy(lengths))
    active = np.ones(S, bool)
    for _ in range(3):
        step = rng.integers(0, cfg.vocab_size, (S,)).astype(np.int32)
        want, ref_cache = ref_tf.transformer_decode_step(
            jparams, jnp.asarray(step), ref_cache, jnp.asarray(active), ref_cfg,
            dense_attn=True, aids=jnp.asarray(plane))
        got = tf.decode_step(params, torch.from_numpy(step).long(), cache,
                             torch.from_numpy(active), cfg, rope=rope,
                             aids=torch.from_numpy(plane))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("name,dtype", [("llama-tiny", "f32"), ("llama-tiny", "bf16"),
                                        ("neox-tiny", "bf16"), ("qwen2-tiny", "bf16")])
def test_adapter_zero_rows_equal_base_exactly(name, dtype):
    """Rows on adapter 0 equal the port's forwards without adapter leaves
    bit for bit (slot 0's delta is exactly 0), in transformer_forward,
    prefill_chunk and decode_step; rows on another adapter differ."""
    targets = ALL if name != "neox-tiny" else ("wq", "wk", "wv", "wo", "w_up", "w_down")
    _, cfg, _, params, base = with_adapters(name, dtype, targets)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 10))).long()
    aids = torch.tensor([0, 1, 0])
    with torch.no_grad():
        got = tf.transformer_forward(params, tokens, cfg, aids=aids)
        want = tf.transformer_forward(base, tokens, cfg)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        assert not torch.allclose(got[1], want[1], atol=1e-2)

        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        caches = [KVCache.create(L, 3, 32, KV, hd, dtype=cfg.dtype) for _ in range(2)]
        slots, starts = torch.tensor([0, 1, 2]), torch.zeros(3, dtype=torch.int32)
        lens = torch.tensor([10, 10, 10], dtype=torch.int32)
        outs = [tf.prefill_chunk(p, tokens, cache, slots, starts, lens, cfg, aids=a)
                for p, cache, a in ((params, caches[0], aids), (base, caches[1], None))]
        assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][2], outs[1][2])
        for cache in caches:
            cache.lengths.fill_(10)
        step = tokens[:, 0]
        active = torch.ones(3, dtype=torch.bool)
        outs = [tf.decode_step(p, step, cache, active, cfg, aids=a)
                for p, cache, a in ((params, caches[0], aids), (base, caches[1], None))]
        assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][2], outs[1][2])
        for a, b in ((caches[0].k, caches[1].k), (caches[0].v, caches[1].v)):
            assert torch.equal(a[:, 0], b[:, 0]) and torch.equal(a[:, 2], b[:, 2])


def _errors(calls) -> list[str]:
    """The ValueError message of each call."""
    out = []
    for fn in calls:
        with pytest.raises(ValueError) as err:
            fn()
        out.append(str(err.value))
    return out


@pytest.mark.parametrize("name", ["llama-tiny", "neox-tiny", "gemma-tiny", "moe-tiny"])
def test_lora_dims_and_init_lora_match_reference(name):
    """lora_dims per target; init_lora's zero leaves (shapes, dtype, every
    value 0) and its errors word for word: MoE, an unknown target."""
    from gofr_tpu.models.registry import get_model as ref_get_model

    ref_cfg, cfg = ref_get_model(name).config, get_model(name).config
    for t in ALL:
        assert tf.lora_dims(cfg, t) == ref_tf.lora_dims(ref_cfg, t)
    if cfg.is_moe:
        msgs = _errors([lambda: ref_tf.init_lora(ref_cfg, 3, 4),
                        lambda: tf.init_lora(cfg, 3, 4, device="cpu")])
        assert msgs[0] == msgs[1] == "LoRA serving does not support MoE models"
        return
    msgs = _errors([lambda: ref_tf.init_lora(ref_cfg, 3, 4, ("wq", "w_qkv")),
                    lambda: tf.init_lora(cfg, 3, 4, ("wq", "w_qkv"), device="cpu")])
    assert msgs[0] == msgs[1]
    want = ref_tf.init_lora(ref_cfg, 3, 4, ALL)
    got = tf.init_lora(cfg, 3, 4, ALL, device="cpu")
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and got[k].dtype == cfg.dtype
        assert not got[k].any()


def test_lora_leaves_round_trip_exactly():
    """params_from_jax then params_to_reference keeps every LoRA leaf
    unfused and bit for bit, beside the fused base leaves."""
    ref_cfg, cfg, jparams, params, _ = with_adapters("llama-tiny", "bf16", ALL)
    want = _np_tree(jparams)["layers"]
    back = params_to_reference(params, cfg)["layers"]
    for t in ALL:
        for suffix in ("_lora_a", "_lora_b"):
            k = t + suffix
            assert tuple(params[k].shape) == want[k].shape
            np.testing.assert_array_equal(back[k], np.asarray(want[k], np.float32), err_msg=k)
    assert "wqkv" in params and "wq" not in params


# ---------------------------------------------------------------------------
# PEFT checkpoints
# ---------------------------------------------------------------------------

CFG = get_model("llama-tiny-f32").config


def write_peft(path, rank: int, alpha: float, modules: dict, skip_layer: int = -1,
               prefix: str = "base_model.model.model.layers.", seed: int = 9,
               bad_shape: str = "") -> None:
    """A PEFT adapter directory: adapter_config.json and one safetensors
    file of ``lora_A`` [r, d_in] / ``lora_B`` [d_out, r] per layer and
    module (``modules``: PEFT module → target); ``skip_layer`` left out,
    ``bad_shape`` (a target) written with r + 1 rows of A."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    tensors = {}
    for mod, t in modules.items():
        d_in, d_out = tf.lora_dims(CFG, t)
        where = "self_attn" if t in ("wq", "wk", "wv", "wo") else "mlp"
        for i in range(CFG.n_layers):
            if i == skip_layer:
                continue
            ra = rank + 1 if t == bad_shape else rank
            tensors[f"{prefix}{i}.{where}.{mod}.lora_A.weight"] = (
                rng.standard_normal((ra, d_in)).astype(np.float32) * 0.5)
            tensors[f"{prefix}{i}.{where}.{mod}.lora_B.weight"] = (
                rng.standard_normal((d_out, rank)).astype(np.float32) * 0.5)
    (path / "adapter_config.json").write_text(json.dumps({
        "r": rank, "lora_alpha": alpha, "target_modules": list(modules)}))
    save_file(tensors, str(path / "adapter_model.safetensors"))


PEFT_ALL = {"q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
            "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down"}


@pytest.mark.parametrize("prefix", ["base_model.model.model.layers.", "model.layers."])
def test_peft_leaves_equal_reference_bit_for_bit(tmp_path, prefix):
    """r 2 under an engine rank of 4, lora_alpha 8 (scale 4 folded into B),
    all seven modules, layer 1 left out (its factors stay zero): every
    leaf of the port's load_peft_adapter equals the reference's."""
    write_peft(tmp_path, 2, 8.0, PEFT_ALL, skip_layer=1, prefix=prefix)
    want = ref_lora.load_peft_adapter(str(tmp_path), CFG, 4, ALL)
    got = lora.load_peft_adapter(str(tmp_path), CFG, 4, ALL)
    assert got.keys() == want.keys() == set(ALL)
    for t, (a, b) in want.items():
        ga, gb = got[t]
        assert ga.dtype == gb.dtype == torch.float32
        np.testing.assert_array_equal(ga.numpy(), np.asarray(a))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(b))
        assert not ga[1].any() and not gb[1].any()
    assert lora.is_peft_checkpoint(str(tmp_path))
    assert not lora.is_peft_checkpoint(str(tmp_path / "adapter_config.json"))
    assert lora.PEFT_TARGET_MAP == ref_lora.PEFT_TARGET_MAP


@pytest.mark.parametrize("case", ["rank", "module", "not_compiled", "shape", "no_tensors",
                                  "no_files"])
def test_peft_errors_equal_reference(tmp_path, case):
    """The reference's errors, type and message: rank above the engine's,
    a module PEFT names that has no target, a target the engine did not
    compile, a tensor of the wrong shape, a target with no tensor in any
    layer, a directory without safetensors."""
    targets = ("wq", "wv")
    if case == "rank":
        write_peft(tmp_path, 8, 8.0, {"q_proj": "wq"})
    elif case == "module":
        write_peft(tmp_path, 2, 2.0, {"q_proj": "wq"})
        (tmp_path / "adapter_config.json").write_text(json.dumps(
            {"r": 2, "target_modules": ["q_proj", "embed_tokens"]}))
    elif case == "not_compiled":
        write_peft(tmp_path, 2, 2.0, {"q_proj": "wq", "o_proj": "wo"})
    elif case == "shape":
        write_peft(tmp_path, 2, 2.0, {"q_proj": "wq", "v_proj": "wv"}, bad_shape="wv")
    elif case == "no_tensors":
        write_peft(tmp_path, 2, 2.0, {"q_proj": "wq"})
        (tmp_path / "adapter_config.json").write_text(json.dumps(
            {"r": 2, "target_modules": ["q_proj", "v_proj"]}))
    else:
        (tmp_path / "adapter_config.json").write_text(json.dumps(
            {"r": 2, "target_modules": ["q_proj"]}))
    errs = []
    for mod in (ref_lora, lora):
        with pytest.raises(Exception) as err:
            mod.load_peft_adapter(str(tmp_path), CFG, 4, targets)
        errs.append(err)
    assert type(errs[0].value) is type(errs[1].value)
    assert str(errs[0].value) == str(errs[1].value)


@pytest.mark.parametrize("case", ["target", "a_shape", "b_shape"])
def test_validate_adapter_leaves_errors_equal_reference(case):
    """The raw-dict form's checks: a target not compiled in, A or B of the
    wrong shape; the messages word for word."""
    d_in, d_out = tf.lora_dims(CFG, "wq")
    a = np.zeros((CFG.n_layers, d_in, 4), np.float32)
    b = np.zeros((CFG.n_layers, 4, d_out), np.float32)
    leaves = {
        "target": {"wo": (a, b)},
        "a_shape": {"wq": (a[:, :, :3], b)},
        "b_shape": {"wq": (a, b[:, :, :-1])},
    }[case]
    errs = []
    for mod in (ref_lora, lora):
        with pytest.raises(ValueError) as err:
            mod.validate_adapter_leaves(leaves, CFG, 4, ("wq", "wk"))
        errs.append(str(err.value))
    assert errs[0] == errs[1]
    lora.validate_adapter_leaves({"wq": (a, b)}, CFG, 4, ("wq",))
