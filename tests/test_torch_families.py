"""The reference's other dense families through the port's four forwards,
against the reference on the same weights: Gemma (``gemma-tiny``: GeGLU,
``(1 + w)`` RMSNorm, scaled embeddings, an explicit head dim), GPT-NeoX
(``neox-tiny``: LayerNorm with bias, parallel residual, 25% rotary, a
non-gated erf-gelu MLP, biases everywhere), GPT-2 (``gpt2-tiny``: learned
positions, no RoPE), a Qwen2-shaped tiny (QKV bias, 7 query heads over one
KV head) and Gemma's head dim 256 on a narrow config — each in bf16 and as
an f32 twin (``dataclasses.replace`` on both sides; no config is added to
either registry).

Weights come from the reference's ``init_transformer`` with every bias
leaf (zeros at init) replaced by seeded noise, so a dropped or misplaced
bias shows; they cross over through ``params_from_jax``. Tokens, slots and
lengths are made with numpy. The reference runs its dense attention; the
port runs its default dispatch, which on CPU tensors is each kernel's
plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import (
    init_transformer,
    transformer_decode_step,
    transformer_forward as ref_forward,
    transformer_prefill as ref_prefill,
    transformer_prefill_chunk,
)
from gofr_tpu.ops.kv_cache import KVCache as RefKVCache
from gofr_tpu.ops.kv_cache import PagedKVCache as RefPagedKVCache
from gofr_tpu.ops.norms import layer_norm as ref_layer_norm
from gofr_tpu_torch.models.registry import get_model
from gofr_tpu_torch.models.transformer import (
    check_supported,
    decode_step,
    init_params,
    prefill_chunk,
    rope_tables,
    transformer_forward,
    transformer_prefill,
)
from gofr_tpu_torch.ops.kv_cache import KVCache
from gofr_tpu_torch.ops.norms import layer_norm
from gofr_tpu_torch.parallel.sharding import make_train_step
from gofr_tpu_torch.weights import kv_cache_from_jax, params_from_jax, params_to_reference
from tests.test_torch_model import _logical, _np_tree, _ref_logical

# Tiny configs that are not registered: (registered base, replaced fields),
# applied alike to the reference's and the port's config.
VARIANTS = {
    "qwen2-tiny": ("llama-tiny", dict(d_model=224, n_heads=7, n_kv_heads=1,
                                      attn_bias=True, rope_theta=1e6)),
    "gemma-hd256-tiny": ("gemma-tiny", dict(head_dim_override=256)),
}
FAMILIES = ["gemma-tiny", "neox-tiny", "gpt2-tiny", "qwen2-tiny", "gemma-hd256-tiny"]
# f32: the same arithmetic in another order (tests/test_torch_model.py);
# bf16: a few bf16 ulps of logits of magnitude ~1, as for llama-tiny.
# f32 on an int8 cache: the two sides' f32 K differ in the last bits, so a
# value at a rounding midpoint can quantize one step apart (a score moves
# by ~1e-3 then; measured 8e-4 on the hd-256 tiny); the int8 values are
# held within one step.
TOL = {"f32": 1e-4, "bf16": 6e-2, "f32+int8": 5e-3}


def family_configs(name: str, dtype: str = "bf16"):
    """(reference config, port config) of a registered tiny or a VARIANTS
    entry, in bf16 or as its f32 twin."""
    base, fields = VARIANTS.get(name, (name, {}))
    ref_cfg = dataclasses.replace(ref_get_model(base).config, **fields)
    cfg = dataclasses.replace(get_model(base).config, **fields)
    if dtype == "f32":
        ref_cfg = dataclasses.replace(ref_cfg, dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return ref_cfg, cfg


def family_weights(ref_cfg, cfg, seed: int = 3):
    """(reference pytree, port params): ``init_transformer`` with every bias
    leaf set to seeded noise of std 0.1, in the leaf's dtype."""
    rng = np.random.default_rng(seed)
    tree = _np_tree(init_transformer(jax.random.PRNGKey(seed), ref_cfg))

    def noisy(d: dict) -> dict:
        return {k: (rng.normal(0.0, 0.1, v.shape).astype(np.float32).astype(v.dtype)
                    if k.endswith("_b") else v)
                for k, v in d.items()}

    tree = {**noisy({k: v for k, v in tree.items() if k != "layers"}),
            "layers": noisy(tree["layers"])}
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_jax(tree, cfg, device="cpu")


CASES = [pytest.param(n, d, id=f"{n}-{d}") for n in FAMILIES for d in ("bf16", "f32")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 3.0, (3, 5, 64)).astype(np.float32)
    w = rng.normal(1.0, 0.2, 64).astype(np.float32)
    b = rng.normal(0.0, 0.2, 64).astype(np.float32)
    want = np.asarray(ref_layer_norm(*(jnp.asarray(a, dtype) for a in (x, w, b)), 1e-5),
                      np.float32)
    got = layer_norm(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w, b)),
                     1e-5)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("name", FAMILIES + ["gemma-7b", "gemma-2b", "qwen2-7b",
                                             "pythia-6.9b", "gpt2"])
def test_families_are_served_but_not_trained(name):
    """check_supported takes every dense family, and so does
    make_train_step now (it once refused all but the Llama path; the
    training itself is held against the reference in
    tests/test_torch_train_families.py)."""
    cfg = family_configs(name)[1]
    check_supported(cfg)
    init_state, train_step, optimizer = make_train_step(cfg, device="cpu")
    assert callable(init_state) and callable(train_step) and optimizer.learning_rate > 0


@pytest.mark.parametrize("name", ["gemma-tiny", "gpt2-tiny"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_embeddings_match_reference_exactly(name, dtype):
    """The embedding step bit for bit: Gemma's sqrt(d_model) rounded to the
    activation dtype before the multiply (55.5 in bf16 at d 3072; here
    sqrt(128)), GPT-2's learned rows at positions past the table clipped
    to its last row."""
    from gofr_tpu.models.transformer import _embed as ref_embed
    from gofr_tpu_torch.models.transformer import _embed

    ref_cfg, cfg = family_configs(name, dtype)
    jparams, params = family_weights(ref_cfg, cfg)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    positions = np.array([[0, 1, 2, 3, 4, 5], [250, 254, 255, 256, 300, 1000]], np.int32)
    want = np.asarray(ref_embed(jparams, jnp.asarray(tokens), ref_cfg, jnp.asarray(positions)),
                      np.float32)
    got = _embed(params, torch.from_numpy(tokens).long(), cfg,
                 torch.from_numpy(positions).long())
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("fields,why", [
    (dict(d_model=64), "head_dim 16"),
    (dict(d_model=192, n_heads=6, n_kv_heads=2), "n_heads / n_kv_heads = 3"),
], ids=["hd16", "ratio3"])
def test_kernel_shapes_are_refused_for_a_card_only(fields, why):
    """A shape no kernel takes passes on the CPU (the plain versions take
    any) and is refused for a card, naming the kernel, so it never reaches
    a launch; MoE at the same shape is refused alike, and at a shape the
    kernels take it passes everywhere."""
    cfg = dataclasses.replace(get_model("llama-tiny").config, **fields)
    moe = dataclasses.replace(get_model("moe-tiny").config, **fields)
    check_supported(cfg, "cpu")
    check_supported(moe, "cpu")
    for device in (None, "cuda"):
        for c in (cfg, moe):
            with pytest.raises(NotImplementedError, match=why.split()[-1]):
                check_supported(c, device)
        check_supported(get_model("moe-tiny").config, device)


@pytest.mark.parametrize("name,dtype", CASES)
def test_params_round_trip_every_leaf_exactly(name, dtype):
    """params_from_jax then params_to_reference gives back every leaf of the
    reference's pytree, exactly; init_params makes the same leaves and
    shapes."""
    ref_cfg, cfg = family_configs(name, dtype)
    jparams, params = family_weights(ref_cfg, cfg)
    want = _np_tree(jparams)
    back = params_to_reference(params, cfg)
    assert back.keys() == want.keys()
    assert back["layers"].keys() == want["layers"].keys()
    for top in want:
        pairs = want[top].items() if top == "layers" else [(top, want[top])]
        got = back["layers"] if top == "layers" else back
        for k, v in pairs:
            np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), err_msg=k)
    fresh = init_params(cfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    assert all(v.dtype == cfg.dtype for v in fresh.values())


@pytest.mark.parametrize("name,dtype", CASES)
def test_forward_and_padded_prefill_match_reference(name, dtype):
    """transformer_forward's logits at every position, then
    transformer_prefill on a right-padded batch (lengths 20 and 7): the
    last-token logits and the K/V written to the slots."""
    ref_cfg, cfg = family_configs(name, dtype)
    jparams, params = family_weights(ref_cfg, cfg)
    tol = TOL[dtype]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want = np.asarray(ref_forward(jparams, jnp.asarray(tokens), ref_cfg))
    with torch.no_grad():
        got = transformer_forward(params, torch.from_numpy(tokens).long(), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)

    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    lengths, slots = np.array([20, 7], np.int32), np.array([1, 0], np.int32)
    ref_cache = RefKVCache.create(L, 2, 32, KV, hd, dtype=ref_cfg.dtype)
    want, ref_cache = ref_prefill(jparams, jnp.asarray(tokens), jnp.asarray(lengths),
                                  ref_cache, jnp.asarray(slots), ref_cfg)
    cache = KVCache.create(L, 2, 32, KV, hd, dtype=cfg.dtype)
    got = transformer_prefill(params, torch.from_numpy(tokens).long(),
                              torch.from_numpy(lengths), cache, torch.from_numpy(slots), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(ref_cache.lengths))
    for slot, n in ((1, 20), (0, 7)):
        for mine, ref in ((cache.k, ref_cache.k), (cache.v, ref_cache.v)):
            np.testing.assert_allclose(mine[:, slot, :, :n].float().numpy(),
                                       np.asarray(ref[:, slot, :, :n], np.float32),
                                       atol=tol, rtol=tol)


def _assert_cache_close(cache, ref_cache, written):
    """The written K of each (slot, n) against the reference's, through the
    table for a pool: f32 values to 1e-5; int8 values within one step and
    their scales to 1e-3 relative. (Two frameworks' f32 K differ in the
    last bits, so a value at a rounding midpoint may land one step away;
    the next layers' K then move by ~1e-5 relative, measured 2.2e-5 on a
    scale of the hd-256 tiny.)"""
    for slot, n in written:
        k, ks = _logical(cache, slot, n)
        rk, rks = _ref_logical(ref_cache, slot, n)
        if ks is None:
            np.testing.assert_allclose(k.float().numpy(), rk.astype(np.float32),
                                       atol=1e-5, rtol=1e-5)
        else:
            assert np.abs(k.numpy().astype(np.int32) - rk.astype(np.int32)).max() <= 1
            np.testing.assert_allclose(ks.numpy(), rks, rtol=1e-3, atol=0)


def chunk_then_decode_matches_reference(ref_cfg, cfg, jparams, params, variant, tol):
    """Two chunked-prefill steps (slot 2 a full chunk at 0, slot 0 five
    tokens at 0, a padding row; then slot 2 six more at 8 and slot 0 a full
    chunk at 5) then three split decode steps on a slot cache, a B=16 pool
    under a shuffled table, or an int8 cache; the reference's cache state
    (table included) is carried over by ``kv_cache_from_jax``. Logits
    within ``tol``; in f32 the written cache as ``_assert_cache_close``
    holds it."""
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    S, max_len, c, B = 3, 64, 8, 16
    quant = "int8" if variant == "int8" else ""
    rng = np.random.default_rng(2)
    if variant == "pool":
        ref_cache = RefPagedKVCache.create(L, S, max_len, KV, hd, dtype=ref_cfg.dtype,
                                           block=B, n_blocks=S * 4 + 3)
        table = rng.permutation(np.arange(1, S * 4 + 3))[:S * 4].reshape(S, 4)
        ref_cache = ref_cache._replace(block_table=jnp.asarray(table, jnp.int32))
    else:
        ref_cache = RefKVCache.create(L, S, max_len, KV, hd, dtype=ref_cfg.dtype,
                                      quant=quant)
    cache = kv_cache_from_jax(_np_tree(ref_cache), device="cpu")
    exact = cfg.dtype == torch.float32

    rope = rope_tables(cfg, max_len, "cpu")
    for rows, written in ((([2, 0, 2], [0, 0, 0], [8, 5, 8]), ((2, 8), (0, 5))),
                          (([2, 0, 2], [8, 5, 8], [6, 8, 6]), ((2, 14), (0, 13)))):
        tokens = rng.integers(0, cfg.vocab_size, (3, c)).astype(np.int32)
        tokens[2] = tokens[0]
        rows = [np.array(x, np.int32) for x in rows]
        want, ref_cache = transformer_prefill_chunk(
            jparams, jnp.asarray(tokens), ref_cache, *map(jnp.asarray, rows), ref_cfg,
            dense_attn=True)
        got = prefill_chunk(params, torch.from_numpy(tokens).long(), cache,
                            *map(torch.from_numpy, rows), cfg, rope=rope)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
        if exact:
            _assert_cache_close(cache, ref_cache, written)

    lengths = np.array([13, 0, 14], np.int32)
    ref_cache = ref_cache._replace(lengths=jnp.asarray(lengths))
    cache.lengths.copy_(torch.from_numpy(lengths))
    active = np.array([True, False, True])
    for _ in range(3):
        step = rng.integers(0, cfg.vocab_size, (S,)).astype(np.int32)
        want, ref_cache = transformer_decode_step(
            jparams, jnp.asarray(step), ref_cache, jnp.asarray(active), ref_cfg,
            dense_attn=True)
        got = decode_step(params, torch.from_numpy(step).long(), cache,
                          torch.from_numpy(active), cfg, rope=rope)
        np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active],
                                   atol=tol, rtol=tol)
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(ref_cache.lengths))
    if exact:
        _assert_cache_close(cache, ref_cache, ((0, 16), (2, 17)))


@pytest.mark.parametrize("variant", ["slot", "pool", "int8"])
@pytest.mark.parametrize("name,dtype", CASES)
def test_chunk_then_decode_match_reference(name, dtype, variant):
    ref_cfg, cfg = family_configs(name, dtype)
    jparams, params = family_weights(ref_cfg, cfg)
    tol = TOL["f32+int8"] if (dtype, variant) == ("f32", "int8") else TOL[dtype]
    chunk_then_decode_matches_reference(ref_cfg, cfg, jparams, params, variant, tol)
