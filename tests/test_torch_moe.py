"""Mixtral's MoE FFN in the port against the reference on ``moe-tiny``
(4 experts, top 2) and its f32 twin (``dataclasses.replace`` on both sides,
registered under a test-only name only while a test runs): the layout,
the router's ties, the full-sequence forwards and int8/int4 experts here;
prefill chunks and decode steps in tests/test_torch_moe_cache.py, the
engine's greedy streams in tests/test_torch_moe_engine.py.

Tolerances: the f32 twin to 1e-4 (the same arithmetic in another order);
bf16 logits to ``TOL["bf16"]`` of tests/test_torch_families.py (a few bf16
ulps). An expert swap is a step, not a small difference: where the two
frameworks' rounding puts a token's 2nd and 3rd router logits in the
other order, the logits would move by far more than any tolerance. So the
forwards run under ``pinned_routing``: the reference's choices (from
``jax.lax.top_k`` in its ``_ffn_moe``) are recorded, and the port takes
them for a token whose own choice differs only if that token's own gap
between its k-th and (k+1)-th router logit is under ``ROUTER_NEAR_TIE``;
a wider gap fails the test.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import registry as ref_registry
from gofr_tpu.models.transformer import _ffn_moe as ref_ffn_moe
from gofr_tpu.models.transformer import init_transformer
from gofr_tpu.models.transformer import transformer_forward as ref_forward
from gofr_tpu.models.transformer import transformer_prefill as ref_prefill
from gofr_tpu.ops import quant as rq
from gofr_tpu.ops.kv_cache import KVCache as RefKVCache
from gofr_tpu_torch.models import registry
from gofr_tpu_torch.models import transformer
from gofr_tpu_torch.models.transformer import (
    _ffn_moe,
    init_params,
    route,
    transformer_forward,
    transformer_prefill,
)
from gofr_tpu_torch.ops.kv_cache import KVCache
from gofr_tpu_torch.weights import params_from_jax, params_to_reference
from tests.test_torch_families import TOL, family_configs
from tests.test_torch_model import _np_tree

DTYPES = ["bf16", "f32"]
# Router logit gap under which the port may take the reference's experts:
# a few bf16 ulps at the logits' magnitude (2**-6 near 2).
ROUTER_NEAR_TIE = 0.1
# The reference's expert choices, call by call, until the port takes them.
_REF_CHOICES: collections.deque = collections.deque()


def _record_top_k(x, k):
    vals, idx = _REAL_TOP_K(x, k)
    jax.debug.callback(lambda i: _REF_CHOICES.append(np.asarray(i).reshape(-1, k)), idx,
                       ordered=True)
    return vals, idx


_REAL_TOP_K = jax.lax.top_k


@pytest.fixture(scope="module", autouse=True)
def recorded_reference_routing():
    """For this module, the reference's ``jax.lax.top_k`` (in a forward,
    only its ``_ffn_moe`` calls it) also appends its indices to
    ``_REF_CHOICES`` through an ordered debug callback; the jit caches are
    cleared once, so its forwards are traced with the callback."""
    with pytest.MonkeyPatch.context() as mp:
        jax.clear_caches()
        mp.setattr(jax.lax, "top_k", _record_top_k)
        yield
    jax.clear_caches()


@pytest.fixture
def pinned_routing(monkeypatch):
    """The port's ``route`` takes the reference's recorded experts, call by
    call, where its own differ at a near-tie. Yields the list of (tokens
    flipped, largest own gap) per call that flipped."""
    real_route = transformer.route
    flips = []

    def pinned(x, router, k):
        weights, idx = real_route(x, router, k)
        want = torch.from_numpy(_REF_CHOICES.popleft())
        same = (idx.sort(-1).values == want.sort(-1).values).all(-1)
        if bool(same.all()):
            return weights, idx
        logits = (x @ router).float()
        top = logits.sort(-1, descending=True).values
        gap = (top[:, k - 1] - top[:, k])[~same].max().item()
        flips.append((int((~same).sum()), gap))
        assert gap < ROUTER_NEAR_TIE, f"the reference routes a token elsewhere at a gap of {gap}"
        idx = torch.where(same[:, None], idx, want)
        p = torch.softmax(logits, dim=-1).gather(-1, idx)
        return torch.zeros_like(weights).scatter_(-1, idx, p / p.sum(-1, keepdim=True)), idx

    _REF_CHOICES.clear()
    monkeypatch.setattr(transformer, "route", pinned)
    yield flips
    assert not _REF_CHOICES, "the port made fewer routing calls than the reference"


def _weights(ref_cfg, cfg, seed=3, mode=""):
    """(reference pytree, port params) from init_transformer, quantized
    (the reference's jitted quantize_params) with ``mode``."""
    tree = init_transformer(jax.random.PRNGKey(seed), ref_cfg)
    if mode:
        tree = jax.jit(lambda p: rq.quantize_params(p, mode))(tree)
    return tree, params_from_jax(_np_tree(tree), cfg, device="cpu")


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_init_and_params_cross_over_exactly():
    """init_params makes the reference's MoE leaves in the port's layout
    (router [L, D, E], gate|up fused per expert [L, E, D, 2F], w_down
    [L, E, F, D]); params_from_jax → params_to_reference is exact."""
    ref_cfg, cfg = family_configs("moe-tiny")
    tree, params = _weights(ref_cfg, cfg)
    L, D, E, F = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.d_ff
    shapes = {k: tuple(v.shape) for k, v in init_params(cfg, 0, "cpu").items()}
    assert shapes == {k: tuple(v.shape) for k, v in params.items()}
    assert shapes["router"] == (L, D, E) and shapes["w_gate_up"] == (L, E, D, 2 * F)
    assert shapes["w_down"] == (L, E, F, D)
    back = params_to_reference(params, cfg)
    want = _np_tree(tree)
    assert back["layers"].keys() == want["layers"].keys()
    for k, v in want["layers"].items():
        np.testing.assert_array_equal(back["layers"][k], np.asarray(v, np.float32), err_msg=k)


def test_route_breaks_ties_as_jax_top_k():
    """Router columns 1, 3 and 4 equal (so are their logits) and the rest
    zero: every token ties three experts (or the three zero ones) for two
    places. jax.lax.top_k, and so the reference, keeps the lowest indices;
    the port's route picks the same experts with the same weights, where
    torch.topk picks others; the whole MoE FFN then equals the
    reference's."""
    cfg = dataclasses.replace(registry.get_model("moe-tiny").config, n_experts=6,
                              dtype=torch.float32)
    rng = np.random.default_rng(0)
    N, D, E, k = 64, cfg.d_model, 6, 2
    x = rng.normal(size=(N, D)).astype(np.float32)
    router = np.zeros((D, E), np.float32)
    router[:, [1, 3, 4]] = rng.normal(size=(D, 1)) * 0.1
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    want_p, want_i = jax.lax.top_k(probs, k)
    weights, idx = route(torch.from_numpy(x), torch.from_numpy(router), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    assert set(map(tuple, idx.numpy().tolist())) == {(1, 3), (0, 2)}
    np.testing.assert_allclose(weights.gather(-1, idx).numpy(), 0.5, rtol=1e-6)
    p = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(router), dim=-1)
    assert (torch.topk(p, k).indices.sort(-1).values != idx.sort(-1).values).any(), \
        "torch.topk breaks these ties as jax does: the case no longer tells them apart"

    lp = {"router": jnp.asarray(router),
          "w_gate": jnp.asarray(rng.normal(size=(E, D, cfg.d_ff)) * D ** -0.5, jnp.float32),
          "w_up": jnp.asarray(rng.normal(size=(E, D, cfg.d_ff)) * D ** -0.5, jnp.float32),
          "w_down": jnp.asarray(rng.normal(size=(E, cfg.d_ff, D)) * cfg.d_ff ** -0.5,
                                jnp.float32)}
    ref_cfg = dataclasses.replace(ref_registry.get_model("moe-tiny").config, n_experts=6,
                                  dtype=jnp.float32)
    want = np.asarray(ref_ffn_moe(jnp.asarray(x)[None], lp, ref_cfg))[0]
    params = {"router": torch.from_numpy(router)[None],
              "w_gate_up": torch.from_numpy(np.concatenate(
                  [np.asarray(lp["w_gate"]), np.asarray(lp["w_up"])], -1))[None],
              "w_down": torch.from_numpy(np.asarray(lp["w_down"]))[None]}
    got = _ffn_moe(torch.from_numpy(x)[None], params, 0, cfg)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_and_padded_prefill_match_reference(dtype, pinned_routing):
    """transformer_forward at every position, then transformer_prefill of a
    right-padded batch (lengths 20 and 7): logits and the K/V written."""
    ref_cfg, cfg = family_configs("moe-tiny", dtype)
    tree, params = _weights(ref_cfg, cfg)
    tol = TOL[dtype]
    tokens = _tokens((2, 20), cfg.vocab_size)
    want = np.asarray(ref_forward(tree, jnp.asarray(tokens), ref_cfg))
    with torch.no_grad():
        got = transformer_forward(params, torch.from_numpy(tokens).long(), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)

    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    lengths, slots = np.array([20, 7], np.int32), np.array([1, 0], np.int32)
    want, ref_cache = ref_prefill(tree, jnp.asarray(tokens), jnp.asarray(lengths),
                                  RefKVCache.create(L, 2, 32, KV, hd, dtype=ref_cfg.dtype),
                                  jnp.asarray(slots), ref_cfg)
    cache = KVCache.create(L, 2, 32, KV, hd, dtype=cfg.dtype)
    got = transformer_prefill(params, torch.from_numpy(tokens).long(),
                              torch.from_numpy(lengths), cache, torch.from_numpy(slots), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    for slot, n in ((1, 20), (0, 7)):
        np.testing.assert_allclose(cache.k[:, slot, :, :n].float().numpy(),
                                   np.asarray(ref_cache.k[:, slot, :, :n], np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_moe_matches_reference(mode, pinned_routing):
    """The f32 twin with the reference's quantized experts (each expert's
    gate|up and down Q8/Q4, the router plain): the forward's logits
    (chunks and decode steps: tests/test_torch_moe_cache.py)."""
    ref_cfg, cfg = family_configs("moe-tiny", "f32")
    tree, params = _weights(ref_cfg, cfg, mode=mode)
    assert type(params["w_gate_up"]).__name__ == {"int8": "Q8", "int4": "Q4"}[mode]
    assert params["router"].dtype == torch.float32
    tokens = _tokens((2, 16), cfg.vocab_size, seed=2)
    want = np.asarray(ref_forward(tree, jnp.asarray(tokens), ref_cfg))
    with torch.no_grad():
        got = transformer_forward(params, torch.from_numpy(tokens).long(), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL["f32"], rtol=TOL["f32"])
