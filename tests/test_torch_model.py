"""The port's Llama forward (gofr_tpu_torch.models.transformer) against the
reference (gofr_tpu.models.transformer) on the same weights: one chunked
prefill step then three split-softmax decode steps, both on the CPU, on
the bf16/f32 slot cache and — from one reference cache state carried
across by ``kv_cache_from_jax`` — on the int8, paged and paged+int8
caches.

The reference runs its dense attention (``dense_attn=True``); the port
runs its default dispatch, which on CPU tensors is the plain version of
each kernel. Weights come from the reference's ``init_transformer`` and
cross over through ``params_from_jax``; tokens and positions are made
with numpy and handed to both sides.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models.registry import get_model as ref_get_model
from gofr_tpu.models.transformer import (
    init_transformer,
    transformer_decode_step,
    transformer_prefill_chunk,
)
from gofr_tpu.ops.kv_cache import KVCache as RefKVCache
from gofr_tpu.ops.kv_cache import PagedKVCache as RefPagedKVCache
from gofr_tpu_torch.models.registry import get_model, list_models
from gofr_tpu_torch.models.transformer import (
    TransformerConfig,
    check_supported,
    decode_step,
    init_params,
    prefill_chunk,
    rope_tables,
)
from gofr_tpu_torch.ops.kv_cache import KVCache, PagedKVCache, paged_view
from gofr_tpu_torch.weights import kv_cache_from_jax, params_from_jax

REPO = Path(__file__).resolve().parents[1]
# f32: both sides do the same f32 arithmetic in another order (XLA vs
# torch CPU kernels); over 2 layers the logits agree to ~1e-6 relative, so
# 1e-4 absolute is a safe bound that still catches any wrong index or mask.
# bf16: activations round to 8 mantissa bits at different places in the
# two frameworks (fused vs separate projections, XLA's fused elementwise
# ops), so logits of magnitude ~1 differ by a few bf16 ulps (2**-7 each).
TOL = {"llama-tiny-f32": 1e-4, "llama-tiny": 6e-2}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name", ["llama-tiny-f32", "llama-tiny"])
def test_prefill_then_decode_matches_reference(name):
    _prefill_then_decode_matches_reference(name)


@pytest.fixture(scope="module")
def emulated_serving_kernels(tmp_path_factory):
    """The port's ``flash_decode`` and ``flash_cache_attention`` with their
    CUDA kernels run under the CPU emulator of
    ``tests/test_torch_cuda_emulation.py``: bf16 (hd 32) and, for f32
    queries, flash_decode's f32 instantiations and ``csrc/attn_f32.cu``."""
    from tests.test_torch_cuda_emulation import CSRC, _emulate

    lib = _emulate({stem: (CSRC / f"{stem}.cu").read_text()
                    for stem in ("flash_decode", "flash_prefill", "attn_f32")},
                   tmp_path_factory.mktemp("cuda_emu_model"))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def flash_decode(q, k_cache, v_cache, lengths, *, k_new=None, v_new=None, k_scale=None,
                     v_scale=None, block_table=None, scale=None, window=0):
        S, H, hd = q.shape
        out = torch.full_like(q, float("nan"))
        rc = lib.gofr_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            ptr(k_new), ptr(v_new), ptr(k_scale), ptr(v_scale), ptr(block_table),
            out.data_ptr(), S, H, k_cache.shape[1], k_cache.shape[2],
            0 if block_table is None else block_table.shape[1], hd, window,
            int(q.dtype == torch.float32), 2, hd**-0.5 if scale is None else scale, None)
        assert rc == 0
        return out

    def flash_cache_attention(q, k_cache, v_cache, slots, starts, lens, *, k_scale=None,
                              v_scale=None, block_table=None, scale=None, window=0):
        P, c, H, hd = q.shape
        out = torch.full_like(q, float("nan"))
        entry = (lib.gofr_flash_cache_attention_f32 if q.dtype == torch.float32
                 else lib.gofr_flash_cache_attention)
        rc = entry(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), slots.data_ptr(),
                   starts.data_ptr(), lens.data_ptr(), ptr(k_scale), ptr(v_scale),
                   ptr(block_table), out.data_ptr(), P, c, H, k_cache.shape[1],
                   k_cache.shape[2], 0 if block_table is None else block_table.shape[1], hd,
                   window, hd**-0.5 if scale is None else scale, None)
        assert rc == 0
        return out

    return dict(flash_decode=flash_decode, flash_cache_attention=flash_cache_attention)


@pytest.mark.parametrize(
    "name", ["llama-tiny-f32", "llama-tiny", "qwen2-tiny", "gemma-hd256-tiny"])
def test_emulated_kernels_prefill_then_decode_match_reference(
    name, emulated_serving_kernels, monkeypatch
):
    """The same prefill chunk and three split decode steps with the serving
    kernels' CUDA code run under the emulator (f32: flash_decode's f32
    instantiation and the CUDA-core chunk kernel; bf16: hd 32), against the
    reference at the same limits; and the families' new kernel shapes in
    bf16 (tests/test_torch_families.py's tinies, bias leaves seeded noise):
    the Qwen2-shaped tiny's 7 query heads a KV head (flash_decode at ratio
    7, 7 chunk rows a token) and Gemma's head dim 256 (64-key tiles)."""
    import gofr_tpu_torch.ops.attention as port_attention

    for fn, impl in emulated_serving_kernels.items():
        monkeypatch.setattr(port_attention, fn, impl)
    if name in ("llama-tiny-f32", "llama-tiny"):
        _prefill_then_decode_matches_reference(name)
        return
    from tests.test_torch_families import (
        chunk_then_decode_matches_reference,
        family_configs,
        family_weights,
    )

    ref_cfg, cfg = family_configs(name)
    chunk_then_decode_matches_reference(ref_cfg, cfg, *family_weights(ref_cfg, cfg), "slot",
                                        TOL["llama-tiny"])


def _prefill_then_decode_matches_reference(name):
    ref_cfg = ref_get_model(name).config
    cfg = get_model(name).config
    jparams = init_transformer(jax.random.PRNGKey(3), ref_cfg)
    params = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    S, max_len, c = 3, 64, 8
    rng = np.random.default_rng(0)

    # Chunk rows: slot 2 with a full chunk at 0, slot 0 with 5 tokens at
    # 0, and a padding row duplicating row 0.
    tokens = rng.integers(0, cfg.vocab_size, (3, c)).astype(np.int32)
    tokens[2] = tokens[0]
    slots = np.array([2, 0, 2], np.int32)
    starts = np.array([0, 0, 0], np.int32)
    lens = np.array([8, 5, 8], np.int32)

    ref_cache = RefKVCache.create(L, S, max_len, KV, hd, dtype=ref_cfg.dtype)
    ref_logits, ref_cache = transformer_prefill_chunk(
        jparams, jnp.asarray(tokens), ref_cache, jnp.asarray(slots),
        jnp.asarray(starts), jnp.asarray(lens), ref_cfg, dense_attn=True,
    )
    cache = KVCache.create(L, S, max_len, KV, hd, dtype=cfg.dtype)
    rope = rope_tables(cfg, max_len, "cpu")
    logits = prefill_chunk(
        params, torch.from_numpy(tokens).long(), cache,
        torch.from_numpy(slots), torch.from_numpy(starts),
        torch.from_numpy(lens), cfg, rope=rope,
    )
    tol = TOL[name]
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(ref_logits), atol=tol, rtol=tol
    )
    # Written K/V agree at every valid position.
    for slot, n in ((2, 8), (0, 5)):
        np.testing.assert_allclose(
            cache.k[:, slot, :, :n].float().numpy(),
            np.asarray(ref_cache.k[:, slot, :, :n], dtype=np.float32),
            atol=tol, rtol=tol,
        )

    lengths = np.array([5, 0, 8], np.int32)
    ref_cache = ref_cache._replace(lengths=jnp.asarray(lengths))
    cache.lengths.copy_(torch.from_numpy(lengths))
    active = np.array([True, False, True])
    for _ in range(3):
        step_tokens = rng.integers(0, cfg.vocab_size, (S,)).astype(np.int32)
        ref_logits, ref_cache = transformer_decode_step(
            jparams, jnp.asarray(step_tokens), ref_cache,
            jnp.asarray(active), ref_cfg, dense_attn=True,
        )
        logits = decode_step(
            params, torch.from_numpy(step_tokens).long(), cache,
            torch.from_numpy(active), cfg, rope=rope,
        )
        np.testing.assert_allclose(
            logits.numpy()[active], np.asarray(ref_logits)[active],
            atol=tol, rtol=tol,
        )
    np.testing.assert_array_equal(
        cache.lengths.numpy(), np.asarray(ref_cache.lengths)
    )
    for slot, n in ((0, 8), (2, 11)):
        np.testing.assert_allclose(
            cache.v[:, slot, :, :n].float().numpy(),
            np.asarray(ref_cache.v[:, slot, :, :n], dtype=np.float32),
            atol=tol, rtol=tol,
        )


def _logical(cache, slot, n):
    """[L, KV, n, hd] keys (and [L, KV, n] K scales or None) of a port
    cache's slot, gathered through the table for a pool."""
    if isinstance(cache, PagedKVCache):
        rows = torch.tensor([slot])
        ks = [paged_view(cache.block_table, cache.k[l], cache.v[l], rows,
                         *((cache.k_s[l], cache.v_s[l]) if cache.quantized else ()))
              for l in range(cache.k.shape[0])]
        k = torch.stack([x[0][0, :, :n] for x in ks])
        sc = torch.stack([x[2][0, :, :n] for x in ks]) if cache.quantized else None
        return k, sc
    return cache.k[:, slot, :, :n], (cache.k_s[:, slot, :, :n] if cache.quantized else None)


def _ref_logical(cache, slot, n):
    k, ks = np.asarray(cache.k), None if cache.k_s is None else np.asarray(cache.k_s)
    if isinstance(cache, RefPagedKVCache):
        B, blocks = cache.block, np.asarray(cache.block_table)[slot]
        k = np.concatenate([k[:, b] for b in blocks], axis=2)
        ks = None if ks is None else np.concatenate([ks[:, b] for b in blocks], axis=3)
        return k[:, :, :n], None if ks is None else ks[:, :, 0, :n]
    return k[:, slot, :, :n], None if ks is None else ks[:, slot, :, 0, :n]


def _assert_cache_equal(cache, ref_cache, written):
    """int8: the written values equal and the scales to 1e-6 relative; f32:
    the values to 1e-5."""
    for slot, n in written:
        k, ks = _logical(cache, slot, n)
        rk, rks = _ref_logical(ref_cache, slot, n)
        if ks is None:
            np.testing.assert_allclose(k.float().numpy(), rk.astype(np.float32),
                                       atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_array_equal(k.numpy(), rk)
            np.testing.assert_allclose(ks.numpy(), rks, rtol=1e-6, atol=0)


@pytest.mark.parametrize("variant", ["int8", "paged", "paged+int8"])
def test_prefill_then_decode_variants_match_reference(variant):
    """llama-tiny-f32 on an int8 slot cache, a B=16 pool under a shuffled
    block table, or both. The reference's cache state (table included)
    is carried over by ``kv_cache_from_jax``; a chunk step and three
    decode steps then run on each side. Logits within 1e-4 (f32, see TOL);
    the written int8 values equal and their scales within 1e-6 relative."""
    name = "llama-tiny-f32"
    ref_cfg = ref_get_model(name).config
    cfg = get_model(name).config
    jparams = init_transformer(jax.random.PRNGKey(4), ref_cfg)
    params = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    S, max_len, c, B = 3, 64, 8, 16
    quant = "int8" if "int8" in variant else ""
    rng = np.random.default_rng(1)
    if variant.startswith("paged"):
        ref_cache = RefPagedKVCache.create(L, S, max_len, KV, hd, dtype=ref_cfg.dtype,
                                           quant=quant, block=B, n_blocks=S * 4 + 3)
        table = rng.permutation(np.arange(1, S * 4 + 3))[:S * 4].reshape(S, 4)
        ref_cache = ref_cache._replace(block_table=jnp.asarray(table, jnp.int32))
    else:
        ref_cache = RefKVCache.create(L, S, max_len, KV, hd, dtype=ref_cfg.dtype,
                                      quant=quant)
    cache = kv_cache_from_jax(_np_tree(ref_cache), device="cpu")

    # Rows: slot 2 a full chunk at 0, slot 0 five tokens at 0, a padding
    # row duplicating row 0.
    tokens = rng.integers(0, cfg.vocab_size, (3, c)).astype(np.int32)
    tokens[2] = tokens[0]
    slots = np.array([2, 0, 2], np.int32)
    starts = np.zeros(3, np.int32)
    lens = np.array([8, 5, 8], np.int32)
    ref_logits, ref_cache = transformer_prefill_chunk(
        jparams, jnp.asarray(tokens), ref_cache, jnp.asarray(slots),
        jnp.asarray(starts), jnp.asarray(lens), ref_cfg, dense_attn=True,
    )
    rope = rope_tables(cfg, max_len, "cpu")
    logits = prefill_chunk(
        params, torch.from_numpy(tokens).long(), cache, torch.from_numpy(slots),
        torch.from_numpy(starts), torch.from_numpy(lens), cfg, rope=rope,
    )
    tol = TOL[name]
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=tol, rtol=tol)
    _assert_cache_equal(cache, ref_cache, ((2, 8), (0, 5)))

    lengths = np.array([5, 0, 8], np.int32)
    ref_cache = ref_cache._replace(lengths=jnp.asarray(lengths))
    cache.lengths.copy_(torch.from_numpy(lengths))
    active = np.array([True, False, True])
    for _ in range(3):
        step_tokens = rng.integers(0, cfg.vocab_size, (S,)).astype(np.int32)
        ref_logits, ref_cache = transformer_decode_step(
            jparams, jnp.asarray(step_tokens), ref_cache, jnp.asarray(active),
            ref_cfg, dense_attn=True,
        )
        logits = decode_step(params, torch.from_numpy(step_tokens).long(), cache,
                             torch.from_numpy(active), cfg, rope=rope)
        np.testing.assert_allclose(logits.numpy()[active], np.asarray(ref_logits)[active],
                                   atol=tol, rtol=tol)
    np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(ref_cache.lengths))
    _assert_cache_equal(cache, ref_cache, ((0, 8), (2, 11)))


def test_transformer_prefill_int8_cache_matches_reference():
    """transformer_prefill on an int8 slot cache: logits, the quantized
    K/V and their scales (1 on the zeroed rest of each row) as the
    reference writes them."""
    from gofr_tpu.models.transformer import transformer_prefill as ref_prefill
    from gofr_tpu_torch.models.transformer import transformer_prefill

    name = "llama-tiny-f32"
    ref_cfg, cfg = ref_get_model(name).config, get_model(name).config
    jparams = init_transformer(jax.random.PRNGKey(5), ref_cfg)
    params = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    lengths, slots = np.array([12, 7], np.int32), np.array([1, 0], np.int32)
    ref_cache = RefKVCache.create(L, 2, 32, KV, hd, dtype=ref_cfg.dtype, quant="int8")
    cache = kv_cache_from_jax(_np_tree(ref_cache), device="cpu")
    want, ref_cache = ref_prefill(jparams, jnp.asarray(tokens), jnp.asarray(lengths),
                                  ref_cache, jnp.asarray(slots), ref_cfg)
    got = transformer_prefill(params, torch.from_numpy(tokens).long(),
                              torch.from_numpy(lengths), cache, torch.from_numpy(slots), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    for slot in (0, 1):
        np.testing.assert_array_equal(cache.v[:, slot].numpy(), np.asarray(ref_cache.v[:, slot]))
        np.testing.assert_allclose(cache.v_s[:, slot].numpy(),
                                   np.asarray(ref_cache.v_s[:, slot, :, 0]), rtol=1e-6, atol=0)
    assert torch.all(cache.k_s[:, :, :, 12:] == 1)
    with pytest.raises(TypeError, match="slot cache"):
        transformer_prefill(params, torch.from_numpy(tokens).long(), torch.from_numpy(lengths),
                            PagedKVCache.create(L, 2, 32, KV, hd, block=16),
                            torch.from_numpy(slots), cfg)


def test_params_from_jax_layout():
    ref_cfg = ref_get_model("llama-tiny-f32").config
    cfg = get_model("llama-tiny-f32").config
    jparams = _np_tree(init_transformer(jax.random.PRNGKey(1), ref_cfg))
    params = params_from_jax(jparams, cfg, device="cpu")
    lp = jparams["layers"]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    np.testing.assert_array_equal(
        params["wqkv"][:, :, H * hd:(H + KV) * hd].numpy(), lp["wk"]
    )
    np.testing.assert_array_equal(
        params["w_gate_up"][:, :, cfg.d_ff:].numpy(), lp["w_up"]
    )
    assert params["wqkv"].dtype == torch.float32
    # The same shapes init_params makes on its own.
    fresh = init_params(cfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: tuple(v.shape) for k, v in params.items()
    }


def _reference_builtin_llms() -> list[str]:
    """The reference registry's built-in LLM names, read in a fresh
    process: in this one, other reference tests may have registered extra
    ``family="llm"`` entries (``swa-test`` in tests/test_sliding_window.py)
    into its process-global registry."""
    code = ("import json; from gofr_tpu.models.registry import get_model, list_models; "
            "print(json.dumps([n for n in list_models() if get_model(n).family == 'llm']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_registry_mirrors_reference_llm_entries():
    builtin = _reference_builtin_llms()
    assert "mistral-7b" in builtin and len(builtin) > 10
    assert [n for n in list_models() if get_model(n).family == "llm"] == sorted(builtin)
    for name in builtin:
        ref = ref_get_model(name)
        port = get_model(name)
        assert port.eos_token == ref.eos_token
        for field in TransformerConfig.__dataclass_fields__:
            if field != "dtype":
                assert getattr(port.config, field) == getattr(ref.config, field)
        assert str(port.config.dtype).split(".")[-1] == ref.config.dtype.__name__


def test_every_supported_config_has_cuda_kernels():
    """Each registered model that ``check_supported`` accepts (bf16 and
    f32, head dims 32, 128 and 256 among them) has a kernel of its dtype
    and head dim in all three wrappers (whose accepted head dims hold for
    both dtypes) and of its GQA ratio in flash_decode, so none passes the
    model check and then raises at its first launch on a card."""
    from gofr_tpu_torch.ops.cuda import flash_attention as fa
    from gofr_tpu_torch.ops.cuda import flash_decode as fd
    from gofr_tpu_torch.ops.cuda import flash_prefill as fp

    seen = set()
    for name in list_models():
        if get_model(name).family != "llm":
            continue  # ViT's attention: tests/test_torch_encoders.py
        cfg = get_model(name).config
        try:
            check_supported(cfg)
        except NotImplementedError:
            continue
        seen.add((cfg.dtype, cfg.head_dim))
        assert cfg.dtype in fd._DTYPES, name
        for mod in (fd, fp, fa):
            assert cfg.head_dim in mod._HEAD_DIMS, (name, mod.__name__)
        assert cfg.n_heads // cfg.n_kv_heads in fd._REPS, name
    assert {(torch.float32, 32), (torch.bfloat16, 32), (torch.bfloat16, 128),
            (torch.bfloat16, 256)} <= seen


@pytest.mark.parametrize("name", ["mixtral-8x7b", "moe-tiny"])
def test_unported_families_raise(name):
    """MoE serves (check_supported takes it) and trains: make_train_step
    builds for it (it once refused it naming ROADMAP item 5; the training
    is held against the reference in tests/test_torch_train_families.py)."""
    from gofr_tpu_torch.parallel.sharding import make_train_step

    check_supported(get_model(name).config)
    init_state, train_step, _ = make_train_step(get_model(name).config, device="cpu")
    assert callable(init_state) and callable(train_step)


def test_mistral_7b_is_supported_and_params_cross_over():
    """mistral-7b passes check_supported with its 4096-token window, and
    params_from_jax takes a windowed config: the Mistral layout is the
    Llama layout (a narrow windowed config of the reference, its weights
    carried over exactly)."""
    cfg = get_model("mistral-7b").config
    assert cfg.sliding_window == 4096
    check_supported(cfg)
    ref_cfg = dataclasses.replace(ref_get_model("llama-tiny-f32").config, sliding_window=8)
    port_cfg = dataclasses.replace(get_model("llama-tiny-f32").config, sliding_window=8)
    jparams = _np_tree(init_transformer(jax.random.PRNGKey(2), ref_cfg))
    params = params_from_jax(jparams, port_cfg, device="cpu")
    H, KV, hd = port_cfg.n_heads, port_cfg.n_kv_heads, port_cfg.head_dim
    np.testing.assert_array_equal(params["wqkv"][:, :, :H * hd].numpy(), jparams["layers"]["wq"])
    np.testing.assert_array_equal(
        params["wqkv"][:, :, (H + KV) * hd:].numpy(), jparams["layers"]["wv"])
    np.testing.assert_array_equal(params["lm_head"].numpy(), jparams["lm_head"])
