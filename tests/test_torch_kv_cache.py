"""The port's KV caches (gofr_tpu_torch/ops/kv_cache.py) against the
reference's (gofr_tpu/ops/kv_cache.py) on the same numpy inputs: the int8
quantizer bit for bit, the block allocator's ids and errors, and the
paged pool's shapes, byte counts and gather. The port keeps one scale per
position where the reference replicates it x8 (``k_s[..., 0, :]``)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gofr_tpu.ops import kv_cache as ref
from gofr_tpu_torch.ops.kv_cache import (
    BlockAllocator,
    KVCache,
    PagedKVCache,
    fake_quantize_kv,
    paged_view,
    quantize_kv,
)
from gofr_tpu_torch.weights import kv_cache_from_jax


def _rows():
    """f32 rows of 32: normal values, an all-zero row, and rows whose
    scaled values sit exactly on .5 (absmax 127 gives scale 1)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6, 32)).astype(np.float32) * 3
    x[1, 2] = 0.0
    x[2, 0] = 0.0
    x[2, 0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bit_equal_to_reference(dtype):
    x = _rows().astype(getattr(ml_dtypes, dtype) if dtype == "bfloat16" else dtype)
    want_q, want_s = (np.asarray(a) for a in ref.quantize_kv(jnp.asarray(x)))
    tx = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    q, s = quantize_kv(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(s.numpy().view(np.int32), want_s.view(np.int32))
    assert np.all(s.numpy()[1, 2] == 1.0) and np.all(q.numpy()[1, 2] == 0)
    np.testing.assert_array_equal(q.numpy()[2, 0, :6], [127, 2, -4, 0, 0, 126])
    want_f = np.asarray(ref.fake_quantize_kv(jnp.asarray(x))).astype(np.float32)
    np.testing.assert_array_equal(fake_quantize_kv(tx).float().numpy(), want_f)


def test_block_allocator_matches_reference_ids_and_errors():
    rng = np.random.default_rng(1)
    ours, theirs = BlockAllocator(9), ref.BlockAllocator(9)
    held = []
    for _ in range(200):
        op = rng.integers(0, 3)
        if op == 0 or not held:
            got, want = ours.alloc(), theirs.alloc()
            assert got == want
            if got is not None:
                assert got != 0
                held.append(got)
        elif op == 1:
            bid = held[rng.integers(0, len(held))]
            assert ours.incref(bid) == theirs.incref(bid)
            held.append(bid)
        else:
            bid = held.pop(rng.integers(0, len(held)))
            assert ours.decref(bid) == theirs.decref(bid)
        assert ours.free_blocks == theirs.free_blocks
        assert [ours.refcount(b) for b in range(9)] == [theirs.refcount(b) for b in range(9)]
    free = ours.free_blocks[0] if ours.free_blocks else None
    if free is not None:
        for a in (ours, theirs):
            with pytest.raises(ValueError, match="free block"):
                a.decref(free)
            with pytest.raises(ValueError, match="free block"):
                a.incref(free)
    # Dry pool: None from both, highest ids handed out first.
    a, b = BlockAllocator(4), ref.BlockAllocator(4)
    assert [a.alloc() for _ in range(4)] == [b.alloc() for _ in range(4)] == [3, 2, 1, None]


@pytest.mark.parametrize("quant", ["", "int8"])
def test_caches_match_reference_shapes_and_bytes(quant):
    L, S, max_len, KV, hd, B = 2, 3, 64, 2, 32, 16
    for paged in (False, True):
        if paged:
            kw = dict(block=B, n_blocks=0)
            mine = PagedKVCache.create(L, S, max_len, KV, hd, quant=quant, **kw)
            theirs = ref.PagedKVCache.create(L, S, max_len, KV, hd, quant=quant, **kw)
            assert mine.block_table.shape == theirs.block_table.shape
            assert mine.block_table.dtype == torch.int32
            assert (mine.n_blocks, mine.block, mine.max_len) == (
                theirs.n_blocks, theirs.block, theirs.max_len)
            assert mine.n_blocks == S * max_len // B + 1
        else:
            mine = KVCache.create(L, S, max_len, KV, hd, quant=quant)
            theirs = ref.KVCache.create(L, S, max_len, KV, hd, quant=quant)
        assert tuple(mine.k.shape) == theirs.k.shape
        assert mine.quantized == theirs.quantized == bool(quant)
        assert (mine.n_slots, mine.max_len) == (theirs.n_slots, theirs.max_len)
        if quant:
            assert mine.k.dtype == torch.int8
            # The port drops the x8 replication of the scale planes.
            assert tuple(mine.k_s.shape) == theirs.k_s.shape[:-2] + theirs.k_s.shape[-1:]
            assert torch.all(mine.k_s == 1) and torch.all(mine.v_s == 1)
            replicated = 2 * theirs.k_s.size * 4
            assert mine.hbm_bytes() == theirs.hbm_bytes() - replicated * 7 // 8
        else:
            assert mine.hbm_bytes() == theirs.hbm_bytes()
        if paged:
            assert mine.block_bytes() == mine.hbm_bytes() // mine.n_blocks
    with pytest.raises(ValueError, match="int8 only"):
        KVCache.create(L, S, max_len, KV, hd, quant="fp8")
    with pytest.raises(ValueError, match="int8 only"):
        ref.KVCache.create(L, S, max_len, KV, hd, quant="fp8")
    with pytest.raises(ValueError, match="multiple of block"):
        PagedKVCache.create(L, S, 60, KV, hd, block=16)


def test_int8_token_bytes_at_llama_3_8b():
    """32 layers x 8 kv heads x (K and V) x (128 int8 + one f32 scale):
    67,584 bytes a token; 131,072 in bf16."""
    int8 = PagedKVCache.create(32, 1, 32, 8, 128, quant="int8", block=32, n_blocks=2,
                               device="meta")
    bf16 = PagedKVCache.create(32, 1, 32, 8, 128, block=32, n_blocks=2, device="meta")
    assert int8.block_bytes() == 32 * 67_584
    assert bf16.block_bytes() == 32 * 131_072


def test_paged_view_matches_reference():
    rng = np.random.default_rng(2)
    n_blocks, KV, B, hd, MB = 9, 2, 16, 8, 4
    k = rng.standard_normal((n_blocks, KV, B, hd)).astype(np.float32)
    v = rng.standard_normal((n_blocks, KV, B, hd)).astype(np.float32)
    ks = rng.random((n_blocks, KV, B)).astype(np.float32)
    vs = rng.random((n_blocks, KV, B)).astype(np.float32)
    table = rng.permutation(np.arange(1, n_blocks))[:6].reshape(2, 3)
    table = np.concatenate([table, np.zeros((2, MB - 3), np.int64)], 1).astype(np.int32)
    rows = np.array([1, 0, 1], np.int32)
    rep8 = lambda a: np.repeat(a[:, :, None, :], 8, axis=2)  # noqa: E731
    want = ref.paged_view(jnp.asarray(table), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(rows), jnp.asarray(rep8(ks)), jnp.asarray(rep8(vs)))
    got = paged_view(*(torch.from_numpy(a) for a in (table, k, v, rows, ks, vs)))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:, :, 0])


def test_kv_cache_from_jax_carries_contents():
    rng = np.random.default_rng(3)
    theirs = ref.PagedKVCache.create(2, 2, 32, 2, 8, quant="int8", block=16)
    theirs = theirs._replace(
        k=jnp.asarray(rng.integers(-127, 128, theirs.k.shape).astype(np.int8)),
        k_s=jnp.asarray(rng.random(theirs.k_s.shape).astype(np.float32)),
        block_table=jnp.asarray([[3, 1], [2, 0]], jnp.int32),
        lengths=jnp.asarray([20, 5], jnp.int32),
    )
    mine = kv_cache_from_jax(theirs, device="cpu")
    assert isinstance(mine, PagedKVCache)
    np.testing.assert_array_equal(mine.k.numpy(), np.asarray(theirs.k))
    np.testing.assert_array_equal(mine.k_s.numpy(), np.asarray(theirs.k_s)[..., 0, :])
    np.testing.assert_array_equal(mine.block_table.numpy(), [[3, 1], [2, 0]])
    np.testing.assert_array_equal(mine.lengths.numpy(), [20, 5])
    dense = kv_cache_from_jax(ref.KVCache.create(1, 2, 16, 2, 8), device="cpu")
    assert isinstance(dense, KVCache) and dense.k.dtype == torch.bfloat16 and not dense.quantized
