"""The plain versions of the port's two serving kernels against the
reference's Pallas kernels (run as the reference's own tests run them on
CPU: interpret mode) and its dense formulas, on the same numpy inputs —
bf16 contiguous caches and the int8, paged and paged+int8 variants, with
and without Mistral's sliding window — and
the dispatch of ``gofr_tpu_torch.ops.attention`` (the CUDA kernels
themselves are held against the plain versions on a GPU, in
``test_torch_gpu.py`` and ``chip_smoke.py``, and on the CPU emulator in
``test_torch_cuda_emulation.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops.attention import cache_chunk_attention as ref_chunk_attention
from gofr_tpu.ops.attention import decode_attention as ref_decode_attention
from gofr_tpu.ops.pallas import flash_cache_attention as ref_flash_cache_attention
from gofr_tpu.ops.pallas import flash_decode as ref_flash_decode
from gofr_tpu_torch.ops import attention
from gofr_tpu_torch.ops.cuda import flash_decode as fd
from gofr_tpu_torch.ops.cuda import flash_prefill as fp
from gofr_tpu_torch.ops.cuda import launch_counts

# f32 on both sides, same online-vs-dense softmax algebra in another
# order: the reference's own kernel tests hold interpret mode to 2e-5.
TOL = 2e-5
# bf16 queries against the Pallas kernel: the plain version rounds the
# normalized probabilities (and, in the split convention, the merge) to
# bf16 where the kernel rounds the unnormalized ones and divides in f32,
# and both round the output: a few bf16 ulps (2**-8 relative) on values of
# magnitude ~1.
BF16_TOL = 3e-2


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _decode_inputs(seed, b, max_len, n_heads, n_kv, hd):
    rng = np.random.default_rng(seed)
    return (
        _rand(rng, b, n_heads, hd), _rand(rng, b, n_kv, max_len, hd),
        _rand(rng, b, n_kv, max_len, hd), _rand(rng, b, n_kv, hd),
        _rand(rng, b, n_kv, hd),
    )


@pytest.mark.parametrize(
    "b,max_len,n_heads,n_kv,hd,lengths",
    [
        (4, 128, 4, 4, 32, [0, 7, 64, 127]),   # MHA, empty prefix
        (3, 96, 8, 2, 32, [5, 95, 0]),         # GQA, max_len off the tile
    ],
)
@pytest.mark.parametrize("split", [False, True])
def test_plain_flash_decode_matches_pallas_and_dense(
    b, max_len, n_heads, n_kv, hd, lengths, split
):
    q, kc, vc, kn, vn = _decode_inputs(0, b, max_len, n_heads, n_kv, hd)
    lens = np.array(lengths, np.int32)
    new = dict(k_new=jnp.asarray(kn), v_new=jnp.asarray(vn)) if split else {}
    want = ref_flash_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        block_k=32, interpret=True, **new,
    )
    tnew = (
        dict(k_new=torch.from_numpy(kn), v_new=torch.from_numpy(vn))
        if split else {}
    )
    got = fd.flash_decode_plain(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lens), **tnew,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # The reference's dense formula agrees too — except on an empty
    # prefix in the written convention, where the dense path averages the
    # whole cache and the kernel contract returns 0.
    dense = np.asarray(ref_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        kernel=False, **new,
    ))
    rows = np.ones(b, bool) if split else lens > 0
    np.testing.assert_allclose(got.numpy()[rows], dense[rows], atol=TOL, rtol=TOL)
    if not split:
        assert np.all(got.numpy()[lens == 0] == 0.0)


def _chunk_inputs(seed, P, c, S, max_len, n_heads, n_kv, hd):
    rng = np.random.default_rng(seed)
    return (
        _rand(rng, P, c, n_heads, hd), _rand(rng, S, n_kv, max_len, hd),
        _rand(rng, S, n_kv, max_len, hd),
    )


def test_plain_flash_cache_attention_matches_pallas_and_dense():
    """Rows: a full chunk at 0, a short chunk (lens < c) mid-cache, a full
    chunk past a block boundary, and a padding row duplicating row 0."""
    P, c, S, max_len, n_heads, n_kv, hd = 4, 16, 4, 128, 8, 2, 32
    q, kc, vc = _chunk_inputs(1, P, c, S, max_len, n_heads, n_kv, hd)
    q[3] = q[0]
    slots = np.array([1, 3, 0, 1], np.int32)
    starts = np.array([0, 40, 64, 0], np.int32)
    lens = np.array([16, 5, 16, 16], np.int32)
    args = [jnp.asarray(a) for a in (q, kc, vc, slots, starts, lens)]
    want = ref_flash_cache_attention(*args, block_k=32, interpret=True)
    dense = ref_chunk_attention(*args, kernel=False)
    got = fp.flash_cache_attention_plain(
        *(torch.from_numpy(a) for a in (q, kc, vc, slots, starts, lens))
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), atol=TOL, rtol=TOL)
    assert np.all(got.numpy()[1, 5:] == 0.0)  # rows past lens[p]
    np.testing.assert_array_equal(got.numpy()[3], got.numpy()[0])


def test_attention_dispatch_on_cpu_takes_the_plain_version():
    """kernel=True on CPU tensors is the plain version and launches no
    kernel; kernel=False calls the plain version directly."""
    q, kc, vc, kn, vn = (
        torch.from_numpy(a) for a in _decode_inputs(2, 2, 64, 4, 2, 32)
    )
    lens = torch.tensor([3, 60], dtype=torch.int32)
    before = launch_counts()
    a = attention.decode_attention(q, kc, vc, lens, k_new=kn, v_new=vn)
    b = attention.decode_attention(q, kc, vc, lens, k_new=kn, v_new=vn,
                                   kernel=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    qc, ck, cv = (
        torch.from_numpy(x) for x in _chunk_inputs(3, 2, 8, 2, 64, 4, 2, 32)
    )
    rows = [torch.tensor(v, dtype=torch.int32) for v in ([0, 1], [0, 9], [8, 3])]
    a = attention.cache_chunk_attention(qc, ck, cv, *rows)
    b = attention.cache_chunk_attention(qc, ck, cv, *rows, kernel=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert launch_counts() == before


# -- int8 / paged / paged+int8 ---------------------------------------------

VARIANTS = {"int8": (True, 0), "paged": (False, 16), "paged+int8": (True, 16)}
# The windowed tests also run the plain bf16/f32 slot cache.
WINDOW_VARIANTS = {"slot": (False, 0), **VARIANTS}


def _int8_cache(rng, *shape):
    """int8 values and positive f32 scales of a [..., hd] cache."""
    return (rng.integers(-127, 128, shape).astype(np.int8),
            (rng.random(shape[:-1]) * 0.05 + 0.01).astype(np.float32))


def _to_pool(rng, arrays, keys, B):
    """Move keys [0, keys[r]) of each row of [rows, KV, max_len, ...]
    arrays into pools [n_blocks, KV, B, ...] under a shuffled table; the
    parking block 0, two unused blocks and every unallocated table entry
    (0) hold large garbage of each array's dtype."""
    rows, KV, max_len = arrays[0].shape[:3]
    need = [-(-n // B) for n in keys]
    n_blocks = sum(need) + 3
    perm = iter(rng.permutation(np.arange(1, n_blocks)).tolist())
    pools = []
    for a in arrays:
        shape = (n_blocks, KV, B, *a.shape[3:])
        if a.dtype == np.int8:
            pools.append(rng.integers(-127, 128, shape).astype(np.int8))
        else:
            pools.append((rng.choice([-1.0, 1.0], shape) * 3e4).astype(a.dtype))
    table = np.zeros((rows, max_len // B), np.int32)
    for r in range(rows):
        for j in range(need[r]):
            blk = next(perm)
            table[r, j] = blk
            for pool, a in zip(pools, arrays):
                pool[blk] = a[r, :, j * B:(j + 1) * B]
    return pools, table


def _variant_cache(rng, variant, rows, KV, max_len, hd, keys):
    """(port kwargs of numpy arrays, reference kwargs) for one variant:
    caches, and the scales (reference: replicated x8) and block table."""
    quant, B = WINDOW_VARIANTS[variant]
    if quant:
        (kc, ks), (vc, vs) = (_int8_cache(rng, rows, KV, max_len, hd) for _ in range(2))
        arrays = [kc, vc, ks, vs]
    else:
        arrays = [_rand(rng, rows, KV, max_len, hd), _rand(rng, rows, KV, max_len, hd)]
    table = None
    if B:
        arrays, table = _to_pool(rng, arrays, keys, B)
    port = dict(k_cache=arrays[0], v_cache=arrays[1])
    if quant:
        port.update(k_scale=arrays[2], v_scale=arrays[3])
    if table is not None:
        port["block_table"] = table
    theirs = {k: (np.repeat(a[..., None, :], 8, axis=-2) if k.endswith("scale") else a)
              for k, a in port.items()}
    return port, theirs


def _split_reference_kw(theirs):
    """Caches (positional) and the reference's kwargs, as jnp arrays."""
    kw = {k: jnp.asarray(a) for k, a in theirs.items()}
    return kw.pop("k_cache"), kw.pop("v_cache"), kw


def _torch_kw(port, dtype=None):
    out = {}
    for k, a in port.items():
        t = torch.from_numpy(a)
        out[k] = t.to(dtype) if dtype is not None and k.endswith("cache") and a.dtype != np.int8 else t
    return out


@pytest.mark.parametrize("split", [False, True], ids=["written", "split"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_flash_decode_variants_match_dense_and_pallas(variant, split):
    """f32: the plain version against the reference's dense formula at
    TOL. bf16 queries: against the reference's Pallas kernel (interpret
    mode) at BF16_TOL. B=16 pools under a shuffled table with garbage in
    the parking block."""
    b, max_len, H, KV, hd = 3, 64, 8, 2, 32
    lengths = np.array([0, 17, 64] if not split else [0, 17, 63], np.int32)
    rng = np.random.default_rng(10 + split)
    port, theirs = _variant_cache(rng, variant, b, KV, max_len, hd, lengths)
    q, kn, vn = _rand(rng, b, H, hd), _rand(rng, b, KV, hd), _rand(rng, b, KV, hd)
    new = dict(k_new=kn, v_new=vn) if split else {}
    kc, vc, rkw = _split_reference_kw(theirs)
    dense = np.asarray(ref_decode_attention(
        jnp.asarray(q), kc, vc, jnp.asarray(lengths), kernel=False,
        **{k: jnp.asarray(a) for k, a in new.items()}, **rkw,
    ))
    tkw = _torch_kw(port)
    got = fd.flash_decode_plain(
        torch.from_numpy(q), tkw.pop("k_cache"), tkw.pop("v_cache"),
        torch.from_numpy(lengths), **{k: torch.from_numpy(a) for k, a in new.items()}, **tkw,
    ).numpy()
    rows = np.ones(b, bool) if split else lengths > 0
    np.testing.assert_allclose(got[rows], dense[rows], atol=TOL, rtol=TOL)
    if not split:
        assert np.all(got[lengths == 0] == 0.0)

    # bf16 queries (the serving dtype) against the Pallas kernel.
    bf = jnp.bfloat16
    want = np.asarray(ref_flash_decode(
        jnp.asarray(q, bf), kc.astype(bf) if kc.dtype != jnp.int8 else kc,
        vc.astype(bf) if vc.dtype != jnp.int8 else vc, jnp.asarray(lengths),
        block_k=16, interpret=True,
        **{k: jnp.asarray(a, bf) for k, a in new.items()}, **rkw,
    ).astype(jnp.float32))
    tkw = _torch_kw(port, torch.bfloat16)
    got = fd.flash_decode_plain(
        torch.from_numpy(q).bfloat16(), tkw.pop("k_cache"), tkw.pop("v_cache"),
        torch.from_numpy(lengths),
        **{k: torch.from_numpy(a).bfloat16() for k, a in new.items()}, **tkw,
    ).float().numpy()
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_flash_cache_attention_variants_match_dense_and_pallas(variant):
    """Rows: a full chunk at 0, a short chunk mid-cache crossing a block
    boundary, a full chunk ending at max_len, a padding row duplicating
    row 0; f32 against the dense formula, bf16 against Pallas."""
    P, c, S, max_len, H, KV, hd = 4, 16, 4, 128, 8, 2, 32
    slots = np.array([1, 3, 0, 1], np.int32)
    starts = np.array([0, 40, 112, 0], np.int32)
    lens = np.array([16, 5, 16, 16], np.int32)
    keys = [0] * S
    for sl, st, n in zip(slots, starts, lens):
        keys[sl] = max(keys[sl], st + n)
    rng = np.random.default_rng(20)
    port, theirs = _variant_cache(rng, variant, S, KV, max_len, hd, keys)
    q = _rand(rng, P, c, H, hd)
    q[3] = q[0]
    rows = [jnp.asarray(a) for a in (slots, starts, lens)]
    kc, vc, rkw = _split_reference_kw(theirs)
    dense = np.asarray(ref_chunk_attention(jnp.asarray(q), kc, vc, *rows, kernel=False, **rkw))
    trows = [torch.from_numpy(a) for a in (slots, starts, lens)]
    tkw = _torch_kw(port)
    got = fp.flash_cache_attention_plain(
        torch.from_numpy(q), tkw.pop("k_cache"), tkw.pop("v_cache"), *trows, **tkw
    ).numpy()
    np.testing.assert_allclose(got, dense, atol=TOL, rtol=TOL)
    assert np.all(got[1, 5:] == 0.0)
    np.testing.assert_array_equal(got[3], got[0])

    bf = jnp.bfloat16
    want = np.asarray(ref_flash_cache_attention(
        jnp.asarray(q, bf), kc.astype(bf) if kc.dtype != jnp.int8 else kc,
        vc.astype(bf) if vc.dtype != jnp.int8 else vc, *rows, block_k=16,
        interpret=True, **rkw,
    ).astype(jnp.float32))
    tkw = _torch_kw(port, torch.bfloat16)
    got = fp.flash_cache_attention_plain(
        torch.from_numpy(q).bfloat16(), tkw.pop("k_cache"), tkw.pop("v_cache"), *trows, **tkw
    ).float().numpy()
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


def test_attention_dispatch_passes_variants_through():
    """decode_attention / cache_chunk_attention hand k_scale, v_scale and
    block_table to the kernel wrappers, whose CPU path is the plain
    version: the same result as calling it directly."""
    rng = np.random.default_rng(30)
    lengths = np.array([5, 40], np.int32)
    port, _ = _variant_cache(rng, "paged+int8", 2, 2, 64, 32, lengths)
    tkw = _torch_kw(port)
    kc, vc = tkw.pop("k_cache"), tkw.pop("v_cache")
    q, kn, vn = (torch.from_numpy(a) for a in (_rand(rng, 2, 4, 32), _rand(rng, 2, 2, 32),
                                               _rand(rng, 2, 2, 32)))
    lens = torch.from_numpy(lengths)
    a = attention.decode_attention(q, kc, vc, lens, k_new=kn, v_new=vn, **tkw)
    b = fd.flash_decode_plain(q, kc, vc, lens, k_new=kn, v_new=vn, **tkw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    rows = [torch.tensor(v, dtype=torch.int32) for v in ([0, 1], [0, 30], [5, 10])]
    qc = torch.from_numpy(_rand(rng, 2, 16, 4, 32))
    a = attention.cache_chunk_attention(qc, kc, vc, *rows, **tkw)
    b = fp.flash_cache_attention_plain(qc, kc, vc, *rows, **tkw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kwargs", [{"window": 16}], ids=["window"])
def test_unported_variants_raise(kwargs):
    """No serving-op variant is refused any more: a binding window goes
    through decode_attention / cache_chunk_attention to the wrappers (on
    CPU tensors, the plain version with the window) and changes the
    result; the capacity rule still drops a window a pool cannot bind."""
    q, kc, vc, kn, vn = (
        torch.from_numpy(a) for a in _decode_inputs(4, 2, 64, 4, 2, 32)
    )
    lens = torch.tensor([30, 60], dtype=torch.int32)
    a = attention.decode_attention(q, kc, vc, lens, k_new=kn, v_new=vn, **kwargs)
    torch.testing.assert_close(
        a, fd.flash_decode_plain(q, kc, vc, lens, k_new=kn, v_new=vn, **kwargs),
        rtol=0, atol=0)
    assert not torch.allclose(
        a, attention.decode_attention(q, kc, vc, lens, k_new=kn, v_new=vn), atol=1e-3)
    qc = q[:, None].expand(2, 4, 4, 32).contiguous()
    rows = (torch.tensor([0, 1], dtype=torch.int32), lens - 4,
            torch.tensor([4, 4], dtype=torch.int32))
    torch.testing.assert_close(
        attention.cache_chunk_attention(qc, kc, vc, *rows, **kwargs),
        fp.flash_cache_attention_plain(qc, kc, vc, *rows, **kwargs), rtol=0, atol=0)
    # A pool's capacity is its table width x block: a window of that size
    # cannot bind and is dropped; one key less binds.
    pool = kc.reshape(8, 2, 16, 32)
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 0]], dtype=torch.int32)
    a = attention.decode_attention(q, pool, pool, lens, k_new=kn, v_new=vn,
                                   block_table=table, window=64)
    b = attention.decode_attention(q, pool, pool, lens, k_new=kn, v_new=vn,
                                   block_table=table)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = attention.decode_attention(q, pool, pool, lens, k_new=kn, v_new=vn,
                                   block_table=table, window=40)
    assert not torch.allclose(b, c, atol=1e-3)


WINDOW = 12


@pytest.mark.parametrize("split", [False, True], ids=["written", "split"])
@pytest.mark.parametrize("variant", list(WINDOW_VARIANTS))
def test_plain_flash_decode_window_matches_dense_and_pallas(variant, split):
    """The windowed plain version (keys in (q_pos - window, q_pos], q_pos =
    lengths in the split convention, lengths - 1 in the written one) on
    every cache kind: f32 against the reference's windowed dense formula at
    TOL, bf16 queries against its windowed Pallas kernel at BF16_TOL.
    Lengths sit at the window's edge in both conventions."""
    b, max_len, H, KV, hd = 5, 64, 8, 2, 32
    lengths = np.array([0, 11, 12, 13, 40 if not split else 63], np.int32)
    rng = np.random.default_rng(40 + split)
    port, theirs = _variant_cache(rng, variant, b, KV, max_len, hd, lengths)
    q, kn, vn = _rand(rng, b, H, hd), _rand(rng, b, KV, hd), _rand(rng, b, KV, hd)
    new = dict(k_new=kn, v_new=vn) if split else {}
    kc, vc, rkw = _split_reference_kw(theirs)
    dense = np.asarray(ref_decode_attention(
        jnp.asarray(q), kc, vc, jnp.asarray(lengths), kernel=False, window=WINDOW,
        **{k: jnp.asarray(a) for k, a in new.items()}, **rkw,
    ))
    tkw = _torch_kw(port)
    got = fd.flash_decode_plain(
        torch.from_numpy(q), tkw.pop("k_cache"), tkw.pop("v_cache"),
        torch.from_numpy(lengths), window=WINDOW,
        **{k: torch.from_numpy(a) for k, a in new.items()}, **tkw,
    ).numpy()
    rows = np.ones(b, bool) if split else lengths > 0
    np.testing.assert_allclose(got[rows], dense[rows], atol=TOL, rtol=TOL)
    if not split:
        assert np.all(got[lengths == 0] == 0.0)

    bf = jnp.bfloat16
    want = np.asarray(ref_flash_decode(
        jnp.asarray(q, bf), kc.astype(bf) if kc.dtype != jnp.int8 else kc,
        vc.astype(bf) if vc.dtype != jnp.int8 else vc, jnp.asarray(lengths),
        block_k=16, window=WINDOW, interpret=True,
        **{k: jnp.asarray(a, bf) for k, a in new.items()}, **rkw,
    ).astype(jnp.float32))
    tkw = _torch_kw(port, torch.bfloat16)
    got = fd.flash_decode_plain(
        torch.from_numpy(q).bfloat16(), tkw.pop("k_cache"), tkw.pop("v_cache"),
        torch.from_numpy(lengths), window=WINDOW,
        **{k: torch.from_numpy(a).bfloat16() for k, a in new.items()}, **tkw,
    ).float().numpy()
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("variant", list(WINDOW_VARIANTS))
def test_plain_flash_cache_attention_window_matches_dense_and_pallas(variant):
    """The per-token window (keys in (starts+t - window, starts+t]) on
    every cache kind, rows as in the unwindowed variant test: f32 against
    the windowed dense formula, bf16 against the windowed Pallas kernel."""
    P, c, S, max_len, H, KV, hd = 4, 16, 4, 128, 8, 2, 32
    slots = np.array([1, 3, 0, 1], np.int32)
    starts = np.array([0, 40, 112, 0], np.int32)
    lens = np.array([16, 5, 16, 16], np.int32)
    keys = [0] * S
    for sl, st, n in zip(slots, starts, lens):
        keys[sl] = max(keys[sl], st + n)
    rng = np.random.default_rng(41)
    port, theirs = _variant_cache(rng, variant, S, KV, max_len, hd, keys)
    q = _rand(rng, P, c, H, hd)
    q[3] = q[0]
    rows = [jnp.asarray(a) for a in (slots, starts, lens)]
    kc, vc, rkw = _split_reference_kw(theirs)
    dense = np.asarray(ref_chunk_attention(jnp.asarray(q), kc, vc, *rows, kernel=False,
                                           window=WINDOW, **rkw))
    trows = [torch.from_numpy(a) for a in (slots, starts, lens)]
    tkw = _torch_kw(port)
    got = fp.flash_cache_attention_plain(
        torch.from_numpy(q), tkw.pop("k_cache"), tkw.pop("v_cache"), *trows,
        window=WINDOW, **tkw
    ).numpy()
    np.testing.assert_allclose(got, dense, atol=TOL, rtol=TOL)
    assert np.all(got[1, 5:] == 0.0)

    bf = jnp.bfloat16
    want = np.asarray(ref_flash_cache_attention(
        jnp.asarray(q, bf), kc.astype(bf) if kc.dtype != jnp.int8 else kc,
        vc.astype(bf) if vc.dtype != jnp.int8 else vc, *rows, block_k=16,
        window=WINDOW, interpret=True, **rkw,
    ).astype(jnp.float32))
    tkw = _torch_kw(port, torch.bfloat16)
    got = fp.flash_cache_attention_plain(
        torch.from_numpy(q).bfloat16(), tkw.pop("k_cache"), tkw.pop("v_cache"), *trows,
        window=WINDOW, **tkw
    ).float().numpy()
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


def test_window_that_cannot_bind_is_dropped():
    """A window at least the capacity (or s_kv) gives exactly the
    unwindowed result in all three ops; so does one that covers every key
    these lengths reach."""
    q, kc, vc, kn, vn = (
        torch.from_numpy(a) for a in _decode_inputs(5, 2, 64, 4, 2, 32)
    )
    lens = torch.tensor([3, 6], dtype=torch.int32)
    a = attention.decode_attention(q, kc, vc, lens, k_new=kn, v_new=vn, window=64)
    b = attention.decode_attention(q, kc, vc, lens, k_new=kn, v_new=vn)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    a = fd.flash_decode_plain(q, kc, vc, lens, k_new=kn, v_new=vn, window=7)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    qc = q[:, None].expand(2, 4, 4, 32).contiguous()
    rows = (torch.tensor([0, 1], dtype=torch.int32), lens, lens - 2)
    torch.testing.assert_close(
        attention.cache_chunk_attention(qc, kc, vc, *rows, window=64),
        attention.cache_chunk_attention(qc, kc, vc, *rows), rtol=0, atol=0)
    ka, va = kc.transpose(1, 2), vc.transpose(1, 2)  # [b, s, KV, hd]
    qa = torch.from_numpy(_rand(np.random.default_rng(6), 2, 64, 4, 32))
    torch.testing.assert_close(attention.attention(qa, ka, va, window=64),
                               attention.attention(qa, ka, va), rtol=0, atol=0)


def _chip_smoke(monkeypatch):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return mod


def test_smoke_row_check_separates_rounding_from_a_dropped_key(monkeypatch):
    """chip_smoke.py's kernel check at its own decode shapes (S=8, H=32,
    KV=8, hd=128, max_len 2048, lengths up to 2047): the f32 answer
    rounded to bf16 passes, while leaving out a single key of the
    2047-key slot, or a nonzero value in a row that must be 0, fails."""
    cs = _chip_smoke(monkeypatch)
    gen = torch.Generator().manual_seed(1234)
    S, H, KV, hd, max_len = 8, 32, 8, 128, 2048

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).float()

    q, kc, vc = rnd(S, H, hd), rnd(S, KV, max_len, hd), rnd(S, KV, max_len, hd)
    lengths = torch.tensor([0, 1, 100, 257, 1000, 1536, 700, 2047], dtype=torch.int32)
    want = fd.flash_decode_plain(q, kc, vc, lengths)
    _, rel = cs.check_close(torch, "rounded", want.bfloat16(), want)
    assert 0 < rel < cs.ROW_REL_TOL
    short = lengths.clone()
    short[-1] -= 1
    with pytest.raises(SystemExit):
        cs.check_close(torch, "one key dropped",
                       fd.flash_decode_plain(q, kc, vc, short).bfloat16(), want)
    leak = want.bfloat16()
    leak[0, 0, 0] = 1e-3  # slot 0 has an empty prefix: its rows must be 0
    with pytest.raises(SystemExit):
        cs.check_close(torch, "nonzero empty row", leak, want)
