"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU. The kernels have no CPU mode, so without a card every test
here skips. This file imports neither JAX nor gofr_tpu, so it also runs on
a machine that has only PyTorch for CUDA:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from gofr_tpu_torch.ops.attention import FlashAttentionFn
from gofr_tpu_torch.ops.cuda import flash_attention as fa
from gofr_tpu_torch.ops.cuda import flash_decode as fd
from gofr_tpu_torch.ops.cuda import flash_prefill as fp
from gofr_tpu_torch.ops.kv_cache import (
    PagedKVCache,
    fake_quantize_kv,
    paged_copy_block,
    paged_view,
    quantize_kv,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# bf16 outputs of the kernel and the plain version: the kernel keeps the
# probabilities in f32 and sums in another order, so they differ by a few
# bf16 ulps (2**-8 relative each) on values of magnitude ~1.
BF16_TOL = 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("split", [False, True])
def test_flash_decode_kernel_matches_plain_on_gpu(cuda_device, split):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    S, H, KV, hd, max_len = 8, 32, 8, 128, 512

    def r(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    q, kc, vc, kn, vn = r(S, H, hd), r(S, KV, max_len, hd), r(S, KV, max_len, hd), r(S, KV, hd), r(S, KV, hd)
    lens = torch.tensor([0, 1, 100, 257, 511, 64, 3, 300], dtype=torch.int32, device=cuda_device)
    new = dict(k_new=kn, v_new=vn) if split else {}
    before = fd.launches
    got = fd.flash_decode(q, kc, vc, lens, **new)
    torch.cuda.synchronize()
    assert fd.launches == before + 1
    want = fd.flash_decode_plain(q, kc, vc, lens, **new)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.gpu
def test_flash_cache_attention_kernel_matches_plain_on_gpu(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    P, c, S, H, KV, hd, max_len = 4, 64, 4, 32, 8, 128, 512

    def r(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    q, kc, vc = r(P, c, H, hd), r(S, KV, max_len, hd), r(S, KV, max_len, hd)
    q[3] = q[0]
    i32 = dict(dtype=torch.int32, device=cuda_device)
    slots = torch.tensor([2, 0, 3, 2], **i32)
    starts = torch.tensor([0, 64, 300, 0], **i32)
    lens = torch.tensor([64, 17, 64, 64], **i32)
    before = fp.launches
    got = fp.flash_cache_attention(q, kc, vc, slots, starts, lens)
    torch.cuda.synchronize()
    assert fp.launches == before + 1
    want = fp.flash_cache_attention_plain(q, kc, vc, slots, starts, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)


# (int8, pool block): the serving kernels' variants.
VARIANTS = {"int8": (True, 0), "paged": (False, 32), "paged+int8": (True, 16)}
WINDOW_VARIANTS = {"bf16": (False, 0), **VARIANTS}


def _variant(gen, dev, variant, rows, KV, max_len, hd, keys):
    """Cache kwargs for a variant (int8 values and scales quantized from
    normal values; a pool under a shuffled table with garbage in the
    parking block and two unused blocks) and the same keys as a slot
    cache, for the bit-for-bit check."""
    quant, B = WINDOW_VARIANTS[variant]
    cache = [torch.randn((rows, KV, max_len, hd), generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(2)]
    if quant:
        (k, ks), (v, vs) = (quantize_kv(t) for t in cache)
        cache = [k, v, ks, vs]
    flat = dict(zip(("k_cache", "v_cache", "k_scale", "v_scale"), cache))
    if not B:
        return flat, None
    need = [-(-n // B) for n in keys]
    n_blocks = sum(need) + 3
    perm = (torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1).tolist()
    table = torch.zeros((rows, max_len // B), dtype=torch.int32)
    pools = [torch.full((n_blocks, KV, B, *t.shape[3:]), -3e4 if t.dtype != torch.int8 else -127,
                        dtype=t.dtype, device=dev) for t in cache]
    for r in range(rows):
        for j in range(need[r]):
            blk = perm.pop()
            table[r, j] = blk
            for pool, t in zip(pools, cache):
                pool[blk] = t[r, :, j * B:(j + 1) * B]
    paged = dict(zip(("k_cache", "v_cache", "k_scale", "v_scale"), pools))
    paged["block_table"] = table.to(dev)
    return paged, flat


@pytest.mark.gpu
@pytest.mark.parametrize("split", [False, True], ids=["written", "split"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flash_decode_variants_match_plain_on_gpu(cuda_device, variant, split):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    S, H, KV, hd, max_len = 8, 32, 8, 128, 512
    lengths = [0, 1, 100, 257, 511, 64, 3, 300]
    kw, flat = _variant(gen, cuda_device, variant, S, KV, max_len, hd, lengths)
    q = torch.randn((S, H, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    new = {}
    if split:
        new = {k: torch.randn((S, KV, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
               for k in ("k_new", "v_new")}
        if "int8" in variant:
            new = {k: fake_quantize_kv(t) for k, t in new.items()}
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fd.launches
    got = fd.flash_decode(q, lengths=lens, **new, **kw)
    torch.cuda.synchronize()
    assert fd.launches == before + 1
    want = fd.flash_decode_plain(q, lengths=lens, **new, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    if flat is not None:  # the pool gives the slot cache's bits
        assert torch.equal(got, fd.flash_decode(q, lengths=lens, **new, **flat))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_flash_cache_attention_variants_match_plain_on_gpu(cuda_device, variant):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    P, c, S, H, KV, hd, max_len = 4, 64, 4, 32, 8, 128, 512
    i32 = dict(dtype=torch.int32, device=cuda_device)
    rows = [(2, 0, 64), (0, 64, 17), (3, 300, 64), (2, 0, 64)]
    keys = [max([s0 + n for sl, s0, n in rows if sl == r] or [0]) for r in range(S)]
    kw, flat = _variant(gen, cuda_device, variant, S, KV, max_len, hd, keys)
    q = torch.randn((P, c, H, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    q[3] = q[0]
    slots, starts, lens = (torch.tensor([r[i] for r in rows], **i32) for i in range(3))
    before = fp.launches
    got = fp.flash_cache_attention(q, slots=slots, starts=starts, lens=lens, **kw)
    torch.cuda.synchronize()
    assert fp.launches == before + 1
    want = fp.flash_cache_attention_plain(q, slots=slots, starts=starts, lens=lens, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    assert torch.all(got[1, 17:] == 0)
    if flat is not None:
        assert torch.equal(got, fp.flash_cache_attention(q, slots=slots, starts=starts,
                                                         lens=lens, **flat))


def _aliased_pool(gen, dev, quant, S, KV, B, hd, max_len, shared, lengths):
    """A pool whose table gives every row the same ``shared`` physical
    blocks (a cached prefix the prefix cache aliases) before its own,
    under a shuffled block order; with ``quant`` int8 values and scales.
    Returns (pool kwargs with the table, the rows gathered as a slot
    cache)."""
    own = [-(-(n + 1) // B) - shared for n in lengths]
    n_blocks = 1 + shared + sum(own) + 2
    perm = (torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1).tolist()
    table = torch.zeros((S, max_len // B), dtype=torch.int32)
    table[:, :shared] = torch.tensor(perm[:shared], dtype=torch.int32)
    at = shared
    for r in range(S):
        table[r, shared: shared + own[r]] = torch.tensor(perm[at: at + own[r]],
                                                         dtype=torch.int32)
        at += own[r]
    table = table.to(dev)
    k, v = (torch.randn((n_blocks, KV, B, hd), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    pool = dict(k_cache=k, v_cache=v)
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        pool = dict(k_cache=k, v_cache=v, k_scale=ks, v_scale=vs)
    gathered = paged_view(table, pool["k_cache"], pool["v_cache"], torch.arange(S, device=dev),
                          pool.get("k_scale"), pool.get("v_scale"))
    flat = {key: t.contiguous() for key, t in
            zip(("k_cache", "v_cache", "k_scale", "v_scale"), gathered) if t is not None}
    return dict(pool, block_table=table), flat


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_serving_kernels_on_aliased_tables_on_gpu(cuda_device, quant):
    """The prefix cache's case: every slot's table aliases the same 4
    physical blocks (refcount > 1) before its own; decode past them (split
    and written) and a prefill that starts at done = 128, the first
    position past the aliased blocks, with a row at 127 (a whole-prompt
    hit's last position): against the plain versions, and bit for bit the
    contiguous kernel on the gathered rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    S, H, KV, hd, B, max_len, shared = 4, 32, 8, 128, 32, 512, 4
    lengths = [150, 200, 300, 500]
    kw, flat = _aliased_pool(gen, cuda_device, quant, S, KV, B, hd, max_len, shared, lengths)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    q = torch.randn((S, H, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    new = {key: torch.randn((S, KV, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
           for key in ("k_new", "v_new")}
    if quant:
        new = {key: fake_quantize_kv(t) for key, t in new.items()}
    lens = torch.tensor(lengths, **i32)
    for conv in ({}, new):
        got = fd.flash_decode(q, lengths=lens, **conv, **kw)
        want = fd.flash_decode_plain(q, lengths=lens, **conv, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
        assert torch.equal(got, fd.flash_decode(q, lengths=lens, **conv, **flat))
    rows = [(0, 128, 22), (1, 128, 64), (2, 128, 64), (3, 127, 1)]
    slots, starts, plens = (torch.tensor([r[j] for r in rows], **i32) for j in range(3))
    qp = torch.randn((4, 64, H, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    before = fp.launches
    got = fp.flash_cache_attention(qp, slots=slots, starts=starts, lens=plens, **kw)
    torch.cuda.synchronize()
    assert fp.launches == before + 1
    want = fp.flash_cache_attention_plain(qp, slots=slots, starts=starts, lens=plens, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    assert torch.equal(got, fp.flash_cache_attention(qp, slots=slots, starts=starts,
                                                     lens=plens, **flat))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["", "int8"], ids=["bf16", "int8"])
def test_paged_copy_block_is_the_source_bit_for_bit_on_gpu(cuda_device, quant):
    """The copy-on-write of a boundary block across 32 layers: the target
    block's K, V (and scales) are the source's bits, every other block is
    unchanged."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    cache = PagedKVCache.create(32, 2, 64, 8, 128, quant=quant, block=32, n_blocks=6,
                                device=cuda_device)
    planes = [t for t in (cache.k, cache.v, cache.k_s, cache.v_s) if t is not None]
    for t in planes:
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=cuda_device))
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device=cuda_device))
    before = [t.clone() for t in planes]
    paged_copy_block(cache, 2, 5)
    torch.cuda.synchronize()
    for t, old in zip(planes, before):
        bits, was = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x for x in (t, old))
        assert torch.equal(bits[:, 5], was[:, 2])
        keep = [b for b in range(6) if b != 5]
        assert torch.equal(bits[:, keep], was[:, keep])


@pytest.mark.gpu
def test_variant_kernels_refuse_what_they_do_not_take(cuda_device):
    """No fallback: a pool block that is not a multiple of 16, int8 values
    without scales, or one scale without the other raise on a card."""
    dev = cuda_device
    q = torch.zeros((2, 8, 64), dtype=torch.bfloat16, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    pool = torch.zeros((5, 2, 24, 64), dtype=torch.bfloat16, device=dev)
    table = torch.ones((2, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        fd.flash_decode(q, pool, pool, lens, block_table=table)
    i8 = torch.zeros((2, 2, 64, 64), dtype=torch.int8, device=dev)
    with pytest.raises(TypeError):
        fd.flash_decode(q, i8, i8, lens)
    sc = torch.ones((2, 2, 64), device=dev)
    with pytest.raises(ValueError, match="together"):
        fd.flash_decode(q, i8, i8, lens, k_scale=sc)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,s_q,s_kv,H,KV,hd,causal,lengths",
    [
        (2, 300, 300, 8, 2, 128, True, None),          # causal GQA, ragged tiles
        (2, 100, 333, 4, 4, 128, True, [333, 0]),      # offset, lengths with an empty row
        (3, 197, 197, 12, 12, 64, False, None),        # ViT-B/16 shape, non-causal
        (2, 64, 64, 4, 1, 64, False, [64, 17]),        # non-causal lengths, MQA
    ],
)
def test_flash_attention_kernel_matches_plain_on_gpu(
    cuda_device, b, s_q, s_kv, H, KV, hd, causal, lengths
):
    gen = torch.Generator(device=cuda_device).manual_seed(2)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    # q read through strides: a slice of a wider projection output.
    q = r(b, s_q, H + 2, hd)[:, :, 1:H + 1]
    k, v = r(b, s_kv, KV, hd), r(b, s_kv, KV, hd)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fa.launches
    got = fa.flash_attention(q, k, v, lens, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, lens, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    zero = want.float().abs().amax(dim=(-1, -2)) == 0
    assert torch.all(got[zero] == 0)


@pytest.mark.gpu
def test_flash_attention_fn_backward_matches_dense_autograd_on_gpu(cuda_device):
    """FlashAttentionFn: the kernel forward and the dense-recompute
    backward against autograd through the plain version, in bf16."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, s, H, KV, hd = 2, 256, 8, 2, 128

    def r(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    q, k, v, g = r(b, s, H, hd), r(b, s, KV, hd), r(b, s, KV, hd), r(b, s, H, hd)
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FlashAttentionFn.apply(*xs, True, None)
    out.backward(g)
    ys = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = fa.flash_attention_plain(*ys, causal=True)
    ref.backward(g)
    torch.testing.assert_close(out.float(), ref.float(), atol=BF16_TOL, rtol=BF16_TOL)
    for got, want in zip(xs, ys):
        # bf16 gradients of sums over up to s rows: a few bf16 ulps of the
        # largest entries.
        scale = want.grad.float().abs().max().item()
        torch.testing.assert_close(got.grad.float(), want.grad.float(),
                                   atol=BF16_TOL * scale, rtol=BF16_TOL)


def _nan_below(kw, slots_rows, B):
    """A copy of the cache kwargs with NaN (int8: in the scales) in logical
    rows [0, n) of each slot r of ``slots_rows`` {r: n}, through the table
    for a pool."""
    out = {k: t.clone() for k, t in kw.items()}
    names = ("k_scale", "v_scale") if "k_scale" in out else ("k_cache", "v_cache")
    table = out.get("block_table")
    for r, n in slots_rows.items():
        for j in range(n):
            blk, off = (r, j) if table is None else (int(table[r, j // B]), j % B)
            for name in names:
                out[name][blk, :, off] = float("nan")
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("split", [False, True], ids=["written", "split"])
@pytest.mark.parametrize("variant", list(WINDOW_VARIANTS))
def test_windowed_flash_decode_matches_plain_on_gpu(cuda_device, variant, split):
    """Window 128 with lengths at its edge in both conventions: against
    the plain version, a pool bit for bit against the slot cache, and NaN
    in every row below the window changes nothing."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    S, H, KV, hd, max_len, window = 8, 32, 8, 128, 512, 128
    lengths = [0, 1, 127, 128, 129, 300, 511, 64]
    kw, flat = _variant(gen, cuda_device, variant, S, KV, max_len, hd, lengths)
    q = torch.randn((S, H, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    new = {}
    if split:
        new = {k: torch.randn((S, KV, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
               for k in ("k_new", "v_new")}
        if "int8" in variant:
            new = {k: fake_quantize_kv(t) for k, t in new.items()}
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fd.launches
    got = fd.flash_decode(q, lengths=lens, window=window, **new, **kw)
    torch.cuda.synchronize()
    assert fd.launches == before + 1
    want = fd.flash_decode_plain(q, lengths=lens, window=window, **new, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    if flat is not None:
        assert torch.equal(got, fd.flash_decode(q, lengths=lens, window=window, **new, **flat))
    below = {r: max(0, (n if split else n - 1) - window + 1) for r, n in enumerate(lengths)}
    B = WINDOW_VARIANTS[variant][1]
    assert torch.equal(got, fd.flash_decode(q, lengths=lens, window=window, **new,
                                            **_nan_below(kw, below, B)))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(WINDOW_VARIANTS))
def test_windowed_flash_cache_attention_matches_plain_on_gpu(cuda_device, variant):
    """Window 100: rows whose window edge lies past whole 64-key tiles;
    NaN in every tile wholly below a slot's loosest edge changes
    nothing."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    P, c, S, H, KV, hd, max_len, window = 4, 64, 4, 32, 8, 128, 512, 100
    i32 = dict(dtype=torch.int32, device=cuda_device)
    rows = [(2, 0, 64), (0, 200, 17), (3, 300, 64), (1, 448, 64)]
    keys = [max([s0 + n for sl, s0, n in rows if sl == r] or [0]) for r in range(S)]
    kw, flat = _variant(gen, cuda_device, variant, S, KV, max_len, hd, keys)
    q = torch.randn((P, c, H, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    slots, starts, lens = (torch.tensor([r[i] for r in rows], **i32) for i in range(3))
    args = dict(slots=slots, starts=starts, lens=lens, window=window)
    got = fp.flash_cache_attention(q, **args, **kw)
    torch.cuda.synchronize()
    want = fp.flash_cache_attention_plain(q, **args, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    assert torch.all(got[1, 17:] == 0)
    if flat is not None:
        assert torch.equal(got, fp.flash_cache_attention(q, **args, **flat))
    below = {sl: max(0, s0 - window + 1) // 64 * 64 for sl, s0, _ in rows}
    assert torch.equal(got, fp.flash_cache_attention(
        q, **args, **_nan_below(kw, below, WINDOW_VARIANTS[variant][1])))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,s_q,s_kv,H,KV,hd,lengths,window",
    [
        (2, 300, 300, 8, 2, 128, None, 100),       # causal GQA, ragged tiles
        (2, 100, 333, 4, 4, 128, [333, 250], 64),  # offset; row 1's queries see nothing
        (1, 256, 256, 4, 1, 64, [200], 1),         # each query sees itself only
    ],
)
def test_windowed_flash_attention_matches_plain_on_gpu(
    cuda_device, b, s_q, s_kv, H, KV, hd, lengths, window
):
    gen = torch.Generator(device=cuda_device).manual_seed(8)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    q, k, v = r(b, s_q, H, hd), r(b, s_kv, KV, hd), r(b, s_kv, KV, hd)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    got = fa.flash_attention(q, k, v, lens, causal=True, window=window)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, lens, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    zero = want.float().abs().amax(dim=(-1, -2)) == 0
    assert torch.all(got[zero] == 0)
    # Key tiles wholly below the first query tile's edge are never read.
    edge = max(0, s_kv - s_q - window + 1) // 64 * 64
    if edge:
        k2, v2 = k.clone(), v.clone()
        k2[:, :edge] = float("nan")
        v2[:, :edge] = float("nan")
        assert torch.equal(got, fa.flash_attention(q, k2, v2, lens, causal=True, window=window))


@pytest.mark.gpu
def test_windowed_flash_attention_fn_backward_matches_dense_autograd_on_gpu(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    b, s, H, KV, hd, window = 1, 512, 8, 2, 128, 128

    def r(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    q, k, v, g = r(b, s, H, hd), r(b, s, KV, hd), r(b, s, KV, hd), r(b, s, H, hd)
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FlashAttentionFn.apply(*xs, True, None, window)
    out.backward(g)
    ys = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = fa.flash_attention_plain(*ys, causal=True, window=window)
    ref.backward(g)
    torch.testing.assert_close(out.float(), ref.float(), atol=BF16_TOL, rtol=BF16_TOL)
    for got, want in zip(xs, ys):
        scale = want.grad.float().abs().max().item()
        torch.testing.assert_close(got.grad.float(), want.grad.float(),
                                   atol=BF16_TOL * scale, rtol=BF16_TOL)


# -- the Hopper primitives and the tiled kernels' tile edges ----------------


@pytest.mark.gpu
@pytest.mark.parametrize("a_regs", [False, True], ids=["smem_a", "reg_a"])
@pytest.mark.parametrize("b_mn_major", [False, True], ids=["k_major_b", "mn_major_b"])
@pytest.mark.parametrize("n", [64, 128])
def test_sm90_wgmma_matches_torch_on_gpu(cuda_device, n, b_mn_major, a_regs):
    """One warpgroup's wgmma m64nNk16 over 8 k-steps, from the kernels'
    swizzled tiles and descriptors, against an f32 product: only the sum's
    order differs (f32 accumulation of bf16 products)."""
    from gofr_tpu_torch.ops.cuda import sm90_selftest as st

    gen = torch.Generator(device=cuda_device).manual_seed(n + 2 * b_mn_major + a_regs)
    a = torch.randn((64, 128), generator=gen, device=cuda_device).to(torch.bfloat16)
    shape = (128, n) if b_mn_major else (n, 128)
    b = torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    got = st.wgmma_product(a, b, b_mn_major=b_mn_major, a_regs=a_regs)
    torch.cuda.synchronize()
    want = st.wgmma_product_plain(a, b, b_mn_major=b_mn_major)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.gpu
def test_sm90_ring_and_tma_box_on_gpu(cuda_device):
    from gofr_tpu_torch.ops.cuda import sm90_selftest as st

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    src = torch.randint(-30000, 30000, (10, 128, 8), generator=gen, device=cuda_device,
                        dtype=torch.int32).to(torch.int16)
    assert torch.equal(st.ring_roundtrip(src), st.ring_roundtrip_plain(src))
    m = torch.randn((100, 72), generator=gen, device=cuda_device).to(torch.bfloat16)
    for r0 in (0, 64):
        assert torch.equal(st.tma_box(m, r0), st.tma_box_plain(m, r0))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,s_q,s_kv,H,KV,hd,causal,lengths",
    [
        (1, 1, 1, 2, 1, 64, True, None),
        (2, 127, 127, 4, 4, 128, True, None),     # rep 1
        (1, 129, 129, 8, 1, 64, True, [100]),     # rep 8, lengths
        (2, 191, 191, 4, 2, 128, False, None),
        (1, 1, 300, 4, 2, 128, True, None),
    ],
)
def test_flash_attention_tile_edges_on_gpu(cuda_device, b, s_q, s_kv, H, KV, hd, causal,
                                           lengths):
    gen = torch.Generator(device=cuda_device).manual_seed(s_q + s_kv)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    q, k, v = r(b, s_q, H, hd), r(b, s_kv, KV, hd), r(b, s_kv, KV, hd)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32,
                                                     device=cuda_device)
    got = fa.flash_attention(q, k, v, lens, causal=causal)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, lens, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.gpu
def test_flash_attention_reads_a_fused_qkv_view_on_gpu(cuda_device):
    """q, k and v as views of one fused [b, s, H + 2 KV, hd] projection are
    read in place (TMA through their strides), as a contiguous copy is."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    b, s, H, KV, hd = 2, 300, 8, 2, 128
    qkv = torch.randn((b, s, H + 2 * KV, hd), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous()
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    contiguous = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert torch.equal(got, contiguous)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.gpu
def test_flash_attention_refuses_what_tma_cannot_describe_on_gpu(cuda_device):
    """A sequence stride that is not a multiple of 16 bytes, or a base 2
    bytes off, raises: the wrapper never copies silently."""
    b, s, H, hd = 1, 64, 2, 64
    k = torch.zeros((b, s, H, hd), dtype=torch.bfloat16, device=cuda_device)
    flat = torch.zeros(b * s * (H * hd + 4) + 8, dtype=torch.bfloat16, device=cuda_device)
    odd_stride = flat.as_strided((b, s, H, hd), (s * (H * hd + 4), H * hd + 4, hd, 1))
    off_base = flat[1:].as_strided((b, s, H, hd), (s * H * hd, H * hd, hd, 1))
    before = fa.launches
    for q in (odd_stride, off_base):
        with pytest.raises(ValueError, match="TMA"):
            fa.flash_attention(q, k, k, causal=True)
    assert fa.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize(
    "hd,H,KV,c,slots,starts,lens",
    [
        (64, 8, 1, 20, [1, 0], [0, 150], [20, 13]),   # rep 8: 160 rows
        (128, 2, 2, 50, [0, 2], [100, 0], [50, 49]),  # rep 1: 50 rows
        (128, 32, 8, 35, [3, 1], [10, 0], [35, 1]),   # rep 4: 140 rows
    ],
)
def test_flash_cache_attention_tile_edges_on_gpu(cuda_device, hd, H, KV, c, slots, starts,
                                                 lens):
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    S, max_len = 4, 256

    def r(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    q, kc, vc = r(len(slots), c, H, hd), r(S, KV, max_len, hd), r(S, KV, max_len, hd)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    sl, st, ln = (torch.tensor(x, **i32) for x in (slots, starts, lens))
    got = fp.flash_cache_attention(q, kc, vc, sl, st, ln)
    torch.cuda.synchronize()
    want = fp.flash_cache_attention_plain(q, kc, vc, sl, st, ln)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    for p, n in enumerate(lens):
        assert torch.all(got[p, n:] == 0)


# -- clusters and bulk copies, the cluster-split flash_decode, f32, hd 32 ------

# f32 kernels against the f32 plain versions, per output row: max |d| <=
# 1e-4 * rms(row) (another summation order; f32 rounds at 2**-24).
F32_ROW_TOL = 1e-4


def _rows_close(got, want, rel):
    hd = got.shape[-1]
    g, w = got.double().reshape(-1, hd), want.double().reshape(-1, hd)
    d = (g - w).abs().amax(dim=-1)
    rms = w.pow(2).mean(dim=-1).sqrt()
    zero = rms == 0
    assert torch.all(d[zero] == 0)
    assert (d[~zero] / rms[~zero]).max().item() <= rel


@pytest.mark.gpu
def test_sm90_bulk_copy_and_cluster_exchange_on_gpu(cuda_device):
    """A 1-D bulk copy and 4-byte cp.async words under one mbarrier phase;
    a cluster of 4 blocks reading each other's shared memory."""
    from gofr_tpu_torch.ops.cuda import sm90_selftest as st

    gen = torch.Generator(device=cuda_device).manual_seed(8)
    src = torch.randint(0, 256, (4096,), generator=gen, device=cuda_device,
                        dtype=torch.int32).to(torch.uint8)
    words = torch.randint(-2**31, 2**31 - 1, (37,), generator=gen, device=cuda_device,
                          dtype=torch.int32)
    dst, dst_words = st.bulk_roundtrip(src, words)
    assert torch.equal(dst, src) and torch.equal(dst_words, words)
    x = torch.randint(-2**31, 2**31 - 1, (12, 128), generator=gen, device=cuda_device,
                      dtype=torch.int32)
    got, ranks = st.cluster_exchange(x)
    want, want_ranks = st.cluster_exchange_plain(x)
    assert torch.equal(got, want) and torch.equal(ranks, want_ranks)


def _decode_raw(q, kw, lens, new, window, cluster):
    """flash_decode's kernel with an explicit cluster size (the wrapper
    picks it from the shapes)."""
    out = fd.launch_with_cluster(
        q, kw["k_cache"], kw["v_cache"], lens, new.get("k_new"), new.get("v_new"),
        kw.get("k_scale"), kw.get("v_scale"), kw.get("block_table"), q.shape[2] ** -0.5,
        window, cluster)
    torch.cuda.synchronize()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", list(WINDOW_VARIANTS))
def test_flash_decode_cluster_sizes_on_gpu(cuda_device, variant, cluster):
    """Each cluster size on lengths 0, 1, a tile edge +- 1 (32 rows a bf16
    tile at hd 128, 64 int8) and rows shorter than C tiles, windowed and
    not, both conventions: against the plain version; a pool bit for bit
    the slot cache's; NaN below the window changes no bit; a second launch
    gives the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(60 + cluster)
    S, H, KV, hd, max_len = 8, 32, 8, 128, 512
    lengths = [0, 1, 31, 33, 63, 65, 300, 511]
    kw, flat = _variant(gen, cuda_device, variant, S, KV, max_len, hd, lengths)
    q = torch.randn((S, H, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    B = WINDOW_VARIANTS[variant][1]
    for split in (False, True):
        new = {}
        if split:
            new = {k: torch.randn((S, KV, hd), generator=gen, device=cuda_device)
                   .to(torch.bfloat16) for k in ("k_new", "v_new")}
            if "int8" in variant:
                new = {k: fake_quantize_kv(t) for k, t in new.items()}
        for window in (0, 100):
            got = _decode_raw(q, kw, lens, new, window, cluster)
            want = fd.flash_decode_plain(q, lengths=lens, window=window, **new, **kw)
            torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
            assert torch.equal(got, _decode_raw(q, kw, lens, new, window, cluster))
            if flat is not None:
                assert torch.equal(got, _decode_raw(q, flat, lens, new, window, cluster))
            if window:
                below = {r: max(0, (n if split else n - 1) - window + 1)
                         for r, n in enumerate(lengths)}
                assert torch.equal(got, _decode_raw(q, _nan_below(kw, below, B), lens, new,
                                                    window, cluster))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(WINDOW_VARIANTS))
def test_f32_kernels_match_plain_on_gpu(cuda_device, variant):
    """f32 queries (and f32 caches, or int8 with scales) through all three
    kernels, windowed and paged as the variant says, against the f32 plain
    versions at 1e-4 per row; each launches its kernel once."""
    gen = torch.Generator(device=cuda_device).manual_seed(61)
    dev = cuda_device
    quant, B = WINDOW_VARIANTS[variant]
    S, H, KV, hd, max_len, window = 4, 8, 2, 64, 256, 50
    lengths = [0, 1, 100, 255]
    kw, flat = _variant(gen, dev, variant, S, KV, max_len, hd, lengths)
    kw = {k: (t.float() if t.dtype == torch.bfloat16 else t) for k, t in kw.items()}
    q = torch.randn((S, H, hd), generator=gen, device=dev)
    new = {k: torch.randn((S, KV, hd), generator=gen, device=dev) for k in ("k_new", "v_new")}
    if quant:
        new = {k: fake_quantize_kv(t) for k, t in new.items()}
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for w in (0, window):
        before = fd.launches
        got = fd.flash_decode(q, lengths=lens, window=w, **new, **kw)
        torch.cuda.synchronize()
        assert fd.launches == before + 1 and got.dtype == torch.float32
        _rows_close(got, fd.flash_decode_plain(q, lengths=lens, window=w, **new, **kw),
                    F32_ROW_TOL)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = [(2, 0, 40), (2, 50, 17), (3, 200, 40), (1, 0, 0)]
    slots, starts, lns = (torch.tensor([r[i] for r in rows], **i32) for i in range(3))
    qc = torch.randn((4, 40, H, hd), generator=gen, device=dev)
    for w in (0, window):
        args = dict(slots=slots, starts=starts, lens=lns, window=w)
        before = fp.launches
        got = fp.flash_cache_attention(qc, **args, **kw)
        torch.cuda.synchronize()
        assert fp.launches == before + 1
        _rows_close(got, fp.flash_cache_attention_plain(qc, **args, **kw), F32_ROW_TOL)
    b, s = 2, 150
    qa, k, v = (torch.randn((b, s, n, hd), generator=gen, device=dev) for n in (H, KV, KV))
    for causal, lengths_, w in ((True, None, 0), (True, [150, 70], 40), (False, [150, 0], 0)):
        ln = None if lengths_ is None else torch.tensor(lengths_, **i32)
        before = fa.launches
        got = fa.flash_attention(qa, k, v, ln, causal=causal, window=w)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        _rows_close(got, fa.flash_attention_plain(qa, k, v, ln, causal=causal, window=w),
                    F32_ROW_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,s_q,s_kv,H,KV,causal,lengths,window",
    [
        (2, 300, 300, 8, 2, True, None, 0),      # causal GQA (llama-tiny's ratio)
        (2, 100, 333, 4, 4, True, [333, 0], 0),  # offset, lengths with an empty row
        (2, 64, 64, 4, 1, False, [64, 17], 0),   # non-causal lengths, MQA
        (1, 400, 400, 8, 2, True, None, 96),     # causal window
    ],
)
def test_flash_attention_hd32_on_gpu(cuda_device, b, s_q, s_kv, H, KV, causal, lengths, window):
    """hd 32 (llama-tiny) on a 64-column panel: the tensor maps' boxes
    reach past the 32 columns and TMA fills zeros there."""
    gen = torch.Generator(device=cuda_device).manual_seed(62)
    q, k, v = (torch.randn((b, s, n, 32), generator=gen, device=cuda_device).to(torch.bfloat16)
               for s, n in ((s_q, H), (s_kv, KV), (s_kv, KV)))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32,
                                                     device=cuda_device)
    got = fa.flash_attention(q, k, v, lens, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, lens, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    zero = want.float().abs().amax(dim=(-1, -2)) == 0
    assert torch.all(got[zero] == 0)


# The other families' head shapes (H, KV, hd): Qwen2-7B's ratio of 7,
# Gemma-7B's hd 256 at ratio 1 and Gemma-2B's at ratio 8 (MQA).
FAMILY_SHAPES = {"ratio7": (14, 2, 128), "hd256": (4, 4, 256), "hd256_mqa": (8, 1, 256)}


@pytest.mark.gpu
@pytest.mark.parametrize("split", [False, True], ids=["written", "split"])
@pytest.mark.parametrize("variant", list(WINDOW_VARIANTS))
@pytest.mark.parametrize("shape", list(FAMILY_SHAPES))
def test_family_shapes_flash_decode_on_gpu(cuda_device, shape, variant, split):
    """flash_decode at the families' shapes on every cache kind, in both
    conventions: the plain version's answer, one launch, the pool bit for
    bit the slot cache."""
    gen = torch.Generator(device=cuda_device).manual_seed(71)
    H, KV, hd = FAMILY_SHAPES[shape]
    S, max_len = 6, 512
    lengths = [0, 1, 100, 257, 511, 64]
    kw, flat = _variant(gen, cuda_device, variant, S, KV, max_len, hd, lengths)
    q = torch.randn((S, H, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    new = {}
    if split:
        new = {k: torch.randn((S, KV, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
               for k in ("k_new", "v_new")}
        if "int8" in variant:
            new = {k: fake_quantize_kv(t) for k, t in new.items()}
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fd.launches
    got = fd.flash_decode(q, lengths=lens, **new, **kw)
    torch.cuda.synchronize()
    assert fd.launches == before + 1
    want = fd.flash_decode_plain(q, lengths=lens, **new, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    if flat is not None:
        assert torch.equal(got, fd.flash_decode(q, lengths=lens, **new, **flat))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(WINDOW_VARIANTS))
@pytest.mark.parametrize("shape", list(FAMILY_SHAPES))
def test_family_shapes_flash_cache_attention_on_gpu(cuda_device, shape, variant):
    """flash_cache_attention at the families' shapes (7 chunk rows a token;
    hd 256 on 64-key tiles, int8 staged K then V) on every cache kind:
    the plain version's answer, padding rows 0, the pool bit for bit the
    slot cache."""
    gen = torch.Generator(device=cuda_device).manual_seed(72)
    H, KV, hd = FAMILY_SHAPES[shape]
    P, c, S, max_len = 4, 64, 4, 512
    i32 = dict(dtype=torch.int32, device=cuda_device)
    rows = [(2, 0, 64), (0, 64, 17), (3, 300, 64), (2, 0, 64)]
    keys = [max([s0 + n for sl, s0, n in rows if sl == r] or [0]) for r in range(S)]
    kw, flat = _variant(gen, cuda_device, variant, S, KV, max_len, hd, keys)
    q = torch.randn((P, c, H, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    q[3] = q[0]
    slots, starts, lens = (torch.tensor([r[i] for r in rows], **i32) for i in range(3))
    before = fp.launches
    got = fp.flash_cache_attention(q, slots=slots, starts=starts, lens=lens, **kw)
    torch.cuda.synchronize()
    assert fp.launches == before + 1
    want = fp.flash_cache_attention_plain(q, slots=slots, starts=starts, lens=lens, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    assert torch.all(got[1, 17:] == 0)
    if flat is not None:
        assert torch.equal(got, fp.flash_cache_attention(q, slots=slots, starts=starts,
                                                         lens=lens, **flat))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,s,H,KV,lengths,window,dtype",
    [
        (2, 300, 4, 2, [300, 0], 0, torch.bfloat16),  # lengths with an empty row, GQA
        (2, 200, 8, 1, None, 0, torch.bfloat16),      # MQA: a head group of 8
        (1, 400, 4, 4, None, 96, torch.bfloat16),     # causal window
        (2, 150, 4, 2, [150, 70], 40, torch.float32),  # the f32 CUDA-core kernel
    ],
)
def test_flash_attention_hd256_on_gpu(cuda_device, b, s, H, KV, lengths, window, dtype):
    """flash_attention at hd 256 (Gemma): causal, with lengths, a window,
    and f32; rows that see no key exactly 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(73)
    q, k, v = (torch.randn((b, s, n, 256), generator=gen, device=cuda_device).to(dtype)
               for n in (H, KV, KV))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32,
                                                     device=cuda_device)
    before = fa.launches
    got = fa.flash_attention(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, lens, window=window)
    if dtype == torch.float32:
        _rows_close(got, want, F32_ROW_TOL)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL, rtol=BF16_TOL)
    zero = want.float().abs().amax(dim=(-1, -2)) == 0
    assert torch.all(got[zero] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["bf16", "paged+int8"], ids=["f32", "f32_int8_pool"])
def test_f32_flash_cache_attention_hd256_on_gpu(cuda_device, variant):
    """The f32 CUDA-core chunk kernel at hd 256 (its tiles past 48 KB of
    shared memory) on an f32 slot cache and an int8 pool, at 1e-4 per row."""
    gen = torch.Generator(device=cuda_device).manual_seed(74)
    H, KV, hd, P, c, S, max_len = 4, 2, 256, 3, 40, 4, 256
    rows = [(2, 0, 40), (0, 100, 17), (3, 200, 40)]
    keys = [max([s0 + n for sl, s0, n in rows if sl == r] or [0]) for r in range(S)]
    kw, _ = _variant(gen, cuda_device, variant, S, KV, max_len, hd, keys)
    kw = {k: (t.float() if t.dtype == torch.bfloat16 else t) for k, t in kw.items()}
    q = torch.randn((P, c, H, hd), generator=gen, device=cuda_device)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    slots, starts, lens = (torch.tensor([r[i] for r in rows], **i32) for i in range(3))
    got = fp.flash_cache_attention(q, slots=slots, starts=starts, lens=lens, **kw)
    torch.cuda.synchronize()
    _rows_close(got, fp.flash_cache_attention_plain(q, slots=slots, starts=starts, lens=lens,
                                                    **kw), F32_ROW_TOL)


def _decode_state(dev, cfg, S, L, flags, history_len=1):
    from gofr_tpu_torch.ops.kv_cache import KVCache
    from gofr_tpu_torch.serving.programs import SlotPlanes

    cache = KVCache.create(cfg.n_layers, S, L, cfg.n_kv_heads, cfg.head_dim, dtype=cfg.dtype,
                           device=dev)
    return cache, SlotPlanes.create(S, dev, cfg.vocab_size, flags, history_len=history_len)


def _copy_decode_state(dst, src):
    for a, b in ((dst[0].k, src[0].k), (dst[0].v, src[0].v), (dst[0].lengths, src[0].lengths)):
        a.copy_(b)
    for name in ("tokens", "nsteps", "seeds", "temps", "greedy", "active", "topps", "fpen",
                 "ppen", "pcounts", "bidx", "bval", "history"):
        getattr(dst[1], name).copy_(getattr(src[1], name))


@pytest.mark.gpu
def test_captured_decode_window_and_mega_window_match_eager_on_gpu(cuda_device):
    """llama-tiny (bf16, hd 32) on 4 slots: the decode programs captured as
    CUDA graphs while every slot is inactive, then replayed on a copy of a
    state after a prefill, against the eager programs on the other copy:
    every static variant's tokens identical and logprobs within 1e-3, the
    launch counters under replay equal to the eager counts; the mega
    window's WHILE graph runs min(m, ceil(max(remaining) / k)) windows and
    gives the plain windows' tokens."""
    import math

    from gofr_tpu_torch.models.registry import get_model
    from gofr_tpu_torch.models.transformer import init_params, rope_tables
    from gofr_tpu_torch.ops.cuda import launch_counts, replayed, reset_launch_counts
    from gofr_tpu_torch.serving import programs as pg

    cfg = get_model("llama-tiny").config
    S, L, k, m = 4, 256, 4, 3
    flags = pg.SamplerFlags()
    with torch.inference_mode():
        params = init_params(cfg, 0, cuda_device)
        rope = rope_tables(cfg, L, cuda_device)
        eager, graphed = (_decode_state(cuda_device, cfg, S, L, flags) for _ in range(2))
        mega = pg.MegaState.create(S, k, m, 0, cuda_device)

        def win(st, sampling, use_bias):
            return pg.decode_window(params, st[0], cfg, rope, st[1], flags, k, 2,
                                    sampling=sampling, use_bias=use_bias)

        graphs = pg.DecodeGraphs(window_fn=lambda s, b: win(graphed, s, b))
        megas = pg.DecodeGraphs(mega_fns=(
            lambda: pg.mega_begin(mega),
            lambda s, b: pg.mega_step(params, graphed[0], cfg, rope, graphed[1], flags, k, m,
                                      2, 2**30, mega, sampling=s, use_bias=b),
            mega.go))
        i32 = dict(dtype=torch.int32, device=cuda_device)
        ones = torch.ones((S,), dtype=torch.bool, device=cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        toks = torch.randint(0, cfg.vocab_size, (S, 32), generator=gen, device=cuda_device)
        planes = eager[1]
        planes.bidx[:, 0] = 7
        planes.bval[:, 0] = 4.0
        pg.prefill_chunk_step(params, eager[0], cfg, rope, planes, flags, toks,
                              torch.arange(S, **i32), torch.zeros((S,), **i32),
                              torch.tensor([1, 9, 20, 32], **i32), ones, ones,
                              torch.ones((S,), device=cuda_device), ones,
                              torch.ones((S,), device=cuda_device), 2, sampling=False)
        planes.active.fill_(True)
        planes.temps.fill_(0.8)
        planes.greedy.copy_(torch.tensor([True, False, True, False], device=cuda_device))
        start = _decode_state(cuda_device, cfg, S, L, flags)
        _copy_decode_state(start, eager)
        for v in pg.VARIANTS:
            _copy_decode_state(eager, start)
            _copy_decode_state(graphed, start)
            reset_launch_counts()
            want = win(eager, *v).clone()
            torch.cuda.synchronize()
            eager_counts = launch_counts()
            reset_launch_counts()
            got = graphs.window(*v).clone()
            torch.cuda.synchronize()
            assert launch_counts() == eager_counts
            assert eager_counts["flash_decode"] == k * cfg.n_layers
            assert torch.equal(got[0], want[0]), v
            assert float((got[1] - want[1]).abs().max()) <= 1e-3
        remaining = (0, 3, 6, 1)
        _copy_decode_state(eager, start)
        _copy_decode_state(graphed, start)
        n = min(m, math.ceil(max(remaining) / k))
        plain = torch.cat([win(eager, False, False) for _ in range(n)], dim=1)
        mega.remaining.copy_(torch.tensor(remaining, device=cuda_device))
        reset_launch_counts()
        record = megas.mega(False, False)
        torch.cuda.synchronize()
        assert int(mega.w) == n == 2
        replayed(record, int(mega.w))
        assert launch_counts()["flash_decode"] == n * k * cfg.n_layers
        assert torch.equal(mega.emitted[0, : n * k], plain[0])
        assert not mega.emitted[:, n * k:].any()


@pytest.mark.gpu
def test_captured_spec_window_and_mega_spec_window_match_eager_on_gpu(cuda_device):
    """llama-tiny (bf16) on 4 slots at G = 2: the speculative window
    captured while every slot is inactive, replayed on a copy of a state
    after a prefill (a repeated prompt, so drafts accept), against the
    eager window on the other copy: every static variant's tokens and
    counts identical, logprobs within 1e-3, flash_decode launched k·(G+1)
    times a layer, counted through the replay; the mega spec window's
    WHILE graph gives the plain spec windows' tokens and counts."""
    from gofr_tpu_torch.models.registry import get_model
    from gofr_tpu_torch.models.transformer import init_params, rope_tables
    from gofr_tpu_torch.ops.cuda import launch_counts, replayed, reset_launch_counts
    from gofr_tpu_torch.serving import programs as pg

    cfg = get_model("llama-tiny").config
    S, L, k, m, G = 4, 256, 4, 3, 2
    flags = pg.SamplerFlags()
    with torch.inference_mode():
        params = init_params(cfg, 0, cuda_device)
        rope = rope_tables(cfg, L, cuda_device)
        eager, graphed = (_decode_state(cuda_device, cfg, S, L, flags, L) for _ in range(2))
        mega = pg.MegaState.create(S, k, m, 0, cuda_device, spec_tokens=G)

        def win(st, sampling, use_bias):
            return pg.spec_window(params, st[0], cfg, rope, st[1], flags, k, G, 2,
                                  sampling=sampling, use_bias=use_bias)

        graphs = pg.DecodeGraphs(window_fn=lambda s, b: win(graphed, s, b))
        megas = pg.DecodeGraphs(mega_fns=(
            lambda: pg.mega_begin(mega),
            lambda s, b: pg.mega_step(params, graphed[0], cfg, rope, graphed[1], flags, k, m,
                                      2, 2**30, mega, sampling=s, use_bias=b, spec_tokens=G),
            mega.go))
        i32 = dict(dtype=torch.int32, device=cuda_device)
        ones = torch.ones((S,), dtype=torch.bool, device=cuda_device)
        toks = torch.tensor([list(range(5, 13)) * 4] * S, device=cuda_device)
        planes = eager[1]
        planes.bidx[:, 0] = 7
        planes.bval[:, 0] = 4.0
        pg.prefill_chunk_step(params, eager[0], cfg, rope, planes, flags, toks,
                              torch.arange(S, **i32), torch.zeros((S,), **i32),
                              torch.tensor([9, 17, 24, 32], **i32), ones, ones,
                              torch.ones((S,), device=cuda_device), ones,
                              torch.ones((S,), device=cuda_device), 2, sampling=False,
                              history=True)
        planes.active.fill_(True)
        planes.temps.fill_(0.8)
        planes.greedy.copy_(torch.tensor([True, False, True, False], device=cuda_device))
        start = _decode_state(cuda_device, cfg, S, L, flags, L)
        _copy_decode_state(start, eager)
        for v in pg.VARIANTS:
            _copy_decode_state(eager, start)
            _copy_decode_state(graphed, start)
            reset_launch_counts()
            want = win(eager, *v).clone()
            torch.cuda.synchronize()
            eager_counts = launch_counts()
            reset_launch_counts()
            got = graphs.window(*v).clone()
            torch.cuda.synchronize()
            assert launch_counts() == eager_counts
            assert eager_counts["flash_decode"] == k * (G + 1) * cfg.n_layers
            assert torch.equal(got[: G + 1], want[: G + 1]), v
            assert torch.equal(got[2 * G + 2], want[2 * G + 2]), v
            assert float((got[G + 1: 2 * G + 2] - want[G + 1: 2 * G + 2]).abs().max()) <= 1e-3
            assert torch.equal(eager[0].lengths, graphed[0].lengths)
            assert torch.equal(eager[1].history, graphed[1].history)
        assert int(want[2 * G + 2].max()) > 1  # drafts were accepted
        _copy_decode_state(eager, start)
        _copy_decode_state(graphed, start)
        plain = torch.cat([win(eager, False, False) for _ in range(m)], dim=1)
        mega.remaining.copy_(torch.full((S,), 10**6, device=cuda_device))
        reset_launch_counts()
        record = megas.mega(False, False)
        torch.cuda.synchronize()
        assert int(mega.w) == m
        replayed(record, m)
        assert launch_counts()["flash_decode"] == m * k * (G + 1) * cfg.n_layers
        assert torch.equal(mega.emitted[: G + 1], plain[: G + 1])
        assert torch.equal(mega.emitted[2 * G + 2], plain[2 * G + 2])


@pytest.mark.gpu
def test_spec_engine_captures_nothing_after_start_on_gpu(cuda_device, monkeypatch):
    """A speculative engine captures its graphs when its scheduler starts;
    greedy, seeded-sampled and logit-bias traffic afterwards captures no
    graph (the counterpart of the reference's zero steady-state
    recompiles with spec on), and its streams equal a spec-off engine's
    on the same weights."""
    from gofr_tpu_torch.serving import programs as pg
    from gofr_tpu_torch.serving.engine import InferenceEngine

    variants = (dict(max_new_tokens=8, temperature=0.0, stop_on_eos=False),
                dict(max_new_tokens=8, temperature=0.8, seed=3, stop_on_eos=False),
                dict(max_new_tokens=8, temperature=0.0, stop_on_eos=False,
                     logit_bias={5: -100.0}))
    prompt = ("abcdefgh" * 4)[:30]
    out = {}
    for G in (0, 2):
        eng = InferenceEngine("llama-tiny", n_slots=4, max_len=256, window_k=4,
                              spec_tokens=G, device=cuda_device)
        try:
            eng.generate_sync(prompt, **variants[0])  # the scheduler has captured
            captured = []
            orig = pg.Captured.__init__
            monkeypatch.setattr(pg.Captured, "__init__",
                                lambda self, *a, **kw: captured.append(1) or orig(self, *a, **kw))
            out[G] = [eng.generate_sync(prompt, **kw).token_ids for kw in variants]
            monkeypatch.setattr(pg.Captured, "__init__", orig)
            assert captured == []
            assert len(eng._graphs.windows) == 4
        finally:
            eng.close()
    assert out[2] == out[0]


@pytest.mark.gpu
def test_engines_return_captured_and_survive_device_syncs_on_gpu(cuda_device):
    """The constructor returns once its scheduler has captured the decode
    programs, so the caller's device-wide synchronize on the next line
    cannot invalidate the capture; two engines built on two threads at
    once take turns capturing. Each then serves the same greedy stream."""
    import threading

    from gofr_tpu_torch.serving.engine import InferenceEngine

    def build():
        return InferenceEngine("llama-tiny", n_slots=4, max_len=256, window_k=4,
                               device=cuda_device)

    eng = build()
    try:
        assert eng._graphs is not None
        for _ in range(200):
            torch.cuda.synchronize()
        want = eng.generate_sync("abcdefgh", max_new_tokens=8, stop_on_eos=False).token_ids
    finally:
        eng.close()
    built = [None, None]
    threads = [threading.Thread(target=lambda i=i: built.__setitem__(i, build()))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        for e in built:
            assert e._graphs is not None
            got = e.generate_sync("abcdefgh", max_new_tokens=8, stop_on_eos=False).token_ids
            assert got == want
    finally:
        for e in built:
            if e is not None:
                e.close()
