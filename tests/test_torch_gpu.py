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
from gofr_tpu_torch.ops.kv_cache import fake_quantize_kv, quantize_kv


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
