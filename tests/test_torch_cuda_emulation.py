"""The port's CUDA kernel sources, run on the CPU.

``gofr_tpu_torch/csrc/*.cu`` is compiled by the host C++ compiler against
``tests/cuda_emu/cuda_mock.h``, which emulates the CUDA subset the
kernels use (one fiber per CUDA thread, barriers for ``__syncthreads``
and warp shuffles; ``tests/cuda_emu/mma.cuh`` replaces
the tensor-core product with its documented fragment layout), and the C
entries are called through ctypes on CPU tensors. Their outputs are held against the plain
versions at small shapes covering every head-dim and GQA template the
wrappers accept, and the serving kernels' int8, paged and paged+int8
variants (a shuffled block table over a pool whose parking block and
unused blocks hold garbage). This checks the kernels' indexing, masking,
online softmax and merges on every CPU run; the card itself (timing, the
real compiler, the real memory model) is checked by ``chip_smoke.py``.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention_plain
from gofr_tpu_torch.ops.cuda.flash_decode import flash_decode_plain
from gofr_tpu_torch.ops.cuda.flash_prefill import flash_cache_attention_plain
from gofr_tpu_torch.ops.kv_cache import fake_quantize_kv, quantize_kv

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "gofr_tpu_torch" / "csrc"
MOCK = REPO / "tests" / "cuda_emu"
# bf16 outputs; the kernels keep probabilities in f32 where the plain
# versions round them to bf16, and sum in another order: a few bf16 ulps
# (2**-8 relative) on values of magnitude ~1-4.
TOL = 2e-2


def _emulate(sources: dict[str, str], out: Path) -> ctypes.CDLL:
    """Compile CUDA sources (file stem -> text) against the mock and load
    them, with the C entries' argument types set."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) to emulate the kernels")
    srcs = []
    for stem, s in sources.items():
        s = s.replace(
            "extern __shared__ __align__(16) unsigned char smem_raw[];",
            "unsigned char* smem_raw = mock_smem;",
        )
        s = re.sub(r"(\w+)<<<", r"mock_launch(\1, ", s).replace(">>>(", ", ")
        dst = out / (stem + ".cpp")
        dst.write_text(s)
        srcs.append(str(dst))
    # One compiler per source, all started together, then one link.
    flags = ["-std=c++20", "-O1", "-fno-strict-aliasing", "-fPIC", "-I", str(MOCK)]
    procs = [
        subprocess.Popen([cxx, *flags, "-c", src, "-o", src + ".o"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in srcs
    ]
    for proc in procs:
        msg, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, msg
    lib = out / "libemu.so"
    res = subprocess.run(
        [cxx, "-shared", *(src + ".o" for src in srcs), "-o", str(lib)],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    dll = ctypes.CDLL(str(lib))
    entries = {
        "gofr_flash_decode": (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        ),
        "gofr_flash_cache_attention": (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        ),
        "gofr_flash_attention": (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
        ),
    }
    for name, argtypes in entries.items():
        if hasattr(dll, name):
            getattr(dll, name).argtypes = argtypes
    return dll


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return _emulate(
        {cu.stem: cu.read_text() for cu in sorted(CSRC.glob("*.cu"))},
        tmp_path_factory.mktemp("cuda_emu"),
    )


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16
    )


def _ptr(t):
    return None if t is None else t.data_ptr()


@pytest.mark.parametrize("split", [False, True], ids=["written", "split"])
@pytest.mark.parametrize(
    "hd,H,KV,lengths",
    [
        (32, 8, 2, [0, 1, 37]),     # rep 4, 8 rows per warp load
        (128, 8, 2, [0, 1, 99]),    # the llama-3-8b head dim
        (64, 4, 4, [3, 0, 64]),     # MHA (rep 1)
        (256, 8, 1, [0, 99, 17]),   # MQA (rep 8), one row per warp load
        (128, 4, 2, [100, 50, 1]),  # rep 2
    ],
)
def test_emulated_flash_decode_matches_plain(emu_lib, hd, H, KV, lengths, split):
    rng = np.random.default_rng(hd + H)
    S, max_len = 3, 100
    q, kc, vc = _bf16(rng, S, H, hd), _bf16(rng, S, KV, max_len, hd), _bf16(rng, S, KV, max_len, hd)
    kn, vn = (_bf16(rng, S, KV, hd), _bf16(rng, S, KV, hd)) if split else (None, None)
    lens = torch.tensor(lengths, dtype=torch.int32)
    out = torch.empty_like(q)
    rc = emu_lib.gofr_flash_decode(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), lens.data_ptr(), _ptr(kn),
        _ptr(vn), None, None, None, out.data_ptr(), S, H, KV, max_len, 0, hd,
        hd**-0.5, None,
    )
    assert rc == 0
    want = flash_decode_plain(q, kc, vc, lens, k_new=kn, v_new=vn)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize(
    "hd,H,KV,c,slots,starts,lens",
    [
        # Full rows, a short row, a padding row duplicating row 0.
        (32, 4, 2, 8, [2, 0, 3, 2], [0, 5, 70, 0], [8, 3, 8, 8]),
        # Several 64-row query tiles and key tiles; a row starting mid-tile.
        (128, 8, 2, 40, [2, 0, 3, 2], [0, 64, 10, 0], [40, 17, 40, 40]),
        # MHA with a tile that is padding only (lens 0) and one at 0.
        (64, 4, 4, 20, [1, 3, 0], [0, 3, 0], [0, 20, 0]),
    ],
)
def test_emulated_flash_cache_attention_matches_plain(
    emu_lib, hd, H, KV, c, slots, starts, lens
):
    rng = np.random.default_rng(c)
    S, max_len, P = 4, 160, len(slots)
    q, kc, vc = _bf16(rng, P, c, H, hd), _bf16(rng, S, KV, max_len, hd), _bf16(rng, S, KV, max_len, hd)
    i32 = dict(dtype=torch.int32)
    sl, st, ln = torch.tensor(slots, **i32), torch.tensor(starts, **i32), torch.tensor(lens, **i32)
    out = torch.empty_like(q)
    rc = emu_lib.gofr_flash_cache_attention(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), sl.data_ptr(),
        st.data_ptr(), ln.data_ptr(), None, None, None, out.data_ptr(), P, c,
        H, KV, max_len, 0, hd, hd**-0.5, None,
    )
    assert rc == 0
    want = flash_cache_attention_plain(q, kc, vc, sl, st, ln)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)


def test_emulated_entries_refuse_unsupported_shapes(emu_lib):
    z = torch.zeros(8, dtype=torch.bfloat16)
    p = z.data_ptr()
    # head_dim 48, n_heads not a multiple of n_kv, a pool block that is not
    # a multiple of 16 and one scale without the other are refused, not run.
    n = None
    assert emu_lib.gofr_flash_decode(p, p, p, p, n, n, n, n, n, p, 1, 4, 2, 8, 0, 48, 1.0, n) != 0
    assert emu_lib.gofr_flash_decode(p, p, p, p, n, n, n, n, n, p, 1, 3, 2, 8, 0, 32, 1.0, n) != 0
    assert emu_lib.gofr_flash_decode(p, p, p, p, n, n, n, n, p, p, 1, 4, 2, 8, 2, 32, 1.0, n) != 0
    assert emu_lib.gofr_flash_decode(p, p, p, p, n, n, p, n, n, p, 1, 4, 2, 8, 0, 32, 1.0, n) != 0
    assert emu_lib.gofr_flash_cache_attention(p, p, p, p, p, p, n, n, n, p, 1, 1, 4, 2, 8, 0, 256, 1.0, n) != 0
    assert emu_lib.gofr_flash_cache_attention(p, p, p, p, p, p, n, n, p, p, 1, 1, 4, 2, 24, 2, 32, 1.0, n) != 0
    st = (ctypes.c_longlong * 9)()
    # flash_attention takes hd 64 and 128 only (32 is refused), and GQA groups.
    assert emu_lib.gofr_flash_attention(p, p, p, None, p, 1, 1, 1, 4, 2, 32, 1, st, 1.0, None) != 0
    assert emu_lib.gofr_flash_attention(p, p, p, None, p, 1, 1, 1, 3, 2, 64, 1, st, 1.0, None) != 0


# -- int8 / paged / paged+int8 variants of the two serving kernels --------

# (kv_quant, pool block): B=16 is the smallest pool block the kernels take.
VARIANTS = {"int8": (True, 0), "paged": (False, 16), "paged+int8": (True, 16)}
GARBAGE = 3e4  # in the parking block and unused pool blocks: a leak shows


def _cache(rng, rows, KV, max_len, hd, quant):
    """Logical caches [rows, KV, max_len, hd]: bf16, or int8 with their
    f32 scales (quantized from normal values, as the model writes them)."""
    k, v = _bf16(rng, rows, KV, max_len, hd), _bf16(rng, rows, KV, max_len, hd)
    if not quant:
        return [k, v]
    (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    return [k, v, ks, vs]


def _garbage(rng, shape, dtype):
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], shape).astype(np.float32))
    return (sign * GARBAGE).to(dtype)


def _pool(rng, logical, keys, B):
    """The keys [0, keys[r]) of each row of the logical caches, moved into
    pools [n_blocks, KV, B, ...] under a shuffled block table; block 0,
    three unused blocks and every table entry past a row's keys (0) hold
    garbage. Returns (pools, table [rows, max_len // B] int32)."""
    rows, KV, max_len = logical[0].shape[:3]
    need = [-(-n // B) for n in keys]
    n_blocks = sum(need) + 4
    perm = iter(rng.permutation(np.arange(1, n_blocks)).tolist())
    pools = [_garbage(rng, (n_blocks, KV, B, *t.shape[3:]), t.dtype) for t in logical]
    table = torch.zeros((rows, max_len // B), dtype=torch.int32)
    for r in range(rows):
        for j in range(need[r]):
            blk = next(perm)
            table[r, j] = blk
            for pool, t in zip(pools, logical):
                pool[blk] = t[r, :, j * B:(j + 1) * B]
    return pools, table


def _call_decode(lib, q, cache, lens, kn, vn, table, B):
    S, H, hd = q.shape
    KV = cache[0].shape[1]
    k_s, v_s = (cache[2], cache[3]) if len(cache) == 4 else (None, None)
    out = torch.empty_like(q)
    rc = lib.gofr_flash_decode(
        q.data_ptr(), cache[0].data_ptr(), cache[1].data_ptr(), lens.data_ptr(),
        _ptr(kn), _ptr(vn), _ptr(k_s), _ptr(v_s), _ptr(table), out.data_ptr(),
        S, H, KV, B if table is not None else cache[0].shape[2],
        0 if table is None else table.shape[1], hd, hd**-0.5, None,
    )
    assert rc == 0
    return out


DECODE_VARIANT_SHAPES = [
    # hd, H, KV, lengths (max_len 112 = 7 blocks of 16)
    (128, 8, 2, [0, 1, 50, 112]),  # llama GQA (rep 4); an empty row, a full one
    (32, 4, 4, [17, 0, 3, 96]),    # MHA, 8 rows per warp load
]


def _decode_variant(lib, variant, split, hd, H, KV, lengths):
    """(kernel output, plain output, contiguous-kernel output or None)."""
    quant, B = VARIANTS[variant]
    rng = np.random.default_rng(hd + H + 7 * split)
    S, max_len = len(lengths), 112
    q = _bf16(rng, S, H, hd)
    kn, vn = (_bf16(rng, S, KV, hd), _bf16(rng, S, KV, hd)) if split else (None, None)
    if quant and split:  # the model attends the new token fake-quantized
        kn, vn = fake_quantize_kv(kn), fake_quantize_kv(vn)
    lens = torch.tensor(lengths, dtype=torch.int32)
    cache = _cache(rng, S, KV, max_len, hd, quant)
    contiguous = None
    table = None
    if B:
        contiguous = _call_decode(lib, q, cache, lens, kn, vn, None, 0)
        cache, table = _pool(rng, cache, lengths, B)
    scales = dict(k_scale=cache[2], v_scale=cache[3]) if quant else {}
    want = flash_decode_plain(q, cache[0], cache[1], lens, k_new=kn, v_new=vn,
                              block_table=table, **scales)
    return _call_decode(lib, q, cache, lens, kn, vn, table, B), want, contiguous


@pytest.mark.parametrize("split", [False, True], ids=["written", "split"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("hd,H,KV,lengths", DECODE_VARIANT_SHAPES)
def test_emulated_flash_decode_variants_match_plain(emu_lib, variant, split, hd, H, KV, lengths):
    out, want, contiguous = _decode_variant(emu_lib, variant, split, hd, H, KV, lengths)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
    if not split:
        assert torch.all(out[torch.tensor(lengths) == 0] == 0)
    if contiguous is not None:  # the pool gives the slot cache's bits
        assert torch.equal(out, contiguous)


PREFILL_VARIANT_SHAPES = [
    # hd, H, KV, c, slots, starts, lens (max_len 160 = 10 blocks of 16): full
    # rows, a short row mid-cache, a padding row duplicating row 0.
    (128, 8, 2, 16, [2, 0, 3, 2], [0, 64, 10, 0], [16, 9, 16, 16]),
    (32, 4, 2, 8, [1, 3, 0], [0, 150, 5], [0, 8, 3]),
]


def _call_prefill(lib, q, cache, sl, st, ln, table, B):
    P, c, H, hd = q.shape
    k_s, v_s = (cache[2], cache[3]) if len(cache) == 4 else (None, None)
    out = torch.empty_like(q)
    rc = lib.gofr_flash_cache_attention(
        q.data_ptr(), cache[0].data_ptr(), cache[1].data_ptr(), sl.data_ptr(),
        st.data_ptr(), ln.data_ptr(), _ptr(k_s), _ptr(v_s), _ptr(table),
        out.data_ptr(), P, c, H, cache[0].shape[1],
        B if table is not None else cache[0].shape[2],
        0 if table is None else table.shape[1], hd, hd**-0.5, None,
    )
    assert rc == 0
    return out


def _prefill_variant(lib, variant, hd, H, KV, c, slots, starts, lens):
    quant, B = VARIANTS[variant]
    rng = np.random.default_rng(c + hd)
    S, max_len, P = 4, 160, len(slots)
    q = _bf16(rng, P, c, H, hd)
    q[-1] = q[0]
    i32 = dict(dtype=torch.int32)
    sl, st, ln = (torch.tensor(x, **i32) for x in (slots, starts, lens))
    cache = _cache(rng, S, KV, max_len, hd, quant)
    contiguous = table = None
    if B:
        contiguous = _call_prefill(lib, q, cache, sl, st, ln, None, 0)
        keys = [max([s0 + n for s, s0, n in zip(slots, starts, lens) if s == r] or [0])
                for r in range(S)]
        cache, table = _pool(rng, cache, keys, B)
    scales = dict(k_scale=cache[2], v_scale=cache[3]) if quant else {}
    want = flash_cache_attention_plain(q, cache[0], cache[1], sl, st, ln,
                                       block_table=table, **scales)
    return _call_prefill(lib, q, cache, sl, st, ln, table, B), want, contiguous


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("hd,H,KV,c,slots,starts,lens", PREFILL_VARIANT_SHAPES)
def test_emulated_flash_cache_attention_variants_match_plain(
    emu_lib, variant, hd, H, KV, c, slots, starts, lens
):
    out, want, contiguous = _prefill_variant(emu_lib, variant, hd, H, KV, c, slots,
                                             starts, lens)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
    for p, n in enumerate(lens):
        assert torch.all(out[p, n:] == 0)  # padding queries
    if contiguous is not None:
        assert torch.equal(out, contiguous)


def test_emulation_catches_the_v_scale_in_the_denominator(tmp_path):
    """Both serving kernels rebuilt so that the softmax denominator takes
    the probabilities after the V scale (the likely int8 bug): every int8
    case, contiguous and paged, must fail."""
    swaps = {
        "flash_decode": (
            "l[r] = l[r] * corr + p;  // the denominator takes p before the V scale\n"
            "          const float pv = kQuant ? p * vs[u] : p;",
            "const float pv = kQuant ? p * vs[u] : p;\n"
            "          l[r] = l[r] * corr + pv;",
        ),
        "flash_prefill": (
            "rs_a += s[nt][e];\n        rs_b += s[nt][2 + e];",
            "rs_a += kQuant ? s[nt][e] * sVs[col - kc0] : s[nt][e];\n"
            "        rs_b += kQuant ? s[nt][2 + e] * sVs[col - kc0] : s[nt][2 + e];",
        ),
    }
    sources = {}
    for stem, (old, new) in swaps.items():
        src = (CSRC / f"{stem}.cu").read_text()
        assert old in src
        sources[stem] = src.replace(old, new)
    lib = _emulate(sources, tmp_path)
    for variant in ("int8", "paged+int8"):
        for split in (False, True):
            for shape in DECODE_VARIANT_SHAPES:
                out, want, _ = _decode_variant(lib, variant, split, *shape)
                assert not torch.allclose(out.float(), want.float(), atol=TOL, rtol=TOL)
        for shape in PREFILL_VARIANT_SHAPES:
            out, want, _ = _prefill_variant(lib, variant, *shape)
            assert not torch.allclose(out.float(), want.float(), atol=TOL, rtol=TOL)


FA_CASES = [
    # b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths
    (1, 70, 70, 4, 2, 128, True, None),         # causal GQA, two query tiles
    (1, 40, 100, 1, 1, 64, True, None),         # causal offset 60, two key tiles
    (3, 66, 66, 2, 2, 64, True, [66, 0, 9]),    # lengths: full, empty, short
    (2, 20, 80, 2, 1, 128, False, [80, 33]),    # non-causal with lengths
    (1, 70, 30, 2, 2, 64, False, None),         # non-causal, s_q > s_kv
]


def _run_emulated_flash_attention(lib, b, s_q, s_kv, n_heads, n_kv, hd, causal,
                                  lengths, *, transpose_kv=False):
    rng = np.random.default_rng(s_q + s_kv + hd)
    q = _bf16(rng, b, s_q, n_heads, hd)
    k, v = _bf16(rng, b, s_kv, n_kv, hd), _bf16(rng, b, s_kv, n_kv, hd)
    if transpose_kv:  # [b, n_kv, s_kv, hd] storage read through strides
        k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (k, v))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    out = torch.full((b, s_q, n_heads, hd), float("nan"), dtype=torch.bfloat16)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    rc = lib.gofr_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(lens), out.data_ptr(),
        b, s_q, s_kv, n_heads, n_kv, hd, int(causal), strides, hd**-0.5, None,
    )
    assert rc == 0
    return out, flash_attention_plain(q, k, v, lens, causal=causal)


@pytest.mark.parametrize("b,s_q,s_kv,n_heads,n_kv,hd,causal,lengths", FA_CASES)
def test_emulated_flash_attention_matches_plain(
    emu_lib, b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths
):
    out, want = _run_emulated_flash_attention(
        emu_lib, b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths,
        transpose_kv=lengths is not None,
    )
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
    zero = want.float().abs().amax(dim=(-1, -2)) == 0  # rows that see no key
    assert torch.all(out[zero] == 0)


def test_emulation_catches_an_off_by_one_causal_bound(tmp_path):
    """The causal cases against a copy of the kernel whose causal bound
    lets each query row see one key too many: every one must fail."""
    src = (CSRC / "flash_attention.cu").read_text()
    bound = "return causal ? min(r + offset, len - 1) : len - 1;"
    assert bound in src
    lib = _emulate(
        {"flash_attention": src.replace(bound, bound.replace("r + offset", "r + offset + 1"))},
        tmp_path,
    )
    for case in FA_CASES:
        if case[6]:  # causal
            out, want = _run_emulated_flash_attention(lib, *case)
            assert not torch.allclose(out.float(), want.float(), atol=TOL, rtol=TOL)
