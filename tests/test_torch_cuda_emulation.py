"""The port's CUDA kernel sources, run on the CPU.

``gofr_tpu_torch/csrc/*.cu`` is compiled by the host C++ compiler against
``tests/cuda_emu/cuda_mock.h``, which emulates the CUDA subset the
kernels use (one fiber per CUDA thread, barriers for ``__syncthreads``
and warp shuffles; ``tests/cuda_emu/sm90.cuh`` replaces the Hopper
primitives of ``csrc/sm90.cuh``: wgmma read through its descriptors and
the 128-byte swizzle, mbarrier phases, cp.async and TMA copies, named
barriers), and the C entries are called through ctypes on CPU tensors.
The primitives are also tested alone (``csrc/sm90_selftest.cu``): wgmma
for both B layouts against numpy, a 3-stage mbarrier ring, a TMA box on a
ragged edge. Their outputs are held against the plain
versions at small shapes covering every head-dim and GQA template the
wrappers accept, the serving kernels' int8, paged and paged+int8
variants (a shuffled block table over a pool whose parking block and
unused blocks hold garbage), and Mistral's sliding window in all three
kernels (with NaN in every row or key tile below the window, which no
kernel may read). This checks the kernels' indexing, masking,
online softmax and merges on every CPU run; the card itself (timing, the
real compiler, the real memory model) is checked by ``chip_smoke.py``.
"""

import ctypes
import re
import shutil
import signal
import subprocess
import sys
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


def _emulate(sources: dict[str, str], out: Path, opt: str = "-O1") -> ctypes.CDLL:
    """Compile CUDA sources (file stem -> text) against the mock and load
    them, with the C entries' argument types set. ``opt`` -O0 compiles
    flash_decode.cu's 64 instantiations in a third of -O1's time, for a
    library that runs only a few cases."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) to emulate the kernels")
    srcs = []
    for stem, s in sources.items():
        if stem.endswith(".cuh"):  # a header in place of csrc's own
            (out / stem).write_text(s)
            continue
        s = s.replace(
            "extern __shared__ __align__(16) unsigned char smem_raw[];",
            "unsigned char* smem_raw = mock_smem;",
        )
        s = re.sub(r"(\w+)<<<", r"mock_launch(\1, ", s).replace(">>>(", ", ")
        dst = out / (stem + ".cpp")
        dst.write_text(s)
        srcs.append(str(dst))
    # One compiler per source, all started together, then one link.
    flags = ["-std=c++20", opt, "-fno-strict-aliasing", "-fPIC", "-I", str(MOCK),
             "-I", str(CSRC)]
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
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        ),
        "gofr_flash_cache_attention": (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        ),
        "gofr_flash_attention": (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
        ),
    }
    entries["gofr_flash_cache_attention_f32"] = entries["gofr_flash_cache_attention"]
    entries["gofr_flash_attention_f32"] = entries["gofr_flash_attention"]
    entries.update({
        "gofr_sm90_wgmma_test": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "gofr_sm90_ring_test": [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p],
        "gofr_sm90_tma_test": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "gofr_sm90_bulk_test": ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                                + [ctypes.c_int, ctypes.c_void_p]),
        "gofr_sm90_cluster_test": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p],
    })
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
        _ptr(vn), None, None, None, out.data_ptr(), S, H, KV, max_len, 0, hd, 0, 0, 1,
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
        H, KV, max_len, 0, hd, 0, hd**-0.5, None,
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
    assert emu_lib.gofr_flash_decode(p, p, p, p, n, n, n, n, n, p, 1, 4, 2, 8, 0, 48, 0, 0, 1, 1.0, n) != 0
    assert emu_lib.gofr_flash_decode(p, p, p, p, n, n, n, n, n, p, 1, 3, 2, 8, 0, 32, 0, 0, 1, 1.0, n) != 0
    assert emu_lib.gofr_flash_decode(p, p, p, p, n, n, n, n, p, p, 1, 4, 2, 8, 2, 32, 0, 0, 1, 1.0, n) != 0
    assert emu_lib.gofr_flash_decode(p, p, p, p, n, n, p, n, n, p, 1, 4, 2, 8, 0, 32, 0, 0, 1, 1.0, n) != 0
    # A cluster of 3 or 16 blocks, and a query type flag other than 0 / 1.
    assert emu_lib.gofr_flash_decode(p, p, p, p, n, n, n, n, n, p, 1, 4, 2, 8, 0, 32, 0, 0, 3, 1.0, n) != 0
    assert emu_lib.gofr_flash_decode(p, p, p, p, n, n, n, n, n, p, 1, 4, 2, 8, 0, 32, 0, 0, 16, 1.0, n) != 0
    assert emu_lib.gofr_flash_decode(p, p, p, p, n, n, n, n, n, p, 1, 4, 2, 8, 0, 32, 0, 2, 1, 1.0, n) != 0
    assert emu_lib.gofr_flash_cache_attention(p, p, p, p, p, p, n, n, n, p, 1, 1, 4, 2, 8, 0, 256, 0, 1.0, n) != 0
    assert emu_lib.gofr_flash_cache_attention(p, p, p, p, p, p, n, n, p, p, 1, 1, 4, 2, 24, 2, 32, 0, 1.0, n) != 0
    st = (ctypes.c_longlong * 9)()
    # flash_attention takes hd 32, 64 and 128 only (48 is refused), and GQA
    # groups; so do the f32 kernels.
    for fa in (emu_lib.gofr_flash_attention, emu_lib.gofr_flash_attention_f32):
        assert fa(p, p, p, None, p, 1, 1, 1, 4, 2, 48, 1, 0, st, 1.0, None) != 0
        assert fa(p, p, p, None, p, 1, 1, 1, 3, 2, 64, 1, 0, st, 1.0, None) != 0
    assert emu_lib.gofr_flash_cache_attention_f32(
        p, p, p, p, p, p, n, n, n, p, 1, 1, 4, 2, 8, 0, 256, 0, 1.0, n) != 0


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


def _call_decode(lib, q, cache, lens, kn, vn, table, B, window=0, cluster=2):
    """The kernel (bf16 or f32 q; caches of q's type or int8 with scales)
    with `cluster` blocks per (slot, kv head)."""
    S, H, hd = q.shape
    KV = cache[0].shape[1]
    k_s, v_s = (cache[2], cache[3]) if len(cache) == 4 else (None, None)
    out = torch.full_like(q, float("nan"))
    rc = lib.gofr_flash_decode(
        q.data_ptr(), cache[0].data_ptr(), cache[1].data_ptr(), lens.data_ptr(),
        _ptr(kn), _ptr(vn), _ptr(k_s), _ptr(v_s), _ptr(table), out.data_ptr(),
        S, H, KV, B if table is not None else cache[0].shape[2],
        0 if table is None else table.shape[1], hd, window, int(q.dtype == torch.float32),
        cluster, hd**-0.5, None,
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


def _call_prefill(lib, q, cache, sl, st, ln, table, B, window=0):
    P, c, H, hd = q.shape
    k_s, v_s = (cache[2], cache[3]) if len(cache) == 4 else (None, None)
    out = torch.full_like(q, float("nan"))
    entry = (lib.gofr_flash_cache_attention_f32 if q.dtype == torch.float32
             else lib.gofr_flash_cache_attention)
    rc = entry(
        q.data_ptr(), cache[0].data_ptr(), cache[1].data_ptr(), sl.data_ptr(),
        st.data_ptr(), ln.data_ptr(), _ptr(k_s), _ptr(v_s), _ptr(table),
        out.data_ptr(), P, c, H, cache[0].shape[1],
        B if table is not None else cache[0].shape[2],
        0 if table is None else table.shape[1], hd, window, hd**-0.5, None,
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
    # flash_prefill's softmax lives in the mainloop header it shares with
    # flash_attention (whose bf16 path the swap does not touch).
    swaps = {
        # The redesigned kernel's online softmax over a stage's rows.
        "flash_decode.cu": (
            "psum += p;  // the denominator takes p before the V scale",
            "psum += kQuant ? p * vs[u] : p;",
        ),
        "attn_sm90.cuh": (
            "rs_b += s[i];",
            "rs_b += QUANT ? s[i] * vs[j] : s[i];",
        ),
    }
    sources = {"flash_prefill": (CSRC / "flash_prefill.cu").read_text()}
    for name, (old, new) in swaps.items():
        src = (CSRC / name).read_text()
        assert old in src
        sources[name.removesuffix(".cu")] = src.replace(old, new)
    sources["attn_sm90.cuh"] = sources["attn_sm90.cuh"].replace(
        "rs_a += s[i];", "rs_a += QUANT ? s[i] * vs[j] : s[i];")
    lib = _emulate(sources, tmp_path, opt="-O0")
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
                                  lengths, *, transpose_kv=False, window=0,
                                  dtype=torch.bfloat16):
    rng = np.random.default_rng(s_q + s_kv + hd)
    q = _bf16(rng, b, s_q, n_heads, hd).to(dtype)
    k, v = _bf16(rng, b, s_kv, n_kv, hd).to(dtype), _bf16(rng, b, s_kv, n_kv, hd).to(dtype)
    if transpose_kv:  # [b, n_kv, s_kv, hd] storage read through strides
        k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (k, v))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    out = torch.full((b, s_q, n_heads, hd), float("nan"), dtype=dtype)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    entry = lib.gofr_flash_attention_f32 if dtype == torch.float32 else lib.gofr_flash_attention
    rc = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(lens), out.data_ptr(),
        b, s_q, s_kv, n_heads, n_kv, hd, int(causal), window, strides, hd**-0.5, None,
    )
    assert rc == 0
    return out, flash_attention_plain(q, k, v, lens, causal=causal, window=window)


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


# -- the sliding window (Mistral) in all three kernels ----------------------

WINDOW_VARIANTS = {"bf16": (False, 0), **VARIANTS}
DECODE_WINDOW = 20
# Lengths around the window's edge in both conventions (the split query
# sits at `length`, the written one at `length - 1`), an empty row, a full
# cache (max_len 112 = 7 blocks of 16).
DECODE_WINDOW_LENGTHS = [0, 1, 19, 20, 21, 50, 112]


def _poison_rows(cache, table, B, rows_below):
    """NaN in K and V (an int8 cache: in its scales) of logical rows
    [0, rows_below[r]) of each row r, through the table for a pool."""
    out = [t.clone() for t in cache]
    targets = out[2:] if len(out) == 4 else out[:2]
    for r, n in enumerate(rows_below):
        for j in range(n):
            blk, off = (r, j) if table is None else (int(table[r, j // B]), j % B)
            for t in targets:
                t[blk, :, off] = float("nan")
    return out


def _decode_window_case(lib, variant, split, window=DECODE_WINDOW):
    """(kernel, plain, contiguous kernel or None, kernel on a cache with NaN
    in every row below the window)."""
    quant, B = WINDOW_VARIANTS[variant]
    rng = np.random.default_rng(11 + split)
    hd, H, KV, max_len = 128, 8, 2, 112
    S = len(DECODE_WINDOW_LENGTHS)
    q = _bf16(rng, S, H, hd)
    kn, vn = (_bf16(rng, S, KV, hd), _bf16(rng, S, KV, hd)) if split else (None, None)
    if quant and split:
        kn, vn = fake_quantize_kv(kn), fake_quantize_kv(vn)
    lens = torch.tensor(DECODE_WINDOW_LENGTHS, dtype=torch.int32)
    cache = _cache(rng, S, KV, max_len, hd, quant)
    contiguous = table = None
    if B:
        contiguous = _call_decode(lib, q, cache, lens, kn, vn, None, 0, window)
        cache, table = _pool(rng, cache, DECODE_WINDOW_LENGTHS, B)
    scales = dict(k_scale=cache[2], v_scale=cache[3]) if quant else {}
    want = flash_decode_plain(q, cache[0], cache[1], lens, k_new=kn, v_new=vn,
                              block_table=table, window=window, **scales)
    out = _call_decode(lib, q, cache, lens, kn, vn, table, B, window)
    below = [max(0, (n if split else n - 1) - window + 1) for n in DECODE_WINDOW_LENGTHS]
    poisoned = _call_decode(lib, q, _poison_rows(cache, table, B, below), lens, kn, vn,
                            table, B, window)
    return out, want, contiguous, poisoned


@pytest.mark.parametrize("split", [False, True], ids=["written", "split"])
@pytest.mark.parametrize("variant", list(WINDOW_VARIANTS))
def test_emulated_windowed_flash_decode_matches_plain(emu_lib, variant, split):
    out, want, contiguous, poisoned = _decode_window_case(emu_lib, variant, split)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
    if contiguous is not None:
        assert torch.equal(out, contiguous)
    # No row below the window is read: NaN there changes nothing.
    assert torch.equal(poisoned, out)


PREFILL_WINDOW = 40
# hd, H, KV, c, slots, starts, lens (max_len 224 = 14 blocks of 16, 3.5 key
# tiles): rows whose window edge skips whole key tiles, a short row, a row
# at the start of the cache and a padding row duplicating row 0; c * rep
# spans several 64-row query tiles in the first shape.
PREFILL_WINDOW_SHAPES = [
    (128, 8, 2, 40, [2, 0, 3, 2], [0, 150, 100, 0], [40, 40, 9, 40]),
    (32, 4, 2, 8, [1, 3, 0], [200, 70, 5], [8, 8, 3]),
]


def _prefill_window_case(lib, variant, hd, H, KV, c, slots, starts, lens,
                         window=PREFILL_WINDOW):
    quant, B = WINDOW_VARIANTS[variant]
    rng = np.random.default_rng(c + hd + 1)
    S, max_len, P = 4, 224, len(slots)
    q = _bf16(rng, P, c, H, hd)
    q[-1] = q[0]
    i32 = dict(dtype=torch.int32)
    sl, st, ln = (torch.tensor(x, **i32) for x in (slots, starts, lens))
    cache = _cache(rng, S, KV, max_len, hd, quant)
    contiguous = table = None
    if B:
        contiguous = _call_prefill(lib, q, cache, sl, st, ln, None, 0, window)
        keys = [max([s + n for r2, s, n in zip(slots, starts, lens) if r2 == r] or [0])
                for r in range(S)]
        cache, table = _pool(rng, cache, keys, B)
    scales = dict(k_scale=cache[2], v_scale=cache[3]) if quant else {}
    want = flash_cache_attention_plain(q, cache[0], cache[1], sl, st, ln,
                                       block_table=table, window=window, **scales)
    out = _call_prefill(lib, q, cache, sl, st, ln, table, B, window)
    # Key tiles (64 keys) wholly below each slot's loosest window edge.
    below = [min([max(0, s - window + 1) // 64 * 64
                  for r2, s in zip(slots, starts) if r2 == r] or [0]) for r in range(S)]
    poisoned = _call_prefill(lib, q, _poison_rows(cache, table, B, below), sl, st, ln,
                             table, B, window)
    return out, want, contiguous, poisoned, below


@pytest.mark.parametrize("variant", list(WINDOW_VARIANTS))
@pytest.mark.parametrize("hd,H,KV,c,slots,starts,lens", PREFILL_WINDOW_SHAPES)
def test_emulated_windowed_flash_cache_attention_matches_plain(
    emu_lib, variant, hd, H, KV, c, slots, starts, lens
):
    out, want, contiguous, poisoned, below = _prefill_window_case(
        emu_lib, variant, hd, H, KV, c, slots, starts, lens)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
    for p, n in enumerate(lens):
        assert torch.all(out[p, n:] == 0)
    if contiguous is not None:
        assert torch.equal(out, contiguous)
    assert any(below)  # whole tiles lie below the window: they are skipped
    assert torch.equal(poisoned, out)


FA_WINDOW_CASES = [
    # b, s_q, s_kv, n_heads, n_kv, hd, lengths, window (all causal)
    (1, 200, 200, 4, 2, 128, None, 30),         # GQA, four query tiles
    (3, 130, 130, 2, 2, 64, [130, 0, 40], 50),  # lengths: rows past 88 of row 2 see nothing
    (1, 40, 200, 2, 1, 64, None, 64),           # offset 160: key tile 0 lies below
    (1, 66, 66, 2, 2, 64, None, 1),             # each query sees itself only
]


def _fa_window_case(lib, b, s_q, s_kv, n_heads, n_kv, hd, lengths, window):
    out, want = _run_emulated_flash_attention(
        lib, b, s_q, s_kv, n_heads, n_kv, hd, True, lengths, window=window)
    return out, want


@pytest.mark.parametrize("b,s_q,s_kv,n_heads,n_kv,hd,lengths,window", FA_WINDOW_CASES)
def test_emulated_windowed_flash_attention_matches_plain(
    emu_lib, b, s_q, s_kv, n_heads, n_kv, hd, lengths, window
):
    out, want = _fa_window_case(emu_lib, b, s_q, s_kv, n_heads, n_kv, hd, lengths, window)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
    zero = want.float().abs().amax(dim=(-1, -2)) == 0
    assert torch.all(out[zero] == 0)


def test_emulated_windowed_flash_attention_skips_tiles_below_the_window(emu_lib):
    """NaN in every key tile wholly below the first query tile's window
    edge (offset 160, window 64: keys 0-63) leaves the output unchanged."""
    b, s_q, s_kv, H, KV, hd, window = 1, 40, 200, 2, 1, 64, 64
    rng = np.random.default_rng(3)
    q, k, v = _bf16(rng, b, s_q, H, hd), _bf16(rng, b, s_kv, KV, hd), _bf16(rng, b, s_kv, KV, hd)

    def run(k, v):
        out = torch.empty_like(q)
        strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        rc = emu_lib.gofr_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), b, s_q, s_kv,
            H, KV, hd, 1, window, strides, hd**-0.5, None)
        assert rc == 0
        return out

    clean = run(k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :64] = float("nan")
    v2[:, :64] = float("nan")
    assert torch.equal(run(k2, v2), clean)
    torch.testing.assert_close(
        clean.float(), flash_attention_plain(q, k, v, causal=True, window=window).float(),
        atol=TOL, rtol=TOL)


def test_emulation_catches_a_window_edge_one_key_low(tmp_path):
    """All three kernels rebuilt with the window's lower edge one key lower
    (each query sees window + 1 keys): every windowed case must fail."""
    swaps = {
        "flash_decode": ("(has_new ? length : length - 1) - window + 1)",
                         "(has_new ? length : length - 1) - window)"),
        # The tiled kernels' edge, wherever it is used (each row's mask, the
        # warpgroup's interior test, the first key tile).
        "flash_prefill": ("return lim - window + 1;", "return lim - window;"),
        "flash_attention": ("return r + offset - window + 1;", "return r + offset - window;"),
    }
    sources = {}
    for stem, (old, new) in swaps.items():
        src = (CSRC / f"{stem}.cu").read_text()
        assert old in src
        sources[stem] = src.replace(old, new)
    lib = _emulate(sources, tmp_path, opt="-O0")
    for split in (False, True):
        out, want, _, _ = _decode_window_case(lib, "bf16", split)
        assert not torch.allclose(out.float(), want.float(), atol=TOL, rtol=TOL)
    for shape in PREFILL_WINDOW_SHAPES:
        out, want, _, _, _ = _prefill_window_case(lib, "bf16", *shape)
        assert not torch.allclose(out.float(), want.float(), atol=TOL, rtol=TOL)
    for case in FA_WINDOW_CASES:
        out, want = _fa_window_case(lib, *case)
        assert not torch.allclose(out.float(), want.float(), atol=TOL, rtol=TOL)


# -- the Hopper primitives themselves (csrc/sm90_selftest.cu) ----------------


@pytest.mark.parametrize("a_regs", [False, True], ids=["smem_a", "reg_a"])
@pytest.mark.parametrize("b_mn_major", [False, True], ids=["k_major_b", "mn_major_b"])
@pytest.mark.parametrize("n", [64, 128])
def test_emulated_wgmma_matches_numpy(emu_lib, n, b_mn_major, a_regs):
    """D = A(64 x 128) . B(128 x n) in 8 k-steps of wgmma m64nNk16, with the
    tiles written by cp.async in the kernels' swizzled layout and read back
    through the descriptors the kernels build, against numpy in f64."""
    rng = np.random.default_rng(n + 2 * b_mn_major + a_regs)
    a = _bf16(rng, 64, 128)
    b = _bf16(rng, 128, n) if b_mn_major else _bf16(rng, n, 128)
    d = torch.full((64, n), float("nan"))
    rc = emu_lib.gofr_sm90_wgmma_test(a.data_ptr(), b.data_ptr(), d.data_ptr(), n,
                                      int(b_mn_major), int(a_regs), None)
    assert rc == 0
    bn = b.double().numpy()
    want = a.double().numpy() @ (bn if b_mn_major else bn.T)
    np.testing.assert_allclose(d.numpy(), want, rtol=1e-5, atol=1e-4)


def test_emulated_mbarrier_ring_wraps_its_phases(emu_lib):
    """10 tiles through a 3-stage ring (phases wrap three times): each
    consumer thread gets the chunk another producer thread copied."""
    rng = np.random.default_rng(5)
    src = torch.from_numpy(rng.integers(-30000, 30000, (10, 128, 8)).astype(np.int16))
    dst = torch.zeros_like(src)
    assert emu_lib.gofr_sm90_ring_test(src.data_ptr(), dst.data_ptr(), 10, None) == 0
    assert torch.equal(dst, torch.roll(src, shifts=-37, dims=1))


@pytest.mark.parametrize("r0", [0, 64])
def test_emulated_tma_box_zero_fills_a_ragged_edge(emu_lib, r0):
    """A 128 x 64 box from row r0 of a [100, 72] matrix: rows past 100 (and
    columns past 64) are not read, and the missing rows arrive as zeros."""
    rng = np.random.default_rng(6)
    m = _bf16(rng, 100, 72)
    dst = torch.full((128, 64), float("nan"), dtype=torch.bfloat16)
    assert emu_lib.gofr_sm90_tma_test(m.data_ptr(), dst.data_ptr(), 100, 72, r0, None) == 0
    want = torch.zeros((128, 64), dtype=torch.bfloat16)
    want[:100 - r0] = m[r0:, :64]
    assert torch.equal(dst, want)


def test_emulated_bulk_copy_and_cp_async_words_share_one_phase(emu_lib):
    """A 1-D bulk copy of 4,096 bytes and 37 four-byte cp.async words land
    in shared memory under one mbarrier phase (one announcing arrival and
    32 cp.async arrivals) and come back bit for bit."""
    rng = np.random.default_rng(8)
    src = torch.from_numpy(rng.integers(0, 256, 4096).astype(np.uint8))
    words = torch.from_numpy(rng.integers(-2**31, 2**31, 37).astype(np.int32))
    dst, dst_words = torch.zeros_like(src), torch.zeros_like(words)
    assert emu_lib.gofr_sm90_bulk_test(src.data_ptr(), dst.data_ptr(), 4096, words.data_ptr(),
                                       dst_words.data_ptr(), 37, None) == 0
    assert torch.equal(dst, src) and torch.equal(dst_words, words)
    # A size that is not a multiple of 16 bytes is refused, not run.
    assert emu_lib.gofr_sm90_bulk_test(src.data_ptr(), dst.data_ptr(), 40, words.data_ptr(),
                                       dst_words.data_ptr(), 0, None) != 0


def test_emulated_cluster_exchange_reads_a_peers_shared_memory(emu_lib):
    """Two clusters of 4 blocks: each block returns its next peer's words
    read through the emulated mapa after the cluster barrier, and its
    rank."""
    src = torch.arange(8 * 128, dtype=torch.int32).reshape(8, 128) * 3 + 1
    dst, ranks = torch.zeros_like(src), torch.full((8,), -1, dtype=torch.int32)
    assert emu_lib.gofr_sm90_cluster_test(src.data_ptr(), dst.data_ptr(), ranks.data_ptr(), 2,
                                          None) == 0
    blocks = torch.arange(8)
    peer = blocks // 4 * 4 + (blocks + 1) % 4
    assert torch.equal(dst, torch.roll(src[peer], shifts=-37, dims=1))
    assert ranks.tolist() == [0, 1, 2, 3] * 2


def test_emulated_cluster_that_diverges_at_its_barrier_aborts(tmp_path):
    """A cluster whose rank 0 skips the cluster barrier deadlocks on a card;
    the emulator must abort, not hang or run on."""
    src = (CSRC / "sm90_selftest.cu").read_text()
    sync = "  sm90::cluster_sync();  // every block's words are written\n"
    assert sync in src
    bad = src.replace(sync, "  if (rank != 0) sm90::cluster_sync();\n")
    lib = _emulate({"sm90_selftest": bad}, tmp_path)
    code = (f"import ctypes, torch; lib = ctypes.CDLL({str(lib._name)!r}); "
            "s = torch.zeros(4 * 128, dtype=torch.int32); "
            "lib.gofr_sm90_cluster_test(ctypes.c_void_p(s.data_ptr()), "
            "ctypes.c_void_p(s.data_ptr()), ctypes.c_void_p(s.data_ptr()), 1, None)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, timeout=120)
    assert res.returncode == -signal.SIGABRT


# -- the tiled kernels at the new tiles' edges (128 query rows, 128 keys) ----

FA_EDGE_CASES = [
    # b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths
    (1, 1, 1, 2, 1, 64, True, None),             # one query, one key
    (1, 127, 127, 2, 2, 128, True, None),        # one row short of a block (rep 1)
    (1, 129, 129, 8, 1, 64, True, [100]),        # one row past it (rep 8), lengths
    (2, 191, 191, 2, 2, 128, False, None),       # non-causal, half a second block
    (1, 1, 300, 4, 2, 128, True, None),          # one query over three key tiles
]


@pytest.mark.parametrize("b,s_q,s_kv,n_heads,n_kv,hd,causal,lengths", FA_EDGE_CASES)
def test_emulated_flash_attention_at_tile_edges(
    emu_lib, b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths
):
    out, want = _run_emulated_flash_attention(
        emu_lib, b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)


PREFILL_EDGE_SHAPES = [
    # hd, H, KV, c, slots, starts, lens: c * rep is not a multiple of 128
    (64, 8, 1, 20, [1, 0], [0, 150], [20, 13]),     # rep 8: 160 rows
    (128, 2, 2, 50, [0, 2], [100, 0], [50, 49]),    # rep 1: 50 rows
    (64, 4, 2, 70, [3, 1], [10, 0], [70, 1]),       # rep 2: 140 rows
]


@pytest.mark.parametrize("hd,H,KV,c,slots,starts,lens", PREFILL_EDGE_SHAPES)
def test_emulated_flash_cache_attention_at_tile_edges(
    emu_lib, hd, H, KV, c, slots, starts, lens
):
    rng = np.random.default_rng(c + H)
    S, max_len, P = 4, 224, len(slots)
    q, kc, vc = (_bf16(rng, P, c, H, hd), _bf16(rng, S, KV, max_len, hd),
                 _bf16(rng, S, KV, max_len, hd))
    i32 = dict(dtype=torch.int32)
    sl, st, ln = (torch.tensor(x, **i32) for x in (slots, starts, lens))
    out = _call_prefill(emu_lib, q, [kc, vc], sl, st, ln, None, 0)
    want = flash_cache_attention_plain(q, kc, vc, sl, st, ln)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
    for p, n in enumerate(lens):
        assert torch.all(out[p, n:] == 0)


# -- the f32 kernels of the tiled functions (csrc/attn_f32.cu) ---------------

# The f32 kernels against the f32 plain versions: per output row, max |d|
# <= 1e-4 * rms(row) (the sums run in another order; f32 rounds at 2**-24).
F32_ROW_TOL = 1e-4


def _assert_rows_close(out, want, rel):
    """Per row of the last dim: max |out - want| <= rel * rms(want row);
    rows that must be 0 are exactly 0."""
    hd = out.shape[-1]
    g, w = out.double().reshape(-1, hd), want.double().reshape(-1, hd)
    d = (g - w).abs().amax(dim=-1)
    rms = w.pow(2).mean(dim=-1).sqrt()
    zero = rms == 0
    assert torch.all(d[zero] == 0), "rows that must be 0 are not"
    worst = (d[~zero] / rms[~zero]).max().item()
    assert worst <= rel, f"max row error / row rms {worst} > {rel}"



F32_PREFILL_CASES = [
    # variant, window, hd, H, KV, c, slots, starts, lens (max_len 160)
    ("bf16", 0, 32, 4, 2, 8, [2, 0, 3, 2], [0, 5, 70, 0], [8, 3, 8, 8]),
    ("bf16", 40, 128, 8, 2, 20, [2, 0, 3], [100, 64, 10], [20, 17, 0]),
    ("paged", 0, 64, 4, 4, 20, [1, 3, 0], [0, 3, 130], [0, 20, 9]),
    ("int8", 30, 64, 8, 1, 16, [0, 2], [120, 40], [16, 7]),
    ("paged+int8", 40, 128, 4, 2, 16, [2, 0, 3, 2], [0, 64, 130, 0], [16, 9, 16, 16]),
]


@pytest.mark.parametrize("variant,window,hd,H,KV,c,slots,starts,lens", F32_PREFILL_CASES)
def test_emulated_f32_flash_cache_attention_matches_plain(
    emu_lib, variant, window, hd, H, KV, c, slots, starts, lens
):
    """The CUDA-core f32 chunk kernel on the slot cache, a pool (bit for bit
    the slot cache's), int8 and an int8 pool, with and without the window,
    against the f32 plain version per row; padding rows exactly 0; NaN in
    the key tiles wholly below a windowed row's edge changes no bit."""
    quant, B = WINDOW_VARIANTS[variant]
    rng = np.random.default_rng(c + hd + window)
    S, max_len, P = 4, 160, len(slots)
    q = _bf16(rng, P, c, H, hd).float()
    i32 = dict(dtype=torch.int32)
    sl, st, ln = (torch.tensor(x, **i32) for x in (slots, starts, lens))
    cache = [t.float() if t.dtype == torch.bfloat16 else t
             for t in _cache(rng, S, KV, max_len, hd, quant)]
    contiguous = table = None
    if B:
        contiguous = _call_prefill(emu_lib, q, cache, sl, st, ln, None, 0, window)
        keys = [max([s0 + n for s, s0, n in zip(slots, starts, lens) if s == r] or [0])
                for r in range(S)]
        cache, table = _pool(rng, cache, keys, B)
    scales = dict(k_scale=cache[2], v_scale=cache[3]) if quant else {}
    out = _call_prefill(emu_lib, q, cache, sl, st, ln, table, B, window)
    want = flash_cache_attention_plain(q, cache[0], cache[1], sl, st, ln, block_table=table,
                                       window=window, **scales)
    _assert_rows_close(out, want, F32_ROW_TOL)
    for p, n in enumerate(lens):
        assert torch.all(out[p, n:] == 0)
    if contiguous is not None:
        assert torch.equal(out, contiguous)
    if window:
        below = [min([max(0, s0 - window + 1) for r2, s0 in zip(slots, starts) if r2 == r]
                     or [0]) for r in range(S)]
        poisoned = _call_prefill(emu_lib, q, _poison_rows(cache, table, B, below), sl, st, ln,
                                 table, B, window)
        assert torch.equal(poisoned, out)


F32_FA_CASES = [
    # b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths, window
    (1, 40, 40, 4, 2, 32, True, None, 0),         # causal GQA, hd 32
    (1, 20, 70, 2, 1, 64, True, None, 0),         # causal offset 50
    (3, 33, 33, 2, 2, 128, True, [33, 0, 9], 0),  # lengths: full, empty, short
    (2, 10, 40, 2, 1, 64, False, [40, 17], 0),    # non-causal with lengths
    (2, 50, 50, 8, 2, 32, True, [50, 30], 12),    # causal window with lengths
]


@pytest.mark.parametrize("b,s_q,s_kv,n_heads,n_kv,hd,causal,lengths,window", F32_FA_CASES)
def test_emulated_f32_flash_attention_matches_plain(
    emu_lib, b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths, window
):
    """The CUDA-core f32 full-sequence kernel, k and v read through strides
    where lengths are given, against the f32 plain version per row; rows
    that see no key exactly 0."""
    out, want = _run_emulated_flash_attention(
        emu_lib, b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths,
        transpose_kv=lengths is not None, window=window, dtype=torch.float32)
    _assert_rows_close(out, want, F32_ROW_TOL)


FA_HD32_CASES = [
    # b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths, window: hd 32 on a
    # 64-column panel
    (1, 70, 70, 4, 2, 32, True, None, 0),          # causal GQA, two query tiles
    (3, 40, 140, 2, 2, 32, True, [140, 0, 60], 0),  # offset 100, lengths
    (2, 30, 30, 8, 1, 32, False, [30, 11], 0),     # non-causal, MQA, lengths
    (1, 200, 200, 2, 1, 32, True, None, 24),       # causal window
]


@pytest.mark.parametrize("b,s_q,s_kv,n_heads,n_kv,hd,causal,lengths,window", FA_HD32_CASES)
def test_emulated_flash_attention_hd32_matches_plain(
    emu_lib, b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths, window
):
    """flash_attention (bf16, wgmma) at hd 32: the tensor maps' 64-column
    boxes zero-fill the panel's other half."""
    out, want = _run_emulated_flash_attention(
        emu_lib, b, s_q, s_kv, n_heads, n_kv, hd, causal, lengths,
        transpose_kv=lengths is not None, window=window)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
    zero = want.float().abs().amax(dim=(-1, -2)) == 0
    assert torch.all(out[zero] == 0)
