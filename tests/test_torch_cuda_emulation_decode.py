"""The redesigned flash_decode (``gofr_tpu_torch/csrc/flash_decode.cu``:
split-K over a thread-block cluster, bulk copies into an mbarrier ring)
under the CPU emulator of ``tests/test_torch_cuda_emulation.py``, which
runs the blocks of a cluster together: every instantiation (head dim x GQA
ratio x query type x cache type) and every cluster size, against the plain
version, with pools bit for bit the slot cache's and NaN below the window
changing no bit. Its own file, so the test workers run it beside the
other kernels' emulation.
"""

import numpy as np
import pytest
import torch

from gofr_tpu_torch.ops.cuda.flash_decode import flash_decode_plain, tile_rows
from gofr_tpu_torch.ops.kv_cache import fake_quantize_kv
from tests.test_torch_cuda_emulation import (
    CSRC,
    F32_ROW_TOL,
    TOL,
    _assert_rows_close,
    _bf16,
    _cache,
    _call_decode,
    _emulate,
    _poison_rows,
    _pool,
)


# (query dtype, int8 cache): the kernel's instantiations.
DECODE_KINDS = {"bf16": (torch.bfloat16, False), "f32": (torch.float32, False),
                "int8": (torch.bfloat16, True), "f32+int8": (torch.float32, True)}


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return _emulate({"flash_decode": (CSRC / "flash_decode.cu").read_text()},
                    tmp_path_factory.mktemp("cuda_emu_decode"))


def _decode_inputs(hd, rep, kind, split, seed=0):
    """(q, cache, lens, k_new, v_new, lengths) with one kv head of `rep`
    query heads and lengths 0, 1, a tile edge - 1 and + 1 (max_len two
    tiles): with 2 ranks the longest row puts a tile in each, with 4 or 8
    every row leaves ranks without a key."""
    dtype, quant = DECODE_KINDS[kind]
    tk = tile_rows(hd, 1 if quant else torch.tensor([], dtype=dtype).element_size())
    lengths = [0, 1, tk - 1, tk + 1]
    S, KV, max_len = len(lengths), 1, 2 * tk
    rng = np.random.default_rng(seed + hd + 7 * rep)
    q = _bf16(rng, S, KV * rep, hd).to(dtype)
    kn = vn = None
    if split:
        kn, vn = _bf16(rng, S, KV, hd).to(dtype), _bf16(rng, S, KV, hd).to(dtype)
        if quant:
            kn, vn = fake_quantize_kv(kn), fake_quantize_kv(vn)
    cache = [t.to(dtype) if t.dtype == torch.bfloat16 else t
             for t in _cache(rng, S, KV, max_len, hd, quant)]
    return q, cache, torch.tensor(lengths, dtype=torch.int32), kn, vn, lengths


def _decode_case(lib, hd, rep, kind, cluster, window, split, *, paged=False, seed=0):
    """(kernel output, plain output in the query's dtype, the inputs) on
    ``_decode_inputs``, on the slot cache or a B=16 pool."""
    q, cache, lens, kn, vn, lengths = _decode_inputs(hd, rep, kind, split, seed)
    table, B = None, 0
    if paged:
        B = 16
        cache, table = _pool(np.random.default_rng(seed), cache, lengths, B)
    out = _call_decode(lib, q, cache, lens, kn, vn, table, B, window, cluster)
    scales = dict(k_scale=cache[2], v_scale=cache[3]) if len(cache) == 4 else {}
    want = flash_decode_plain(q, cache[0], cache[1], lens, k_new=kn, v_new=vn,
                              block_table=table, window=window, **scales)
    return out, want, (q, cache, lens, kn, vn, table, B, lengths)


@pytest.mark.parametrize("kind", list(DECODE_KINDS))
@pytest.mark.parametrize("rep", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_emulated_flash_decode_templates_match_plain(emu_lib, hd, rep, kind):
    """Every instantiation (head dim x GQA ratio x query type x cache type),
    at a cluster size that varies with the case, held against the plain
    version: the written convention, then the split one windowed (the edge
    inside the first tile of the longest rows) on the slot cache, on a B=16
    pool under a shuffled table (bit for bit the slot cache's) and with NaN
    in every row below the window (no bit may change)."""
    i = [32, 64, 128, 256].index(hd) + [1, 2, 4, 7, 8].index(rep) + list(DECODE_KINDS).index(kind)
    cluster = (1, 2, 4, 8)[i % 4]
    dtype = DECODE_KINDS[kind][0]
    out, want, _ = _decode_case(emu_lib, hd, rep, kind, cluster, 0, False)
    if dtype == torch.float32:
        _assert_rows_close(out, want, F32_ROW_TOL)
    else:
        torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
    q, cache, lens, kn, vn, lengths = _decode_inputs(hd, rep, kind, True)
    window = lengths[2]  # a tile less one: the edge binds on the two longest rows
    flat = _call_decode(emu_lib, q, cache, lens, kn, vn, None, 0, window, cluster)
    quant = DECODE_KINDS[kind][1]
    scales = dict(k_scale=cache[2], v_scale=cache[3]) if quant else {}
    want = flash_decode_plain(q, cache[0], cache[1], lens, k_new=kn, v_new=vn, window=window,
                              **scales)
    if dtype == torch.float32:
        _assert_rows_close(flat, want, F32_ROW_TOL)
    else:
        torch.testing.assert_close(flat.float(), want.float(), atol=TOL, rtol=TOL)
    below = [max(0, n - window + 1) for n in lengths]
    assert any(below)
    poisoned = _call_decode(emu_lib, q, _poison_rows(cache, None, 0, below), lens, kn, vn, None,
                            0, window, cluster)
    assert torch.equal(poisoned, flat)
    rng = np.random.default_rng(hd + rep)
    pools, table = _pool(rng, cache, lengths, 16)
    assert torch.equal(_call_decode(emu_lib, q, pools, lens, kn, vn, table, 16, window, cluster),
                       flat)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_emulated_flash_decode_cluster_sizes(emu_lib, cluster):
    """The split of each (slot, kv head)'s keys over 1, 2, 4 and 8 ranks, in
    both conventions, on the bf16 slot cache, an int8 pool and windowed: each
    against the plain version, each pool bit for bit the slot cache's, and a
    second launch gives the same bits (fixed-order merges)."""
    for split in (False, True):
        out, want, args = _decode_case(emu_lib, 128, 4, "bf16", cluster, 0, split)
        torch.testing.assert_close(out.float(), want.float(), atol=TOL, rtol=TOL)
        q, cache, lens, kn, vn, table, B, _ = args
        assert torch.equal(_call_decode(emu_lib, q, cache, lens, kn, vn, table, B, 0, cluster),
                           out)
        for window in (0, 40):
            pout, pwant, pargs = _decode_case(emu_lib, 128, 4, "int8", cluster, window, split,
                                              paged=True)
            torch.testing.assert_close(pout.float(), pwant.float(), atol=TOL, rtol=TOL)
