"""flash_cache_attention: a [P, c] chunk of queries per row attends its
slot's KV-cache prefix in place (chunked prefill) — the port of
``gofr_tpu/ops/pallas/flash_prefill.py::flash_cache_attention`` (bf16 or
f32 queries; caches of the query's type or int8; contiguous or paged),
kernels in ``gofr_tpu_torch/csrc/flash_prefill.cu`` (bf16, wgmma) and
``gofr_tpu_torch/csrc/attn_f32.cu`` (f32, CUDA cores).

Row p's query t sits at global position ``starts[p] + t`` and attends keys
``[0, starts[p] + t]`` of slot ``slots[p]``; the chunk's K/V must already be
written. Rows with ``t >= lens[p]`` return 0. The int8 (``k_scale``/
``v_scale``) and paged (``block_table``, row p reads through
``block_table[slots[p]]``) variants are those of ``flash_decode``.
``window`` (> 0) narrows query t to keys in
``(starts[p] + t - window, starts[p] + t]``; key tiles wholly below a query
tile's loosest edge are never read.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gofr_tpu_torch.ops.cuda import _build, _count
from gofr_tpu_torch.ops.cuda.flash_decode import _check, _ptr, check_cache, check_query_dtype
from gofr_tpu_torch.ops.kv_cache import paged_view

NEG_INF = -1e30
# Kernel launches the device ran since the last reset (``_count``: one
# per eager launch, a graph's recorded launches per replay).
launches = 0
_fns: dict = {}

_HEAD_DIMS = (32, 64, 128, 256)  # both the bf16 (wgmma) and f32 kernels


def flash_cache_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    slots: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_table: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version, ported from the dense formula of
    ``gofr_tpu/ops/attention.py::cache_chunk_attention``: gather each row's
    slot (a pool through ``paged_view``), an int8 cache cast to the query
    dtype with its scales on the scores and on the probabilities, f32
    scores and softmax under the causal (and window) mask at global
    positions,
    probabilities cast to the query dtype for the value product, padding
    rows zeroed."""
    P, c, n_heads, hd = q.shape
    sl = slots.to(torch.long)
    if block_table is not None:
        ck, cv, ks, vs = paged_view(block_table, k_cache, v_cache, sl,
                                    k_scale, v_scale)
    else:
        ck, cv = k_cache[sl], v_cache[sl]  # [P, KV, max_len, hd]
        ks = None if k_scale is None else k_scale[sl]
        vs = None if v_scale is None else v_scale[sl]
    n_kv, max_len = ck.shape[1], ck.shape[2]
    rep = n_heads // n_kv
    if scale is None:
        scale = hd**-0.5
    if ks is not None:  # dequantize through the scores and probabilities
        ck, cv = ck.to(q.dtype), cv.to(q.dtype)
    qg = q.reshape(P, c, n_kv, rep, hd)
    scores = torch.einsum(
        "pcgrd,pgkd->pgrck", qg.float(), ck.float()
    ) * scale  # [P, KV, rep, c, max_len]
    if ks is not None:
        scores = scores * ks[:, :, None, None, :]
    t = torch.arange(c, device=q.device)
    pos = starts.to(torch.long)[:, None] + t[None, :]  # [P, c] global
    cols = torch.arange(max_len, device=q.device)[None, None, :]
    valid = cols <= pos[:, :, None]
    if window:
        valid = valid & (cols > (pos - window)[:, :, None])
    row_ok = t[None, :] < lens.to(torch.long)[:, None]  # [P, c]
    valid = valid & row_ok[:, :, None]
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if vs is not None:
        probs = probs * vs[:, :, None, None, :]
    out = torch.einsum("pgrck,pgkd->pcgrd", probs.to(q.dtype), cv)
    out = torch.where(row_ok[:, :, None, None, None], out, 0.0)
    return out.reshape(P, c, n_heads, hd)


def _kernel_fn(dtype: torch.dtype):
    """The C entry for ``dtype`` queries: the wgmma kernel (bf16) or the
    CUDA-core one (f32)."""
    if dtype not in _fns:
        name = "gofr_flash_cache_attention" + ("_f32" if dtype == torch.float32 else "")
        fn = getattr(_build.lib(), name)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return _fns[dtype]


def flash_cache_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    slots: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_table: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """q: [P, c, n_heads, hd]; caches: [S, n_kv, max_len, hd] or a pool
    [n_blocks, n_kv, block, hd] with ``block_table`` [S, max_blocks];
    k_scale/v_scale: int8 scales, the caches' shape without hd;
    slots/starts/lens: [P] int32; window: sliding window (0 = none).
    Returns [P, c, n_heads, hd].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 or f32 q, caches of q's dtype or int8, contiguous, hd in {32, 64,
    128, 256}, pool blocks a multiple of 16) or raise."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return flash_cache_attention_plain(
            q, k_cache, v_cache, slots, starts, lens, k_scale=k_scale,
            v_scale=v_scale, block_table=block_table, scale=scale,
            window=window,
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_cache_attention runs on cuda or cpu, not {q.device}"
        )
    P, c, n_heads, hd = q.shape
    n_kv = k_cache.shape[1]
    dtype = check_query_dtype("q", q)
    if hd not in _HEAD_DIMS or n_heads % n_kv:
        raise ValueError(
            f"flash_cache_attention kernel takes hd in {_HEAD_DIMS} for "
            f"{dtype} and n_heads divisible by n_kv, got hd={hd}, "
            f"n_heads={n_heads}, n_kv={n_kv}"
        )
    dev = q.device
    _check("q", q, (P, c, n_heads, hd), dtype, dev)
    n_slots = k_cache.shape[0] if block_table is None else block_table.shape[0]
    blk, width = check_cache(k_cache, v_cache, k_scale, v_scale, block_table,
                             n_slots, n_kv, hd, dev, dtype)
    for name, t in (("slots", slots), ("starts", starts), ("lens", lens)):
        _check(name, t, (P,), torch.int32, dev)
    if scale is None:
        scale = hd**-0.5
    out = torch.empty_like(q)
    rc = _kernel_fn(dtype)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        slots.data_ptr(), starts.data_ptr(), lens.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), _ptr(block_table), out.data_ptr(), P, c, n_heads,
        n_kv, blk, width, hd, int(window), float(scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"flash_cache_attention launch failed: cudaError {rc}"
        )
    _count.launched(__name__)
    return out
