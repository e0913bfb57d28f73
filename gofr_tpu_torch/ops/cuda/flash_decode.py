"""flash_decode: one query token per slot attends that slot's KV-cache
prefix — the port of ``gofr_tpu/ops/pallas/flash_decode.py::flash_decode``
(bf16 or f32 queries; caches of the query's type or int8; contiguous or
paged), kernel in ``gofr_tpu_torch/csrc/flash_decode.cu``. The kernel
splits each (slot, kv head)'s visible keys over a cluster of
``launch_cluster_size(...)`` blocks in one launch.

Two calling conventions, as in the reference:

* ``k_new is None`` — the current token is already written at
  ``lengths-1`` (``lengths`` includes it); a length-0 row returns 0;
* ``k_new``/``v_new`` (``[b, n_kv, hd]``) given — the current token is
  merged into the softmax split from the cache and ``lengths`` counts the
  cache prefix only; a length-0 row attends the new token alone.

Variants: ``k_scale``/``v_scale`` — an int8 cache with one f32 scale per
position (``[b, n_kv, max_len]``; scores times the K scale, probabilities
times the V scale after the denominator has taken them; the new token in
the split convention is unscaled). ``block_table`` (``[b, max_blocks]``
int32) — the caches are a pool ``[n_blocks, n_kv, block, hd]`` (scales
``[n_blocks, n_kv, block]``) and logical key ``j`` of row ``i`` lives in
pool block ``block_table[i, j // block]`` at offset ``j % block``.
``window`` (> 0, Mistral's sliding window) — the query at ``q_pos``
(``lengths`` in the split convention, ``lengths - 1`` in the written one)
sees only keys in ``(q_pos - window, q_pos]``; the kernel never reads a
row below that edge, so a step costs O(window), not O(length).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gofr_tpu_torch.ops.cuda import _build, _count
from gofr_tpu_torch.ops.kv_cache import paged_view

NEG_INF = -1e30
# Kernel launches the device ran since the last reset (``_count``: one
# per eager launch, a graph's recorded launches per replay).
launches = 0
_fn = None

_HEAD_DIMS = (32, 64, 128, 256)
_REPS = (1, 2, 4, 8)
_DTYPES = (torch.bfloat16, torch.float32)
_TILE_BYTES = 12288  # kTileBytes in the .cu
_CLUSTERS = (1, 2, 4, 8)  # the portable cluster sizes
_max_clusters: dict[tuple, int] = {}


def tile_rows(hd: int, itemsize: int) -> int:
    """Rows of the kernel's key tile (``tile_rows`` in the .cu):
    ``_TILE_BYTES`` of K per ring stage, 16 to 128 rows."""
    return min(128, max(16, _TILE_BYTES // (hd * itemsize)))


def cluster_size(pairs: int, tiles: int, max_clusters) -> int:
    """Blocks per (slot, kv head): the largest of 1, 2, 4 and 8 whose grid
    of ``pairs`` clusters the card runs in one wave (``max_clusters(C)``,
    clusters of C blocks it holds at once) and that leaves no rank without
    a key tile of the longest visible range (``tiles`` of them: the cache's
    capacity, or the window). Both are known on the host without reading
    the device's lengths, and are alike for a pool and a slot cache of the
    same capacity, so both split the keys the same way."""
    c = 1
    for cand in _CLUSTERS[1:]:
        if cand <= tiles and pairs <= max_clusters(cand):
            c = cand
    return c


def max_active_clusters(q: torch.Tensor, k_cache: torch.Tensor, n_tab: int,
                        cluster: int) -> int:
    """Clusters of ``cluster`` blocks of the kernel for these inputs' types
    and shapes that the card runs at once (the CUDA occupancy calculator),
    cached per card and instantiation."""
    hd, rep = q.shape[-1], q.shape[-2] // k_cache.shape[1]
    quant = k_cache.dtype == torch.int8
    idx = q.device.index if q.device.index is not None else torch.cuda.current_device()
    key = (idx, hd, rep, q.dtype, quant, n_tab, cluster)
    if key not in _max_clusters:
        fn = _build.lib().gofr_flash_decode_max_clusters
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_int
        with torch.cuda.device(idx):
            n = fn(hd, rep, int(q.dtype == torch.float32), int(quant), n_tab, cluster)
        if n < 0:
            raise RuntimeError(f"flash_decode occupancy query failed: cudaError {-n}")
        _max_clusters[key] = n
    return _max_clusters[key]


def launch_cluster_size(q: torch.Tensor, k_cache: torch.Tensor,
                        block_table: Optional[torch.Tensor], window: int) -> int:
    """The cluster size the wrapper launches these CUDA inputs with."""
    blk = k_cache.shape[2]
    n_tab = 0 if block_table is None else block_table.shape[-1]
    capacity = blk * n_tab if n_tab else blk
    visible = min(capacity, window) if window else capacity
    tiles = -(-visible // tile_rows(q.shape[-1], k_cache.element_size()))
    return cluster_size(q.shape[0] * k_cache.shape[1], tiles,
                        lambda c: max_active_clusters(q, k_cache, n_tab, c))


def flash_decode_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_table: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version, ported from the dense formula of
    ``gofr_tpu/ops/attention.py::decode_attention``: a pool is gathered
    through ``paged_view``, an int8 cache is cast to the query dtype with
    its scales on the scores and on the probabilities, f32 scores and
    softmax (keys outside the window masked), probabilities cast to the
    query dtype for the value product. In the written convention a
    length-0 row returns 0 (the kernel contract)."""
    b, n_heads, hd = q.shape
    if block_table is not None:
        k_cache, v_cache, k_scale, v_scale = paged_view(
            block_table, k_cache, v_cache, torch.arange(b, device=q.device),
            k_scale, v_scale,
        )
    n_kv, max_len = k_cache.shape[1], k_cache.shape[2]
    rep = n_heads // n_kv
    if scale is None:
        scale = hd**-0.5
    quant = k_scale is not None
    if quant:  # dequantize through the scores and probabilities
        k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
    qg = q.reshape(b, n_kv, rep, hd)
    scores = torch.einsum(
        "bgrd,bgkd->bgrk", qg.float(), k_cache.float()
    ) * scale  # [b, kv, rep, max_len]
    if quant:
        scores = scores * k_scale[:, :, None, :]
    lens = lengths.to(torch.long)
    cols = torch.arange(max_len, device=q.device)[None, :]
    valid = cols < lens[:, None]
    if window:
        q_pos = lens if k_new is not None else lens - 1
        valid = valid & (cols > (q_pos - window)[:, None])
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    if k_new is None:
        probs = torch.softmax(scores, dim=-1)
        if quant:
            probs = probs * v_scale[:, :, None, :]
        out = torch.einsum("bgrk,bgkd->bgrd", probs.to(q.dtype), v_cache)
        out = torch.where((lens > 0)[:, None, None, None], out, 0.0)
        return out.reshape(b, n_heads, hd)
    s_new = torch.einsum(
        "bgrd,bgd->bgr", qg.float(), k_new.float()
    ) * scale  # [b, kv, rep]
    m = torch.maximum(scores.amax(dim=-1), s_new)
    e_c = torch.exp(scores - m[..., None])
    e_n = torch.exp(s_new - m)
    denom = e_c.sum(dim=-1) + e_n
    if quant:
        e_c = e_c * v_scale[:, :, None, :]
    out = torch.einsum("bgrk,bgkd->bgrd", e_c.to(q.dtype), v_cache)
    out = out + e_n[..., None].to(q.dtype) * v_new[:, :, None, :]
    out = out / denom[..., None].to(q.dtype)
    return out.reshape(b, n_heads, hd)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.lib().gofr_flash_decode
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_query_dtype(name: str, q: torch.Tensor) -> torch.dtype:
    """The query's dtype, if a kernel takes it (bf16 or f32)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} has dtype {q.dtype}; the kernels take {_DTYPES}")
    return q.dtype


def check_cache(
    k_cache: torch.Tensor, v_cache: torch.Tensor,
    k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
    block_table: Optional[torch.Tensor], table_rows: int, n_kv: int, hd: int,
    device: torch.device, dtype: torch.dtype,
) -> tuple[int, int]:
    """Check a cache (contiguous or pool; of the query's ``dtype``, or int8
    with scales) for a kernel launch; returns (rows per cache block:
    ``max_len`` or the pool block, table width or 0)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass k_scale and v_scale together")
    rows, blk = k_cache.shape[0], k_cache.shape[2]
    dtype = dtype if k_scale is None else torch.int8
    _check("k_cache", k_cache, (rows, n_kv, blk, hd), dtype, device)
    _check("v_cache", v_cache, (rows, n_kv, blk, hd), dtype, device)
    if k_scale is not None:
        _check("k_scale", k_scale, (rows, n_kv, blk), torch.float32, device)
        _check("v_scale", v_scale, (rows, n_kv, blk), torch.float32, device)
    if block_table is None:
        return blk, 0
    if blk % 16:
        raise ValueError(f"the pool's block size must be a multiple of 16, got {blk}")
    width = block_table.shape[-1] if block_table.dim() == 2 else -1
    _check("block_table", block_table, (table_rows, width), torch.int32, device)
    return blk, width


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def flash_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_table: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """q: [b, n_heads, hd]; caches: [b, n_kv, max_len, hd] or a pool
    [n_blocks, n_kv, block, hd] with ``block_table`` [b, max_blocks];
    k_scale/v_scale: int8 scales, the caches' shape without hd; lengths:
    [b] int32; k_new/v_new: [b, n_kv, hd]; window: sliding window (0 =
    none). Returns [b, n_heads, hd].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 or f32 q, new token of q's dtype, caches of q's dtype or int8,
    contiguous, hd in {32, 64, 128, 256}, n_heads/n_kv in {1, 2, 4, 8},
    pool blocks a multiple of 16) or raise."""
    if (k_new is None) != (v_new is None):
        raise ValueError("pass k_new and v_new together")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return flash_decode_plain(
            q, k_cache, v_cache, lengths, k_new=k_new, v_new=v_new,
            k_scale=k_scale, v_scale=v_scale, block_table=block_table,
            scale=scale, window=window,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    b, n_heads, hd = q.shape
    n_kv = k_cache.shape[1]
    if hd not in _HEAD_DIMS or n_heads % n_kv or n_heads // n_kv not in _REPS:
        raise ValueError(
            f"flash_decode kernel takes hd in {_HEAD_DIMS} and n_heads/n_kv "
            f"in {_REPS}, got hd={hd}, n_heads={n_heads}, n_kv={n_kv}"
        )
    dev = q.device
    dtype = check_query_dtype("q", q)
    _check("q", q, (b, n_heads, hd), dtype, dev)
    if block_table is None and k_cache.shape[0] != b:
        raise ValueError(f"k_cache has {k_cache.shape[0]} slots, q has {b}")
    check_cache(k_cache, v_cache, k_scale, v_scale, block_table, b, n_kv, hd, dev, dtype)
    _check("lengths", lengths, (b,), torch.int32, dev)
    if k_new is not None:
        _check("k_new", k_new, (b, n_kv, hd), dtype, dev)
        _check("v_new", v_new, (b, n_kv, hd), dtype, dev)
    out = launch_with_cluster(
        q, k_cache, v_cache, lengths, k_new, v_new, k_scale, v_scale, block_table,
        hd**-0.5 if scale is None else scale, window,
        launch_cluster_size(q, k_cache, block_table, window))
    _count.launched(__name__)
    return out


def launch_with_cluster(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
    lengths: torch.Tensor, k_new: Optional[torch.Tensor],
    v_new: Optional[torch.Tensor], k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor], block_table: Optional[torch.Tensor],
    scale: float, window: int, cluster: int,
) -> torch.Tensor:
    """The kernel on CUDA inputs that ``flash_decode`` has checked, with
    ``cluster`` (1, 2, 4 or 8) blocks per (slot, kv head); bumps no launch
    counter. ``flash_decode`` calls it with ``launch_cluster_size``; a
    measurement may compare cluster sizes through it."""
    b, n_heads, hd = q.shape
    width = 0 if block_table is None else block_table.shape[-1]
    out = torch.empty_like(q)
    rc = _kernel_fn()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), _ptr(k_new), _ptr(v_new), _ptr(k_scale),
        _ptr(v_scale), _ptr(block_table), out.data_ptr(),
        b, n_heads, k_cache.shape[1], k_cache.shape[2], width, hd, int(window),
        int(q.dtype == torch.float32), int(cluster), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError {rc}")
    return out
