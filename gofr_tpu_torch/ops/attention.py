"""Attention ops: full-sequence attention (training forward, padded-batch
serving prefill), decode (one query token per slot against the cache) and
chunked-prefill attention against the cache.

The counterpart of ``gofr_tpu/ops/attention.py``. ``kernel=True`` (the
default) goes to the hand-written CUDA kernels of ``ops/cuda/`` — whose
wrappers take the plain version for CPU tensors and launch the kernel
for CUDA tensors — and ``kernel=False`` calls the plain PyTorch version
directly, on any device (tests and ``chip_smoke.py`` use it as the
oracle); for ``attention`` that is the reference's dense formula. The
serving ops take the int8 cache (``k_scale``/``v_scale``) and the paged
pool (``block_table``) on both paths, and all three ops take Mistral's
sliding ``window`` under the reference's rules: a window that cannot bind
within the keys (the cache's capacity, for the serving ops) is dropped,
and a window without causal attention raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from gofr_tpu_torch.ops.cuda import flash_attention as _fa
from gofr_tpu_torch.ops.cuda import flash_decode as _fd
from gofr_tpu_torch.ops.cuda import flash_prefill as _fp
from gofr_tpu_torch.ops.cuda.flash_attention import (
    dense_attention,
    flash_attention,
    visible_keys,
)
from gofr_tpu_torch.ops.cuda.flash_decode import flash_decode, flash_decode_plain
from gofr_tpu_torch.ops.cuda.flash_prefill import (
    flash_cache_attention,
    flash_cache_attention_plain,
)


def kernel_refusal(head_dim: int, n_heads: int, n_kv: int) -> Optional[str]:
    """Why one of the three kernels (bf16 or f32) would refuse a model's
    attention of this head dim and head counts on a card (each wrapper's
    accepted set), or None when all three take it."""
    if n_heads % n_kv:
        return f"n_heads {n_heads} is not a multiple of n_kv_heads {n_kv}"
    for name, mod in (("flash_attention", _fa), ("flash_cache_attention", _fp),
                      ("flash_decode", _fd)):
        if head_dim not in mod._HEAD_DIMS:
            return (f"{name} has no kernel at head_dim {head_dim} "
                    f"(takes {mod._HEAD_DIMS}; ROADMAP Queue 2 A)")
    if n_heads // n_kv not in _fd._REPS:
        return (f"flash_decode has no kernel at n_heads / n_kv_heads = "
                f"{n_heads // n_kv} (takes {_fd._REPS}; ROADMAP Queue 2 A)")
    return None


def _effective_window(window: int, k_cache: torch.Tensor,
                      block_table: Optional[torch.Tensor]) -> int:
    """0 when the sliding window cannot bind within the cache's capacity:
    ``max_len`` for a slot cache, table width x block for a pool (whose
    ``shape[2]`` is the block axis)."""
    if not window:
        return 0
    capacity = k_cache.shape[2]
    if block_table is not None:
        capacity *= block_table.shape[1]
    return 0 if window >= capacity else window


class FlashAttentionFn(torch.autograd.Function):
    """Kernel forward, dense-recompute backward — the counterpart of
    ``_flash_attention_ad``: the reference has no backward kernel, so the
    gradients are re-derived from the dense formula (f32 scores,
    probabilities in the input dtype) on the saved q, k, v, under the same
    causal ``window`` as the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float],
                window: int = 0):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            vis = visible_keys(q.shape[0], q.shape[1], k.shape[1],
                               causal=ctx.causal, window=ctx.window,
                               device=q.device)
            out = dense_attention(q, k, v, vis, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    mask: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    kernel: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Full-sequence attention (training forward, prefill, encoder).

    q: [b, s_q, n_heads, hd]; k, v: [b, s_kv, n_kv, hd]; causal offset
    ``s_kv - s_q``. mask: optional [b, s_q, s_kv] bool (True = attend),
    which takes the dense formula. lengths: optional [b] int32 valid key
    prefix per row (right-padded serving prefill, no gradient) — straight
    to the kernel. Otherwise the kernel runs under ``FlashAttentionFn``
    (differentiable). window: each query attends only keys in
    ``(q_pos - window, q_pos]`` (causal only); one that cannot bind
    (``window >= s_kv``) is dropped.
    """
    if mask is not None and lengths is not None:
        raise ValueError("pass either mask or lengths, not both")
    if window and window >= k.shape[1]:
        window = 0  # cannot bind: plain causal
    if window and not causal:
        raise ValueError("window requires causal attention")
    if kernel and mask is None:
        if lengths is not None:
            return flash_attention(q, k, v, lengths, causal=causal,
                                   scale=scale, window=window)
        return FlashAttentionFn.apply(q, k, v, causal, scale, window)
    b, s_q = q.shape[:2]
    vis = visible_keys(b, s_q, k.shape[1], causal=causal, lengths=lengths,
                       window=window, device=q.device)
    if mask is not None:
        vis = vis & mask
    return dense_attention(q, k, v, vis, scale=scale)


def decode_attention(
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
    kernel: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Single-token decode attention against per-slot caches.

    q: [b, n_heads, hd]; k_cache, v_cache: [b, n_kv, max_len, hd]
    (heads-major); lengths: [b] int32. Two conventions: ``k_new is None``
    — the token is already written at lengths-1 (lengths includes it);
    ``k_new``/``v_new`` ([b, n_kv, hd]) given — the token is attended split
    from the cache and lengths counts only the prefix (the serving path).
    k_scale/v_scale: int8-cache scales, the caches' shape without hd;
    block_table ([b, max_blocks] int32): the caches are a pool
    [n_blocks, n_kv, block, hd]. window: the query attends only the last
    ``window`` positions including its own; one that cannot bind within
    the capacity is dropped, as in the reference.
    """
    if (k_new is None) != (v_new is None):
        raise ValueError("pass k_new and v_new together")
    fn = flash_decode if kernel else flash_decode_plain
    return fn(q, k_cache, v_cache, lengths, k_new=k_new, v_new=v_new,
              k_scale=k_scale, v_scale=v_scale, block_table=block_table,
              scale=scale,
              window=_effective_window(window, k_cache, block_table))


def cache_chunk_attention(
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
    kernel: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Chunked-prefill attention: a [P, c] chunk of queries per row attends
    its slot's cache prefix [0, starts[p]+t] (causal at global positions);
    the chunk's K/V must already be written. q: [P, c, n_heads, hd];
    caches: [S, n_kv, max_len, hd] or a pool [n_blocks, n_kv, block, hd]
    with ``block_table`` [S, max_blocks]; k_scale/v_scale: int8-cache
    scales; slots/starts/lens: [P] int32. Rows with t >= lens[p] return
    0. window: query t sees keys in ``(starts[p]+t - window, starts[p]+t]``;
    one that cannot bind within the capacity is dropped."""
    fn = flash_cache_attention if kernel else flash_cache_attention_plain
    return fn(q, k_cache, v_cache, slots, starts, lens, k_scale=k_scale,
              v_scale=v_scale, block_table=block_table, scale=scale,
              window=_effective_window(window, k_cache, block_table))
