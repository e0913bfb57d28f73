"""flash_attention: full-sequence attention (training forward, padded-batch
serving prefill, encoders) — the port of
``gofr_tpu/ops/pallas/flash_attention.py::flash_attention`` without its
sliding window, kernel in ``gofr_tpu_torch/csrc/flash_attention.cu``.

q: [b, s_q, n_heads, hd]; k, v: [b, s_kv, n_kv, hd]. Causal attention
aligns the diagonal at offset ``s_kv - s_q`` (a query suffix sees every
earlier key); query head h reads kv head ``h // (n_heads // n_kv)``;
optional ``lengths`` [b] masks keys at or past each row's length. A query
row that sees no key returns exactly 0 — the kernel's convention, which
the plain version here follows (the reference's dense formula averages
every key there instead).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gofr_tpu_torch.ops.cuda import _build
from gofr_tpu_torch.ops.cuda.flash_decode import _check

NEG_INF = -1e30
# Kernel launches since the last reset (bumped by the wrapper only).
launches = 0
_fn = None

_HEAD_DIMS = (64, 128)


def visible_keys(
    b: int, s_q: int, s_kv: int, *, causal: bool,
    lengths: Optional[torch.Tensor] = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """[b or 1, s_q, s_kv] bool: query row r sees key c (causal bound at
    offset ``s_kv - s_q``, key ``lengths``)."""
    cols = torch.arange(s_kv, device=device)
    vis = torch.ones((1, s_q, s_kv), dtype=torch.bool, device=device)
    if causal:
        rows = torch.arange(s_q, device=device)[:, None] + (s_kv - s_q)
        vis = vis & (cols[None, :] <= rows)[None]
    if lengths is not None:
        lens = lengths.to(device=device, dtype=torch.long)
        vis = vis & (cols[None, :] < lens[:, None])[:, None, :]
    return vis


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, visible: torch.Tensor,
    *, scale: Optional[float] = None,
) -> torch.Tensor:
    """The reference's dense formula (``gofr_tpu/ops/attention.py::
    attention`` with ``kernel=False``): grouped-head f32 scores, masked
    softmax, probabilities cast to ``q.dtype`` for the value product.
    visible: [b or 1, s_q, s_kv] bool. Differentiable."""
    b, s_q, n_heads, hd = q.shape
    n_kv = k.shape[2]
    rep = n_heads // n_kv
    if scale is None:
        scale = hd**-0.5
    qg = q.reshape(b, s_q, n_kv, rep, hd)
    scores = torch.einsum(
        "bqgrd,bkgd->bgrqk", qg.float(), k.float()
    ) * scale  # [b, kv, rep, s_q, s_kv]
    scores = torch.where(visible[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    return out.reshape(b, s_q, n_heads, hd)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version: the dense formula, with the rows that see no
    key set to 0 as the kernel returns them."""
    b, s_q = q.shape[:2]
    vis = visible_keys(b, s_q, k.shape[1], causal=causal, lengths=lengths,
                       device=q.device)
    out = dense_attention(q, k, v, vis, scale=scale)
    return torch.where(vis.any(dim=-1)[:, :, None, None], out, 0.0)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.lib().gofr_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _in_place(name: str, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` if the kernel can read it through its strides (unit stride on
    head_dim, 16-byte aligned rows), else a contiguous copy."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.bfloat16")
    if (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: [b, s_q, n_heads, hd]; k, v: [b, s_kv, n_kv, hd]; lengths: [b]
    int32 or None. Returns [b, s_q, n_heads, hd], contiguous.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16, hd in {64, 128}, n_heads divisible by n_kv; q/k/v are read
    through their strides, or copied once when their rows are not 16-byte
    aligned) or raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lengths, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    b, s_q, n_heads, hd = q.shape
    s_kv, n_kv = k.shape[1], k.shape[2]
    if hd not in _HEAD_DIMS or n_heads % n_kv:
        raise ValueError(
            f"flash_attention kernel takes hd in {_HEAD_DIMS} and n_heads "
            f"divisible by n_kv, got hd={hd}, n_heads={n_heads}, n_kv={n_kv}"
        )
    if tuple(k.shape) != (b, s_kv, n_kv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"k/v must be [{b}, s_kv, n_kv, {hd}] alike, got {tuple(k.shape)} "
            f"and {tuple(v.shape)}"
        )
    dev = q.device
    q, k, v = _in_place("q", q, dev), _in_place("k", k, dev), _in_place("v", v, dev)
    if lengths is not None:
        _check("lengths", lengths, (b,), torch.int32, dev)
    if scale is None:
        scale = hd**-0.5
    out = torch.empty((b, s_q, n_heads, hd), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    rc = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lengths.data_ptr() if lengths is not None else None, out.data_ptr(),
        b, s_q, s_kv, n_heads, n_kv, hd, int(causal), strides, float(scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out
