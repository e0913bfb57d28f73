"""flash_attention: full-sequence attention (training forward, padded-batch
serving prefill, encoders) — the port of
``gofr_tpu/ops/pallas/flash_attention.py::flash_attention``, kernels in
``gofr_tpu_torch/csrc/flash_attention.cu`` (bf16, wgmma) and
``gofr_tpu_torch/csrc/attn_f32.cu`` (f32, CUDA cores).

q: [b, s_q, n_heads, hd]; k, v: [b, s_kv, n_kv, hd]. Causal attention
aligns the diagonal at offset ``s_kv - s_q`` (a query suffix sees every
earlier key); query head h reads kv head ``h // (n_heads // n_kv)``;
optional ``lengths`` [b] masks keys at or past each row's length; a causal
``window`` (> 0) limits query row r to keys in
``(r + offset - window, r + offset]``, and the kernel skips key tiles
wholly below a query tile's edge. A query row that sees no key returns
exactly 0 — the kernel's convention, which the plain version here follows
(the reference's dense formula averages every key there instead).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gofr_tpu_torch.ops.cuda import _build, _count
from gofr_tpu_torch.ops.cuda.flash_decode import _check, check_query_dtype

NEG_INF = -1e30
# Kernel launches the device ran since the last reset (``_count``: one
# per eager launch, a graph's recorded launches per replay).
launches = 0
_fns: dict = {}

_HEAD_DIMS = (32, 64, 128, 256)  # both the bf16 (wgmma) and f32 kernels


def visible_keys(
    b: int, s_q: int, s_kv: int, *, causal: bool,
    lengths: Optional[torch.Tensor] = None, window: int = 0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """[b or 1, s_q, s_kv] bool: query row r sees key c (causal bound at
    offset ``s_kv - s_q``, the causal ``window``'s lower edge, key
    ``lengths``)."""
    if window and not causal:
        raise ValueError("window requires causal attention")
    cols = torch.arange(s_kv, device=device)
    vis = torch.ones((1, s_q, s_kv), dtype=torch.bool, device=device)
    if causal:
        rows = torch.arange(s_q, device=device)[:, None] + (s_kv - s_q)
        vis = vis & (cols[None, :] <= rows)[None]
        if window:
            vis = vis & (cols[None, :] > rows - window)[None]
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
    window: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version: the dense formula, with the rows that see no
    key set to 0 as the kernel returns them."""
    b, s_q = q.shape[:2]
    vis = visible_keys(b, s_q, k.shape[1], causal=causal, lengths=lengths,
                       window=window, device=q.device)
    out = dense_attention(q, k, v, vis, scale=scale)
    return torch.where(vis.any(dim=-1)[:, :, None, None], out, 0.0)


def _kernel_fn(dtype: torch.dtype):
    """The C entry for ``dtype`` inputs: the wgmma kernel (bf16) or the
    CUDA-core one (f32)."""
    if dtype not in _fns:
        name = "gofr_flash_attention" + ("_f32" if dtype == torch.float32 else "")
        fn = getattr(_build.lib(), name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return _fns[dtype]


def _tma_view(name: str, t: torch.Tensor, dev: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    """``t`` itself: the kernels read q, k and v in place through their
    strides; the bf16 kernel through TMA tensor maps, which need a unit
    stride on head_dim and a 16-byte aligned base and batch, sequence and
    head strides (the f32 kernel needs the unit stride only). Anything else
    raises (no silent copy)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.stride(-1) != 1 or (dtype == torch.bfloat16 and (
            any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16)):
        raise ValueError(
            f"{name} (strides {tuple(t.stride())}, base offset {t.data_ptr() % 16} "
            "bytes past 16) cannot be described by a TMA tensor map: head_dim "
            "must have stride 1 and the other strides and the base must be "
            "multiples of 16 bytes"
        )
    return t


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """q: [b, s_q, n_heads, hd]; k, v: [b, s_kv, n_kv, hd]; lengths: [b]
    int32 or None; window: causal sliding window (0 = none). Returns
    [b, s_q, n_heads, hd], contiguous.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 or f32, hd in {32, 64, 128, 256}, n_heads divisible by n_kv; q/k/v
    are read in place through their strides, which TMA must be able to
    describe in bf16) or raise."""
    if window < 0 or (window and not causal):
        raise ValueError(f"window {window} needs causal attention and >= 0")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lengths, causal=causal,
                                     scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    b, s_q, n_heads, hd = q.shape
    s_kv, n_kv = k.shape[1], k.shape[2]
    dtype = check_query_dtype("q", q)
    if hd not in _HEAD_DIMS or n_heads % n_kv:
        raise ValueError(
            f"flash_attention kernel takes hd in {_HEAD_DIMS} for {dtype} "
            f"and n_heads divisible by n_kv, got hd={hd}, n_heads={n_heads}, "
            f"n_kv={n_kv}"
        )
    if tuple(k.shape) != (b, s_kv, n_kv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"k/v must be [{b}, s_kv, n_kv, {hd}] alike, got {tuple(k.shape)} "
            f"and {tuple(v.shape)}"
        )
    dev = q.device
    q, k, v = (_tma_view(name, t, dev, dtype) for name, t in (("q", q), ("k", k), ("v", v)))
    if lengths is not None:
        _check("lengths", lengths, (b,), torch.int32, dev)
    if scale is None:
        scale = hd**-0.5
    out = torch.empty((b, s_q, n_heads, hd), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    rc = _kernel_fn(dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lengths.data_ptr() if lengths is not None else None, out.data_ptr(),
        b, s_q, s_kv, n_heads, n_kv, hd, int(causal), int(window), strides,
        float(scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    _count.launched(__name__)
    return out
