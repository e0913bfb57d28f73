"""KV caches of the port — the counterpart of ``gofr_tpu/ops/kv_cache.py``.

* ``KVCache``, the slot cache: ``[n_layers, n_slots, n_kv_heads, max_len,
  head_dim]``, heads-major, one row per slot.
* ``PagedKVCache``, the block pool: ``[n_layers, n_blocks, n_kv_heads,
  block, head_dim]`` and a ``[n_slots, max_blocks]`` int32 block table
  that maps each slot's logical block ``j`` to a pool block. Block 0 is
  the parking block: inactive-slot and padding writes land there, the
  allocator never hands it out, and unallocated table entries point at
  it, so nothing in it is ever attended.
* ``BlockAllocator``, the host-side refcounted allocator over the pool.

Int8 mode (``quant="int8"``): K/V are stored as int8 with one f32 absmax
scale per (layer, row, kv head, position), set to 1 at creation. The
port stores the scales **without** the reference's x8 sublane replication
(``[L, S, KV, max_len]`` and ``[L, n_blocks, KV, block]`` instead of an
extra axis of 8 before the last): that axis exists only so a TPU VMEM
block tiles, and at Llama-3-8B it would add 16,384 bytes to each
67,584-byte int8 token. The reference's ``k_s[..., 0, :]`` is the port's
``k_s``.

Unlike the reference's functional pytrees, the port updates the buffers
in place (prefill and decode write their K/V with ``index_put_``): no
buffer is ever copied whole, which is what the reference gets from
donation.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import torch


def _quant_mode(quant: str) -> bool:
    """True for int8, False for none; anything else raises."""
    mode = (quant or "").lower()
    if mode and mode != "int8":
        raise ValueError(f"unsupported KV quant mode {quant!r} (int8 only)")
    return mode == "int8"


def _buffers(shape: tuple, dtype: torch.dtype, int8: bool,
             device: torch.device | str) -> dict:
    """K/V buffers (zeros) and, in int8 mode, scale planes (ones) of
    ``shape[:-1]``."""
    if not int8:
        return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                    v=torch.zeros(shape, dtype=dtype, device=device))
    return dict(
        k=torch.zeros(shape, dtype=torch.int8, device=device),
        v=torch.zeros(shape, dtype=torch.int8, device=device),
        k_s=torch.ones(shape[:-1], dtype=torch.float32, device=device),
        v_s=torch.ones(shape[:-1], dtype=torch.float32, device=device),
    )


def _nbytes(*tensors: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@dataclass
class KVCache:
    k: torch.Tensor  # [layers, slots, kv_heads, max_len, head_dim]
    v: torch.Tensor
    lengths: torch.Tensor  # [slots] int32 — tokens currently in each slot
    # int8 mode only: [layers, slots, kv_heads, max_len] f32 scales.
    k_s: Optional[torch.Tensor] = None
    v_s: Optional[torch.Tensor] = None

    @classmethod
    def create(
        cls,
        n_layers: int,
        n_slots: int,
        max_len: int,
        n_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        quant: str = "",
        device: torch.device | str = "cpu",
    ) -> "KVCache":
        shape = (n_layers, n_slots, n_kv_heads, max_len, head_dim)
        return cls(
            **_buffers(shape, dtype, _quant_mode(quant), device),
            lengths=torch.zeros((n_slots,), dtype=torch.int32, device=device),
        )

    @property
    def quantized(self) -> bool:
        return self.k_s is not None

    @property
    def n_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    def hbm_bytes(self) -> int:
        """Device bytes of the K/V buffers and scale planes."""
        return _nbytes(self.k, self.v, self.k_s, self.v_s)


@dataclass
class PagedKVCache:
    """Block-pool KV cache: device memory follows the tokens resident, not
    ``n_slots x max_len`` (see the module docstring for the layout)."""

    k: torch.Tensor  # [layers, n_blocks, kv_heads, block, head_dim]
    v: torch.Tensor
    block_table: torch.Tensor  # [slots, max_blocks] int32
    lengths: torch.Tensor  # [slots] int32
    k_s: Optional[torch.Tensor] = None  # int8: [layers, n_blocks, kv_heads, block]
    v_s: Optional[torch.Tensor] = None

    @classmethod
    def create(
        cls,
        n_layers: int,
        n_slots: int,
        max_len: int,
        n_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        quant: str = "",
        block: int = 128,
        n_blocks: int = 0,
        device: torch.device | str = "cpu",
    ) -> "PagedKVCache":
        """``max_len`` is the per-slot logical cap (table width x block);
        ``n_blocks`` the pool size, block 0 included (default
        ``n_slots * max_len / block + 1``: the slot cache's capacity)."""
        if max_len % block:
            raise ValueError(f"max_len {max_len} not a multiple of block {block}")
        max_blocks = max_len // block
        if n_blocks <= 0:
            n_blocks = n_slots * max_blocks + 1  # +1: parking block 0
        shape = (n_layers, n_blocks, n_kv_heads, block, head_dim)
        return cls(
            **_buffers(shape, dtype, _quant_mode(quant), device),
            block_table=torch.zeros((n_slots, max_blocks), dtype=torch.int32,
                                    device=device),
            lengths=torch.zeros((n_slots,), dtype=torch.int32, device=device),
        )

    @property
    def quantized(self) -> bool:
        return self.k_s is not None

    @property
    def n_slots(self) -> int:
        return self.block_table.shape[0]

    @property
    def block(self) -> int:
        return self.k.shape[3]

    @property
    def n_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.block_table.shape[1] * self.k.shape[3]

    def hbm_bytes(self) -> int:
        """Device bytes of the pool's K/V buffers and scale planes."""
        return _nbytes(self.k, self.v, self.k_s, self.v_s)

    def block_bytes(self) -> int:
        """Bytes of one pool block across every layer's K/V (and scale)
        planes."""
        return self.hbm_bytes() // self.n_blocks


class BlockAllocator:
    """Host-side refcounted allocator over the pool's blocks, the
    reference's ``BlockAllocator``: block 0 is never handed out, the
    highest free id goes first, and a block returns to the free list when
    its refcount reaches 0. Thread-safe (an internal lock)."""

    def __init__(self, n_blocks: int) -> None:
        self.n_blocks = int(n_blocks)
        self._lock = threading.Lock()
        self._free: list[int] = list(range(1, self.n_blocks))
        self._refs: list[int] = [0] * self.n_blocks

    @property
    def free_blocks(self) -> list[int]:
        """Free-list view (length == free blocks). Treat as read-only."""
        return self._free

    @property
    def n_free(self) -> int:
        return len(self._free)

    def refcount(self, bid: int) -> int:
        return self._refs[bid]

    def alloc(self) -> Optional[int]:
        """One free block with refcount 1, or None when the pool is dry."""
        with self._lock:
            if not self._free:
                return None
            bid = self._free.pop()
            self._refs[bid] = 1
            return bid

    def incref(self, bid: int) -> int:
        with self._lock:
            if self._refs[bid] <= 0:
                raise ValueError(f"incref of free block {bid}")
            self._refs[bid] += 1
            return self._refs[bid]

    def decref(self, bid: int) -> bool:
        """Drop one reference; True when this freed the block."""
        with self._lock:
            if self._refs[bid] <= 0:
                raise ValueError(f"decref of free block {bid}")
            self._refs[bid] -= 1
            if self._refs[bid] == 0:
                self._free.append(bid)
                return True
            return False


def paged_view(
    block_table: torch.Tensor,
    layer_k: torch.Tensor,
    layer_v: torch.Tensor,
    rows: torch.Tensor,
    layer_ks: Optional[torch.Tensor] = None,
    layer_vs: Optional[torch.Tensor] = None,
) -> tuple:
    """Gather ``rows``' blocks of one layer's pool (``[n_blocks, KV,
    block, hd]``, scales ``[n_blocks, KV, block]``) into contiguous
    per-row caches ``[R, KV, max_len, hd]`` (scales ``[R, KV, max_len]``).
    A copy: the plain path's gather; the kernels read the pool in place."""
    bt = block_table[rows.long()].long()  # [R, max_blocks]
    R, MB = bt.shape
    KV, B, hd = layer_k.shape[1], layer_k.shape[2], layer_k.shape[3]

    def gather(pool: torch.Tensor) -> torch.Tensor:
        g = pool[bt].transpose(1, 2)  # [R, KV, MB, B(, hd)]
        return g.reshape(R, KV, MB * B, *pool.shape[3:])

    k, v = gather(layer_k), gather(layer_v)
    if layer_ks is None:
        return k, v, None, None
    return k, v, gather(layer_ks), gather(layer_vs)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Absmax int8 over the trailing head_dim axis: x [..., hd] → (int8
    [..., hd], f32 scale [...]), scale = absmax / 127 (1 for an all-zero
    row), values rounded half to even and clipped to ±127 — bit for bit
    the reference's ``quantize_kv`` on the same f32 input."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def fake_quantize_kv(x: torch.Tensor) -> torch.Tensor:
    """Quantize then dequantize, in ``x``'s dtype: what an int8 cache will
    give back for ``x``. The decode step attends its fresh K/V through
    this before committing them, so what it attends is what later steps
    read (re-quantizing the result gives the same int8)."""
    q, scale = quantize_kv(x)
    return (q.float() * scale[..., None]).to(x.dtype)
