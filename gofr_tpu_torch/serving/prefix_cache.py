"""Prefix-KV reuse on the slot cache — the port's copy of
``gofr_tpu/serving/prefix_cache.py``.

Shared prompt prefixes (system prompts, few-shot preambles) are prefilled
once and their K/V rows parked in a device pool; a later request whose
prompt starts with a registered prefix has the pool rows copied into its
slot at admission and chunk-prefills only the remainder.

The pool is ``[L, n_entries, KV, max_len, hd]`` in the slot cache's dtype
(and, in int8 mode, the ``[L, n_entries, KV, max_len]`` scale planes).
Both copies move the first ``_COPY_BUCKET``-multiple positions covering
the prefix, as the reference's bucketed slices do: positions past the
prefix are never attended before the remainder's prefill writes them. The
copies are in-place tensor copies on the caller's stream, so they run in
order with the prefill and decode programs around them and add no host
wait.

The registry, ``(adapter slot, token tuple) → pool row``, is LRU over
registered prefixes and guarded by a lock (the reference's contract: a
purge may come from another thread). A request reuses only a prefix
registered under its own LoRA adapter, and a load or unload of that
adapter purges its entries (``purge_aid``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import torch

from gofr_tpu_torch.analysis import lockcheck
from gofr_tpu_torch.ops.kv_cache import KVCache

_COPY_BUCKET = 256  # positions a copy covers, in multiples of this

#: Registry key: (adapter slot id, the prefix's token ids).
_PrefixKey = tuple[int, tuple[int, ...]]


class PrefixPool:
    """Device pool of prefilled K/V prefixes and its host registry."""

    def __init__(self, n_entries: int, cache: KVCache) -> None:
        self.n_entries = int(n_entries)
        self.max_len = cache.max_len
        self._lock = lockcheck.make_lock("PrefixPool._lock")
        self._registry: "OrderedDict[_PrefixKey, int]" = OrderedDict()

        def like(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
            if t is None:
                return None
            return torch.zeros((t.shape[0], self.n_entries) + tuple(t.shape[2:]),
                               dtype=t.dtype, device=t.device)

        self._pool = tuple(like(t) for t in (cache.k, cache.v, cache.k_s, cache.v_s))

    def __len__(self) -> int:
        with self._lock:
            return len(self._registry)

    def _bucket(self, plen: int) -> int:
        return min(-(-plen // _COPY_BUCKET) * _COPY_BUCKET, self.max_len)

    def hbm_bytes(self) -> int:
        """Device bytes of the pool's K/V (and scale) planes."""
        return sum(t.numel() * t.element_size() for t in self._pool if t is not None)

    def lookup(self, ids: Sequence[int], aid: int = 0) -> tuple[int, int]:
        """Longest prefix of ``ids`` registered under adapter ``aid`` →
        (pool row, prefix length); (-1, 0) on a miss. A hit refreshes LRU
        order."""
        best: Optional[tuple[int, ...]] = None
        ids = tuple(ids)
        with self._lock:
            for p_aid, prefix in self._registry:
                if p_aid != aid:
                    continue
                if len(prefix) <= len(ids) and ids[: len(prefix)] == prefix:
                    if best is None or len(prefix) > len(best):
                        best = prefix
            if best is None:
                return -1, 0
            self._registry.move_to_end((aid, best))
            return self._registry[(aid, best)], len(best)

    def store(self, ids: Sequence[int], cache: KVCache, slot: int, aid: int = 0) -> int:
        """Copy a just-prefilled slot's prefix rows into the pool; returns
        the pool row (a registered prefix keeps its row, a new one takes
        the smallest free row or the LRU entry's)."""
        key: _PrefixKey = (aid, tuple(ids))
        with self._lock:
            if key in self._registry:
                idx = self._registry[key]
            elif len(self._registry) < self.n_entries:
                used = set(self._registry.values())
                idx = next(i for i in range(self.n_entries) if i not in used)
            else:  # LRU eviction
                _, idx = self._registry.popitem(last=False)
            n = self._bucket(len(key[1]))
            for pool, src in zip(self._pool, (cache.k, cache.v, cache.k_s, cache.v_s)):
                if pool is not None:
                    pool[:, idx, :, :n].copy_(src[:, slot, :, :n])
            self._registry[key] = idx
            self._registry.move_to_end(key)
            return idx

    def purge_aid(self, aid: int) -> int:
        """Drop every prefix registered under adapter ``aid``; their device
        rows stay, unreferenced. Returns the count."""
        with self._lock:
            stale = [k for k in self._registry if k[0] == aid]
            for k in stale:
                del self._registry[k]
            return len(stale)

    def load(self, cache: KVCache, idx: int, slot: int, plen: int) -> None:
        """Copy pool row ``idx``'s prefix into ``slot`` of ``cache`` (the
        bucket covering ``plen`` positions), in place."""
        n = self._bucket(plen)
        for pool, dst in zip(self._pool, (cache.k, cache.v, cache.k_s, cache.v_s)):
            if pool is not None:
                dst[:, slot, :, :n].copy_(pool[:, idx, :, :n])
