"""Automatic block-level prefix caching: the host-side radix index — the
port's copy of ``gofr_tpu/serving/radix_cache.py``.

With the paged cache every read and write goes through a per-slot block
table, so a fully-filled prompt block can be shared across requests by
*table aliasing*: zero bytes moved on a hit. This module is the host-side
half of that:

* a radix/trie index keyed by ``(adapter slot, chain of full-block token
  contents)`` mapping each full prompt block ever retired to its physical
  pool block id;
* LRU eviction of *unreferenced* cached blocks (refcount 1: held only by
  the index) when the allocator runs dry or the optional cap is exceeded,
  leaf-first so the chain structure stays reachable;
* purge by adapter slot (``purge_aid``): a LoRA load or unload drops
  the entries prefilled under that slot's previous weights.

Reference discipline: the index owns exactly ONE allocator reference per
node (``ops/kv_cache.py::BlockAllocator``). ``lookup`` increfs every
matched block under the index lock and returns with those references
held; the caller (admission) transfers each to the slot's block table, or
decrefs the blocks it ends up not aliasing. ``insert`` adopts the caller's
reference for every newly created node and leaves it with the caller for
chunks whose node already existed. Eviction and purge drop the index's
own reference, returning refcount-0 blocks to the free list.

Every public method takes the lock (the reference's contract: a purge may
come from another thread). LRU order is a monotonic tick, not wall time.
The index maps token content to physical pool blocks, so it lives and
dies with the engine's cache.
"""

from __future__ import annotations

from typing import Iterator, Optional

from gofr_tpu_torch.analysis import lockcheck
from gofr_tpu_torch.ops.kv_cache import BlockAllocator


class _RadixNode:
    """One cached full block: ``key`` is the block's token content (the
    edge label from its parent), ``block`` the physical pool block id.
    Depth in the trie == block index in the prefix."""

    __slots__ = ("key", "block", "parent", "children", "tick")

    def __init__(
        self,
        key: Optional[tuple[int, ...]],
        block: int,
        parent: Optional["_RadixNode"],
    ) -> None:
        self.key = key
        self.block = block
        self.parent = parent
        self.children: dict[tuple[int, ...], _RadixNode] = {}
        self.tick = 0


class RadixPrefixIndex:
    """Radix index over retired full prompt blocks (see module doc).
    ``evicted`` counts the blocks eviction has returned to the pool (the
    pressure path, the watermark sweep and the ``max_blocks`` cap)."""

    def __init__(
        self,
        block: int,
        allocator: BlockAllocator,
        max_blocks: int = 0,
    ) -> None:
        if block <= 0:
            raise ValueError("radix index needs the paged block size")
        self.block = int(block)
        self.max_blocks = max(0, int(max_blocks))  # 0 = pool-bounded only
        self._alloc = allocator
        self._lock = lockcheck.make_lock("RadixPrefixIndex._lock")
        # One root per adapter slot; roots carry no block (block -1).
        self._roots: dict[int, _RadixNode] = {}
        self._tick = 0
        self._count = 0  # cached nodes == cached blocks
        self.evicted = 0

    # -- introspection ----------------------------------------------------

    @property
    def n_cached_blocks(self) -> int:
        return self._count

    def __len__(self) -> int:
        return self._count

    def cached_block_ids(self) -> list[int]:
        """Every physical block the index currently holds a reference to
        (tests and invariant checks)."""
        with self._lock:
            return [n.block for n in self._iter_nodes()]

    # -- core -------------------------------------------------------------

    def _chunks(self, ids: list[int]) -> Iterator[tuple[int, ...]]:
        B = self.block
        for lo in range(0, (len(ids) // B) * B, B):
            yield tuple(ids[lo: lo + B])

    def _iter_nodes(self) -> Iterator[_RadixNode]:
        stack = [c for r in self._roots.values() for c in r.children.values()]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def lookup(self, ids: list[int], aid: int = 0) -> tuple[list[int], int]:
        """Longest cached full-block prefix of ``ids`` under adapter
        ``aid`` → (physical block ids, matched token count). Refreshes LRU
        order on the walked chain and increfs every returned block while
        holding the index lock. The caller owns one reference per returned
        block: it transfers each to a slot table, or decrefs the ones it
        does not alias."""
        with self._lock:
            node = self._roots.get(aid)
            if node is None:
                return [], 0
            blocks: list[int] = []
            for chunk in self._chunks(ids):
                child = node.children.get(chunk)
                if child is None:
                    break
                self._tick += 1
                child.tick = self._tick
                self._alloc.incref(child.block)
                blocks.append(child.block)
                node = child
            return blocks, len(blocks) * self.block

    def peek(self, ids: list[int], aid: int = 0) -> int:
        """Matched-token count of the longest cached full-block prefix:
        the non-mutating twin of :meth:`lookup` (no increfs, no LRU
        refresh), for the admission queue's prefix-aware tie-break."""
        with self._lock:
            node = self._roots.get(aid)
            if node is None:
                return 0
            matched = 0
            for chunk in self._chunks(ids):
                child = node.children.get(chunk)
                if child is None:
                    break
                matched += self.block
                node = child
            return matched

    def insert(
        self, ids: list[int], blocks: list[int], aid: int = 0
    ) -> list[bool]:
        """Index a retiring request's full prompt blocks: ``blocks[j]``
        holds the K/V of ``ids``' j-th full block. Returns one flag per
        block: True when a new node ADOPTED the caller's allocator
        reference (the caller must not decref it), False when a node for
        that content already existed (the caller keeps, and releases, its
        own reference; the index keeps the incumbent block)."""
        adopted: list[bool] = []
        with self._lock:
            node = self._roots.get(aid)
            if node is None:
                node = self._roots[aid] = _RadixNode(None, -1, None)
            for chunk, bid in zip(self._chunks(ids), blocks):
                child = node.children.get(chunk)
                if child is None:
                    child = _RadixNode(chunk, bid, node)
                    node.children[chunk] = child
                    self._count += 1
                    adopted.append(True)
                else:
                    adopted.append(False)
                self._tick += 1
                child.tick = self._tick
                node = child
            if self.max_blocks and self._count > self.max_blocks:
                self._evict_locked(self._count - self.max_blocks)
        return adopted

    # -- eviction / purge -------------------------------------------------

    def evict(self, n_blocks: int = 1) -> int:
        """Free up to ``n_blocks`` pool blocks by dropping LRU cached
        entries nobody references (the allocator pressure path). Returns
        how many blocks returned to the free list."""
        with self._lock:
            return self._evict_locked(n_blocks)

    def _evict_locked(self, n_blocks: int) -> int:
        """Drop up to ``n_blocks`` least-recently-used evictable entries:
        leaves (evicting an interior node would orphan its subtree) whose
        block only the index references (refcount 1: blocks aliased into
        live slot tables stay). One trie scan collects every evictable
        leaf oldest-first; dropping a chain's leaf can expose its parent,
        so re-scan while the target is unmet and progress is made."""
        freed = 0
        while freed < n_blocks:
            leaves = [
                n for n in self._iter_nodes()
                if not n.children and self._alloc.refcount(n.block) == 1
            ]
            if not leaves:
                break
            leaves.sort(key=lambda n: n.tick)
            for victim in leaves[: n_blocks - freed]:
                parent = victim.parent
                if parent is not None and victim.key is not None:
                    parent.children.pop(victim.key, None)
                self._count -= 1
                self._alloc.decref(victim.block)
                freed += 1
        self.evicted += freed
        return freed

    def purge_aid(self, aid: int) -> int:
        """Drop every entry cached under adapter slot ``aid``. Blocks still
        aliased into live slot tables survive until those slots release;
        the rest free at once. Returns the number of entries dropped."""
        with self._lock:
            root = self._roots.pop(aid, None)
            if root is None:
                return 0
            dropped = 0
            stack = list(root.children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                self._alloc.decref(node.block)
                self._count -= 1
                dropped += 1
            return dropped

    def clear(self) -> int:
        """Drop everything (all adapters). Returns entries dropped."""
        total = 0
        with self._lock:
            aids = list(self._roots)
        for aid in aids:
            total += self.purge_aid(aid)
        return total
