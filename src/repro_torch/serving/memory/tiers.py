"""The device page store: the narrow seam the scheduler programs against.

Port of ``PageStore`` from ``repro.serving.memory.tiers``, the
single-tier store: it owns the ``BlockAllocator``, the optional
``PrefixCache``, and the host-authoritative block-table / position
mirrors.  Eviction and preemption destroy KV (sessions re-prefill on
resume).  The host-DRAM tier (``TieredPageStore``, ``HostPagePool``,
the blob movers and the placement policies) waits for the host-tier
slice.

``sync`` copies the mirrors into the cache's existing device tensors
rather than binding new ones: a captured CUDA graph of the decode step
reads the block table and positions at fixed addresses.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serving.memory.allocator import GARBAGE_PAGE, BlockAllocator
from repro_torch.serving.memory.prefix import PrefixCache


class PageStore:
    """Single-tier page store: allocation (with prefix-cache pressure
    relief), prefix match/register, and the block-table / position
    mirrors whose dirty flags gate the host-to-device copy (``sync``)."""

    def __init__(self, *, n_slots: int, max_blocks: int, page_size: int,
                 n_pages: int, prefix_cache: bool = False):
        self.page_size = page_size
        self.n_pages = n_pages
        self.allocator = BlockAllocator(n_pages)
        self.prefix = PrefixCache(self.allocator) if prefix_cache else None
        self._bt = np.zeros((n_slots, max_blocks), np.int32)
        self._bt_dirty = True
        self._pos = np.zeros((n_slots,), np.int32)
        self._pos_dirty = True

    # ------------------------------------------------------- capacity
    @property
    def free_pages(self) -> int:
        return self.allocator.n_free

    @property
    def cached_pages(self) -> Optional[int]:
        return len(self.prefix) if self.prefix is not None else None

    # ----------------------------------------------------- allocation
    def alloc(self, n: int) -> Optional[List[int]]:
        """``allocator.alloc`` with prefix-cache pressure relief: when
        the free list is short, unreferenced cached prefix pages are
        reclaimed LRU-first to cover the shortfall.  Cached pages are a
        soft reserve — they never deny a MANDATORY allocation the bare
        pool could have served."""
        got = self.allocator.alloc(n)
        if got is None and self.prefix is not None:
            self.prefix.reclaim(n - self.allocator.n_free)
            got = self.allocator.alloc(n)
        return got

    def alloc_free(self, n: int) -> Optional[List[int]]:
        """Free-list-only allocation (optional horizon lookahead):
        speculative pages never drain the prefix cache."""
        return self.allocator.alloc(n)

    def can_cover(self, need: int, exclude: Sequence[int] = ()) -> bool:
        """Could ``need`` pages be obtained without preempting anyone —
        free list first, cache reclaim cascade as the fallback
        (``exclude``: matched pages an admission in flight is about to
        retain, which must count as pinned)?"""
        if self.allocator.n_free >= need:
            return True
        if self.prefix is None:
            return False
        return (self.allocator.n_free
                + self.prefix.reclaimable(exclude)) >= need

    def retain(self, pages: Sequence[int]) -> None:
        self.allocator.retain(pages)

    def release(self, pages: Sequence[int]) -> None:
        self.allocator.release(pages)

    # --------------------------------------------------------- prefix
    def match(self, seq: np.ndarray) -> List[int]:
        if self.prefix is None:
            return []
        return self.prefix.match(seq, self.page_size)

    def register(self, seq: np.ndarray, pages: Sequence[int],
                 n_blocks: int) -> None:
        if self.prefix is not None and n_blocks:
            self.prefix.register(seq, self.page_size, pages, n_blocks)

    def flush_prefix(self) -> int:
        return self.prefix.flush() if self.prefix is not None else 0

    # ---------------------------------------------------- block table
    def map_pages(self, slot: int, start_blk: int,
                  pages: Sequence[int]) -> None:
        self._bt[slot, start_blk:start_blk + len(pages)] = pages
        self._bt_dirty = True

    def set_pos(self, slot: int, pos: int) -> None:
        self._pos[slot] = pos
        self._pos_dirty = True

    def mirror_pos(self, slot: int, pos: int) -> None:
        """Update the host pos mirror WITHOUT dirtying: the device
        already holds this value (its decode step advanced it), so no
        upload is owed — only host-side resets dirty the vector."""
        self._pos[slot] = pos

    def clear_slot(self, slot: int) -> None:
        self._bt[slot, :] = GARBAGE_PAGE
        self._bt_dirty = True
        self._pos[slot] = 0
        self._pos_dirty = True

    def sync(self, cache, pos_always: bool = True) -> None:
        """Copy the host-authoritative block table and positions into the
        cache's device tensors, in place.  The block table is copied only
        when admission, eviction or allocation dirtied it;
        ``pos_always`` re-copies positions every tick (the K=1 path,
        whose step advances every lane's device position), while the
        horizon-K path passes False (its steps freeze inactive lanes, so
        only host-side resets need a copy)."""
        if self._bt_dirty:
            cache["block_table"].copy_(torch.from_numpy(self._bt))
            self._bt_dirty = False
        if pos_always or self._pos_dirty:
            cache["pos"].copy_(torch.from_numpy(self._pos))
            self._pos_dirty = False
