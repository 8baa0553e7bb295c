"""Refcounted page allocation over the paged KV pool.

The device pool (``Model.init_cache(paged=True)``) is a flat array of
fixed-size KV pages; which physical page backs a slot's block is pure
data (the block table).  This module owns the host-side accounting of
that pool: a LIFO free list with per-page reference counts, so pages
can be *shared* (prefix sharing aliases one physical page into many
block tables) and only return to the free list when the last holder is
gone.  A copy of ``repro.serving.memory.allocator`` (numpy-free host
code), held equal in behaviour to it by
``tests/test_torch_serving_copies.py``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

GARBAGE_PAGE = 0   # reserved pool page free/mid-prefill lanes point at


class BlockAllocator:
    """Refcounted LIFO free-list over a fixed pool of KV pages.

    Page ``GARBAGE_PAGE`` (0) is reserved as the write sink for lanes
    that have no real page under their current position (free slots,
    blocks beyond a session's allocation) and is never handed out.

    ``alloc`` hands pages out with refcount 1; prefix sharing adds
    holders (``retain``) when another slot's block table — or the prefix
    cache — points at the same physical page, and ``release`` drops one
    holder, returning the page to the free list only when the last
    holder is gone.  The free list is mirrored by a set, so double-free
    detection is O(1) per page instead of an O(free-list) membership
    scan (a long session releasing hundreds of pages used to make
    reclaim quadratic on big pools)."""

    def __init__(self, n_pages: int):
        assert n_pages >= 2, "need the garbage page plus >= 1 real page"
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._free_set = set(self._free)
        self._refs = [0] * n_pages

    @property
    def n_free(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages (refcount 1 each), or None (and no change) if
        under-supplied."""
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for p in got:
            self._free_set.discard(p)
            self._refs[p] = 1
        return got

    def retain(self, pages: Sequence[int]) -> None:
        """Add one holder to each (already allocated) page."""
        for p in pages:
            assert 0 < p < self.n_pages, f"bad page id {p}"
            assert self._refs[p] > 0, f"retain of unallocated page {p}"
            self._refs[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one holder per page; the last release frees the page."""
        for p in pages:
            assert 0 < p < self.n_pages, f"bad page id {p}"
            assert p not in self._free_set and self._refs[p] > 0, \
                f"double free of page {p}"
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                self._free_set.add(p)

    def check(self) -> List[str]:
        """Self-audit: free list ↔ free set ↔ refcount consistency.
        Returns human-readable issue strings (empty = clean).  Pure
        reads — never mutates, safe to run mid-serving."""
        issues = []
        if len(self._free) != len(set(self._free)):
            issues.append("free list holds duplicate pages")
        if set(self._free) != self._free_set:
            issues.append("free list and free set disagree")
        if GARBAGE_PAGE in self._free_set:
            issues.append("garbage page on the free list")
        for p in range(1, self.n_pages):
            r = self._refs[p]
            if r < 0:
                issues.append(f"page {p}: negative refcount {r}")
            elif p in self._free_set and r != 0:
                issues.append(f"page {p}: free with refcount {r}")
            elif p not in self._free_set and r == 0:
                issues.append(f"page {p}: refcount 0 but not free")
        return issues
