"""Hash-chain prefix index over page-aligned token runs → pool pages.

Physical-AI fleets replay the same system prompt / scene preamble
across sessions; with a block table already indirecting every page,
"the same prefix" can simply BE the same pages.  ``PrefixCache``
indexes every fully-prefilled page by ``(parent page, its token run)``
so admission can alias the longest cached page-aligned prefix into a
new slot's block table and prefill only the tail (the scheduler's CoW
fault keeps shared pages unwritten — see serving/scheduler.py).  A copy
of ``repro.serving.memory.prefix`` (numpy only), held equal in behaviour
to it by ``tests/test_torch_serving_copies.py``.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.memory.allocator import GARBAGE_PAGE, BlockAllocator


@dataclasses.dataclass
class _PrefixNode:
    """One cached page: ``key = (parent page, the page's token run)``."""
    key: Tuple[int, Tuple[int, ...]]
    page: int
    parent: int                      # parent page id; GARBAGE_PAGE = root
    children: set = dataclasses.field(default_factory=set)  # child pages
    last_used: int = 0               # LRU clock stamp


class PrefixCache:
    """Prefix index over the paged pool, one node per cached full page.

    A node's key is ``(parent page id, tuple of the page's tokens)`` —
    exact (dict equality, never a hash collision) and chain-unique: a
    page's KV content is a pure function of the token path from the
    root, so any two sessions whose prompts share a page-aligned prefix
    resolve to the SAME physical pages, whichever session prefilled
    them first.  Only *full* pages are indexed (a partial page is still
    being written and its content is not final).

    The cache holds one allocator reference per registered page, which
    is what keeps a finished session's prefix resident after its slot
    is reclaimed.  A cached page whose only remaining holder is the
    cache is *reclaimable*; under allocation pressure ``reclaim``
    releases such pages leaf-first in LRU order (a parent is never
    evicted while a child chain still hangs off it — the child's
    content is only reachable through the parent's chain).

    ``on_evict`` (optional) is called with ``(token_path, page)`` right
    before an eviction releases the page — while its device content is
    still valid and its parent chain still indexed — which is how the
    host-DRAM tier (memory/tiers.py) spills LRU-evicted prefix pages
    instead of losing them."""

    def __init__(self, allocator: BlockAllocator,
                 on_evict: Optional[Callable[[Tuple[int, ...], int],
                                             None]] = None):
        self._allocator = allocator
        self._nodes: Dict[Tuple[int, Tuple[int, ...]], _PrefixNode] = {}
        self._by_page: Dict[int, _PrefixNode] = {}
        self._clock = 0
        self.on_evict = on_evict

    def __len__(self) -> int:
        return len(self._nodes)

    def pages(self) -> List[int]:
        """Physical page ids currently registered (sorted)."""
        return sorted(self._by_page)

    def _now(self) -> int:
        self._clock += 1
        return self._clock

    @staticmethod
    def _run(tokens: np.ndarray, blk: int, page_size: int
             ) -> Tuple[int, ...]:
        return tuple(int(t)
                     for t in tokens[blk * page_size:(blk + 1) * page_size])

    def match(self, tokens: np.ndarray, page_size: int) -> List[int]:
        """Pages backing the longest cached page-aligned prefix of
        ``tokens``, root-first (empty when the first page misses).
        Walked nodes get their LRU stamp refreshed."""
        now = self._now()
        pages: List[int] = []
        parent = GARBAGE_PAGE
        for blk in range(len(tokens) // page_size):
            node = self._nodes.get((parent, self._run(tokens, blk,
                                                      page_size)))
            if node is None:
                break
            node.last_used = now
            pages.append(node.page)
            parent = node.page
        return pages

    def register(self, tokens: np.ndarray, page_size: int,
                 pages: Sequence[int], n_blocks: int) -> None:
        """Index the first ``n_blocks`` (full) pages of a session's
        prefilled run.  Each newly registered page gains a cache
        reference; blocks whose content is already cached (the session
        matched them, or another session prefilled identical content
        concurrently) keep the incumbent page — the walk continues down
        the INDEX's chain, so a mixed-ownership chain stays coherent."""
        now = self._now()
        parent = GARBAGE_PAGE
        for blk in range(n_blocks):
            key = (parent, self._run(tokens, blk, page_size))
            node = self._nodes.get(key)
            if node is None:
                page = pages[blk]
                if page in self._by_page:     # already indexed elsewhere
                    break
                node = _PrefixNode(key, page, parent, last_used=now)
                self._nodes[key] = node
                self._by_page[page] = node
                if parent != GARBAGE_PAGE:
                    self._by_page[parent].children.add(page)
                self._allocator.retain([page])
            node.last_used = now
            parent = node.page

    def reclaimable(self, exclude: Sequence[int] = ()) -> int:
        """Pages a full cascade of leaf-first evictions could free right
        now — cached pages held only by the cache whose entire subtree
        is likewise unreferenced.  ``exclude`` pages (about to be
        retained by an admission in flight) count as pinned.  Iterative
        post-order with memoisation: O(nodes) per call, no recursion
        depth to hit on deep chains."""
        ex = set(exclude)
        memo: Dict[int, bool] = {}
        for root in self._by_page:
            if root in memo:
                continue
            stack = [(root, False)]
            while stack:
                page, visited = stack.pop()
                if page in memo:
                    continue
                node = self._by_page[page]
                if visited:
                    memo[page] = (page not in ex
                                  and self._allocator.refcount(page) == 1
                                  and all(memo[c] for c in node.children))
                else:
                    stack.append((page, True))
                    stack.extend((c, False) for c in node.children
                                 if c not in memo)
        return sum(memo.values())

    def _token_path(self, node: _PrefixNode) -> Tuple[int, ...]:
        """Full token path root→``node`` (the exact content key of the
        page's KV).  Evictions are leaf-first, so every parent on the
        chain is still indexed while its leaf is being evicted."""
        runs = []
        while True:
            runs.append(node.key[1])
            if node.parent == GARBAGE_PAGE:
                break
            node = self._by_page[node.parent]
        return tuple(t for run in reversed(runs) for t in run)

    def _evict(self, node: _PrefixNode) -> None:
        if self.on_evict is not None:
            self.on_evict(self._token_path(node), node.page)
        del self._nodes[node.key]
        del self._by_page[node.page]
        if node.parent != GARBAGE_PAGE and node.parent in self._by_page:
            self._by_page[node.parent].children.discard(node.page)
        self._allocator.release([node.page])

    def reclaim(self, n: int) -> int:
        """Release up to ``n`` unreferenced cached pages back to the
        free list, LRU leaves first (evicting a leaf may expose its
        parent as the next candidate).  A heap of candidate leaves keeps
        this O((cache + n) log cache) — this runs inside the mandatory
        allocation path, so a per-eviction rescan (quadratic on deep
        chains, the same class of bug the allocator's free-set fixed)
        is not acceptable.  Returns the pages actually freed."""
        freed = 0
        heap = [(nd.last_used, nd.page) for nd in self._by_page.values()
                if not nd.children
                and self._allocator.refcount(nd.page) == 1]
        heapq.heapify(heap)
        while freed < n and heap:
            stamp, page = heapq.heappop(heap)
            nd = self._by_page.get(page)
            if nd is None or nd.children or nd.last_used != stamp \
                    or self._allocator.refcount(page) != 1:
                continue        # stale candidate
            parent = nd.parent
            self._evict(nd)
            freed += 1
            if parent != GARBAGE_PAGE:
                pn = self._by_page.get(parent)
                if pn is not None and not pn.children \
                        and self._allocator.refcount(parent) == 1:
                    heapq.heappush(heap, (pn.last_used, parent))
        return freed

    def flush(self) -> int:
        """Drop every unreferenced cached page (end-of-run accounting;
        pages still shared by live sessions stay)."""
        return self.reclaim(len(self._by_page))

    def check(self) -> List[str]:
        """Self-audit: every cached page must hold an allocator
        reference and the node/parent/child linkage must be coherent.
        Returns issue strings (empty = clean); pure reads."""
        issues = []
        if len(self._nodes) != len(self._by_page):
            issues.append("prefix node / by-page index size mismatch")
        for page, node in self._by_page.items():
            if self._allocator.refcount(page) < 1:
                issues.append(f"cached page {page} holds no allocator ref")
            if node.page != page:
                issues.append(f"cached page {page}: node page desync")
            if self._nodes.get(node.key) is not node:
                issues.append(f"cached page {page}: key index desync")
            if node.parent != GARBAGE_PAGE:
                pn = self._by_page.get(node.parent)
                if pn is None:
                    issues.append(f"cached page {page}: parent "
                                  f"{node.parent} not indexed")
                elif page not in pn.children:
                    issues.append(f"cached page {page}: missing from "
                                  f"parent {node.parent}'s children")
            for c in node.children:
                if c not in self._by_page:
                    issues.append(f"cached page {page}: dangling child {c}")
        return issues
