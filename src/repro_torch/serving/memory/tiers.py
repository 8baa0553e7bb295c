"""Page tiers: the device pool's store and the host-DRAM spill tier.

Port of ``repro.serving.memory.tiers``.  The paper's serving-side finding
is that for batch-1 physical-AI fleets *capacity*, not bandwidth, caps
concurrent sessions — the regime a host-memory tier targets.  Two stores
implement one narrow interface the scheduler programs against:

  * ``PageStore`` — the single-tier baseline.  Owns the
    ``BlockAllocator``, the optional ``PrefixCache``, and the
    host-authoritative block-table / position mirrors; eviction and
    preemption destroy KV (sessions re-prefill on resume).
  * ``TieredPageStore`` — adds a fixed-capacity ``HostPagePool``.
    Preemption *parks*: a session's full KV pages are copied
    device→host (``Model.save_kv_pages``) before its device pages are
    released, and copied back (``Model.restore_kv_pages``) on
    re-admission — the tail past the parked blocks re-prefills as usual,
    so streams are greedy token-identical to the re-prefill baseline.
    LRU-evicted prefix pages spill into a host prefix index (keyed by
    the exact token path) instead of dying, and admissions can restore a
    matching continuation.  What spills and when is a ``TierPolicy``
    (memory/policy.py); every migrated page is charged to the virtual
    clock through ``charge_cb``.

Restored bytes are the very bytes prefill/decode originally wrote, so
restore == re-prefill == no-preemption for greedy streams by
construction.

Where the port differs from the reference, and why:

  * A blob is a tuple of CPU tensors, one per page-indexed slab (bf16 has
    no numpy dtype).  ``blob_checksum`` runs CRC32 over each component's
    bytes in the reference's order, so equal bytes give equal checksums.
  * ``HostPagePool`` keeps its blobs in rows of per-slab tensors
    allocated once, page-locked when the pool copies to and from a card
    (``pin_memory``).  A save copies the device gather straight into the
    rows the pool's next puts will take (``staging``), so a put adopts
    its row without a copy and no blob is pinned on its own.
  * No power-of-two padding: torch compiles no program per run length,
    so each save and restore moves exactly the pages asked for.  Page
    counts never included the reference's pad pages (they are sliced
    off), so every counter is the same.
  * ``restore_kv_blobs`` writes the pools in place: a captured decode
    graph reads them at fixed addresses.

Ordering on the card (one stream): a save's device-to-host copies have
completed when ``save_kv_blobs`` returns (it waits on an event), so the
put-time checksum reads final bytes; a restore's host-to-device copies
and any later save into the same rows are ordered by the stream; a host
write into a row (a blob copied in by ``put``, ``replace``) first waits
for the device, so no in-flight restore still reads it.

``sync`` copies the mirrors into the cache's existing device tensors
rather than binding new ones, for the same fixed-address reason.
"""
from __future__ import annotations

import collections
import heapq
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dispatch import pinned_copy
from repro_torch.serving.memory.allocator import GARBAGE_PAGE, BlockAllocator
from repro_torch.serving.memory.prefix import PrefixCache

# One page's host-side slabs in Model.save_kv_pages order: (k, v) for
# bf16 pools, (k, v, k_scale, v_scale) for int8-quantised ones — the
# tier is slab-structure-agnostic, codes and scales park together.
Blob = Tuple[torch.Tensor, ...]


class TierCopyError(RuntimeError):
    """A host-tier page copy failed past its retry budget, or a parked
    blob failed verify-on-restore.  The store's state is left so the
    caller can degrade cleanly: on restore failure the parked entry and
    its handles survive (``drop_parked`` releases them) and NO device
    pages or refcounts were consumed by this call."""


def _bytes_of(t: torch.Tensor) -> np.ndarray:
    """A uint8 numpy view of a CPU tensor's bytes, in C order."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def blob_checksum(blob: Blob) -> int:
    """CRC32 chained over a blob's slab components — cheap enough to
    run on every park and verify on every restore."""
    c = 0
    for comp in blob:
        c = zlib.crc32(_bytes_of(comp), c)
    return c


def _follows(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``b`` is a contiguous row starting where contiguous ``a`` ends,
    in the same storage."""
    return (a.is_contiguous() and b.is_contiguous() and a.shape == b.shape
            and a.dtype == b.dtype
            and a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
            and b.data_ptr() == a.data_ptr() + a.numel() * a.element_size())


def _run(rows: Sequence[torch.Tensor], i: int, j: int) -> torch.Tensor:
    """Rows ``i..j-1`` (adjacent in memory) as one (j - i, ...) view."""
    r = rows[i]
    if j == i + 1:
        return r
    return r.as_strided((j - i,) + tuple(r.shape),
                        (r.numel(),) + tuple(r.stride()))


def _copy_rows(dst: Sequence[torch.Tensor],
               src: Sequence[torch.Tensor]) -> None:
    """``dst[i].copy_(src[i])`` for every i, asynchronously where the
    memory allows, one copy per run of rows adjacent on both sides."""
    i = 0
    while i < len(dst):
        j = i + 1
        while j < len(dst) and _follows(dst[j - 1], dst[j]) \
                and _follows(src[j - 1], src[j]):
            j += 1
        _run(dst, i, j).copy_(_run(src, i, j), non_blocking=True)
        i = j


def save_kv_blobs(save_fn, cache, pages: Sequence[int],
                  pool: Optional["HostPagePool"] = None) -> List[Blob]:
    """Batched device→host copy of ``pages``.  ``save_fn`` gathers them
    on the device (``Model.save_kv_pages``: (L, P, ...) slabs, page-major
    in memory); each page's rows land in the rows ``pool``'s next puts
    will take when it has them free, else in new CPU tensors
    (page-locked when the source is on a card).  The copies have
    completed when this returns."""
    n = len(pages)
    if n == 0:
        return []
    ids = torch.as_tensor(list(pages), dtype=torch.long)
    slabs = [s.transpose(0, 1).contiguous() for s in save_fn(cache, ids)]
    like = tuple(s[0] for s in slabs)
    dest = pool.staging(n, like) if pool is not None else None
    if dest is None:
        fresh = [torch.empty(s.shape, dtype=s.dtype, pin_memory=s.is_cuda)
                 for s in slabs]
        dest = [tuple(f[i] for f in fresh) for i in range(n)]
    for c, s in enumerate(slabs):
        _copy_rows([d[c] for d in dest], s.unbind(0))
    if slabs[0].is_cuda:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return dest


def restore_kv_blobs(restore_fn, cache, pages: Sequence[int],
                     blobs: Sequence[Blob]):
    """Batched host→device copy of ``blobs`` into pool ``pages``: one
    device staging tensor per slab, filled by asynchronous copies from
    the blobs' rows, then ``restore_fn`` (``Model.restore_kv_pages``)
    writes it into the pools in place.  Returns the same cache."""
    n = len(pages)
    if n != len(blobs):
        raise ValueError(f"{n} pages but {len(blobs)} blobs")
    if n == 0:
        return cache
    device = cache["k"].device
    staging = [torch.empty((n,) + tuple(comp.shape), dtype=comp.dtype,
                           device=device) for comp in blobs[0]]
    for c, st in enumerate(staging):
        _copy_rows(st.unbind(0), [b[c] for b in blobs])
    ids = torch.as_tensor(list(pages), dtype=torch.long)
    return restore_fn(cache, ids, *(st.transpose(0, 1) for st in staging))


class PageStore:
    """Single-tier page store: the narrow seam the scheduler programs
    against — allocation (with prefix-cache pressure relief), prefix
    match/register, and the block-table / position mirrors whose dirty
    flags gate the host-to-device copy (``sync``).  Tier hooks are
    no-ops here; ``TieredPageStore`` overrides them."""

    kv_tier = "none"
    policy = None
    # tier counters (class-level zeros on the single-tier store)
    pages_spilled = 0
    pages_restored = 0
    tier_restores = 0
    host_prefix_hits = 0
    park_fails = 0
    save_retries = 0
    restore_retries = 0
    corrupt_blobs = 0

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
    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

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

    # torchcheck: hotpath
    def sync(self, cache, pos_always: bool = True) -> None:
        """Copy the host-authoritative block table and positions into the
        cache's device tensors, in place.  The block table is copied only
        when admission, eviction or allocation dirtied it;
        ``pos_always`` re-copies positions every tick (the K=1 path,
        whose step advances every lane's device position), while the
        horizon-K path passes False (its steps freeze inactive lanes, so
        only host-side resets need a copy).  On the card both copies go
        from page-locked buffers without blocking (``pinned_copy``): the
        decode tick makes one sync, its read of the sampled tokens."""
        if self._bt_dirty:
            bt = cache["block_table"]
            bt.copy_(pinned_copy(self._bt, bt.device), non_blocking=True)
            self._bt_dirty = False
        if pos_always or self._pos_dirty:
            pos = cache["pos"]
            pos.copy_(pinned_copy(self._pos, pos.device), non_blocking=True)
            self._pos_dirty = False

    # ------------------------------------------------------ self-audit
    def check(self, live_pages: Sequence[int] = ()) -> List[str]:
        """Consistency audit of the page accounting: allocator free
        list/set/refcounts, prefix-cache linkage, and (optionally) the
        resident sessions' ``live_pages``, which must all be held.
        Returns human-readable issue strings — empty means clean.  Pure
        host reads: safe to run on idle ticks."""
        issues = self.allocator.check()
        if self.prefix is not None:
            issues += self.prefix.check()
        for p in live_pages:
            if not 0 < p < self.n_pages:
                issues.append(f"block table maps bad page id {p}")
            elif self.allocator.refcount(p) <= 0:
                issues.append(f"mapped page {p} has no holder")
        return issues

    # ---------------------------------------------- tier hooks (no-op)
    def park(self, sid: str, n_full: int, pages: Sequence[int],
             cache) -> Optional[int]:
        """Single tier: nothing to park into — preemption re-prefills."""
        return None

    def parked_blocks(self, sid: str) -> int:
        return 0

    def take_parked(self, sid: str, skip: int, pages: Sequence[int],
                    cache):
        raise NotImplementedError("single-tier store parks nothing")

    def drop_parked(self, sid: str) -> None:
        pass

    def drop_shadows(self, sid: str) -> None:
        pass

    def host_match(self, seq: np.ndarray, from_blk: int,
                   max_blocks: int) -> List[Tuple[int, ...]]:
        return []

    def restore_host_prefix(self, paths, pages, cache):
        raise NotImplementedError("single-tier store has no host index")

    def flush_host(self) -> int:
        return 0

    @property
    def host_used(self) -> int:
        return 0


class HostPagePool:
    """Fixed-capacity pool of spilled KV page blobs in host DRAM.

    Handles are opaque ints; *pinned* blobs (parked sessions and shadow
    pre-spills — KV a waiting session will need back) are never
    evicted, unpinned blobs (the host prefix index) are LRU-evicted to
    make room.  ``on_drop`` tells the owner an unpinned handle was
    evicted so its index entry can be forgotten.

    Storage: one (capacity, ...) tensor per blob component, allocated
    once — by ``allocate`` or else at the first put or staging request —
    and page-locked with ``pin_memory``; a handle owns one row, and free
    rows are handed out lowest first.
    ``get`` and ``pop`` return views of the handle's row: after ``pop``
    the row is free, so read it before the next put."""

    def __init__(self, capacity: int, pin_memory: bool = False):
        if capacity < 1:
            raise ValueError("a host tier needs at least one page")
        self.capacity = capacity
        self.pin_memory = pin_memory
        self._slabs: Optional[Tuple[torch.Tensor, ...]] = None
        self._rows: Dict[int, int] = {}            # handle -> row
        self._free_rows: List[int] = list(range(capacity))   # a heap
        self._pinned: set = set()
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._next = 0
        self.spilled = 0                 # total puts
        self.dropped = 0                 # LRU evictions of unpinned blobs
        self.on_drop: Optional[Callable[[int], None]] = None

    @property
    def used(self) -> int:
        return len(self._rows)

    @property
    def free(self) -> int:
        return self.capacity - len(self._rows)

    def _row_views(self, row: int) -> Blob:
        return tuple(s[row] for s in self._slabs)

    def allocate(self, like: Blob) -> None:
        """Allocate the rows for blobs laid out as ``like`` (once: the
        scheduler calls it at construction, so no park pays for it);
        refuse a blob of another layout."""
        if self._slabs is None:
            self._slabs = tuple(
                torch.empty((self.capacity,) + tuple(c.shape), dtype=c.dtype,
                            pin_memory=self.pin_memory) for c in like)
        if len(like) != len(self._slabs) or any(
                tuple(c.shape) != tuple(s.shape[1:]) or c.dtype != s.dtype
                for c, s in zip(like, self._slabs)):
            raise ValueError("blob layout differs from the pool's rows")

    def _host_write(self, row: int, blob: Blob) -> None:
        """Copy ``blob`` into ``row`` on the host, after the device has
        finished any copy that still reads the row."""
        self.allocate(blob)
        if self.pin_memory:
            torch.cuda.synchronize()
        for dst, src in zip(self._row_views(row), blob):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)

    def reserve(self, n: int) -> bool:
        """Make room for ``n`` blobs by LRU-dropping unpinned entries;
        False (and no change beyond the drops) when pinned blobs alone
        leave the pool too full."""
        while self.free < n and self._lru:
            h, _ = self._lru.popitem(last=False)
            heapq.heappush(self._free_rows, self._rows.pop(h))
            self.dropped += 1
            if self.on_drop is not None:
                self.on_drop(h)
        return self.free >= n

    def staging(self, n: int, like: Blob) -> Optional[List[Blob]]:
        """Views of the rows the next ``n`` puts will take, for a save to
        copy into (those puts then adopt them without a copy), or None
        when fewer than ``n`` rows are free."""
        self.allocate(like)
        if len(self._free_rows) < n:
            return None
        return [self._row_views(r) for r in heapq.nsmallest(n, self._free_rows)]

    def put(self, blob: Blob, pinned: bool) -> Optional[int]:
        if not self.reserve(1):
            return None
        self.allocate(blob)
        row = heapq.heappop(self._free_rows)
        if any(d.data_ptr() != b.data_ptr()
               for d, b in zip(self._row_views(row), blob)):
            self._host_write(row, blob)  # not staged in this row
        h = self._next
        self._next += 1
        self._rows[h] = row
        if pinned:
            self._pinned.add(h)
        else:
            self._lru[h] = None
        self.spilled += 1
        return h

    def touch(self, handle: int) -> None:
        if handle in self._lru:
            self._lru.move_to_end(handle)

    def get(self, handle: int) -> Blob:
        return self._row_views(self._rows[handle])

    def pop(self, handle: int) -> Blob:
        row = self._rows.pop(handle)
        self._pinned.discard(handle)
        self._lru.pop(handle, None)
        heapq.heappush(self._free_rows, row)
        return self._row_views(row)

    def replace(self, handle: int, blob: Blob) -> None:
        """Swap a resident blob's bytes in place (pin/LRU state keeps):
        the fault injector's corruption hook."""
        if handle not in self._rows:
            raise KeyError(f"unknown handle {handle}")
        self._host_write(self._rows[handle], blob)


class TieredPageStore(PageStore):
    """Device pool + host-DRAM spill tier behind the ``PageStore``
    seam.  See the module docstring for the migration contract.
    ``pin_memory`` page-locks the host pool's rows (the scheduler sets it
    for a model on a card)."""

    kv_tier = "host"

    def __init__(self, *, host_pages: int, policy, save_fn, restore_fn,
                 get_cache, charge_cb=None, retry_budget: int = 2,
                 retry_cb=None, verify_checksums: bool = True,
                 pin_memory: bool = False, **kw):
        super().__init__(**kw)
        if retry_budget < 0:
            raise ValueError(f"retry_budget {retry_budget} < 0")
        self.policy = policy
        self.host = HostPagePool(host_pages, pin_memory=pin_memory)
        self.host.on_drop = self._forget_handle
        self._save = save_fn             # (cache, pages) -> [Blob]
        self._restore = restore_fn       # (cache, pages, blobs) -> cache
        self._get_cache = get_cache      # live cache for the evict hook
        self._charge = charge_cb or (lambda n_pages: None)
        self.retry_budget = retry_budget
        self._retry = retry_cb or (lambda attempt: None)
        self.verify_checksums = verify_checksums
        self._parked: Dict[str, List[Optional[int]]] = {}  # sid -> handles
        self._shadow: Dict[Tuple[str, int], int] = {}      # (sid, blk) -> h
        self._shadow_sids: Dict[str, set] = {}
        self._hpath: Dict[Tuple[int, ...], int] = {}       # token path -> h
        self._by_handle: Dict[int, Tuple[int, ...]] = {}
        self._crc: Dict[int, int] = {}   # handle -> put-time checksum
        # instance counters shadow the class-level zeros
        self.pages_spilled = 0
        self.pages_restored = 0
        self.tier_restores = 0
        self.host_prefix_hits = 0
        self.park_fails = 0
        self.save_retries = 0
        self.restore_retries = 0
        self.corrupt_blobs = 0
        if policy.spill_prefix and self.prefix is not None:
            self.prefix.on_evict = self._spill_evicted_prefix

    # ------------------------------------------- guarded page movers
    def _save_guarded(self, cache, pages: Sequence[int]) -> List[Blob]:
        """``save_fn`` under the bounded retry budget; each retry is
        charged to the virtual clock via ``retry_cb(attempt)``."""
        last = None
        for attempt in range(self.retry_budget + 1):
            if attempt:
                self.save_retries += 1
                self._retry(attempt)
            try:
                return self._save(cache, pages)
            except Exception as e:           # noqa: BLE001 — transport
                last = e                     # faults are type-agnostic
        raise TierCopyError(
            f"save of {len(pages)} page(s) failed after "
            f"{self.retry_budget + 1} attempts") from last

    def _restore_guarded(self, cache, pages, blobs):
        last = None
        for attempt in range(self.retry_budget + 1):
            if attempt:
                self.restore_retries += 1
                self._retry(attempt)
            try:
                return self._restore(cache, pages, blobs)
            except Exception as e:           # noqa: BLE001
                last = e
        raise TierCopyError(
            f"restore of {len(pages)} page(s) failed after "
            f"{self.retry_budget + 1} attempts") from last

    def _put(self, blob: Blob, pinned: bool) -> Optional[int]:
        """``host.put`` recording the blob's put-time checksum."""
        h = self.host.put(blob, pinned)
        if h is not None:
            self._crc[h] = blob_checksum(self.host.get(h))
        return h

    def _pop(self, h: int) -> Blob:
        self._crc.pop(h, None)
        return self.host.pop(h)

    def _verify(self, handles: Sequence[int]) -> int:
        """Blobs among ``handles`` whose bytes no longer match their
        put-time checksum (0 when verification is off)."""
        if not self.verify_checksums:
            return 0
        bad = sum(1 for h in handles
                  if blob_checksum(self.host.get(h)) != self._crc.get(h))
        self.corrupt_blobs += bad
        return bad

    # ------------------------------------------------- host prefix index
    def _forget_handle(self, handle: int) -> None:
        self._crc.pop(handle, None)
        path = self._by_handle.pop(handle, None)
        if path is not None:
            self._hpath.pop(path, None)

    def _spill_evicted_prefix(self, path: Tuple[int, ...],
                              page: int) -> None:
        """PrefixCache eviction hook: copy the dying page host-side and
        index it by its exact token path (content == f(token path), so
        the path is a collision-free key)."""
        if path in self._hpath:
            return
        try:
            (blob,) = self._save_guarded(self._get_cache(), [page])
        except TierCopyError:
            return                       # the page just dies single-tier
        h = self._put(blob, pinned=False)
        if h is None:
            return                       # pinned blobs own the pool
        self._hpath[path] = h
        self._by_handle[h] = path
        self.pages_spilled += 1
        self._charge(1)

    def host_match(self, seq: np.ndarray, from_blk: int,
                   max_blocks: int) -> List[Tuple[int, ...]]:
        """Token paths of host-index blocks continuing ``seq`` from
        block ``from_blk`` (exclusive-capped at ``max_blocks`` so a
        fresh prompt always keeps >= 1 tail token to prefill — its
        first sample comes from the tail's logits)."""
        paths = []
        for blk in range(from_blk, max_blocks):
            path = tuple(int(t) for t in seq[:(blk + 1) * self.page_size])
            if path not in self._hpath:
                break
            paths.append(path)
        return paths

    def restore_host_prefix(self, paths: Sequence[Tuple[int, ...]],
                            pages: Sequence[int], cache):
        """Copy matched host-index blobs back into fresh device pages
        (the entries move back to the device tier — the caller registers
        the pages in the device prefix cache).  Entries are consumed
        only on success: checksum mismatches drop the damaged entries
        and raise ``TierCopyError`` (the caller re-prefills); a
        restore failure past the retry budget raises with the entries
        kept (the bytes are fine — a later admission may succeed)."""
        handles = [self._hpath[p] for p in paths]
        if self._verify(handles):
            for h in handles:            # detected damage: purge it
                self._forget_handle(h)
                self._pop(h)
            raise TierCopyError(
                f"{len(paths)} host-prefix blob(s) failed checksum")
        blobs = [self.host.get(h) for h in handles]
        cache = self._restore_guarded(cache, pages, blobs)
        for h in handles:
            self._forget_handle(h)
            self._pop(h)
        self.pages_restored += len(pages)
        self.host_prefix_hits += len(pages)
        self._charge(len(pages))
        return cache

    def flush_host(self) -> int:
        """Drop every host prefix-index entry (end-of-run accounting;
        parked/shadow blobs — pinned KV a session still owns — stay)."""
        n = 0
        for path, h in list(self._hpath.items()):
            self._pop(h)
            self._by_handle.pop(h, None)
            del self._hpath[path]
            n += 1
        return n

    @property
    def host_used(self) -> int:
        return self.host.used

    def host_stats(self) -> Dict[str, int]:
        return {"capacity": self.host.capacity, "used": self.host.used,
                "parked": sum(len(h) for h in self._parked.values()),
                "shadow": len(self._shadow),
                "prefix": len(self._hpath)}

    # -------------------------------------------------- park / restore
    def park(self, sid: str, n_full: int, pages: Sequence[int],
             cache) -> Optional[int]:
        """Spill a preempted session's ``n_full`` full KV pages to the
        host pool (reusing shadow pre-spills — LookAheadSpill — where
        present).  Returns the pages copied *now*, or None when parking
        was impossible (no full pages, or pinned blobs already fill the
        host pool) — the caller then falls back to plain re-prefill."""
        if sid in self._parked:
            raise RuntimeError(f"{sid} parked twice")
        shadows = self._shadow_sids.get(sid, set())
        fresh = [b for b in range(n_full) if b not in shadows]
        if n_full == 0 or not self.host.reserve(len(fresh)):
            self.drop_shadows(sid)
            self.park_fails += 1
            return None
        handles: List[Optional[int]] = [None] * n_full
        if fresh:
            try:
                blobs = self._save_guarded(cache, [pages[b] for b in fresh])
            except TierCopyError:
                # save failed past the retry budget before any blob was
                # admitted to the pool: nothing to unwind host-side, the
                # session degrades to plain re-prefill
                self.drop_shadows(sid)
                self.park_fails += 1
                return None
            for b, blob in zip(fresh, blobs):
                handles[b] = self._put(blob, pinned=True)
                if handles[b] is None:
                    raise RuntimeError("reserve() did not cover the park")
        for b in range(n_full):           # adopt shadows, drop overshoot
            if b in shadows:
                handles[b] = self._shadow.pop((sid, b))
        for b in shadows - set(range(n_full)):
            self._pop(self._shadow.pop((sid, b)))
        self._shadow_sids.pop(sid, None)
        self._parked[sid] = handles
        self.pages_spilled += len(fresh)
        if fresh:
            self._charge(len(fresh))
        return len(fresh)

    def parked_blocks(self, sid: str) -> int:
        return len(self._parked.get(sid, ()))

    def take_parked(self, sid: str, skip: int, pages: Sequence[int],
                    cache):
        """Restore a parked session's blocks ``skip..n_full-1`` into
        fresh device ``pages`` (blocks below ``skip`` were covered by a
        device prefix match — same tokens, same content) and retire the
        parked entry.

        The entry is consumed only AFTER verify + restore succeed: a
        checksum mismatch or a restore failure past the retry budget
        raises ``TierCopyError`` with the parked handles (and the host
        pool's accounting) intact, so the caller can release its device
        pages, ``drop_parked`` the dead copy, and degrade to re-prefill
        without leaking either pool."""
        handles = self._parked[sid]
        if len(pages) != len(handles) - skip:
            raise ValueError(f"{len(pages)} pages for {len(handles) - skip} "
                             f"parked blocks of {sid}")
        take = handles[skip:]
        if self._verify(take):
            raise TierCopyError(
                f"parked blob(s) of {sid} failed verify-on-restore")
        blobs = [self.host.get(h) for h in take]
        cache = self._restore_guarded(cache, pages, blobs)
        del self._parked[sid]
        for h in handles:
            self._pop(h)
        self.pages_restored += len(pages)
        self.tier_restores += 1
        self._charge(len(pages))
        return cache

    def drop_parked(self, sid: str) -> None:
        """Forget a parked entry without restoring (the session was
        re-admitted through a device prefix match or plain
        re-prefill)."""
        for h in self._parked.pop(sid, ()):
            self._pop(h)

    def corrupt_parked_blob(self) -> Optional[str]:
        """Fault-injection hook: flip one byte of the first parked blob
        of the lowest-sorted parked sid (deterministic victim choice).
        The restore-time checksum screen must catch the damage.
        Returns the victim sid, or None when nothing is parked."""
        for sid in sorted(self._parked):
            handles = [h for h in self._parked[sid] if h is not None]
            if not handles:
                continue
            h = handles[0]
            blob = self.host.get(h)
            comp = blob[0].clone()
            comp.reshape(-1).view(torch.uint8)[:1].bitwise_xor_(0xFF)
            self.host.replace(h, (comp,) + tuple(blob[1:]))
            return sid
        return None

    # ---------------------------------------------- shadow pre-spills
    def has_shadow(self, sid: str, blk: int) -> bool:
        return (sid, blk) in self._shadow

    def shadow_spill(self, sid: str, blks: Sequence[int],
                     pages: Sequence[int], cache) -> int:
        """LookAheadSpill: pre-copy a *resident* session's cold full
        pages host-side during idle ticks, so a later park copies only
        the un-shadowed remainder.  Cold full pages are immutable
        (decode writes only at ``pos``), so the copies stay valid."""
        if not self.host.reserve(len(blks)):
            return 0
        try:
            blobs = self._save_guarded(cache, pages)
        except TierCopyError:
            return 0                     # optional pre-spill: skip it
        for blk, blob in zip(blks, blobs):
            h = self._put(blob, pinned=True)
            if h is None:
                raise RuntimeError("reserve() did not cover the pre-spill")
            self._shadow[(sid, blk)] = h
            self._shadow_sids.setdefault(sid, set()).add(blk)
        self.pages_spilled += len(blks)
        self._charge(len(blks))
        return len(blks)

    def drop_shadows(self, sid: str) -> None:
        for blk in self._shadow_sids.pop(sid, set()):
            self._pop(self._shadow.pop((sid, blk)))
