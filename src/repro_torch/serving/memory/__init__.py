"""Serving memory subsystem: page accounting, prefix index, tiers.

Port of ``repro.serving.memory``: the scheduler programs against the
narrow ``PageStore`` seam, and the host-DRAM tier plus its placement and
migration policies slot in behind it without touching dispatch."""
from repro_torch.serving.memory.allocator import GARBAGE_PAGE, BlockAllocator
from repro_torch.serving.memory.policy import (LookAheadSpill, PreferDevice,
                                               SpillOnEvict, TierPolicy,
                                               get_policy)
from repro_torch.serving.memory.prefix import PrefixCache
from repro_torch.serving.memory.tiers import (HostPagePool, PageStore,
                                              TierCopyError, TieredPageStore,
                                              blob_checksum, restore_kv_blobs,
                                              save_kv_blobs)

__all__ = [
    "GARBAGE_PAGE", "BlockAllocator", "PrefixCache",
    "PageStore", "TieredPageStore", "HostPagePool",
    "save_kv_blobs", "restore_kv_blobs",
    "TierCopyError", "blob_checksum",
    "TierPolicy", "PreferDevice", "SpillOnEvict", "LookAheadSpill",
    "get_policy",
]
