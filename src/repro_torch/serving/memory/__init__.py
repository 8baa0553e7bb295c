"""Serving memory subsystem: page accounting, prefix index and the device
page store the scheduler programs against.  Port of
``repro.serving.memory``; the host-DRAM tier and its policies wait for
the host-tier slice."""
from repro_torch.serving.memory.allocator import GARBAGE_PAGE, BlockAllocator
from repro_torch.serving.memory.prefix import PrefixCache
from repro_torch.serving.memory.tiers import PageStore

__all__ = ["GARBAGE_PAGE", "BlockAllocator", "PrefixCache", "PageStore"]
