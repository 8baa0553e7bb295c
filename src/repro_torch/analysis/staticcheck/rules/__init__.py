"""Rule modules register themselves on import (core.RULES).  The file
names are the reference's, so a reader finds each counterpart:
``recompile`` holds ``capture-hazard``, ``donation`` holds
``graph-output-alias`` and ``prng`` holds ``generator-discipline``."""
from repro_torch.analysis.staticcheck.rules import (donation,  # noqa: F401
                                                    hot_sync, prng,
                                                    recompile, refcount)

__all__ = ["hot_sync", "recompile", "donation", "prng", "refcount"]
