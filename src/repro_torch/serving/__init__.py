from repro_torch.serving.engine import DecodeEngine, GenerationResult  # noqa: F401
from repro_torch.serving.memory import BlockAllocator, PrefixCache  # noqa: F401
from repro_torch.serving.sampling import sample  # noqa: F401
from repro_torch.serving.scheduler import SlotScheduler  # noqa: F401
from repro_torch.serving.session import (ContinuousResult,  # noqa: F401
                                         SessionRequest, SessionResult)
