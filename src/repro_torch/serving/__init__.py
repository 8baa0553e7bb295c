from repro_torch.serving.engine import DecodeEngine, GenerationResult  # noqa: F401
from repro_torch.serving.sampling import sample  # noqa: F401
