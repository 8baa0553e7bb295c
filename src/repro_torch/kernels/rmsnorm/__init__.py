from repro_torch.kernels.rmsnorm import ops, ref  # noqa: F401
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: F401
