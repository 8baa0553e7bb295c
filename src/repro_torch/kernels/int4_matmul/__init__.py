from repro_torch.kernels.int4_matmul import ops, ref  # noqa: F401
from repro_torch.kernels.int4_matmul.ops import int4_matmul  # noqa: F401
