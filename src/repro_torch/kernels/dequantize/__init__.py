from repro_torch.kernels.dequantize import ops, ref  # noqa: F401
from repro_torch.kernels.dequantize.ops import dequantize  # noqa: F401
