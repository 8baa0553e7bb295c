from repro_torch.kernels.decode_attention import ops, ref  # noqa: F401
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: F401
