from repro_torch.kernels.paged_decode_attention import ops, ref  # noqa: F401
from repro_torch.kernels.paged_decode_attention.ops import (  # noqa: F401
    paged_decode_attention)
