from repro_torch.kernels.ssd_update import ops, ref  # noqa: F401
from repro_torch.kernels.ssd_update.ops import ssd_update  # noqa: F401
