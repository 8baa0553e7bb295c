"""The paper's primary contribution as a library: the batch-1 decode
step-time decomposition — analytic HBM floor model (floor), hardware
tier registry (hardware), the measurement protocol (protocol/stats), and
the dispatch-mode executors of the CUDA-Graphs A/B (dispatch).  floor,
hardware and stats are copies of ``repro.core``'s framework-neutral
modules."""
from repro_torch.core import dispatch, floor, hardware, protocol, stats  # noqa: F401
