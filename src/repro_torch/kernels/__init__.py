"""Hand-written Hopper kernels (CUDA C++ in ``repro_torch/csrc``), each
with a plain PyTorch version beside it in ``ref.py``."""
