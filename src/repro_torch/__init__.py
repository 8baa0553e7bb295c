"""PyTorch/CUDA port of the batch-1 decode stack in ``repro``.

The layout mirrors ``src/repro/``: each module here is the counterpart
of the module at the same relative path there.  The package imports
``torch`` and numpy only; it carries its own copies of the
framework-neutral modules it needs (configs, floor model, hardware
table).  Hand-written CUDA kernels live in ``csrc/`` and are built on
first use by ``kernels/_build.py``.
"""
