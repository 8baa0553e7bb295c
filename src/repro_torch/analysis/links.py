"""The H100's link bandwidth for the roofline's collective term.

``core/hardware.py`` (a copy of the reference's table, held equal to it)
gives the GPUs no link bandwidth (``ici_bw`` is None), so the copied
``roofline.build_row`` cannot price a collective on the H100.  This
module adds it, port-only.

Source: NVIDIA's H100 Tensor Core GPU datasheet, the SXM5 form factor:
NVLink 4 at 900 GB/s total per GPU, that is 450 GB/s each way.  The
ring formulas of ``analysis/collectives.py`` count the bytes each rank
sends, so the term divides them by one direction's rate.

A bound from below: NVLink joins the 8 GPUs of one node.  A 16-wide
``model`` axis (the production meshes, ``launch/mesh.py``) spans two
nodes, and the part of a ring that crosses between them runs on the
network between the nodes, which is slower than NVLink, so a real
collective there takes longer than this term says.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import GPU_H100, ChipSpec

# NVLink 4 on the H100 SXM5: 900 GB/s total, 450 GB/s each way (decimal)
H100_NVLINK_BW_TOTAL = 900e9
H100_NVLINK_BW_PER_DIRECTION = 450e9


def h100_chip() -> ChipSpec:
    """``GPU_H100`` with ``ici_bw`` set to NVLink 4's rate each way."""
    return dataclasses.replace(GPU_H100, ici_bw=H100_NVLINK_BW_PER_DIRECTION)
