"""Device meshes with the reference's axis names (``pod``, ``data``,
``model``).

Port of ``repro.launch.mesh``.  The constructors are functions, not module
constants: importing this module touches no CUDA state and creates no
process group (``torch.cuda.is_initialized()`` and
``torch.distributed.is_initialized()`` stay False).  A mesh is built on
the process group the caller has started, over its world: the product
of the mesh's sizes must equal the world size.

``dp_axes``, ``dp_size`` and ``tp_size`` read only the axis names and
sizes, so they take a ``DeviceMesh`` or any object with ``axis_names``
and a ``shape`` dict (the reference's tests pass such a stand-in).
"""
from __future__ import annotations

from typing import Dict, Tuple


def _mk(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 devices.
    Multi-pod: (pod=2, data=16, model=16) = 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device_type)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0,
                   device_type: str = "cuda"):
    """A small mesh over the current process group (tests, the
    launcher): (data, model), or (pod, data, model) with ``pod``."""
    if pod:
        return _mk((pod, data, model), ("pod", "data", "model"), device_type)
    return _mk((data, model), ("data", "model"), device_type)


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in mesh-dim order."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a stand-in with a
    ``shape`` dict."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes: everything that is not 'model'."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    s = 1
    for a in dp_axes(mesh):
        s *= sizes[a]
    return s


def tp_size(mesh) -> int:
    return axis_sizes(mesh)["model"]
