"""Activation-sharding hints.

Port of ``repro.launch.hints``.  Models stay mesh-agnostic: they call
``constrain(x, axes)`` with logical axis names ("dp" = all data axes,
"tp" = the model axis, None = keep).  With a mesh installed (the
launcher's ``activation_hints(mesh)``), a DTensor activation is
``redistribute``d to the resolved layout, so attention scores and MLP
intermediates shard over heads and features; a plain tensor is left as
it is.  With no mesh installed ``constrain`` returns its argument
itself, so single-device runs are untouched.

Divisibility guards mirror ``launch/sharding.py``: an axis that does not
divide the dim is dropped (never an error).
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.launch.mesh import axis_names, axis_sizes

_STATE = {"mesh": None, "dp_all": False}


def enable(mesh, dp_all: bool = False) -> None:
    _STATE["mesh"] = mesh
    _STATE["dp_all"] = dp_all


def disable() -> None:
    _STATE["mesh"] = None
    _STATE["dp_all"] = False


class activation_hints:
    """Context manager: ``with activation_hints(mesh): ...`` runs the
    step under the hints.  On a ``DeviceMesh`` it also enters DTensor's
    ``implicit_replication``: a plain tensor the step makes (a causal
    mask, RoPE angles, a token batch) meets DTensors as a replicated one.

    dp_all=True (pure-DP strategy): 'dp' resolves to ALL mesh axes and
    'tp' is dropped (no model axis is reserved for TP)."""

    def __init__(self, mesh, dp_all: bool = False):
        self.mesh = mesh
        self.dp_all = dp_all
        self._implicit = None

    def __enter__(self):
        enable(self.mesh, self.dp_all)
        if hasattr(self.mesh, "mesh_dim_names"):
            from torch.distributed.tensor.experimental import implicit_replication
            self._implicit = implicit_replication()
            self._implicit.__enter__()
        return self

    def __exit__(self, *exc):
        if self._implicit is not None:
            self._implicit.__exit__(*exc)
            self._implicit = None
        disable()
        return False


def _resolve(ax, mesh):
    if ax == "dp":
        if _STATE["dp_all"]:
            axes = axis_names(mesh)
        else:
            axes = tuple(a for a in axis_names(mesh) if a != "model")
        return axes if len(axes) > 1 else axes[0]
    if ax == "tp":
        if _STATE["dp_all"]:
            return None
        return "model"
    return ax


def _size_of(ax, mesh) -> int:
    sizes = axis_sizes(mesh)
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= sizes[a]
        return n
    return sizes[ax]


def tp_divides(n: int) -> bool:
    """True iff a mesh is installed, TP is active, and n divides the
    model-axis size."""
    mesh = _STATE["mesh"]
    if mesh is None or _STATE["dp_all"]:
        return False
    return n % axis_sizes(mesh)["model"] == 0


def resolved_spec(shape, axes: Sequence[Optional[str]], mesh) -> tuple:
    """The spec ``constrain`` gives a tensor of ``shape``: each logical
    axis resolved on ``mesh``, dropped where it does not divide."""
    spec = []
    for i, dim in enumerate(shape):
        ax = axes[i] if i < len(axes) else None
        if ax is not None:
            ax = _resolve(ax, mesh)
            if ax is not None and dim % _size_of(ax, mesh) != 0:
                ax = None
        spec.append(ax)
    return tuple(spec)


def constrain(x, axes: Sequence[Optional[str]]):
    """x: tensor; axes: per-dim 'dp' | 'tp' | None (trailing dims None).
    A DTensor on the installed mesh comes back redistributed (a
    differentiable all-gather, all-to-all or local slice, as DTensor
    picks) to the resolved placements; anything else comes back as it
    is."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or x.device_mesh != mesh:
        return x
    from repro_torch.launch.sharding import placements
    want = placements(resolved_spec(x.shape, axes, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def constrain_first_fit(x, candidates: Sequence[Sequence[Optional[str]]]):
    """Apply the first candidate whose named axes ALL divide their dims
    (e.g. prefer kv-head TP for attention scores, fall back to
    query-sequence context-parallelism when head counts don't split)."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return x
    for axes in candidates:
        ok = True
        for i, dim in enumerate(x.shape):
            ax = axes[i] if i < len(axes) else None
            if ax is None:
                continue
            r = _resolve(ax, mesh)
            if r is not None and dim % _size_of(r, mesh) != 0:
                ok = False
                break
        if ok:
            return constrain(x, axes)
    return constrain(x, candidates[-1])   # guards drop what doesn't fit
