"""Adaptive sharding planner.

Port of ``repro.launch.sharding``.  Maps every param, batch and cache
leaf to a *spec* by name-based rules and divisibility guards.  A spec
is a tuple with one entry per tensor dim: ``None`` (replicated), an
axis name, or a tuple of axis names (the dim split over several axes,
the first the outermost) -- the reference's ``PartitionSpec``, so the
two plans compare entry for entry.  An axis is assigned only when the
dim divides the axes' size (the reference never shards unevenly, and
DTensor's uneven shards are not used either); every fallback is
recorded in ``plan.decisions``.

Strategies, as in the reference:
  TP       -- feature dims (d_ff, heads*head_dim, d_inner, vocab) over
              "model" (Megatron column/row pattern)
  EP vs in-expert TP -- experts over "model" when E % model == 0, else
              TP inside each expert
  DP       -- batch over ("pod", "data")
  FSDP/ZeRO -- params (and always optimizer moments) additionally
              sharded over "data" on a non-TP dim
  seq-sharded KV -- decode caches shard context over "model" (and batch
              over "data"); B == 1 shards context over data and model

The spec logic reads only axis names and sizes (``launch/mesh.py``), so
it runs on a stand-in mesh.  ``placements(spec, mesh)`` turns a spec
into DTensor placements, one per mesh dim, and ``ShardingPlan.named``
into a ``Layout`` (mesh, placements, spec) that ``distribute`` applies.

The port's ``blocks`` is a list of per-layer dicts, where the
reference's leaves carry a leading L axis with a ``None`` entry: a block
leaf's spec here is the reference's without that entry, and
``decisions`` are keyed by the reference's path (``blocks/attn/wq``, no
layer index).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import axis_names, axis_sizes, dp_axes, tp_size
from repro_torch.quant.quantize import QuantizedTensor
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.tree import tree_map, tree_map_with_path

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a tensor lives: a mesh, one DTensor placement per mesh dim,
    and the spec they came from."""
    mesh: Any
    placements: Tuple[Any, ...]
    spec: Spec


@dataclasses.dataclass
class ShardingPlan:
    mesh: Any
    cfg: ArchConfig
    fsdp: bool
    decisions: Dict[str, str]
    strategy: str = "tp"   # "tp" (Megatron default) | "dp" (pure data-
    #                        parallel: params replicated, batch over ALL
    #                        axes, ZeRO-1 moments)

    def named(self, spec: Spec) -> Layout:
        return Layout(self.mesh, placements(spec, self.mesh), tuple(spec))

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        if self.strategy == "dp":
            return axis_names(self.mesh)       # all axes carry batch
        return dp_axes(self.mesh)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on a mesh dim whose axis names tensor dim d, else
    ``Replicate()``.  A dim over several axes shards over them in
    mesh-dim order (DTensor's order, the outermost first), so its axes
    must be listed in mesh order: otherwise this raises, as it does for
    an axis the mesh lacks or one named twice.  Never reorders."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: axis {a!r} is not in the "
                                 f"mesh's axes {names}")
            if a in dim_of:
                raise ValueError(f"spec {spec}: axis {a!r} named twice")
            dim_of[a] = d
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {d} lists {axes}, not in the "
                             f"mesh's order {names}; DTensor would shard "
                             "them in mesh order")
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in names)


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    sizes = axis_sizes(mesh)
    n = 1
    for a in _axes_of(axis):
        n *= sizes[a]
    return dim % n == 0


def _guard(plan: ShardingPlan, path: str, shape, wanted: Tuple) -> Spec:
    """Drop axes that don't divide; record every fallback.  A tuple of
    one axis is written as the axis, as ``PartitionSpec`` writes it."""
    out = []
    for dim, axis in zip(shape, wanted):
        if axis is not None and not _fits(dim, plan.mesh, axis):
            plan.decisions[path] = (f"wanted {axis} on dim {dim}, "
                                    f"not divisible -> replicated")
            axis = None
        if isinstance(axis, tuple) and len(axis) <= 1:
            axis = axis[0] if axis else None
        out.append(axis)
    return tuple(out)


def _ref_path(path: Tuple[str, ...]) -> str:
    """The reference's path of a leaf: a block leaf without its layer
    index (``blocks/0/attn/wq`` -> ``blocks/attn/wq``)."""
    if path and path[0] == "blocks":
        path = path[:1] + path[2:]
    return "/".join(path)


def make_plan(cfg: ArchConfig, mesh, *, fsdp: bool = False,
              strategy: str = "tp") -> ShardingPlan:
    return ShardingPlan(mesh, cfg, fsdp, {}, strategy)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def param_spec(plan: ShardingPlan, path: Tuple[str, ...], leaf) -> Spec:
    """The spec of one param leaf at ``path`` (its keys in the port's
    tree, e.g. ``("blocks", "3", "moe", "w_up")``); ``leaf`` has a
    ``shape``.  A block leaf is one layer's: experts are (E, ...)."""
    cfg, mesh = plan.cfg, plan.mesh
    name = path[-1]
    ref_path = _ref_path(path)
    shape = tuple(leaf.shape)
    if plan.strategy == "dp":
        # pure DP: parameters replicated everywhere
        return (None,) * len(shape)
    dp = "data" if (plan.fsdp and "data" in axis_names(mesh)) else None

    def guard(*wanted):
        # align to the actual rank (quantized leaves add/remove dims)
        base = tuple(wanted)[:len(shape)] + (None,) * (len(shape) - len(wanted))
        return _guard(plan, ref_path, shape, base)

    ep_ok = cfg.n_experts and cfg.n_experts % tp_size(mesh) == 0

    if name in ("embed", "lm_head"):
        # (V, D) or (K_codebooks, V, D): vocab over model, else d_model
        if shape[-2] % tp_size(mesh) == 0:
            spec = (None,) * (len(shape) - 2) + ("model", dp)
        else:
            spec = (None,) * (len(shape) - 2) + (None, "model")
        return _guard(plan, ref_path, shape, spec)
    if name in ("wq", "wk", "wv"):            # (D, H*hd) col-parallel
        return guard(dp, "model")
    if name == "wo":                          # (H*hd, D) row-parallel
        return guard("model", dp)
    if name in ("bq", "bk", "bv"):
        return guard("model")
    if name in ("gate", "up"):                # (D, F) col-parallel
        return guard(dp, "model")
    if name == "down":                        # (F, D) row-parallel
        return guard("model", dp)
    if name == "router":
        return guard(None, None)
    if name in ("w_gate", "w_up"):            # (E, D, F)
        return guard("model", dp, None) if ep_ok else guard(None, dp, "model")
    if name == "w_down":                      # (E, F, D)
        return guard("model", None, dp) if ep_ok else guard(None, "model", dp)
    if name == "in_proj":                     # (D, 2DI+2GN+H) col-parallel
        return guard(dp, "model")
    if name == "out_proj":                    # (DI, D) row-parallel
        return guard("model", dp)
    if name in ("conv_w",):                   # (K, C)
        return guard(None, "model")
    if name in ("conv_b", "gate_norm"):
        return guard("model")
    if name in ("A_log", "D", "dt_bias"):     # (H,)
        return guard("model")
    # norms, scalars: replicated
    return guard(*([None] * len(shape)))


def params_shardings(plan: ShardingPlan, params) -> Any:
    """A tree like ``params`` of ``plan.named(spec)``, one per leaf.

    QuantizedTensor leaves: ``data`` and ``scales`` inherit the logical
    weight's spec on their shared (K-ish, N) trailing dims, each guarded
    on its own shape; the result is a QuantizedTensor of the two."""
    def visit(path, leaf):
        if isinstance(leaf, QuantizedTensor):
            spec = param_spec(plan, path, leaf)     # uses the logical shape
            ref_path = _ref_path(path)
            d_spec = _guard(plan, ref_path + ".data", leaf.data.shape, spec)
            s_spec = _guard(plan, ref_path + ".scales", leaf.scales.shape, spec)
            return QuantizedTensor(plan.named(d_spec), plan.named(s_spec),
                                   leaf.bits, leaf.path)
        return plan.named(param_spec(plan, path, leaf))
    return tree_map_with_path(visit, params)


def opt_state_shardings(plan: ShardingPlan, opt_state: AdamWState,
                        *, zero1: bool = False) -> AdamWState:
    """Moments follow the param layout by default; ``zero1=True``
    additionally shards them over the data axes.  Under the pure-DP
    strategy, moments take the TP layout with FSDP (ZeRO-1: replicated
    params, sharded optimizer).  The step counter is replicated."""
    plan_m = dataclasses.replace(plan, fsdp=True) if zero1 else plan
    if plan.strategy == "dp":
        plan_m = dataclasses.replace(plan, strategy="tp", fsdp=True)
    return AdamWState(plan.named(()),
                      params_shardings(plan_m, opt_state.mu),
                      params_shardings(plan_m, opt_state.nu))


# --------------------------------------------------------------------------
# batches and caches
# --------------------------------------------------------------------------

def batch_shardings(plan: ShardingPlan, batch: Dict) -> Dict:
    """Each batch leaf's rows over the plan's batch axes."""
    dp = plan.batch_axes
    out = {}
    for k, v in batch.items():
        wanted = (dp,) + (None,) * (len(v.shape) - 1)
        out[k] = plan.named(_guard(plan, f"batch/{k}", v.shape, wanted))
    return out


def cache_shardings(plan: ShardingPlan, cache: Dict) -> Dict:
    """KV cache (L, B, S, Hkv, hd): batch over data, seq over model.
    SSM state (L, B, H, P, N): batch over data, heads over model.
    B == 1 (long-context single stream): seq additionally over data."""
    mesh = plan.mesh
    dp = dp_axes(mesh)
    # a single data axis shards as the flat name
    dpf = dp[0] if len(dp) == 1 else dp
    out = {}
    for k, v in cache.items():
        shape = tuple(v.shape)
        if k in ("k", "v"):
            B, S = shape[1], shape[2]
            if B == 1:
                wanted = (None, None, (dp + ("model",)), None, None)
                if not _fits(S, mesh, wanted[2]):
                    wanted = (None, None, "model", None, None)
            else:
                wanted = (None, dpf, "model", None, None)
            out[k] = plan.named(_guard(plan, f"cache/{k}", shape, wanted))
        elif k in ("k_scale", "v_scale"):   # (L, B, S, Hkv) int8-KV scales
            B = shape[1]
            wanted = ((None, None, (dp + ("model",)), None) if B == 1
                      else (None, dpf, "model", None))
            out[k] = plan.named(_guard(plan, f"cache/{k}", shape, wanted))
        elif k == "h":        # (L, B, H, P, N)
            wanted = (None, dpf, "model", None, None)
            out[k] = plan.named(_guard(plan, f"cache/{k}", shape, wanted))
        elif k == "conv":     # (L, B, K-1, C)
            wanted = (None, dpf, None, "model")
            out[k] = plan.named(_guard(plan, f"cache/{k}", shape, wanted))
        else:                 # pos scalar
            out[k] = plan.named(())
    return out


# --------------------------------------------------------------------------
# applying a plan
# --------------------------------------------------------------------------

def distribute(tree: Any, shardings: Any) -> Any:
    """``tree``'s tensors as DTensors laid out by the matching
    ``Layout`` leaves of ``shardings`` (a tree like ``tree``, as
    ``params_shardings`` returns); a tensor's ``requires_grad`` carries
    over, and a QuantizedTensor's codes and scales are laid out by its
    layouts' ``data`` and ``scales``.  Every rank must hold the same full
    tensors."""
    from torch.distributed.tensor import distribute_tensor

    def put(t, layout: Layout):
        if isinstance(t, QuantizedTensor):
            return QuantizedTensor(put(t.data, layout.data),
                                   put(t.scales, layout.scales), t.bits, t.path)
        d = distribute_tensor(t.detach(), layout.mesh, list(layout.placements))
        return d.requires_grad_(t.requires_grad)
    return tree_map(put, tree, shardings)
