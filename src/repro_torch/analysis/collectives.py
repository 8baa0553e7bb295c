"""Collectives of a traced step, counted as they run.

The counterpart of ``repro.analysis.hlo``.  The reference compiles a
step and parses the collectives out of the partitioned HLO text, where
a collective inside a while-loop body (the scan over layers, over
microbatches) appears once and runs trip-count times, so each parsed op
carries a multiplier.  Torch has no HLO to parse: the port runs the
layers and the microbatches in Python loops, and a DTensor step issues
each collective as it runs.  ``CollectiveCounter`` is a
``TorchDispatchMode`` that records every ``c10d_functional`` collective
(what DTensor's redistributions and ``_dtensor.local_call`` issue) and
every in-place ``c10d`` collective issued under it, once per call:
``multiplier`` is always 1 and there are no trip counts.

Each op records its kind under the reference's names (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``; a broadcast,
gather, scatter or reduce keeps its own name and is charged as a
``collective-permute``, its result's size), its result's bytes (the
gathered tensor of an all-gather, the scattered one of a
reduce-scatter, as in HLO) and its group's size.  ``CollectiveOp``'s
ring formulas and ``collective_summary`` are copies of the reference's
(``hlo.py``), held equal to them by ``tests/test_torch_analysis.py``.

Ring-algorithm wire bytes per chip:
  all-reduce     2 (n-1)/n * size
  all-gather       (n-1)/n * result_size
  reduce-scatter   (n-1)/n * operand_size
  all-to-all       (n-1)/n * size
  collective-permute  size
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: float
    group_size: int
    computation: str
    multiplier: int

    @property
    def wire_bytes_per_chip(self) -> float:
        n = max(self.group_size, 2)
        f = (n - 1) / n
        if self.kind == "all-reduce":
            b = 2 * f * self.result_bytes
        elif self.kind == "all-gather":
            b = f * self.result_bytes
        elif self.kind == "reduce-scatter":
            b = f * self.result_bytes * n   # operand = result * n
        elif self.kind == "all-to-all":
            b = f * self.result_bytes
        else:  # collective-permute
            b = self.result_bytes
        return b * self.multiplier


def collective_summary(ops: List[CollectiveOp]) -> Dict:
    by_kind: Dict[str, Dict[str, float]] = {}
    for op in ops:
        d = by_kind.setdefault(op.kind, {"count": 0, "wire_bytes_per_chip": 0.0})
        d["count"] += op.multiplier
        d["wire_bytes_per_chip"] += op.wire_bytes_per_chip
    total = sum(d["wire_bytes_per_chip"] for d in by_kind.values())
    return {"by_kind": by_kind, "total_wire_bytes_per_chip": total}


# op name (the overload packet's, without its namespace) -> kind
_KINDS = {
    # functional collectives (torch.ops._c10d_functional, c10d_functional)
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    # in-place c10d collectives (torch.ops.c10d)
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "gather_": "gather", "scatter_": "scatter", "reduce_": "reduce",
}
_FUNCTIONAL = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd")


def kind_of(func) -> Optional[str]:
    """The kind of the op ``func`` (an OpOverload), or None when it is no
    collective."""
    ns, _, op = func._overloadpacket._qualified_op_name.partition("::")
    return _KINDS.get(op) if ns in _FUNCTIONAL + ("c10d",) else None


def _result(func, args, out):
    """A functional collective returns its result; an in-place ``c10d``
    one writes it into its first argument."""
    ns = func._overloadpacket._qualified_op_name.partition("::")[0]
    return args[0] if ns == "c10d" else out


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(x) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(x)))


def _group_size(func, args, kwargs) -> int:
    """The size of the op's group: the group a functional collective
    names (``group_name``), or an in-place one's ``process_group``."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    bound = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)
    if "group_name" in bound:
        return _resolve_process_group(bound["group_name"]).size()
    if "process_group" in bound:
        from torch.distributed import ProcessGroup
        return ProcessGroup.unbox(bound["process_group"]).size()
    raise ValueError(f"{func}: no group among its arguments")


class CollectiveCounter(TorchDispatchMode):
    """``with CollectiveCounter() as cc: step()`` records each collective
    the step issues in ``cc.ops`` (``CollectiveOp``s, multiplier 1),
    seen below DTensor: a DTensor op is let through to DTensor first
    (``NotImplemented``), and the collectives it desugars into come back
    here as plain ops, as ``CommDebugMode`` sees them."""

    def __init__(self):
        super().__init__()
        self.ops: List[CollectiveOp] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        kind = kind_of(func)
        if kind is not None:
            self.ops.append(CollectiveOp(
                kind, _nbytes(_result(func, args, out)), _group_size(func, args, kwargs),
                func._overloadpacket._qualified_op_name, 1))
        return out

    def counts(self) -> Dict[str, int]:
        """{kind: count}."""
        out: Dict[str, int] = {}
        for op in self.ops:
            out[op.kind] = out.get(op.kind, 0) + op.multiplier
        return out

    def summary(self) -> Dict:
        return collective_summary(self.ops)
