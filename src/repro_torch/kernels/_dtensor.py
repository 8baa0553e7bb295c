"""DTensor inputs of the kernel wrappers.

A ctypes launcher takes raw pointers, and a DTensor's ``data_ptr()`` is
0 (its storage is the local shard, ``to_local()``).  So every wrapper
sends DTensor inputs here first, before its CPU / CUDA branch:
``local_call`` runs the wrapper on the ranks' local shards and wraps
the results as DTensors again.

Each input names its dims with one letter apiece: the same letter in
two inputs is the same logical axis (the batch, the heads), and ``.``
marks a dim the kernel reduces over or mixes across (the sequence of a
decode attention, the row of a norm, head_dim).  On each mesh dim:

- an input sharded along a ``.`` dim is first all-gathered there
  (``redistribute`` to ``Replicate()``);
- a ``Partial`` input is all-reduced;
- if the inputs that stay sharded agree on one letter, and every input
  with that letter divides evenly, every such input is sharded the same
  way (a replicated one is sliced locally, with no communication), the
  inputs without it are replicated, and the outputs are sharded along
  that letter; otherwise every input is all-gathered on that mesh dim.

An output without the chosen letter is a sum over the ranks' parts
(RMSNorm's ``dw`` of batch-sharded rows): it comes back ``Partial()``
on that mesh dim, and only an output declared a sum may lack it.
Gradients flow through ``to_local`` / ``from_local``: an input
replicated along a mesh dim on which the work is split gets a
``Partial()`` gradient there, the sum of the ranks' parts.  A plain
tensor among DTensor inputs counts as replicated.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple


def is_dtensor(t) -> bool:
    if t is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def any_dtensor(*ts) -> bool:
    return any(is_dtensor(t) for t in ts)


def check_pointers(wrapper: str, named) -> None:
    """Refuse a tensor whose ``data_ptr()`` is 0 (a DTensor, or one with
    no storage) before it reaches a launcher: on the card it would be an
    illegal address."""
    for name, t in named:
        if t is None:
            continue
        if is_dtensor(t):
            raise ValueError(f"{wrapper}: {name} is a DTensor; its data_ptr() "
                             "is 0 (the wrapper runs DTensors on their local "
                             "shards)")
        if t.numel() and t.data_ptr() == 0:
            raise ValueError(f"{wrapper}: {name} has data_ptr() 0 (no storage)")


def shard_span(t, dim: int) -> Tuple[int, int]:
    """(first index, length) of the slice of ``dim`` that this rank's
    shard of the DTensor ``t`` holds, for even shards: a dim split over
    several mesh dims is split by them in mesh order, the first the
    outermost."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    coord, sizes = mesh.get_coordinate(), mesh.mesh.shape
    off, span = 0, t.shape[dim]
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            span //= sizes[m]
            off += coord[m] * span
    return off, span


def split_dim(t, dim: int, outer: int):
    """``t`` ready for a reshape that splits ``dim`` into ``outer`` times
    the rest: a DTensor split along ``dim`` by more ranks than ``outer``
    divides is all-gathered on those mesh dims first (DTensor shards a
    split dim's outer part, and only evenly).  Anything else comes back
    as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim %= t.dim()
    on = [isinstance(p, Shard) and p.dim == dim for p in t.placements]
    k = 1
    for m, hit in enumerate(on):
        if hit:
            k *= t.device_mesh.mesh.shape[m]
    if outer % k == 0:
        return t
    return t.redistribute(t.device_mesh, [Replicate() if hit else p
                                          for p, hit in zip(t.placements, on)])


def local_call(fn, args: Sequence[Tuple[Any, str]], outs: Sequence[str], *,
               sums: Sequence[bool] = (), kwargs: Optional[dict] = None):
    """``fn(*local args, **kwargs)`` on each rank's shards.

    ``args``: (tensor or None, letters) per positional argument; ``outs``:
    the letters of each output (``fn`` returns one tensor, or a tuple,
    whose None entries stay None); ``sums[i]`` marks output i a sum over
    the letters it lacks.  Returns DTensors on the inputs' mesh, one per
    output (a single one when ``outs`` has one entry)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dts = [t for t, _ in args if is_dtensor(t)]
    mesh = dts[0].device_mesh
    for t in dts:
        if t.device_mesh != mesh:
            raise ValueError("every DTensor input must be on one mesh")
    sizes = mesh.mesh.shape
    n_mesh = len(sizes)

    def letters_of(t, letters):
        if len(letters) != t.dim():
            raise ValueError(f"letters {letters!r} for a {t.dim()}-dim input")
        return letters

    # the shard letter of each input on each mesh dim ('.' and Partial
    # are gathered), then one letter per mesh dim
    chosen: List[Optional[str]] = []
    for m in range(n_mesh):
        seen = set()
        for t, letters in args:
            if not is_dtensor(t):
                continue
            p = t.placements[m]
            if isinstance(p, Shard):
                c = letters_of(t, letters)[p.dim]
                if c != ".":
                    seen.add(c)
        chosen.append(seen.pop() if len(seen) == 1 else None)
    # a letter sharded over several mesh dims splits each of its dims in
    # mesh order: each input's dim must divide the product
    for c in set(x for x in chosen if x is not None):
        k = 1
        for m in range(n_mesh):
            if chosen[m] == c:
                k *= sizes[m]
        if not all(t.shape[letters.index(c)] % k == 0
                   for t, letters in args if t is not None and c in letters):
            chosen = [None if x == c else x for x in chosen]

    def target(letters) -> List[Any]:
        out = []
        for m in range(n_mesh):
            c = chosen[m]
            out.append(Shard(letters.index(c)) if c is not None and c in letters
                       else Replicate())
        return out

    locals_ = []
    for t, letters in args:
        if t is None:
            locals_.append(None)
            continue
        want = target(letters)
        if not is_dtensor(t):
            # a plain tensor counts as replicated
            t = DTensor.from_local(t, mesh, [Replicate()] * n_mesh, run_check=False)
        if list(t.placements) != want:
            # all-gathers a '.'-sharded or disagreeing dim, all-reduces a
            # Partial, slices a replicated dim locally
            t = t.redistribute(mesh, want)
        grad = [Partial() if chosen[m] is not None and chosen[m] not in letters
                else want[m] for m in range(n_mesh)]
        locals_.append(t.to_local(grad_placements=grad).contiguous())

    res = fn(*locals_, **(kwargs or {}))
    single = not isinstance(res, tuple)
    res = (res,) if single else res
    wrapped = []
    for i, (r, letters) in enumerate(zip(res, outs)):
        if r is None:
            wrapped.append(None)
            continue
        pl = []
        for m in range(n_mesh):
            c = chosen[m]
            if c is None:
                pl.append(Replicate())
            elif c in letters:
                pl.append(Shard(letters.index(c)))
            elif i < len(sums) and sums[i]:
                pl.append(Partial())
            else:
                raise ValueError(f"output {i} ({letters!r}) lacks the sharded "
                                 f"axis {c!r} and is not a sum")
        wrapped.append(DTensor.from_local(r, mesh, pl, run_check=False))
    return wrapped[0] if single else tuple(wrapped)
