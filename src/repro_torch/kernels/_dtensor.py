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

The same local-shard treatment serves ops whose DTensor rules refuse a
layout or would gather a tensor whole: ``flatten_leading`` and
``unflatten_leading`` (an (A, B, D) <-> (A*B, D) reshape with an uneven
or inner split) and ``take_rows`` (a row gather from a split buffer).
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


def _flat_placements(x) -> list:
    """The placements of a DTensor x (A, B, D) that its flatten to
    (A*B, D) runs on: A split evenly and D split stay; a split of B, an
    uneven split of A and a Partial become Replicate.  Then each rank's
    rows are whole rows of A, in the global order."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = x.device_mesh.mesh.shape
    k = 1
    for m, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            k *= sizes[m]
    keep = [isinstance(pl, Shard) and (pl.dim == 2 or (pl.dim == 0
                                                      and x.shape[0] % k == 0))
            for pl in x.placements]
    return [pl if kept else Replicate() for pl, kept in zip(x.placements, keep)]


def _flat_of(placements) -> list:
    """(A, B, D) placements as those of its (A*B, D) flatten."""
    from torch.distributed.tensor import Shard
    return [Shard(0 if p.dim == 0 else 1) if isinstance(p, Shard) else p
            for p in placements]


def flatten_leading(x):
    """x (A, B, D) -> (A*B, D).  A DTensor is redistributed explicitly to
    ``_flat_placements``, flattened on its local shards and wrapped again
    with A's split on the flat dim: DTensor's own view rules refuse an
    uneven split or a split of B, and gave the flatten's backward shards
    of the wrong size (``from_local``'s backward redistributes the
    gradient to these placements first)."""
    A, B, D = x.shape
    if not is_dtensor(x):
        return x.reshape(A * B, D)
    import torch
    from torch.distributed.tensor import DTensor
    want = _flat_placements(x)
    if list(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    local = x.to_local()
    return DTensor.from_local(local.reshape(-1, local.shape[-1]), x.device_mesh,
                              _flat_of(want), run_check=False,
                              shape=torch.Size((A * B, D)), stride=(D, 1))


def unflatten_leading(y, like):
    """y (A*B, D) -> (A, B, D) of ``like``'s shape.  A DTensor is first
    redistributed explicitly to the layout ``flatten_leading`` gave
    ``like``'s rows, then unflattened on its local shards."""
    A, B, D = like.shape
    if not is_dtensor(y):
        return y.reshape(A, B, D)
    import torch
    from torch.distributed.tensor import DTensor
    want = _flat_placements(like)
    if list(y.placements) != _flat_of(want):
        y = y.redistribute(y.device_mesh, _flat_of(want))
    local = y.to_local()
    return DTensor.from_local(local.reshape(-1, B, local.shape[-1]), y.device_mesh,
                              want, run_check=False, shape=torch.Size((A, B, D)),
                              stride=(B * D, D, 1))


def take_rows(buf, idx):
    """Rows ``idx`` (R,) of ``buf`` (..., D) with its leading dims
    flattened: ``buf.reshape(-1, D).index_select(0, idx)``.

    On DTensors each rank takes, from its own block of ``buf``, the rows
    that block holds and zeros for the others.  A mesh dim that splits
    idx gathers buf there, and the result is split as idx is.  A split of
    buf's leading dims on a mesh dim of n ranks that does not split idx
    stays where that moves fewer rows: the result is then ``Partial()``
    (a sum over the ranks) there, which an all-reduce of 2 (n-1)/n times
    the result's rows settles, against (n-1) times the rows each rank
    holds for the gather.  A split of D stays, and a Partial buf stays
    Partial."""
    if not any_dtensor(buf, idx):
        return buf.reshape(-1, buf.shape[-1]).index_select(0, idx)
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    mesh = (buf if is_dtensor(buf) else idx).device_mesh
    sizes = mesh.mesh.shape
    rep = [Replicate()] * mesh.ndim
    if not is_dtensor(buf):
        buf = DTensor.from_local(buf, mesh, rep, run_check=False)
    if not is_dtensor(idx):
        idx = DTensor.from_local(idx, mesh, rep, run_check=False)
    lead = buf.dim() - 1
    want_idx = [pi if isinstance(pi, Shard) else Replicate() for pi in idx.placements]
    want_buf = [Replicate() if isinstance(pi, Shard) else pb
                for pb, pi in zip(buf.placements, want_idx)]

    def rows_held(t_shape, placements, dims) -> int:
        # the most rows of dims any rank holds (the same on every rank)
        n = 1
        for d in dims:
            k = 1
            for m, pl in enumerate(placements):
                if isinstance(pl, Shard) and pl.dim == d:
                    k *= sizes[m]
            n *= -(-t_shape[d] // k)
        return n
    out_rows = rows_held(idx.shape, want_idx, (0,))
    for m, pb in enumerate(want_buf):
        if isinstance(pb, Shard) and pb.dim < lead and \
                2 * out_rows >= sizes[m] * rows_held(buf.shape, want_buf, range(lead)):
            want_buf[m] = Replicate()
    out, grad = [], []
    for pb, pi in zip(want_buf, want_idx):
        out.append(Shard(0) if isinstance(pi, Shard) else
                   (Partial() if pb.dim < lead else Shard(1)) if isinstance(pb, Shard)
                   else pb)
        # buf's gradient: a sum of the ranks' parts where the rows are
        # split; the whole for each part of a Partial buf
        grad.append(Partial() if isinstance(pi, Shard) else
                    Replicate() if isinstance(pb, Partial) else pb)
    if list(buf.placements) != want_buf:
        buf = buf.redistribute(mesh, want_buf)
    if list(idx.placements) != want_idx:
        idx = idx.redistribute(mesh, want_idx)
    shape, offset = compute_local_shape_and_global_offset(buf.shape, mesh, want_buf)
    local = buf.to_local(grad_placements=grad)
    i = idx.to_local()
    # each row's coordinates in buf's leading dims, then its index in this
    # rank's block (valid where every coordinate falls inside the block)
    coords, rem = [], i
    for d in reversed(range(lead)):
        coords.append(rem % buf.shape[d])
        rem = rem // buf.shape[d]
    local_i, inside = torch.zeros_like(i), torch.ones_like(i, dtype=torch.bool)
    for d, c in enumerate(reversed(coords)):
        c = c - offset[d]
        inside = inside & (c >= 0) & (c < shape[d])
        local_i = local_i * shape[d] + c
    # a zero row after the block for the rows it does not hold (an uneven
    # split may leave a rank an empty block)
    flat = local.reshape(-1, local.shape[-1])
    flat = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
    rows = flat.index_select(0, torch.where(inside, local_i, flat.shape[0] - 1))
    R, D = idx.shape[0], buf.shape[-1]
    return DTensor.from_local(rows, mesh, out, run_check=False,
                              shape=torch.Size((R, D)), stride=(D, 1))


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
