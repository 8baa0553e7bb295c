"""Atomic checkpointing of a train state (no dependency beyond numpy).

Port of ``repro.training.checkpoint``, with the same layout:

    <dir>/step_<N>/
        manifest.json   step, cursor, the leaves' keys, raw dtypes
        arrays.npz      the leaves, keyed by their path in the tree
    <dir>/LATEST        atomic pointer (write tmp + os.replace)

A leaf's key is its path in the port's tree (``training/tree.py``), e.g.
``1/mu/blocks/0/attn/wq``.  bf16 has no numpy dtype: a bf16 leaf is
stored as its raw bits (uint16) with its dtype and shape recorded in the
manifest's ``raw_dtypes``, without ml_dtypes.  ``restore`` loads the
leaves on the host and puts each on the device (and in the dtype) of the
matching leaf of ``like``; a leaf of ``like`` that requires grad comes
back requiring grad.  Keep-last-k garbage collection.

A sharded state (DTensor leaves) is saved as full tensors: every rank
gathers each leaf (``full_tensor()``, a collective), rank 0 writes, and
the ranks meet at a barrier.  ``restore(..., shardings=)`` lays each
leaf out again, ``distribute_tensor(full, mesh, placements)``, on the
current mesh: a checkpoint taken on one layout restores on another (the
elastic path).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _dtensor as _dt
from repro_torch.training.tree import leaves_with_path, path_key, tree_unflatten


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, dict]]:
    flat, raw = {}, {}
    for path, leaf in leaves_with_path(tree):
        key = path_key(path)
        if _dt.is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            raw[key] = {"dtype": "bfloat16", "shape": list(t.shape)}
            flat[key] = t.contiguous().view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    return flat, raw


def save(ckpt_dir: str, step: int, tree: Any, *, cursor: Optional[dict] = None,
         keep: int = 3) -> str:
    """Atomically save a train state. Returns the step dir.  A state with
    DTensor leaves is gathered on every rank and written by rank 0."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat, raw = _flatten(tree)
    sharded = any(_dt.is_dtensor(t) for _, t in leaves_with_path(tree))
    if sharded and torch.distributed.get_rank() != 0:
        torch.distributed.barrier()     # rank 0 is writing
        return final
    try:
        _write(ckpt_dir, final, step, flat, raw, cursor, keep)
    finally:
        if sharded:
            torch.distributed.barrier()
    return final


def _write(ckpt_dir, final, step, flat, raw, cursor, keep) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "cursor": cursor or {},
        "keys": sorted(flat.keys()),
        "raw_dtypes": raw,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)

    # atomic LATEST pointer
    ptr_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))

    _gc(ckpt_dir, keep)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def _layouts(like: Any, shardings: Any) -> List[Any]:
    """One (mesh, placements) or None per leaf of ``like``: ``shardings``
    is a tree shaped like ``like`` whose leaves are ``Layout``s (as
    ``launch/sharding.py`` plans them) or (mesh, placements) pairs;
    without it, a DTensor leaf of ``like`` keeps its own layout."""
    if shardings is None:
        return [(t.device_mesh, tuple(t.placements)) if _dt.is_dtensor(t) else None
                for _, t in leaves_with_path(like)]
    out = []

    def walk(node, sh):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], sh[k])
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f in node._fields:
                walk(getattr(node, f), getattr(sh, f))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, sh[i])
        elif hasattr(sh, "placements"):
            out.append((sh.mesh, tuple(sh.placements)))
        else:
            out.append((sh[0], tuple(sh[1])))
    walk(like, shardings)
    return out


def restore(ckpt_dir: str, like: Any, *, step: Optional[int] = None,
            shardings: Any = None) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (a train state of tensors):
    new tensors on ``like``'s devices, in its dtypes.  ``shardings`` (a
    tree like ``like`` of ``Layout``s or (mesh, placements) pairs, as
    ``launch/sharding.py``'s ``params_shardings`` and
    ``opt_state_shardings`` give) lays each leaf out on its mesh with
    ``distribute_tensor`` -- the elastic path; without it a DTensor leaf
    of ``like`` takes ``like``'s layout.  Returns (tree, manifest)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    raw = manifest.get("raw_dtypes", {})
    layouts = _layouts(like, shardings)
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        for (path, leaf), layout in zip(leaves_with_path(like), layouts):
            key = path_key(path)
            arr = arrays[key]
            if key in raw:
                if raw[key]["dtype"] != "bfloat16":
                    raise ValueError(f"{key}: unknown raw dtype {raw[key]['dtype']}")
                t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
                t = t.reshape(raw[key]["shape"])
            else:
                t = torch.from_numpy(arr.copy())
            t = t.to(device=leaf.device, dtype=leaf.dtype)
            if layout is not None:
                from torch.distributed.tensor import distribute_tensor
                t = distribute_tensor(t, layout[0], list(layout[1]))
            if leaf.requires_grad:
                t.requires_grad_(True)
            out.append(t)
    return tree_unflatten(like, out), manifest
