"""Trees of tensors: the params' nested dicts and per-layer lists, and
tuples and NamedTuples of them (a train state is ``(params,
AdamWState)``).  ``None`` is an absent leaf (a non-parametric norm's
weight), as it is an empty subtree in JAX.  Dict keys are walked in
sorted order, as JAX flattens a dict."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch

Path = Tuple[str, ...]


def _children(node) -> Iterator[Tuple[str, Any]]:
    if isinstance(node, dict):
        return ((str(k), node[k]) for k in sorted(node))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return ((f, getattr(node, f)) for f in node._fields)
    return ((str(i), v) for i, v in enumerate(node))


def _is_node(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def leaves_with_path(tree: Any, prefix: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """(path, leaf) of every tensor in ``tree``, in a fixed order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += leaves_with_path(child, prefix + (key,))
    return out


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def path_key(path: Path) -> str:
    """A leaf's path as one string, e.g. ``1/mu/blocks/0/attn/wq``."""
    return "/".join(path)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       prefix: Path = ()) -> Any:
    """``tree_map`` with each leaf's path as ``fn``'s first argument."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      prefix=prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f),
                                               *(getattr(r, f) for r in rest),
                                               prefix=prefix + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                             prefix=prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree, *rest)


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with ``leaves`` in ``leaves_with_path``'s
    order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if not _is_node(node):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        return type(node)(build(v) for v in node)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
