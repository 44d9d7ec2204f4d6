"""Tree helpers: path names, sizes and bytes over nested state.

Counterpart of ``repro.utils.pytree``. A tree is nested dicts, lists and
tuples, and dataclasses (the optimizer's encoded moments, the comm
error-feedback state) whose tensor fields are its children; its leaves are
tensors, numpy arrays and numpy or Python scalars. ``None`` is an empty
subtree, as in JAX.

Names follow ``jax.tree_util``'s flatten order and path strings letter for
letter, so a checkpoint's manifest names a leaf as the reference names the
leaf of a tree with the same keys: dict keys in sorted order, list and
tuple items by index, a dataclass field as ``.field`` (its tensor fields in
declaration order; the static fields, such as a codec's ``shape`` and
``dtype``, are not children), joined with ``/``:

    {"opt": {"mu": {"fc0_w": RowQuant8(q, scale, ...)}, "step": 3}}
        -> ["opt/mu/fc0_w/.q", "opt/mu/fc0_w/.scale", "opt/step"]
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

__all__ = ["flatten_with_names", "leaves", "map_leaves", "tree_bytes",
           "tree_size"]


def _is_leaf(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float))


def _children(node: Any) -> List[Tuple[str, Any]]:
    """(path part, child) pairs of a container, in flatten order."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [("." + f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)
                if isinstance(getattr(node, f.name),
                              (torch.Tensor, np.ndarray))]
    raise TypeError(f"not a tree node or leaf: {type(node).__name__}")


def flatten_with_names(tree: Any) -> List[Tuple[str, Any]]:
    """Flatten to [(path string, leaf)] in the reference's order."""
    out: List[Tuple[str, Any]] = []

    def walk(prefix: str, node: Any) -> None:
        if node is None:
            return
        if _is_leaf(node):
            out.append((prefix, node))
            return
        for part, child in _children(node):
            walk(f"{prefix}/{part}" if prefix else part, child)

    walk("", tree)
    return out


def leaves(tree: Any) -> List[Any]:
    """The leaves in flatten order."""
    return [leaf for _, leaf in flatten_with_names(tree)]


def map_leaves(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """The tree with every leaf replaced by ``fn(name, leaf)``: dicts,
    lists and tuples rebuilt, dataclasses through ``dataclasses.replace``
    (their static fields kept)."""
    def walk(prefix: str, node: Any) -> Any:
        if node is None:
            return None
        if _is_leaf(node):
            return fn(prefix, node)
        new = {part: walk(f"{prefix}/{part}" if prefix else part, child)
               for part, child in _children(node)}
        if isinstance(node, dict):
            return {k: new[str(k)] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(new[str(i)] for i in range(len(node)))
        return dataclasses.replace(
            node, **{part[1:]: v for part, v in new.items()})

    return walk("", tree)


def _shape(x: Any) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else ()


def _itemsize(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.element_size()
    if isinstance(x, (np.ndarray, np.generic)):
        return x.dtype.itemsize
    return np.asarray(x).dtype.itemsize


def tree_size(tree: Any) -> int:
    """Total number of elements across all leaves."""
    return sum(math.prod(_shape(x)) for x in leaves(tree))


def tree_bytes(tree: Any) -> int:
    """Total bytes across all leaves (each at its dtype's item size)."""
    return sum(math.prod(_shape(x)) * _itemsize(x) for x in leaves(tree))
