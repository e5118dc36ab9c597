"""Tree helpers shared by the train, serve and checkpoint layers.

A tree is nested dicts, tuples and lists whose leaves are tensors (or
numpy arrays, or anything with ``shape`` and ``dtype``); ``None`` is an
empty subtree, as in ``jax.tree_util``.  Leaves are visited in the JAX
package's order — dict keys sorted, sequences by index — and a leaf's
path is the one ``repro.utils.tree.flatten_with_paths`` gives it,
letter for letter (``0/seg0/b0/attn/wq/w``, ``1/step``), so a
checkpoint written by either package names its leaves alike.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch


def _children(node: Any) -> Iterator[Tuple[str, Any]]:
    if isinstance(node, dict):
        for k in sorted(node):
            yield str(k), node[k]
    else:
        for i, v in enumerate(node):
            yield str(i), v


def _is_node(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple))


def _walk(tree: Any, prefix: Tuple[str, ...]) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if tree is None:
        return
    if _is_node(tree):
        for name, child in _children(tree):
            yield from _walk(child, prefix + (name,))
    else:
        yield prefix, tree


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves, in the JAX package's order."""
    return [leaf for _, leaf in _walk(tree, ())]


def flatten_with_paths(tree: Any) -> Dict[str, Any]:
    """``{'a/b/0': leaf}``, in the JAX package's order."""
    return {"/".join(path): leaf for path, leaf in _walk(tree, ())}


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); keeps the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def unflatten_like(tree_like: Any, flat: Dict[str, Any]) -> Any:
    """The inverse of :func:`flatten_with_paths`: the structure of
    ``tree_like`` with each leaf taken from ``flat`` by its path."""

    def build(node: Any, prefix: Tuple[str, ...]) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (str(i),)) for i, v in enumerate(node))
        return flat["/".join(prefix)]

    return build(tree_like, ())


def _itemsize(dtype: Any) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def tree_size_bytes(tree: Any) -> int:
    """Total bytes of all array leaves (meta tensors count their shape)."""
    return sum(
        int(np.prod(leaf.shape, dtype=np.int64)) * _itemsize(leaf.dtype)
        for leaf in tree_leaves(tree)
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype")
    )


def tree_param_count(tree: Any) -> int:
    return sum(
        int(np.prod(leaf.shape, dtype=np.int64))
        for leaf in tree_leaves(tree)
        if hasattr(leaf, "shape")
    )


def flatten_up_to(structure: Any, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``structure``, in
    its leaf order (``treedef.flatten_up_to`` of the JAX package): the
    Adafactor state's ``{"row", "col"}`` beside each parameter."""
    if structure is None:
        return []
    if _is_node(structure):
        out: List[Any] = []
        for name, child in _children(structure):
            sub = tree[name] if isinstance(structure, dict) else tree[int(name)]
            out.extend(flatten_up_to(child, sub))
        return out
    return [tree]
