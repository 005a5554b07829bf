"""Shared pytree path utilities, without JAX.

Own counterpart of ``ray_dynamic_batching_tpu/utils/pytree.py``, which
flattens through ``jax.tree_util.tree_flatten_with_path``. Here the walk is
written out for the containers a params or train-state tree holds, in the
order JAX flattens them, so the keys of a checkpoint written by either
package are the same strings in the same order:

- a mapping: its keys sorted, the key itself in the path;
- a namedtuple (optax's ``ScaleByAdamState``, ``EmptyState``): its fields
  in order, each as ``.<field>`` in the path (JAX's ``GetAttrKey``);
- a list or tuple: its items by index;
- ``None``: an empty node (no leaf);
- anything else (a tensor, a numpy array, a Python number): a leaf.

:func:`treedef_str` renders the structure as ``str(jax.tree_util.
tree_structure(tree))`` does, for the checkpoint manifest's ``treedef``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, List, Tuple


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any):
    """(key, child) pairs of a container node, or None for a leaf."""
    if isinstance(node, Mapping):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _walk(node: Any, prefix: Tuple) -> Iterator[Tuple[Tuple, Any]]:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        yield prefix, node
        return
    for key, child in kids:
        yield from _walk(child, prefix + (key,))


def path_str(path) -> str:
    """'/'-joined key path (the keys of :func:`flatten_with_paths`)."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def flatten_with_paths(tree: Any) -> Dict[str, Any]:
    """Ordered {path_str: leaf} (flatten order); raises on key collisions
    (e.g. {'a': {'b': ...}, 'a/b': ...} both stringify to 'a/b' — silent
    merging would corrupt checkpoints)."""
    out: Dict[str, Any] = {}
    for path, leaf in _walk(tree, ()):
        key = path_str(path)
        if key in out:
            raise ValueError(
                f"pytree path collision: two leaves stringify to {key!r}"
            )
        out[key] = leaf
    return out


def unflatten_like(target: Any, leaves: List[Any]) -> Any:
    """``target``'s structure with its leaves replaced, in flatten order
    (``jax.tree_util.tree_unflatten(tree_structure(target), leaves)``)."""
    it = iter(leaves)

    def rebuild(node: Any) -> Any:
        if node is None:
            return None
        if isinstance(node, Mapping):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [rebuild(c) for c in node]
        if _is_namedtuple(node):
            return type(node)(*(rebuild(c) for c in node))
        if isinstance(node, tuple):
            return tuple(rebuild(c) for c in node)
        return next(it)

    return rebuild(target)


def nest_paths(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dicts from '/'-joined keys (``{"a/b": x}`` -> ``{"a": {"b":
    x}}``): a flax tree from its leaves' paths."""
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        *parents, last = key.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def treedef_str(tree: Any) -> str:
    """The structure as JAX prints a ``PyTreeDef``: ``*`` for a leaf,
    ``None``, ``{'k': ...}`` with sorted keys, ``[...]``, ``(...)`` and a
    namedtuple as ``CustomNode(namedtuple[Name], [...])``."""

    def render(node: Any) -> str:
        if node is None:
            return "None"
        if isinstance(node, Mapping):
            return "{" + ", ".join(f"{k!r}: {render(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(render(c) for c in node) + "]"
        if _is_namedtuple(node):
            inner = ", ".join(render(c) for c in node)
            return f"CustomNode(namedtuple[{type(node).__name__}], [{inner}])"
        if isinstance(node, tuple):
            inner = ", ".join(render(c) for c in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({render(tree)})"
