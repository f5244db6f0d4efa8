"""Nested containers of tensors ("trees"): dicts, lists, tuples and
NamedTuples, walked in JAX's order.

The port's counterpart of the ``jax.tree`` calls the training stack
makes. Leaves are visited as ``jax.tree_util`` visits them: dict keys in
sorted order, sequence items and NamedTuple fields in order, so a sum over
the leaves (the global gradient norm) adds in the reference's order and a
leaf's path ("/"-joined dict keys, indices and field names) is the key the
reference's checkpoints use.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(path key, child) of one container node, in JAX's order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    return [(str(i), x) for i, x in enumerate(tree)]


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def leaves_with_paths(tree) -> List[Tuple[str, Any]]:
    """Every leaf with its "/"-joined path, in JAX's order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if not _is_node(node):
            out.append(("/".join(prefix), node))
            return
        for key, child in _children(node):
            walk(child, prefix + (key,))

    walk(tree, ())
    return out


def leaves(tree) -> List[Any]:
    """The leaves in JAX's order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure; the
    result has ``tree``'s structure (NamedTuples keep their type)."""
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    items = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    if _is_namedtuple(tree):
        return type(tree)(*items)
    return type(tree)(items)


def unflatten_like(tree, new_leaves) -> Any:
    """``tree``'s structure holding ``new_leaves`` (in JAX's leaf order)."""
    it: Iterator = iter(new_leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
