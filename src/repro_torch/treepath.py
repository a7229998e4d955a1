"""Trees of tensors, walked as ``jax.tree_util`` walks them.

The port's copy of what the training side needs of ``repro.sharding``:
``keystr_simple``, the ``/``-joined name of a leaf's path, which keys
checkpoints and optimizer state (``params/layers/attn/wq``,
``opt/m/layers/mlp/w_up``).  A tree is nested dicts (walked in sorted key
order, as JAX sorts them), lists, tuples and NamedTuples (field names name
their children); ``None`` is an empty subtree; anything else is a leaf.
Leaf order is JAX's, so reductions over leaves (``global_norm``) add in
the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(node) -> List[Tuple[Any, Any]]:
    """(key, child) pairs of an inner node, in JAX's order."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    return list(enumerate(node))


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _child(node, key):
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return getattr(node, key)
    return node[key]


def keystr_simple(path) -> str:
    """The ``/``-separated name of a tree path (a sequence of keys)."""
    return "/".join(str(p) for p in path)


# The walks are module-level functions: a nested function that calls itself
# is a reference cycle (it holds itself through its closure), which keeps
# what the closure holds, leaves included, alive until the collector runs.
def _flatten(node, path, out: list) -> None:
    if node is None:
        return
    if _is_node(node):
        for k, child in _children(node):
            _flatten(child, path + (k,), out)
    else:
        out.append((path, node))


def flatten_with_path(tree) -> List[Tuple[tuple, Any]]:
    """[(path, leaf)] in JAX's leaf order."""
    out = []
    _flatten(tree, (), out)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _map(fn: Callable, node, others: list, path: tuple):
    if node is None:
        return None
    if not _is_node(node):
        return fn(path, node, *others)
    kids = [_map(fn, child, [_child(o, k) for o in others], path + (k,))
            for k, child in _children(node)]
    if isinstance(node, dict):
        return {k: v for (k, _), v in zip(_children(node), kids)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*kids)
    return type(node)(kids)


def tree_map_with_path(fn: Callable, tree, *rest):
    """A tree of ``tree``'s structure holding ``fn(path, leaf, *others)``,
    where ``others`` are the leaves at the same path of ``rest``."""
    return _map(fn, tree, list(rest), ())


def tree_map(fn: Callable, tree, *rest):
    """``fn`` of the leaves at each path of ``tree`` and ``rest``."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_unzip(fn: Callable, n: int, tree, *rest) -> tuple:
    """``n`` trees of ``tree``'s structure from an ``fn`` that returns an
    ``n``-tuple at each path."""
    outs = []
    index = tree_map(lambda *leaves: outs.append(fn(*leaves)) or
                     len(outs) - 1, tree, *rest)
    return tuple(tree_map(lambda i, j=j: outs[i][j], index)
                 for j in range(n))
