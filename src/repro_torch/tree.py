"""Parameter trees: nested dicts, lists and tuples whose leaves are tensors
(the JAX package's pytree layout).  ``leaves`` orders them as
``jax.tree.leaves`` does (dict keys sorted), so a list of per-leaf values
lines up with the JAX package's flattening of the same tree."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def leaves(tree) -> List[Any]:
    """The leaves in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    if tree is None:
        return []
    return [tree]
