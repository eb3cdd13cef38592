"""Parameter trees: nested dicts, lists and tuples whose leaves are tensors
(the JAX package's pytree layout).  ``leaves`` orders them as
``jax.tree.leaves`` does (dict keys sorted), so a list of per-leaf values
lines up with the JAX package's flattening of the same tree."""
from __future__ import annotations

from typing import Any, Callable, List

# elements of one slice of a leaf (128 MiB in float32): bounds the
# temporaries of elementwise work over a stacked-layer leaf
SLICE_ELEMS = 1 << 25


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


def leaf_slices(t, max_elems: int = SLICE_ELEMS):
    """Views of ``t`` along its leading (stacked-layer) dim, each of at most
    ``max_elems`` elements, or one row where a row is larger; a tensor of
    fewer than two dims is one slice.  Tensors of one shape slice alike."""
    if t.dim() < 2:
        return (t,)
    return t.split(max(1, max_elems // max(1, t[0].numel())))
