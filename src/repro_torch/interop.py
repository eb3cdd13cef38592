"""Parameter trees between the two packages, through numpy.

The JAX package's params are a pytree of dicts, lists and tuples whose
leaves are arrays; the test side turns it into numpy with
``jax.tree.map(np.asarray, params)``.  ``params_from_numpy`` rebuilds the
same nesting with torch tensors in the same layouts, which is the form
``repro_torch.models.transformer.Model`` takes.  ``params_to_numpy`` is the
way back (bf16 leaves come back as float32: numpy has no bf16).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_numpy(tree, device, dtype=None):
    """numpy leaves -> torch tensors on ``device``.  ``dtype`` casts the
    floating leaves (None keeps each leaf's own type)."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":      # ml_dtypes bf16 from jax
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))    # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """torch leaves -> numpy arrays on the host."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(leaf, tree)
