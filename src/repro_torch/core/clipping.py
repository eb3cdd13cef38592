"""Per-example gradient clipping (Algorithm 1 lines 22–23 / 35).
Counterpart of ``repro/core/clipping.py``."""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch import tree

F32 = torch.float32


def clip_factors(norm_sq: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """c_i = min(1, C / n_i), computed as C / max(n_i, C) (no div-by-zero)."""
    n = torch.sqrt(torch.clamp(norm_sq, min=0.0))
    return clip_norm / torch.clamp(n, min=clip_norm)


def tree_per_example_norm_sq(grads_b: List[torch.Tensor]) -> torch.Tensor:
    """Per-example squared L2 norm over per-example gradient leaves
    ``(B, ...)``: (B,) float32, the squares summed in float32.  Each
    example's leaf is taken one slice at a time (``tree.leaf_slices``), so
    the float32 copy is a slice's size, not a stacked leaf's."""
    B = grads_b[0].shape[0]
    nsq = torch.zeros((B,), dtype=F32, device=grads_b[0].device)
    for g in grads_b:
        for b in range(B):
            for s in tree.leaf_slices(g[b]):
                nsq[b] += torch.sum(torch.square(s.to(F32)))
    return nsq


def clip_and_sum(grads_b: List[torch.Tensor], clip_norm: float,
                 out: List[torch.Tensor], mask: Optional[torch.Tensor] = None,
                 use_kernels: bool = False) -> torch.Tensor:
    """Vanilla DP-SGD's post-processing: per-example norms -> clip ->
    reduce.  ``grads_b``: per-example gradient leaves ``(B, ...)``;
    ``mask``: optional (B,) 0/1 validity weights (Poisson-padded batches),
    whose zero rows get clip factor 0 and add nothing to the sum.  Adds
    each leaf's Σ_b c_b·g_b into ``out`` (float32 tensors shaped as the
    leaves) as soon as it is made, so no second float32 copy of the
    gradients exists; returns the per-example norms² (B,).  The JAX
    package's ``clip_and_sum`` returns the sums instead.

    With ``use_kernels`` each leaf's sum is one ``clip_reduce`` launch on
    its ``(B, numel)`` view, summed in float32; the plain version sums in
    the gradients' dtype and casts to float32, as the JAX package does."""
    nsq = tree_per_example_norm_sq(grads_b)
    c = clip_factors(nsq, clip_norm)
    if mask is not None:
        c = c * mask.to(c.dtype)
    for acc, g in zip(out, grads_b):
        if use_kernels:
            from repro_torch.kernels import ops as kops
            acc.add_(kops.clip_reduce(g.reshape(g.shape[0], -1), c)
                     .reshape(g.shape[1:]))
        else:
            cb = c.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)
            acc.add_(torch.sum(g * cb, dim=0).to(F32))
    return nsq
