"""Per-example gradient clipping (Algorithm 1 lines 22–23 / 35).
Counterpart of ``repro/core/clipping.py``."""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch import tree

F32 = torch.float32
# a flat buffer's rows are padded to a multiple of this many elements: 16
# bytes in bf16, so every row of a (rows, N) buffer starts 16-byte aligned
# and clip_reduce can take its 16-byte path
ROW_ALIGN = 8


def clip_factors(norm_sq: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """c_i = min(1, C / n_i), computed as C / max(n_i, C) (no div-by-zero)."""
    n = torch.sqrt(torch.clamp(norm_sq, min=0.0))
    return clip_norm / torch.clamp(n, min=clip_norm)


def _blocks(g2: torch.Tensor, max_elems: int):
    """``(rows, n)`` -> (row slice, column slice) blocks of at most
    ``max_elems`` elements: whole rows where ``max_elems`` holds one,
    otherwise column slices of one row."""
    B, n = g2.shape
    if n <= max_elems:
        rows = max(1, max_elems // max(1, n))
        return [(slice(r, r + rows), slice(None)) for r in range(0, B, rows)]
    return [(slice(b, b + 1), slice(c, c + max_elems))
            for b in range(B) for c in range(0, n, max_elems)]


def tree_per_example_norm_sq(grads_b: List[torch.Tensor],
                             max_elems: int = tree.SLICE_ELEMS) -> torch.Tensor:
    """Per-example squared L2 norm over per-example gradients ``(B, ...)``
    (leaves, or ``flat_stacks``' buffers of them): (B,) float32, the
    squares summed in float32, a block of at most ``max_elems`` elements at
    a time (``_blocks``), so that is the float32 copy's size."""
    B = grads_b[0].shape[0]
    nsq = torch.zeros((B,), dtype=F32, device=grads_b[0].device)
    for g in grads_b:
        g2 = g.reshape(B, -1)
        for r, c in _blocks(g2, max_elems):
            nsq[r] += torch.sum(torch.square(g2[r, c].to(F32)), dim=1)
    return nsq


def flat_stacks(leaves: List[torch.Tensor], rows: int):
    """Vanilla DP-SGD's microbatch buffers, one per parameter dtype (in the
    order of the dtypes' first leaves): ``bufs``, ``(rows, N)`` per-example
    gradients, each row an example's leaves end to end, N padded with zero
    columns to a multiple of ``ROW_ALIGN`` elements (so every row starts
    16-byte aligned); ``sums``, their ``(N,)`` float32 running sums (zeros).
    Also, aligned with ``leaves``, each leaf's ``(rows, *shape)`` view of its
    buffer and its ``shape`` view of its sum.  The buffers hold the bytes of
    one ``(rows, *shape)`` stack a leaf (and the padding); ``clip_and_sum``
    reduces each buffer in one ``clip_reduce`` launch."""
    groups = {}
    for i, p in enumerate(leaves):
        groups.setdefault(p.dtype, []).append(i)
    bufs, sums = [], []
    stacks, summed = [None] * len(leaves), [None] * len(leaves)
    for dtype, idx in groups.items():
        device = leaves[idx[0]].device
        n = sum(leaves[i].numel() for i in idx)
        buf = torch.empty((rows, -(-n // ROW_ALIGN) * ROW_ALIGN), dtype=dtype,
                          device=device)
        buf[:, n:].zero_()          # the padding adds nothing to a norm² or sum
        acc = torch.zeros((buf.shape[1],), dtype=F32, device=device)
        off = 0
        for i in idx:
            shape, k = tuple(leaves[i].shape), leaves[i].numel()
            stacks[i] = buf[:, off:off + k].view((rows,) + shape)
            summed[i] = acc[off:off + k].view(shape)
            off += k
        bufs.append(buf)
        sums.append(acc)
    return bufs, sums, stacks, summed


def clip_and_sum(grads_b: List[torch.Tensor], clip_norm: float,
                 out: List[torch.Tensor], mask: Optional[torch.Tensor] = None,
                 use_kernels: bool = False,
                 max_elems: int = tree.SLICE_ELEMS) -> torch.Tensor:
    """Vanilla DP-SGD's post-processing: per-example norms -> clip ->
    reduce.  ``grads_b``: per-example gradients ``(B, ...)``, as leaves or
    as ``flat_stacks``' buffers; ``out``: float32 running sums shaped as
    their rows, into which each Σ_b c_b·g_b is added in place, so no second
    float32 copy of the gradients exists; ``mask``: optional (B,) 0/1
    validity weights (Poisson-padded batches), whose zero rows get clip
    factor 0 and add nothing to the sum.  Returns the per-example norms²
    (B,).  The JAX package's ``clip_and_sum`` returns the sums instead.

    With ``use_kernels`` each of ``grads_b`` is one ``clip_reduce`` launch
    on its ``(B, numel)`` view, summed in float32 into its ``out``
    (``out=``): one launch per parameter dtype for flat buffers.  The plain
    version sums in the gradients' dtype and casts to float32, as the JAX
    package does, a slice of columns at a time.  The norms' float32 copies
    and the plain version's products take at most ``max_elems`` elements at
    a time."""
    nsq = tree_per_example_norm_sq(grads_b, max_elems)
    c = clip_factors(nsq, clip_norm)
    if mask is not None:
        c = c * mask.to(c.dtype)
    from repro_torch.kernels import ops as kops
    for acc, g in zip(out, grads_b):
        g2, a1 = g.reshape(g.shape[0], -1), acc.view(-1)
        if use_kernels:
            kops.clip_reduce(g2, c, out=a1)
        else:
            cb = c.reshape(-1, 1).to(g.dtype)
            cols = max(1, max_elems // g2.shape[0])
            for s, o in zip(g2.split(cols, dim=1), a1.split(cols)):
                o.add_(torch.sum(s * cb, dim=0).to(F32))
    return nsq
