"""Gradient compression for the slow cross-pod link: blockwise-absmax int8
with error feedback.  Counterpart of ``repro/dist/compress.py``.

The noised gradient is the only tensor that would cross the pod boundary a
step, and it already carries Gaussian noise of scale σ·C: a quantization
error far below that is free.  Error feedback carries the residual ``t -
dequantize(quantize(t))`` into the next step, so the cumulative signal
sent converges to the cumulative true one.  The residual rides in the
optimizer state (train/trainer.py), so a checkpoint keeps it.

Compression runs strictly after clip and noise, on the all-reduced noised
gradient, identically on every rank: it is post-processing, and the
privacy guarantee is untouched.  The codec's blocks run over the whole
flattened leaf, as the 8-bit optimizer's (optim/optimizers.py), so every
rank keeps the whole residual of every leaf.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch import tree
from repro_torch.optim.optimizers import _dequantize, _quantize_into, n_blocks

F32 = torch.float32
BLOCK = 256  # quantization block (the 8-bit optimizer's granularity)


def init_error_state(params):
    """Zero error-feedback residuals, one float32 tensor a param (a tree or
    a list of leaves, kept as given)."""
    return tree.tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                               device=p.device), params)


def _compress_leaf(g: torch.Tensor, err: torch.Tensor,
                   block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    t = g.to(F32) + err
    nb = n_blocks(t.numel(), block)
    q = torch.empty((nb, block), dtype=torch.int8, device=t.device)
    s = torch.empty((nb,), dtype=F32, device=t.device)
    _quantize_into(t.reshape(-1), q, s)
    deq = _dequantize(q, s, t.numel()).reshape(t.shape)
    return deq, t - deq


def compress_grads(grads: List[torch.Tensor], err_state: List[torch.Tensor],
                   block: int = BLOCK):
    """(gradients, residuals) -> (dequantized gradients, new residuals),
    lists aligned leaf by leaf.  Each leaf is quantized to blockwise-absmax
    int8 after the carried residual is added; what the optimizer sees is
    the dequantized value (the int8 payload and a float32 scale a block is
    what would cross the wire: about 1.02 bytes an element for 4)."""
    outs = [_compress_leaf(g, e, block) for g, e in zip(grads, err_state)]
    return [o[0] for o in outs], [o[1] for o in outs]
