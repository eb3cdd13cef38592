"""Gaussian noise addition (Algorithm 1 line 24 / 41).  Counterpart of
``repro/core/noise.py``.

The noise is drawn from an explicit ``torch.Generator`` on the gradients'
device, which the trainer seeds from (seed, step): a retried step draws the
same noise.  Its bits differ from the JAX package's threefry draws for the
same seed; tests compare the two at σ = 0.
"""
from __future__ import annotations

from typing import List

import torch


def add_noise_(grads: List[torch.Tensor], generator: torch.Generator,
               noise_multiplier: float, clip_norm: float, denom) -> None:
    """In place on float32 ``grads``: g ← (g + N(0, σ²C²I)) / denom.

    In place, unlike the JAX package's functional version: the summed f32
    gradients are the step's largest buffer after the optimizer state, and
    the update needs no second copy of them.  ``denom`` is the physical
    batch size for fixed-size batches and the expected batch q·N under
    Poisson sampling: a Python number, never a function of the realized
    sample."""
    std = noise_multiplier * clip_norm
    for g in grads:
        if g.dtype != torch.float32:
            raise TypeError(f"add_noise_: want float32 grads, got {g.dtype}")
        if noise_multiplier > 0.0:
            g.add_(torch.randn(g.shape, generator=generator, dtype=torch.float32,
                               device=g.device), alpha=std)
        g.div_(denom)
