"""Gaussian noise addition (Algorithm 1 line 24 / 41).  Counterpart of
``repro/core/noise.py``.

The noise is drawn from an explicit ``torch.Generator`` on the gradients'
device, which the trainer seeds from (seed, step): a retried step draws the
same noise.  Its bits differ from the JAX package's threefry draws for the
same seed; tests compare the two at σ = 0.

Under FSDP a rank holds one slice of a sharded leaf's gradient, and draws
the noise of that slice only, from ``shard_generator``: keyed by the
step's generator (seed, step) and the slice's index on the ``data`` axis,
so the ranks' slices get independent draws and no rank draws a whole
leaf.  Its bits differ from a world of one's by design.  A tensor-parallel
model slice's noise alike, keyed by the slice's index on the ``model``
axis: the data ranks that hold one slice add the same noise to it, so
their replicas stay equal; a pipeline stage's blocks alike, keyed by the
stage index.
"""
from __future__ import annotations

import zlib
from typing import List, Optional, Sequence

import torch


def shard_generator(generator: torch.Generator, index: int,
                    axis: str = "data") -> torch.Generator:
    """The generator of the noise of this rank's slices: seeded from
    ``generator``'s seed (the step's) and the slice index ``index`` on the
    mesh axis ``axis`` (``"data"``: FSDP slices; ``"model"``: model
    slices; ``"stage"``: a pipeline stage's blocks), on its device;
    ``generator`` is not advanced."""
    g = torch.Generator(device=generator.device)
    tag = "shard" if axis == "data" else axis
    # 32 bits: the CPU generator keeps only the low 32 bits of a seed
    g.manual_seed(zlib.crc32(f"{generator.initial_seed()}:{tag}{index}".encode()))
    return g


def add_noise_(grads: List[torch.Tensor], generator: torch.Generator,
               noise_multiplier: float, clip_norm: float, denom,
               local_generator: Optional[torch.Generator] = None,
               local: Sequence[int] = ()) -> None:
    """In place on float32 ``grads``: g ← (g + N(0, σ²C²I)) / denom.

    In place, unlike the JAX package's functional version: the summed f32
    gradients are the step's largest buffer after the optimizer state, and
    the update needs no second copy of them.  ``denom`` is the physical
    batch size for fixed-size batches and the expected batch q·N under
    Poisson sampling: a Python number, never a function of the realized
    sample.  ``local``: the indices of the grads that are this rank's FSDP
    or model slices, whose noise ``local_generator`` draws
    (``shard_generator``);
    the others' comes from ``generator``, in order."""
    std = noise_multiplier * clip_norm
    local = set(local)
    for i, g in enumerate(grads):
        if g.dtype != torch.float32:
            raise TypeError(f"add_noise_: want float32 grads, got {g.dtype}")
        if noise_multiplier > 0.0:
            gen = local_generator if i in local else generator
            g.add_(torch.randn(g.shape, generator=gen, dtype=torch.float32,
                               device=g.device), alpha=std)
        g.div_(denom)
