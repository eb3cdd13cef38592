"""Quantile-based adaptive clip norm (Andrew et al. 2021).  Counterpart of
``repro/core/adaptive_clip.py``.

Each step privately estimates the fraction b̃ of the examples whose
per-example gradient norm is at most the current clip norm C, then moves C
geometrically toward the configured quantile γ:

    b̃   = (Σᵢ mᵢ·1[nᵢ ≤ C]  +  N(0, σ_b²)) / expected_batch
    C'  = C · exp(−η · (b̃ − γ))

The count has sensitivity 1, so it is a Poisson-subsampled Gaussian
mechanism with noise multiplier σ_b (``DPConfig.clip_count_noise``) at the
gradient mechanism's sampling rate; ``mechanism`` is the accountant entry
the trainer composes.  The norms it reads are the ones the algorithm
already made; the division is by the expected batch, never the realized
one.  The state is one float32 scalar, which the trainer carries in the
optimizer state as ``{"opt": ..., "clip": {"clip_norm": C}}``, so a
checkpoint restores the clip trajectory.  The noise comes from an explicit
``torch.Generator``: its bits differ from the JAX package's threefry draw,
so tests compare the two at σ_b = 0 or with the draw injected.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.accountant import Mechanism

# the optimizer-state key the trainer stores the clip state under
CLIP_STATE_KEY = "clip"


def init_state(dp, device=None) -> dict:
    """The initial clip state: C = ``dp.clip_norm`` as a float32 scalar."""
    return {"clip_norm": torch.tensor(dp.clip_norm, dtype=torch.float32,
                                      device=device)}


def noisy_fraction_below(nsq: torch.Tensor, mask: torch.Tensor, clip_norm,
                         count_noise: float, expected_batch: float,
                         generator: Optional[torch.Generator] = None,
                         draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The privatised fraction of real examples with norm <= C.

    ``nsq``/``mask``: (B,) per-example squared norms and 0/1 validity
    (padded Poisson rows are excluded by the mask).  The noise is
    ``count_noise`` times one standard normal from ``generator``, or
    ``draw`` where given (tests inject the JAX package's draw).
    ``expected_batch`` is q·N: a division by the realized count would leak
    it."""
    n = torch.sqrt(torch.clamp(nsq, min=0.0))
    below = torch.sum(mask * (n <= clip_norm).float())
    if draw is None:
        draw = torch.randn((), generator=generator, dtype=torch.float32,
                           device=nsq.device)
    return (below + float(count_noise) * draw) / float(expected_batch)


def updated_clip(clip_norm, frac_below, quantile: float, lr: float):
    """The geometric quantile step C' = C·exp(−η(b̃ − γ)): multiplicative,
    so C stays positive whatever the noise."""
    return clip_norm * torch.exp(-float(lr) * (frac_below - float(quantile)))


def update(state: dict, nsq: torch.Tensor, mask: torch.Tensor, dp,
           expected_batch: float, generator: Optional[torch.Generator] = None,
           draw: Optional[torch.Tensor] = None):
    """One adaptive-clip step: (new state, b̃)."""
    c = state["clip_norm"]
    frac = noisy_fraction_below(nsq, mask, c, dp.clip_count_noise,
                                expected_batch, generator, draw)
    return {"clip_norm": updated_clip(c, frac, dp.clip_quantile,
                                      dp.clip_lr)}, frac


def mechanism(dp, sample_rate: float) -> Mechanism:
    """The accountant entry of the noisy below-C count: sensitivity 1,
    absolute noise σ_b, so noise multiplier σ_b, at the gradient
    mechanism's sampling rate."""
    return Mechanism("clip", float(sample_rate), float(dp.clip_count_noise))
