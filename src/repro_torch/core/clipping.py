"""Per-example gradient clipping (Algorithm 1 lines 22–23 / 35).
Counterpart of ``repro/core/clipping.py``."""
from __future__ import annotations

import torch


def clip_factors(norm_sq: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """c_i = min(1, C / n_i), computed as C / max(n_i, C) (no div-by-zero)."""
    n = torch.sqrt(torch.clamp(norm_sq, min=0.0))
    return clip_norm / torch.clamp(n, min=clip_norm)
