"""On-device token sampling for the serving engine.  Counterpart of
``repro/serve/sampling.py``.

Batched over slots with per-slot temperatures: greedy slots (temperature
<= 0) take the argmax, stochastic slots the Gumbel-max trick, drawn from an
explicit ``torch.Generator`` in place of the JAX key.  The two generators
give different bits from the same seed, so only greedy streams compare
across the packages.  The padded vocab tail is masked to -inf so it can
never be sampled.
"""
from __future__ import annotations

import torch


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """(..., Vpad) logits -> float32 logits with columns >= vocab at -inf."""
    lg = logits.float()
    if lg.shape[-1] == vocab:
        return lg
    col = torch.arange(lg.shape[-1], device=lg.device)
    return torch.where(col < vocab, lg, float("-inf"))


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor, vocab: int,
                  generator: torch.Generator) -> torch.Tensor:
    """One token per slot.  logits: (B, Vpad); temps: (B,), <= 0 greedy.
    Returns (B,) int32 ids in [0, vocab)."""
    lg = mask_padded_vocab(logits, vocab)
    greedy = torch.argmax(lg, dim=-1)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    # temps <= 0 take the greedy lane; the clamp only keeps the stochastic
    # lane finite for those rows
    safe_t = temps.float().clamp_min(1e-6)[:, None]
    stochastic = torch.argmax(lg / safe_t + gumbel, dim=-1)
    return torch.where(temps > 0.0, stochastic, greedy).to(torch.int32)
