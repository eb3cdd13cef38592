"""Layout shims between the model's attention layout and the kernels'.
Counterpart of ``repro/kernels/ops.py`` ``flash_attention``.

Forward only: the port's flash backward is the training slice's work, so a
call that would need a gradient raises instead of silently detaching.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attn as _fa


def flash_attention(q, k, v, causal: bool = True):
    """q: (B,T,KV,rep,hd); k/v: (B,S,KV,hd) -> o: (B,T,KV,rep,hd).
    Flattened as in the JAX shim, query-head major within a kv head, so the
    kernel's kv row is ``bh // rep``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention backward is not ported yet (ROADMAP queue 2, "
            "flash_attn_bwd); call under torch.no_grad()")
    B, T, KV, rep, hd = q.shape
    S = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * KV * rep, T, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * KV, S, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * KV, S, hd).contiguous()
    o, _ = _fa.flash_attn_fwd(qf, kf, vf, causal=causal, rep=rep)
    return o.reshape(B, KV, rep, T, hd).permute(0, 3, 1, 2, 4)
