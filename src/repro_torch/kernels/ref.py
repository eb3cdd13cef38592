"""Plain PyTorch versions of the port's kernels: the oracle the CPU tests
hold the port to, the path every wrapper takes for a CPU tensor, and what
the CUDA kernels are compared with on the card.  Counterpart of
``repro/kernels/ref.py``."""
from __future__ import annotations

import math

import torch

NEG = -1e30


def flash_attn_ref(q, k, v, causal: bool = True):
    """Plain softmax attention. q: (B,T,KV,rep,hd); k/v: (B,S,KV,hd)."""
    B, T, KV, rep, hd = q.shape
    S = k.shape[1]
    s = torch.einsum("btkrh,bskh->bkrts", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(S, device=q.device)[None, :]
                <= torch.arange(T, device=q.device)[:, None])
        s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkrts,bskh->btkrh", p.to(v.dtype), v)


def flash_attn_fwd_ref(q, k, v, causal: bool = True, rep: int = 1):
    """The flash kernel's function in its flattened layout.

    q: (BH, T, hd); k/v: (BH // rep, S, hd), query row b reads kv row
    b // rep.  Returns (o (BH,T,hd) in q's dtype, lse (BH,T) float32), with
    the kernel's conventions: scale 1/sqrt(hd), masked logits -1e30 (keys
    past S never exist here; causal keeps kpos <= qpos, aligned at 0), the
    row sum floored at 1e-30 and p cast to v's dtype before P·V."""
    BH, T, hd = q.shape
    S = k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=0)
    vv = v.repeat_interleave(rep, dim=0)
    s = torch.matmul(q.float(), kf.transpose(1, 2)) * (1.0 / math.sqrt(hd))
    if causal:
        mask = (torch.arange(S, device=q.device)[None, :]
                <= torch.arange(T, device=q.device)[:, None])
        s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), vv.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse
