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


def flash_attn_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                       rep: int = 1):
    """The flash backward kernels' function in their flattened layout:
    (dq, dk, dv) float32 from the saved row logsumexp, with the kernels'
    conventions (``repro/kernels/flash_attn.py`` ``_p_ds``): masked logits
    -1e30, ``p = exp(s - lse)``, ``delta = Σ do∘o``,
    ``ds = p∘(do·vᵀ - delta)/sqrt(hd)``; dk/dv summed over the rep query
    heads of each kv head.  q/o/do: (BH, T, hd); k/v: (BH//rep, S, hd)."""
    BH, T, hd = q.shape
    S = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    kf = k.float().repeat_interleave(rep, dim=0)
    vf = v.float().repeat_interleave(rep, dim=0)
    qf, dof = q.float(), do.float()
    s = torch.matmul(qf, kf.transpose(1, 2)) * scale
    if causal:
        mask = (torch.arange(S, device=q.device)[None, :]
                <= torch.arange(T, device=q.device)[:, None])
        s = torch.where(mask, s, NEG)
    p = torch.exp(s - lse.float()[..., None])
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(1, 2), qf)
    dv = torch.matmul(p.transpose(1, 2), dof)
    if rep > 1:
        dk = dk.reshape(BH // rep, rep, S, hd).sum(dim=1)
        dv = dv.reshape(BH // rep, rep, S, hd).sum(dim=1)
    return dq, dk, dv


def pegrad_norm_ref(x, gy):
    """x: (BG, T, di), gy: (BG, T, do) -> (BG,) ‖x_bᵀ gy_b‖²_F, float32."""
    g = torch.matmul(x.float().transpose(1, 2), gy.float())
    return (g * g).sum(dim=(1, 2))


def dense_dgrad_ref(gy, w):
    """gy (BG, T, do), w (E, di, do) with row b using group ``b % E`` ->
    gx (BG, T, di) = gy_b · w[b % E]ᵀ, computed in float32, in gy's dtype."""
    E = w.shape[0]
    wb = w.float()[torch.arange(gy.shape[0], device=w.device) % E]
    return torch.matmul(gy.float(), wb.transpose(1, 2)).to(gy.dtype)


def dense_bwd_norm_ref(x, gy, w):
    """The fused dense backward kernel's function: x (BG, T, di), gy
    (BG, T, do), w (E, di, do) with row b using group ``b % E`` ->
    (gx (BG, T, di) in x's dtype, nsq (BG,) float32), both computed in
    float32 (``repro/kernels/ref.py`` ``dense_bwd_ref``)."""
    return dense_dgrad_ref(gy, w).to(x.dtype), pegrad_norm_ref(x, gy)


def clip_reduce_ref(g, c, out=None):
    """g (B, N) per-example gradients, c (B,) clip factors -> (N,)
    Σ_b c_b·g_b, computed in float32; with ``out`` ((N,) float32) added into
    it in place and ``out`` returned."""
    s = torch.matmul(c.float(), g.float())
    return s if out is None else out.add_(s)


def gram_norm_ref(x, gy, mask_ids=None, square: bool = True):
    """x: (BG, T, di), gy: (BG, T, do) -> (BG,) float32
    Σ_{t,s} (x_t·x_s)(gy_t·gy_s); ``square=False`` drops the x Gram; with
    ``mask_ids`` (BG, T) only pairs with equal ids contribute."""
    gf = gy.float()
    prod = torch.matmul(gf, gf.transpose(1, 2))
    if square:
        xf = x.float()
        prod = prod * torch.matmul(xf, xf.transpose(1, 2))
    if mask_ids is not None:
        prod = torch.where(mask_ids[:, :, None] == mask_ids[:, None, :], prod,
                           torch.zeros((), dtype=prod.dtype, device=prod.device))
    return prod.sum(dim=(1, 2))
