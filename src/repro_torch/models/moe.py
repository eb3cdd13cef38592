"""Mixture-of-Experts with sort-based capacity dispatch.  Counterpart of
``repro/models/moe.py``.

Dispatch keeps the example dimension: the tokens of example b are routed
into a (b, E, C, d) buffer, so every (example, expert) group belongs to one
example and the ``moe_dense`` site's norm rules stay exact.  A token's slot
within its expert's buffer is its rank among the example's (token, choice)
pairs routed to that expert, in position order (a stable sort); pairs
ranked at or past the capacity C are dropped into a dump slot that is cut
off.  The scatter and the gather are linear, so autograd transposes them.

Remat: MoE layers run inside the transformer's blocks, so every policy
covers them.  Under ``remat="sites"`` the dispatch buffers (the
``moe_dense`` sites' operand 0: ``xd`` and ``h`` below) are kept, and the
router softmax, the ranks and the combine gather are recomputed.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.context import DPContext
from repro_torch.models.layers import P, cast

F32 = torch.float32


def capacity(cfg_moe, seq_len: int) -> int:
    c = int(seq_len * cfg_moe.top_k / cfg_moe.num_experts * cfg_moe.capacity_factor)
    return max(min(c, seq_len), 1)


def moe_spec(cfg) -> dict:
    """Expert FFNs follow ``cfg.mlp_act``: swiglu = 3 matrices (w1, w3, w2),
    gelu = 2 (w1, w2), as the dense MLP."""
    d, m = cfg.d_model, cfg.moe
    swiglu = cfg.mlp_act == "swiglu"
    spec = {
        "router": P((d, m.num_experts), axes=("embed", "expert")),
        "we1": P((m.num_experts, d, m.d_expert),
                 axes=("expert", "embed", "mlp")),
        "we2": P((m.num_experts, m.d_expert, d),
                 axes=("expert", "mlp", "embed")),
    }
    if swiglu:
        spec["we3"] = P((m.num_experts, d, m.d_expert),
                        axes=("expert", "embed", "mlp"))
    if m.num_shared_experts > 0:
        spec.update({"ws1": P((d, m.d_shared), axes=("embed", "mlp")),
                     "ws2": P((m.d_shared, d), axes=("mlp", "embed"))})
        if swiglu:
            spec["ws3"] = P((d, m.d_shared), axes=("embed", "mlp"))
    return spec


def _route(gates_probs: torch.Tensor, top_k: int, cap: int):
    """gates_probs: (B, T, E) float32.  Returns (gate_vals, e_idx, slot,
    keep), all (B, T, K); slot is the position within the expert's
    capacity buffer.

    The top k are taken by a stable descending sort, so among equal
    probabilities the lower expert index comes first, as ``jax.lax.top_k``
    orders them (``torch.topk`` promises no order of ties on the card)."""
    B, T, E = gates_probs.shape
    vals, idx = torch.sort(gates_probs, dim=-1, descending=True, stable=True)
    gate_vals, e_idx = vals[..., :top_k], idx[..., :top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    ef = e_idx.reshape(B, T * top_k)
    order = torch.argsort(ef, dim=1, stable=True)
    es = torch.gather(ef, 1, order)
    # rank within expert = index - first index of that expert in sorted order
    seg_start = torch.searchsorted(es, es, side="left")
    ranks_sorted = torch.arange(T * top_k, device=ef.device)[None, :] - seg_start
    ranks = torch.empty_like(ranks_sorted).scatter_(1, order, ranks_sorted)
    slot = ranks.reshape(B, T, top_k)
    return gate_vals, e_idx, slot, slot < cap


def _dest(e_idx, slot, keep, E: int, cap: int):
    """(B, T·K) flat buffer rows: ``e·C + slot``, the dump row E·C when
    dropped."""
    B = e_idx.shape[0]
    return torch.where(keep, e_idx * cap + slot,
                       torch.full((), E * cap, device=e_idx.device)).reshape(B, -1)


def _dispatch(x: torch.Tensor, e_idx, slot, keep, E: int, cap: int):
    """x: (B, T, d) -> (B, E, C, d).  Dropped tokens land in a dump slot.
    Kept destinations are unique, so the accumulating scatter adds each
    token to zeros (exact) and sums only in the dump row, which is cut."""
    B, T, d = x.shape
    K = e_idx.shape[-1]
    dest = _dest(e_idx, slot, keep, E, cap)
    xe = x[:, :, None, :].expand(B, T, K, d).reshape(B, T * K, d)
    buf = x.new_zeros((B, E * cap + 1, d))
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, T * K)
    buf = buf.index_put((b_idx, dest), xe, accumulate=True)
    return buf[:, :-1].reshape(B, E, cap, d)


def _combine(ye: torch.Tensor, gate_vals, e_idx, slot, keep):
    """ye: (B, E, C, d) expert outputs -> (B, T, d) gated combination."""
    B, E, cap, d = ye.shape
    _, T, K = e_idx.shape
    dest = _dest(e_idx, slot, keep, E, cap)
    pad = torch.cat([ye.reshape(B, E * cap, d), ye.new_zeros((B, 1, d))], dim=1)
    yt = torch.gather(pad, 1, dest[..., None].expand(B, T * K, d))
    w = (gate_vals * keep.to(gate_vals.dtype)).to(ye.dtype)
    return torch.einsum("btkd,btk->btd", yt.reshape(B, T, K, d), w)


def moe_apply(p, x, ctx: DPContext, cfg) -> Tuple[torch.Tensor, DPContext, torch.Tensor]:
    """Returns (y, ctx, per-example aux loss (B,) float32)."""
    B, T, d = x.shape
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    cap = capacity(m, T)

    logits, ctx = ctx.dense(x, cast(p["router"], x))             # (B,T,E)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, e_idx, slot, keep = _route(probs, K, cap)

    xd = _dispatch(x, e_idx, slot, keep, E, cap)                  # (B,E,C,d)
    h1, ctx = ctx.moe_dense(xd, cast(p["we1"], xd))
    if "we3" in p:
        h3, ctx = ctx.moe_dense(xd, cast(p["we3"], xd))
        h = F.silu(h1.float()).to(x.dtype) * h3
    else:
        h = F.gelu(h1.float(), approximate="tanh").to(x.dtype)
    ye, ctx = ctx.moe_dense(h, cast(p["we2"], h))                 # (B,E,C,d)
    y = _combine(ye, gate_vals, e_idx, slot, keep)

    if m.num_shared_experts > 0:
        s1, ctx = ctx.dense(x, cast(p["ws1"], x))
        if "ws3" in p:
            s3, ctx = ctx.dense(x, cast(p["ws3"], x))
            sh = F.silu(s1.float()).to(x.dtype) * s3
        else:
            sh = F.gelu(s1.float(), approximate="tanh").to(x.dtype)
        ys, ctx = ctx.dense(sh, cast(p["ws2"], sh))
        y = y + ys

    # per-example load-balance aux loss: a function of the example alone
    me = probs.mean(dim=1)                                        # (B,E)
    fe = F.one_hot(e_idx[..., 0], E).to(F32).mean(dim=1)          # (B,E)
    aux = E * (me * fe).sum(dim=-1)                               # (B,)
    return y, ctx, aux
