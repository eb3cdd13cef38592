"""Layout shims between the model's and DP core's layouts and the kernels'.
Counterpart of ``repro/kernels/ops.py``.

``flash_attention`` is a ``torch.autograd.Function``: its forward is the
``flash_attn_fwd`` kernel (saving o and the row logsumexp), its backward
the ``flash_attn_bwd`` kernel pair — the JAX package's
``REPRO_USE_FLASH=1 REPRO_FLASH_BWD=pallas`` route.  Under ``no_grad``
(serving, and a site's forward) it records nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import clip_reduce as _cr
from repro_torch.kernels import flash_attn as _fa
from repro_torch.kernels import fused_bwd as _fb
from repro_torch.kernels import gram_norm as _gn
from repro_torch.kernels import pegrad_norm as _pn


def pegrad_norm(x4, gy4):
    """(B,G,T,di),(B,G,T,do) -> (B,) per-example grad norms² (float32),
    the group norms² summed per example."""
    B, G, T, di = x4.shape
    do = gy4.shape[-1]
    out = _pn.pegrad_norm(x4.reshape(B * G, T, di).contiguous(),
                          gy4.reshape(B * G, T, do).contiguous())
    return out.reshape(B, G).sum(dim=1)


def dense_bwd_norm(x4, gy4, w):
    """Fused dense backward (norm_strategy="fused", use_kernels=True):
    (B,G,T,di), (B,G,T,do), w (di,do) or (G,di,do) ->
    (gx4 (B,G,T,di), nsq (B,) float32) from one kernel call."""
    B, G, T, di = x4.shape
    do = gy4.shape[-1]
    wE = w if w.dim() == 3 else w[None]
    gx, nsq = _fb.dense_bwd_norm(x4.reshape(B * G, T, di).contiguous(),
                                 gy4.reshape(B * G, T, do).contiguous(),
                                 wE.contiguous())
    return gx.reshape(x4.shape), nsq.reshape(B, G).sum(dim=1)


def dense_dgrad(gy4, w):
    """The dgrad half alone: (B,G,T,do), w (di,do) or (G,di,do) ->
    gx4 (B,G,T,di).  Paired with ``pegrad_norm`` it is the two-launch
    baseline that ``dense_bwd_norm`` fuses."""
    B, G, T, do = gy4.shape
    wE = w if w.dim() == 3 else w[None]
    gx = _fb.dense_dgrad(gy4.reshape(B * G, T, do).contiguous(), wE.contiguous())
    return gx.reshape(B, G, T, wE.shape[1])


def clip_reduce(g, c, out=None):
    """(B, N), (B,) -> (N,) Σ_b c_b·g_b (float32); with ``out`` added into
    it in place."""
    return _cr.clip_reduce(g.contiguous(), c.float().contiguous(), out=out)


def gram_norm(x4, gy4, mask_ids=None, square: bool = True):
    """(B,G,T,di),(B,G,T,do)[, ids (B,T)] -> (B,) ghost norms² (float32)."""
    B, G, T, di = x4.shape
    do = gy4.shape[-1]
    ids = None
    if mask_ids is not None:
        if G != 1:
            raise ValueError("gram_norm: the id mask is for embeddings (G == 1)")
        ids = mask_ids.reshape(B, T)
    out = _gn.gram_norm(x4.reshape(B * G, T, di).contiguous(),
                        gy4.reshape(B * G, T, do).contiguous(), ids,
                        square=square)
    return out.reshape(B, G).sum(dim=1)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _flat_q(a):      # (B,T,KV,rep,hd) -> (B·KV·rep, T, hd), query-head major
    B, T, KV, rep, hd = a.shape
    return a.permute(0, 2, 3, 1, 4).reshape(B * KV * rep, T, hd).contiguous()


def _flat_kv(a):     # (B,S,KV,hd) -> (B·KV, S, hd)
    B, S, KV, hd = a.shape
    return a.permute(0, 2, 1, 3).reshape(B * KV, S, hd).contiguous()


def _unflat_q(a, shape):
    B, T, KV, rep, hd = shape
    return a.reshape(B, KV, rep, T, hd).permute(0, 3, 1, 2, 4)


def _unflat_kv(a, shape):
    B, S, KV, hd = shape
    return a.reshape(B, KV, S, hd).permute(0, 2, 1, 3)


def _flash_fwd_impl(q, k, v, causal):
    """(o (B,T,KV,rep,hd), flattened (qf, kf, vf, of, lse)) via the kernel
    (its plain version for a CPU tensor)."""
    rep = q.shape[3]
    qf, kf, vf = _flat_q(q), _flat_kv(k), _flat_kv(v)
    of, lse = _fa.flash_attn_fwd(qf, kf, vf, causal=causal, rep=rep)
    return _unflat_q(of, q.shape), (qf, kf, vf, of, lse)


def _flash_bwd_impl(saved, do, causal, q_shape, kv_shape):
    qf, kf, vf, of, lse = saved
    dqf, dkf, dvf = _fa.flash_attn_bwd(qf, kf, vf, of, lse, _flat_q(do),
                                       causal=causal, rep=q_shape[3])
    return (_unflat_q(dqf, q_shape), _unflat_kv(dkf, kv_shape),
            _unflat_kv(dvf, kv_shape))


def flash_attention_bwd(q, k, v, do, causal: bool = True):
    """One-call flash backward: recomputes (o, lse) with the forward kernel,
    then runs the backward kernels.  The attention site's ``"fused"`` route
    (core/sites.py).  Layouts as in ``flash_attention``; float32 grads."""
    _, saved = _flash_fwd_impl(q, k, v, causal)
    return _flash_bwd_impl(saved, do, causal, q.shape, k.shape)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, saved = _flash_fwd_impl(q, k, v, causal)
        ctx.save_for_backward(*saved)
        ctx.causal = causal
        ctx.shapes = (q.shape, k.shape)
        return o

    @staticmethod
    def backward(ctx, do):
        q_shape, kv_shape = ctx.shapes
        saved = ctx.saved_tensors      # once: a checkpoint hands each out once
        qf, kf, vf = saved[:3]
        dq, dk, dv = _flash_bwd_impl(saved, do, ctx.causal, q_shape, kv_shape)
        return dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype), None


def flash_attention(q, k, v, causal: bool = True):
    """q: (B,T,KV,rep,hd); k/v: (B,S,KV,hd) -> o: (B,T,KV,rep,hd).
    Flattened as in the JAX shim, query-head major within a kv head, so the
    kernel's kv row is ``bh // rep``.  Differentiable through the flash
    backward kernels."""
    return _FlashAttention.apply(q, k, v, causal)
