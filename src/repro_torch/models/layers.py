"""Core layers of the dense decoder: RMSNorm, RoPE (full/partial), GQA
attention (training and prefill through the flash kernels, cached decode,
paged decode) and MLPs.  Counterpart of ``repro/models/layers.py``.

Conventions as there: activations (B, T, d); attention heads (B, T, H, hd);
softmax and normalisation math in float32, outputs cast back to the compute
dtype; every dense is ``x @ w`` with ``w`` of shape (d_in, d_out).  The
training and prefill functions take a ``DPContext`` and route every
parameterised op through it (``DPContext.off()`` is the plain op); the
decode paths use plain matmuls.  Weights are held in the parameter type
and cast to the activations' (the compute) type where they are used
(``cast``), so the kernels see the compute type and autograd returns each
weight's gradient in its parameter type; norm scales stay float32.
``remat_wrap`` puts a block function under an activation-checkpointing
policy; ``inner_remat`` says whether the finer checkpoints inside a block
(the SSD scan's chunks, models/mamba2.py) are on.  ``gated_rmsnorm`` is the
Mamba2 mixer's output norm.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import validate_remat
from repro_torch.core import sites
from repro_torch.core.context import DPContext
from repro_torch.dist import runtime
from repro_torch.kernels import ops as kops

NEG = -1e30


def cast(w, x):
    """Weight ``w`` in ``x``'s type (itself where the two are one type)."""
    return w if w.dtype == x.dtype else w.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class P:
    """Param spec: shape, init rule (fan_in | embed | ones | zeros |
    mamba_dt | mamba_alog) and logical axis names, one a dim or None
    (``dist/sharding.py`` maps them onto the mesh; default all None)."""
    shape: Tuple[int, ...]
    init: str = "fan_in"
    axes: Optional[Tuple[Optional[str], ...]] = None

    def __post_init__(self):
        if self.axes is None:
            object.__setattr__(self, "axes", (None,) * len(self.shape))
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} for shape {self.shape}")


# ---------------------------------------------------------------------------
# Remat policies (configs/base.py REMAT_POLICIES is the vocabulary)
# ---------------------------------------------------------------------------

class _Recompute:
    """A saved tensor of a checkpointed region, rebuilt on demand."""
    __slots__ = ("region", "index")

    def __init__(self, region, index):
        self.region, self.index = region, index


class _Region:
    """One call of a block function ``fn(*args, saved) -> outputs`` (the
    activations, the norm accumulator and, in the decoder, the running MoE
    aux total) under a checkpoint: autograd's saved tensors go through
    ``saved_tensors_hooks``; the region keeps the ones that live in a
    storage the sites recorded in ``saved`` (``keep_site_operands``, the
    ``"sites"`` policy) and replaces every other one by a placeholder.  The
    first backward to unpack a placeholder runs ``fn`` once more on the same
    inputs, under ``enable_grad``, and takes that run's saved tensors in
    the order they were packed; each is handed out once and dropped, so a
    later backward through the same graph (``retain_graph``) recomputes
    again.  The recompute is deterministic, so it saves the same tensors
    in the same order, with the same values.

    The graph the backward walks is the first run's, so every ``SiteCall``
    adds its norm² to the accumulator's gradient exactly once however often
    the region is recomputed.  ``torch.utils.checkpoint``'s selective
    policy cannot serve here: it allows one backward through a region, and
    ``dpsgd_r1f`` pulls back twice."""

    def __init__(self, fn, args, keep_site_operands: bool):
        self.fn, self.args = fn, args
        self.keep = keep_site_operands
        self.count = 0           # placeholders handed out by the first run
        self.values = {}         # index -> recomputed tensor, until unpacked

    def _run(self, pack_other):
        saved = {} if self.keep else None

        def pack(t):
            if sites.is_saved_operand(t, saved):
                return t.detach()
            return pack_other(t)

        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, self._unpack):
                return self.fn(*self.args, saved)
        finally:
            # every saved tensor holds ``pack``; a record still holding the
            # tagged tensors would close a cycle through their grad_fns
            # that keeps them, and the graph behind them, alive
            if saved is not None:
                saved.clear()

    def forward(self):
        def placeholder(t):
            self.count += 1
            return _Recompute(self, self.count - 1)
        return self._run(placeholder)

    def _recompute(self):
        values = {}

        def record(t):
            values[len(values)] = t.detach()
        with torch.enable_grad():
            self._run(record)
        if len(values) != self.count:
            raise RuntimeError(f"remat: the recompute saved {len(values)} "
                               f"tensors where the forward saved {self.count}")
        self.values = values

    @staticmethod
    def _unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        region = packed.region
        if packed.index not in region.values:
            region._recompute()
        return region.values.pop(packed.index)


def remat_wrap(fn, remat: str):
    """Wrap a block function ``fn(x, acc, *rest, saved=None) -> (x, acc,
    *rest)`` in the configured activation-checkpointing policy; returns
    ``g(x, acc, *rest)``.  ``"none"`` stores everything, ``"block"`` stores
    only the block's inputs, ``"sites"`` also keeps exactly the site
    operands the DP norm rules consume (``sites.name_saved_operands``) and
    recomputes the rest.  ``acc`` is the norm² accumulator (None in ``off``
    mode); ``fn`` rebuilds its ``DPContext`` around it and ``saved``.
    ``rest``: further tensors carried through the block (the decoder's
    (B,) MoE aux total).  Unknown policies raise."""
    if validate_remat(remat) == "none":
        return fn
    keep = remat == "sites"
    return lambda *args: _Region(fn, args, keep).forward()


def inner_remat(remat: str) -> bool:
    """Whether the fine-grained inner checkpoints (the SSD scan's chunks)
    are active: any checkpointing policy keeps them, since they are what
    bounds the O(Q²) score blocks, and only ``"none"`` (store everything)
    drops them."""
    return validate_remat(remat) != "none"


def pipeline_shift(buf, inject):
    """One clock tick of the shifted-buffer pipeline schedule: stage s
    takes stage s-1's output of the previous tick, stage 0 the tick's
    injected microbatch, and the last stage's previous output falls off
    (the caller collects it first; ``transformer._blocks_pipelined``).
    ``buf``: a list of S stage slots (the schedule's; a slot is any value,
    None for a bubble), or a tensor or a dict or tuple of tensors, each
    stage-major (S, ...), shifted leaf by leaf with ``inject`` alike.
    Autograd's transpose of the tensor form carries per-example
    cotangents, the norm² partials, back across the stages."""
    if isinstance(buf, list):
        return [inject] + buf[:-1]
    if isinstance(buf, dict):
        return {k: pipeline_shift(buf[k], inject[k]) for k in buf}
    if isinstance(buf, tuple):
        return tuple(pipeline_shift(b, i) for b, i in zip(buf, inject))
    return torch.cat([inject[None], buf[:-1]], dim=0)


def largest_divisor_leq(n: int, cap: int) -> int:
    for b in range(min(cap, n), 0, -1):
        if n % b == 0:
            return b
    return 1


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------

def _rms(x, scale, eps: float):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm(x, scale, ctx: DPContext, eps: float = 1e-5):
    """RMSNorm over the last dim of x (batch dim 0, any rank); scale: (d,)
    is tapped for per-example norms.  Returns (y, ctx)."""
    s, ctx = ctx.tap(scale, x.dim() - 1 - scale.dim(), x.shape[0])
    return _rms(x, s, eps), ctx


def gated_rmsnorm(y, z, scale, ctx: DPContext, eps: float = 1e-5):
    """Mamba2's output norm, rmsnorm(y * silu(z)) * scale, in float32;
    scale (d,) is tapped for per-example norms.  Returns (out, ctx)."""
    g = y.float() * F.silu(z.float())
    s, ctx = ctx.tap(scale, 1, y.shape[0])
    out = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + eps)
    return (out * s.float()).to(y.dtype), ctx


def rope(x, pos, theta: float, pct: float):
    """Half-split (NeoX) rotary on the first ``pct`` of the head dim.
    x: (B, T, H, hd); pos: (B, T) integer absolute positions."""
    hd = x.shape[-1]
    r = int(hd * pct)
    r -= r % 2
    if r == 0:
        return x
    xr, xp = x[..., :r], x[..., r:]
    half = r // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, :, None, None] * freqs                     # (B,T,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half].float(), xr[..., half:].float()
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attn_spec(cfg) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    spec = {
        "wq": P((d, H * hd), axes=("embed", "heads")),
        "wk": P((d, KV * hd), axes=("embed", "kv")),
        "wv": P((d, KV * hd), axes=("embed", "kv")),
        "wo": P((H * hd, d), axes=("heads", "embed")),
    }
    if cfg.qk_norm:
        spec["q_norm"] = P((hd,), "ones")
        spec["k_norm"] = P((hd,), "ones")
    return spec


def _heads(p, cfg) -> Tuple[int, int]:
    """(H, KV): the query and KV heads the projections ``p`` hold, all of
    them, or a tensor-parallel rank's contiguous run of them (its
    column slices of ``wq`` and ``wk``)."""
    return p["wq"].shape[-1] // cfg.hd, p["wk"].shape[-1] // cfg.hd


def _qkv(p, x, pos, cfg, ctx: DPContext):
    """Projections, optional qk-norm and rotary: q (B,T,H,hd), k/v
    (B,T,KV,hd), and the context; H and KV the heads ``p`` holds
    (``_heads``)."""
    B, T, _ = x.shape
    (H, KV), hd = _heads(p, cfg), cfg.hd
    q, ctx = ctx.dense(x, cast(p["wq"], x))
    k, ctx = ctx.dense(x, cast(p["wk"], x))
    v, ctx = ctx.dense(x, cast(p["wv"], x))
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, KV, hd)
    v = v.reshape(B, T, KV, hd)
    if cfg.qk_norm:
        q, ctx = rmsnorm(q, p["q_norm"], ctx, cfg.norm_eps)
        k, ctx = rmsnorm(k, p["k_norm"], ctx, cfg.norm_eps)
    if cfg.rotary_pct > 0:
        q = rope(q, pos, cfg.rope_theta, cfg.rotary_pct)
        k = rope(k, pos, cfg.rope_theta, cfg.rotary_pct)
    return q, k, v, ctx


def attn_apply(p, x, ctx: DPContext, cfg, pos):
    """Training/prefill attention. x: (B,T,d); pos: (B,T).  Returns
    (y, ctx, (k, v)).  Under the fused norm pass (``ctx.mode == "norm"``
    and ``ctx.strategy == "fused"``) attention goes through its registry
    site, whose backward is the flash backward kernels (``use_kernels``);
    otherwise through ``ops.flash_attention`` (forward kernel, and the
    backward kernels when a gradient is needed).

    Tensor parallel (``p`` a rank's slices): ``x`` enters through
    ``runtime.to_model`` (its gradient summed over the ``model`` group),
    the column slices of ``wq``, ``wk``, ``wv`` give the rank's heads,
    attention runs on them alone (``runtime.attn_local``), and the row
    slice of ``wo`` gives a partial sum, made whole by
    ``runtime.from_model``.  Outside a tensor-parallel layout both are
    the identity."""
    B, T, _ = x.shape
    (H, KV), hd = _heads(p, cfg), cfg.hd
    x = runtime.to_model(x)
    q, k, v, ctx = _qkv(p, x, pos, cfg, ctx)
    qg = q.reshape(B, T, KV, H // KV, hd)

    def attend(qg, k, v, ctx):
        if ctx.mode == "norm" and ctx.strategy == "fused":
            return ctx.attention(qg, k, v, causal=True)
        return kops.flash_attention(qg, k, v, True), ctx
    o, ctx = runtime.attn_local(attend, cfg.n_kv_heads)(qg, k, v, ctx)
    o = o.reshape(B, T, H * hd)
    y, ctx = ctx.dense(o, cast(p["wo"], o))
    return runtime.from_model(y), ctx, (k, v)


def _decode_attend(q, gk, gv, pos, p, cfg):
    """One query per row against a (B, S, KV, hd) cache, keys at
    positions <= pos, on the heads ``p`` holds (``_heads``).  Scores and
    softmax in float32."""
    B = q.shape[0]
    (H, KV), hd = _heads(p, cfg), cfg.hd
    S = gk.shape[1]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkrh,bskh->bkrs", qg.float(), gk.float()) / math.sqrt(hd)
    mask = torch.arange(S, device=q.device)[None, :] <= pos[:, None]  # (B,S)
    s = torch.where(mask[:, None, None, :], s, NEG)
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrs,bskh->bkrh", pattn.to(gv.dtype), gv)
    return o.reshape(B, 1, H * hd) @ cast(p["wo"], o)


def attn_decode(p, x, cache_kv, pos, cfg):
    """Single-token decode. x: (B,1,d); cache_kv: (k, v) each (B,S,KV,hd);
    pos: (B,) write positions.  Writes the new k/v into the cache IN PLACE
    (the JAX version returns updated copies) and returns (y, cache_kv).

    Tensor parallel as ``attn_apply``: ``x`` through ``runtime.to_model``,
    the column slices of ``wq``, ``wk``, ``wv`` give the rank's heads, whose
    (k, v) alone its cache holds (KV = the rank's KV heads), attention on
    them (``runtime.attn_local``), and the row slice of ``wo``'s partial
    sum made whole by ``runtime.from_model``."""
    B = x.shape[0]
    x = runtime.to_model(x)
    q, k, v, _ = _qkv(p, x, pos[:, None], cfg, DPContext.off())
    ck, cv = cache_kv
    b = torch.arange(B, device=x.device)
    ck[b, pos] = k[:, 0].to(ck.dtype)
    cv[b, pos] = v[:, 0].to(cv.dtype)
    y = runtime.attn_local(lambda q, ck, cv: _decode_attend(q, ck, cv, pos, p, cfg),
                           cfg.n_kv_heads)(q, ck, cv)
    return runtime.from_model(y), (ck, cv)


def put_rows(pool, pb, off, val):
    """``pool[pb[b], off[b]] = val[b]`` in place, where rows whose ``pb`` is
    the sentinel ``len(pool)`` write nowhere (JAX's ``mode="drop"``).

    Dropping by filtering rows would read the mask on the host; instead the
    write is two exact accumulations at the clamped index: first subtract
    the current value where kept (x - x == 0 exactly), then add the new one
    where kept; a dropped row adds -0·x and 0·v, which leaves its clamped
    target unchanged even when a kept row writes the same cell.  Exact for
    finite values, which cache entries always are."""
    nb = pool.shape[0]
    keep = (pb < nb).to(pool.dtype).reshape((-1,) + (1,) * (val.dim() - 1))
    idx = (pb.clamp(max=nb - 1), off)
    pool.index_put_(idx, -pool[idx] * keep, accumulate=True)
    pool.index_put_(idx, val.to(pool.dtype) * keep, accumulate=True)


def attn_decode_paged(p, x, cache_kv, tables, pos, cfg):
    """Single-token decode against a block-paged KV pool.  x: (B,1,d);
    cache_kv: (k, v) each (num_blocks, block_size, KV, hd); tables: (B, nb)
    block tables, sentinel = num_blocks for unallocated entries; pos: (B,).

    Write at (tables[b, pos//bs], pos%bs) in place, dropping sentinel rows
    (``put_rows``).  Read by gathering the pool through the table with the
    sentinel clamped to the last pool row (JAX clamps implicitly): those
    rows land at positions > pos, where the mask pins them to -1e30 exactly
    as it pins the contiguous path's unwritten lanes, so outputs match the
    contiguous path.  Returns (y, cache_kv)."""
    B = x.shape[0]
    KV, hd = cfg.n_kv_heads, cfg.hd
    if _heads(p, cfg) != (cfg.n_heads, KV):
        raise NotImplementedError(
            f"{cfg.name}: the paged decode of tensor-parallel model slices is "
            f"not ported (ROADMAP queue 1)")
    ck, cv = cache_kv
    nb_pool, bs = ck.shape[0], ck.shape[1]
    q, k, v, _ = _qkv(p, x, pos[:, None], cfg, DPContext.off())
    pb = torch.gather(tables, 1, (pos // bs)[:, None])[:, 0]
    off = pos % bs
    put_rows(ck, pb, off, k[:, 0])
    put_rows(cv, pb, off, v[:, 0])
    S = tables.shape[1] * bs
    safe = tables.clamp(max=nb_pool - 1)
    gk = ck[safe].reshape(B, S, KV, hd)
    gv = cv[safe].reshape(B, S, KV, hd)
    return _decode_attend(q, gk, gv, pos, p, cfg), (ck, cv)


# ---------------------------------------------------------------------------
# MLP (dense FFN)
# ---------------------------------------------------------------------------

def mlp_spec(cfg, d_ff: int) -> dict:
    d = cfg.d_model
    if cfg.mlp_act == "swiglu":
        return {"w1": P((d, d_ff), axes=("embed", "mlp")),
                "w3": P((d, d_ff), axes=("embed", "mlp")),
                "w2": P((d_ff, d), axes=("mlp", "embed"))}
    return {"w1": P((d, d_ff), axes=("embed", "mlp")),
            "w2": P((d_ff, d), axes=("mlp", "embed"))}


def mlp_apply(p, x, ctx: DPContext, cfg):
    """Dense FFN; returns (y, ctx).  Tensor parallel as ``attn_apply``:
    ``x`` through ``runtime.to_model``, the column slices of ``w1`` (and
    ``w3``), the row slice of ``w2``, its partial sum through
    ``runtime.from_model``."""
    x = runtime.to_model(x)
    h1, ctx = ctx.dense(x, cast(p["w1"], x))
    if cfg.mlp_act == "swiglu":
        h3, ctx = ctx.dense(x, cast(p["w3"], x))
        h = F.silu(h1.float()).to(x.dtype) * h3
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h1.float(), approximate="tanh").to(x.dtype)
    y, ctx = ctx.dense(h, cast(p["w2"], h))
    return runtime.from_model(y), ctx
