"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) in PyTorch.
Counterpart of ``repro/models/mamba2.py``.

Training and prefill use the chunked SSD algorithm: a block-diagonal
"attention-like" term inside each chunk and a recurrent state carried from
chunk to chunk, O(T·Q) work at chunk length Q.  Decode carries an O(1)
state a layer (the conv window and the SSM state).

DP integration as in the JAX package: the in and out projections are dense
sites; A_log, dt_bias, D, the conv weight and the gated norm's scale are
tapped, so per-example norms stay exact through the scan.

Two differences from the JAX package, both the same function:
  * **Chunking.**  The reference takes Q = ``largest_divisor_leq(T,
    chunk)``, so a prompt of prime length runs T chunks of 1.  Here the
    chunks are ``chunk`` long with a shorter last one (the scan's carry is
    the same state; only the grouping of the sums differs).
  * **Batched chunks and the checkpoint.**  The reference scans the
    chunks one at a time (``lax.scan``) and wraps each in ``jax.checkpoint``
    under ``block`` and ``sites``.  Here the chunks' (B, H, Q, Q) blocks are
    formed a group of chunks at a time (``GROUP_BYTES`` bounds a group),
    and only the recurrence across chunks, two small ops a chunk, is a
    Python loop: a loop of one chunk at a time made tens of launches a
    chunk.  ``_SSDScan``, an ``autograd.Function``, runs the scan without a
    graph, saves its inputs and each chunk's entry state with
    ``save_for_backward`` and rebuilds one group's graph at a time in its
    backward.  A nested ``layers._Region`` would hold its arguments as
    Python references for the whole forward, out of reach of the enclosing
    block's ``saved_tensors_hooks``; ``save_for_backward`` goes through
    those hooks, so under ``block`` the enclosing region recomputes them
    too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.context import DPContext
from repro_torch.models.layers import P, cast, gated_rmsnorm, inner_remat


def mamba_dims(cfg):
    m = cfg.mamba
    d_in = m.d_inner(cfg.d_model)
    H = m.n_heads(cfg.d_model)
    return d_in, H, m.n_groups, m.d_state, m.d_conv, m.head_dim


def mamba_spec(cfg) -> dict:
    d = cfg.d_model
    d_in, H, G, N, K, Pdim = mamba_dims(cfg)
    conv_ch = d_in + 2 * G * N
    return {
        "in_proj": P((d, 2 * d_in + 2 * G * N + H), axes=("embed", "mlp")),
        "conv_w": P((K, conv_ch), axes=(None, "mlp")),
        "dt_bias": P((H,), "mamba_dt"),
        "A_log": P((H,), "mamba_alog"),
        "D": P((H,), "ones"),
        "norm": P((d_in,), "ones"),
        "out_proj": P((d_in, d), axes=("mlp", "embed")),
    }


def _split_proj(zxbcdt, d_in, G, N, H):
    z = zxbcdt[..., :d_in]
    x = zxbcdt[..., d_in:2 * d_in]
    Bm = zxbcdt[..., 2 * d_in:2 * d_in + G * N]
    Cm = zxbcdt[..., 2 * d_in + G * N:2 * d_in + 2 * G * N]
    dt = zxbcdt[..., 2 * d_in + 2 * G * N:]
    return z, x, Bm, Cm, dt


def _causal_depthwise_conv(u, w, ctx: DPContext, init_state=None):
    """u: (B, T, C); w: (K, C) depthwise causal conv, silu activation, in
    float32.  init_state: (B, K-1, C) left context (prefill chaining).
    Returns (y, ctx, final_state)."""
    B, T, C = u.shape
    K = w.shape[0]
    if init_state is None:
        init_state = u.new_zeros((B, K - 1, C))
    up = torch.cat([init_state.to(u.dtype), u], dim=1)              # (B,T+K-1,C)
    wb, ctx = ctx.tap(w, 0, B)      # norm mode: (B,K,C); off: (K,C)
    wf = wb.float()
    wk = (lambda k: wf[k]) if wf.dim() == 2 else (lambda k: wf[:, k, None])
    upf = up.float()
    y = upf[:, :T] * wk(0)
    for k in range(1, K):
        y = torch.addcmul(y, upf[:, k:k + T], wk(k))
    y = F.silu(y).to(u.dtype)
    final = up[:, T:] if K > 1 else u.new_zeros((B, 0, C))
    return y, ctx, final


def _segsum(loga):
    """loga: (..., Q) -> (..., Q, Q) lower-triangular cumulative sums,
    out[t, s] = sum_{s < u <= t} loga_u, -inf above the diagonal.  The
    mask is applied before the caller's ``exp``, so the backward through
    the masked entries is exactly zero."""
    Q = loga.shape[-1]
    cs = torch.cumsum(loga, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]                      # t, s
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=loga.device))
    return torch.where(mask, diff, torch.full((), -torch.inf, device=loga.device))


# one group's (B, chunks, H, Q, Q) float32 blocks stay under this many bytes
GROUP_BYTES = 2**30


def _chunked(a, Q: int):
    """(B, T, ...) -> (B, nC, Q, ...), zero-padded to whole chunks.  Zero
    padding is exact for the scan: a padded position has dt 0, so it adds
    nothing to the state and leaves its decay alone, and x, B and C 0."""
    B, T = a.shape[:2]
    nC = -(-T // Q)
    if nC * Q != T:
        a = F.pad(a, (0, 0) * (a.dim() - 2) + (0, nC * Q - T))
    return a.reshape((B, nC, Q) + tuple(a.shape[2:]))


def _log_decays(d, A):
    """d: (B, k, Q, H) dt of k chunks; A: (H,) or (B, 1, H).  Returns each
    position's log decay dt·A (B, k, Q, H)."""
    return d * (A if A.dim() == 1 else A[:, :, None])


def _chunk_updates(x, d, cs, Bc):
    """Each chunk's state update from a zero state: Σ_s exp(cs_end - cs_s)
    dt_s x_s ⊗ B_s, (B, k, H, P, N)."""
    Bsz, k, Q, H, Pd = x.shape
    G, N = Bc.shape[3], Bc.shape[4]
    w = torch.exp(cs[:, :, -1:] - cs) * d                           # (B,k,Q,H)
    xw = (x.float() * w[..., None]).reshape(Bsz, k, Q, G, H // G, Pd)
    return torch.einsum("bkqgrp,bkqgn->bkgrpn", xw, Bc.float()).reshape(
        Bsz, k, H, Pd, N)


def _chunk_outputs(x, d, A, Bc, Cc, Sin, want_exit: bool):
    """k chunks at once.  x: (B,k,Q,H,P); d: (B,k,Q,H) float32; A: (H,) or
    (B,1,H); Bc/Cc: (B,k,Q,G,N); Sin: (B,k,H,P,N) each chunk's entry state.
    Returns (y (B,k,Q,H,P) float32, the exit states or None).  The heads of
    one group share B and C, so the scores are formed once a group."""
    Bsz, k, Q, H, Pd = x.shape
    G, N = Bc.shape[3], Bc.shape[4]
    rep = H // G
    xf, Bf, Cf = x.float(), Bc.float(), Cc.float()
    da = _log_decays(d, A)
    cs = torch.cumsum(da, dim=2)
    # intra-chunk
    L = torch.exp(_segsum(da.transpose(2, 3)))                      # (B,k,H,Q,Q)
    scores = torch.einsum("bkqgn,bksgn->bkgqs", Cf, Bf)             # (B,k,G,Q,Q)
    M = (scores[:, :, :, None] * L.reshape(Bsz, k, G, rep, Q, Q)).reshape(
        Bsz, k, H, Q, Q)
    # dt_s scales column s of every score block: taken into x instead
    y = torch.einsum("bkhqs,bkshp->bkqhp", M, xf * d[..., None])
    # inter-chunk: the entry state's contribution
    y_in = torch.einsum("bkqgn,bkgrpn->bkqgrp", Cf, Sin.reshape(Bsz, k, G, rep, Pd, N))
    y = y + y_in.reshape(Bsz, k, Q, H, Pd) * torch.exp(cs)[..., None]
    if not want_exit:
        return y, None
    S_exit = (Sin * torch.exp(cs[:, :, -1])[..., None, None]
              + _chunk_updates(xf, d, cs, Bf))
    return y, S_exit


def _groups(shape, Q: int):
    """Chunk ranges whose (B, k, H, Q, Q) float32 blocks fit GROUP_BYTES."""
    Bsz, nC, _, H = shape[:4]
    k = max(1, GROUP_BYTES // (Bsz * H * Q * Q * 4))
    return [(lo, min(lo + k, nC)) for lo in range(0, nC, k)]


def _scan(x, d, A, Bc, Cc, S0):
    """The scan over chunked inputs (``_chunked``): every chunk's update
    from a zero state at once, the recurrence across chunks (two small ops
    a chunk), then the outputs a group of chunks at a time.  Returns (y
    (B,nC,Q,H,P) float32, the final state, the entry states (B,nC,H,P,N))."""
    cs = torch.cumsum(_log_decays(d, A), dim=2)
    U = _chunk_updates(x, d, cs, Bc)
    decay = torch.exp(cs[:, :, -1])                                 # (B,nC,H)
    states, S = [], S0
    for c in range(x.shape[1]):
        states.append(S)
        S = S * decay[:, c, :, None, None] + U[:, c]
    Sin = torch.stack(states, dim=1)
    ys = [_chunk_outputs(x[:, lo:hi], d[:, lo:hi], A, Bc[:, lo:hi], Cc[:, lo:hi],
                         Sin[:, lo:hi], False)[0]
          for lo, hi in _groups(x.shape, x.shape[2])]
    return torch.cat(ys, dim=1), S, Sin


class _SSDScan(torch.autograd.Function):
    """The scan under the per-chunk checkpoint (see the module docstring).
    The forward runs ``_scan`` without a graph and keeps the inputs and
    each chunk's entry state.  The backward first carries the state
    gradient back across the chunks (the entry state's part through the
    chunk's outputs, then the recurrence, two small ops a chunk), then
    rebuilds one group of chunks' graph at a time, from the saved entry
    states, and pulls back its outputs and exit states together."""

    @staticmethod
    def forward(ctx, Q, xh, dt, A, Bm, Cm, S0):
        T = xh.shape[1]
        chunked = [_chunked(t, Q) for t in (xh, dt, Bm, Cm)]
        y, S, Sin = _scan(chunked[0], chunked[1], A, chunked[2], chunked[3], S0)
        ctx.Q = Q
        ctx.save_for_backward(xh, dt, A, Bm, Cm, Sin)
        return y.flatten(1, 2)[:, :T], S

    @staticmethod
    def backward(ctx, gy, gS):
        xh, dt, A, Bm, Cm, Sin = ctx.saved_tensors
        Q, T = ctx.Q, xh.shape[1]
        x, d, Bc, Cc = (_chunked(t, Q) for t in (xh, dt, Bm, Cm))
        Bsz, nC, _, H, Pd = x.shape
        G, N = Bc.shape[3], Bc.shape[4]
        gy = _chunked(gy.float(), Q)      # unused outputs' gradients are zeros
        # each entry state's gradient through its chunk's outputs
        cs = torch.cumsum(_log_decays(d, A), dim=2)
        gz = (gy * torch.exp(cs)[..., None]).reshape(Bsz, nC, Q, G, H // G, Pd)
        R = torch.einsum("bcqgrp,bcqgn->bcgrpn", gz, Cc.float()).reshape(
            Bsz, nC, H, Pd, N)
        decay = torch.exp(cs[:, :, -1])
        g_exit = [None] * nC
        for c in reversed(range(nC)):
            g_exit[c] = gS
            gS = gS * decay[:, c, :, None, None] + R[:, c]
        g_exit = torch.stack(g_exit, dim=1)
        ins = (x, d, A, Bc, Cc)
        needs = ctx.needs_input_grad[1:6]
        grads = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                 if n else None for t, n in zip(ins, needs)]
        for lo, hi in _groups(x.shape, Q) if any(needs) else ():
            part = [t if i == 2 else t[:, lo:hi] for i, t in enumerate(ins)]
            with torch.enable_grad():
                part = [t.detach().requires_grad_(n) for t, n in zip(part, needs)]
                y, S_exit = _chunk_outputs(*part, Sin[:, lo:hi], True)
                want = [t for t, n in zip(part, needs) if n]
                got = iter(torch.autograd.grad((y, S_exit), want,
                                               (gy[:, lo:hi], g_exit[:, lo:hi]),
                                               allow_unused=True))
            for i, n in enumerate(needs):
                gi = next(got) if n else None
                if gi is None:
                    continue
                if i == 2:                      # A: shared by every chunk
                    grads[i] += gi
                else:
                    grads[i][:, lo:hi] = gi
        out = [None if g is None else
               (g if i == 2 else g.flatten(1, 2)[:, :T]).to(t.dtype)
               for i, (g, t) in enumerate(zip(grads, (xh, dt, A, Bm, Cm)))]
        return (None, *out, gS if ctx.needs_input_grad[6] else None)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, init_state=None,
                remat: str = "block"):
    """SSD scan in chunks of ``chunk`` (the last one shorter; one chunk of
    T when T < chunk).

    xh: (B,T,H,P) inputs; dt: (B,T,H) (post-softplus); A: (H,) or (B,1,H)
    negative decay rates; Bm/Cm: (B,T,G,N).  Returns (y (B,T,H,P) float32,
    final_state (B,H,P,N) float32).  A graph being recorded under
    ``block`` and ``sites`` (``layers.inner_remat``) takes ``_SSDScan``'s
    per-chunk checkpoint; under ``none``, or with no graph, ``_scan``
    itself, a group of chunks at a time."""
    B, T, H, Pd = xh.shape
    N = Bm.shape[3]
    Q = min(chunk, T)
    dt, A = dt.float(), A.float()
    S0 = (torch.zeros((B, H, Pd, N), dtype=torch.float32, device=xh.device)
          if init_state is None else init_state.float())
    if inner_remat(remat) and torch.is_grad_enabled() and any(
            t.requires_grad for t in (xh, dt, A, Bm, Cm, S0)):
        return _SSDScan.apply(Q, xh, dt, A, Bm, Cm, S0)
    chunked = [_chunked(t, Q) for t in (xh, dt, Bm, Cm)]
    y, S, _ = _scan(chunked[0], chunked[1], A, chunked[2], chunked[3], S0)
    return y.flatten(1, 2)[:, :T], S


def mamba_apply(p, x, ctx: DPContext, cfg, conv_state=None, ssm_state=None,
                want_cache: bool = False, remat: str = "block"):
    """Full-sequence Mamba2 mixer. x: (B,T,d).  Returns (y, ctx, cache),
    cache = (conv window (B,K-1,C) in x's type, SSM state (B,H,P,N)
    float32) when ``want_cache``."""
    B, T, d = x.shape
    d_in, H, G, N, K, Pd = mamba_dims(cfg)
    zxbcdt, ctx = ctx.dense(x, cast(p["in_proj"], x))
    z, xin, Bm, Cm, dt = _split_proj(zxbcdt, d_in, G, N, H)
    u = zxbcdt[..., d_in:2 * d_in + 2 * G * N]          # [xin, Bm, Cm]
    u, ctx, conv_final = _causal_depthwise_conv(u, p["conv_w"], ctx, conv_state)
    xin, Bm, Cm = (u[..., :d_in], u[..., d_in:d_in + G * N],
                   u[..., d_in + G * N:])
    dtb, ctx = ctx.tap(p["dt_bias"], 1, B)                          # (B,1,H)|(H,)
    dt = F.softplus(dt.float() + dtb.float())                       # (B,T,H)
    Alog, ctx = ctx.tap(p["A_log"], 1, B)
    A = -torch.exp(Alog.float())                                    # (B,1,H)|(H,)
    xh = xin.reshape(B, T, H, Pd)
    y, S_final = ssd_chunked(xh, dt, A, Bm.reshape(B, T, G, N),
                             Cm.reshape(B, T, G, N), cfg.mamba.chunk,
                             init_state=ssm_state, remat=remat)
    Dp, ctx = ctx.tap(p["D"], 1, B)                                 # (B,1,H)|(H,)
    y = y + Dp[..., None].float() * xh.float()
    y = y.reshape(B, T, d_in).to(x.dtype)
    y, ctx = gated_rmsnorm(y, z, p["norm"], ctx, cfg.norm_eps)
    out, ctx = ctx.dense(y, cast(p["out_proj"], y))
    cache = (conv_final, S_final) if want_cache else None
    return out, ctx, cache


def mamba_decode(p, x, conv_state, ssm_state, cfg):
    """Single-token decode. x: (B,1,d); conv_state: (B,K-1,C); ssm_state:
    (B,H,P,N) float32.  Returns (y, (conv_state, ssm_state)), both new
    tensors (the caller writes them into its cache)."""
    B = x.shape[0]
    d_in, H, G, N, K, Pd = mamba_dims(cfg)
    zxbcdt = x @ cast(p["in_proj"], x)
    z, xin, Bm, Cm, dt = _split_proj(zxbcdt, d_in, G, N, H)
    u = zxbcdt[..., d_in:2 * d_in + 2 * G * N]                      # (B,1,C)
    window = torch.cat([conv_state.to(u.dtype), u], dim=1)          # (B,K,C)
    yconv = (window.float() * p["conv_w"].float()).sum(dim=1)
    yconv = F.silu(yconv).to(x.dtype)[:, None]
    new_conv = window[:, 1:]
    xin, Bm, Cm = (yconv[..., :d_in], yconv[..., d_in:d_in + G * N],
                   yconv[..., d_in + G * N:])
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())         # (B,H)
    A = -torch.exp(p["A_log"].float())                              # (H,)
    a = torch.exp(dt * A)                                           # (B,H)
    xh = xin.reshape(B, H, Pd).float()
    Bh = Bm.reshape(B, G, N).float().repeat_interleave(H // G, dim=1)
    Ch = Cm.reshape(B, G, N).float().repeat_interleave(H // G, dim=1)
    dBx = (dt[:, :, None] * xh)[..., None] * Bh[:, :, None, :]      # (B,H,P,N)
    S = ssm_state * a[:, :, None, None] + dBx
    y = torch.einsum("bhn,bhpn->bhp", Ch, S)
    y = y + p["D"].float()[None, :, None] * xh
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y, _ = gated_rmsnorm(y, z, p["norm"], DPContext.off(), cfg.norm_eps)
    return y @ cast(p["out_proj"], y), (new_conv, S)
