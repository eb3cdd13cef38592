"""The port's Mamba2 mixer (``models/mamba2.py``) against the JAX package's,
on seeded numpy inputs, float32, TF32 off.

The port chunks the SSD scan in chunks of ``chunk`` with a shorter last
one, where the reference takes Q = ``largest_divisor_leq(T, chunk)``: the
same function, its sums grouped otherwise.  Where the two chunkings differ
(T 37: the reference's Q 1; T 40: Q 10; the port's 16, 16, 5 and 16, 16,
8) the SSD outputs are held at rtol 1e-4 / atol 1e-5; where they match, at
the reference's pins, rtol 1e-5 / atol 2e-6.  The scan's gradients against
the JAX vjp take rtol 1e-4 with an atol of 1e-5 times the gradient's
largest entry, at every length: each sums over every later position, and
the port forms a group's scores once where the reference forms them a
head (the order of the float32 sums differs even where the chunks agree).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.context import DPContext as JDPContext
from repro.models import layers as jlayers
from repro.models import mamba2 as jm2
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.core.context import DPContext
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tm2

PINS = dict(rtol=1e-5, atol=2e-6)
SSD_TOL = dict(rtol=1e-4, atol=1e-5)       # where the chunkings differ
CHUNK = 16


@pytest.fixture(autouse=True)
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _cfgs(name="mamba2-1.3b"):
    return jreduced(JARCHS[name]), treduced(TARCHS[name])


def _ssd_inputs(rng, B, T, H, G, Pd=4, N=8, per_example_A=False):
    xh = rng.standard_normal((B, T, H, Pd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, (B, 1, H) if per_example_A else (H,)))
    Bm = rng.standard_normal((B, T, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, G, N)).astype(np.float32)
    return xh, dt, A.astype(np.float32), Bm, Cm


@pytest.mark.parametrize("T,G,init", [(37, 1, False), (40, 2, True)])
def test_ssd_chunked_matches_jax(T, G, init, monkeypatch):
    """y and the final state without and with an initial state, at lengths
    where the reference's chunk differs from the port's, one group and
    two; per-example A (the norm pass's tap) with the initial state.  The
    gradients of ``_SSDScan``'s per-chunk checkpoint equal the plain
    scan's (``none``), in one group of chunks and in groups of one chunk
    (``GROUP_BYTES`` at its least).  (Where the chunks agree, T 32, the
    mixer is held at the pins in ``test_mamba_apply_and_decode_match_jax``.)"""
    rng = np.random.default_rng(T + G)
    B, H = 2, 4
    for t in (T, 32):
        assert tlayers.largest_divisor_leq(t, CHUNK) == jlayers.largest_divisor_leq(t, CHUNK)
    assert tlayers.largest_divisor_leq(T, CHUNK) < CHUNK
    ins = _ssd_inputs(rng, B, T, H, G, per_example_A=init)
    S0 = rng.standard_normal((B, H, 4, 8)).astype(np.float32) if init else None
    jy, jS = jm2.ssd_chunked(*map(jnp.asarray, ins), CHUNK,
                             init_state=None if S0 is None else jnp.asarray(S0),
                             remat="none")
    tol = SSD_TOL
    plain = [torch.from_numpy(a).requires_grad_() for a in ins]
    ty, tS = tm2.ssd_chunked(*plain, CHUNK, remat="none",
                             init_state=None if S0 is None else torch.from_numpy(S0))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(tS.detach().numpy(), np.asarray(jS), **tol)
    # the checkpointed scan: same outputs, the same gradients
    ck = [torch.from_numpy(a).requires_grad_() for a in ins]
    s0 = None if S0 is None else torch.from_numpy(S0).requires_grad_()
    cy, cS = tm2.ssd_chunked(*ck, CHUNK, remat="block", init_state=s0)
    assert cy.grad_fn is not None and "SSDScan" in type(cy.grad_fn).__name__
    torch.testing.assert_close(cy, ty, rtol=0, atol=0)
    gy = torch.from_numpy(rng.standard_normal(ty.shape).astype(np.float32))
    gS = torch.from_numpy(rng.standard_normal(tS.shape).astype(np.float32))
    want = torch.autograd.grad((ty, tS), plain, (gy, gS))
    got = torch.autograd.grad((cy, cS), ck, (gy, gS))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **PINS)
    monkeypatch.setattr(tm2, "GROUP_BYTES", 1)          # one chunk a group
    assert len(tm2._groups((B, 3, CHUNK, H), CHUNK)) == 3
    one = [torch.from_numpy(a).requires_grad_() for a in ins]
    oy, oS = tm2.ssd_chunked(*one, CHUNK, remat="block", init_state=s0)
    torch.testing.assert_close(oy, ty, **PINS)
    for g, w in zip(torch.autograd.grad((oy, oS), one, (gy, gS)), want):
        torch.testing.assert_close(g, w, **PINS)
    # against the JAX scan's vjp: a gradient sums over every later
    # position, so its absolute tolerance is scaled by its largest entry
    _, vjp = jax.vjp(lambda *a: jm2.ssd_chunked(*a, CHUNK, init_state=(
        None if S0 is None else jnp.asarray(S0)), remat="none"), *map(jnp.asarray, ins))
    for g, w in zip(got, vjp((jnp.asarray(gy.numpy()), jnp.asarray(gS.numpy())))):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=SSD_TOL["rtol"],
                                   atol=SSD_TOL["atol"] * max(1.0, np.abs(w).max()))


def test_segsum_backward_has_no_nan():
    """The mask comes before the ``exp``: the masked entries' backward is
    exactly zero, never NaN."""
    loga = torch.tensor([[-0.5, -1.0, -2.0, -0.1]], requires_grad=True)
    out = torch.exp(tm2._segsum(loga))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.exp(np.asarray(jm2._segsum(jnp.asarray(
                                   loga.detach().numpy())))), **PINS)
    (g,) = torch.autograd.grad(out.sum(), loga)
    assert torch.isfinite(g).all()


def test_conv_and_its_chained_state_match_jax():
    """The causal depthwise conv with per-example weights off and through
    the tap (norm mode), and chained: the second half from the first's
    final window equals the whole."""
    rng = np.random.default_rng(1)
    B, T, C, K = 2, 11, 6, 4
    u = rng.standard_normal((B, T, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    jy, _, jst = jm2._causal_depthwise_conv(jnp.asarray(u), jnp.asarray(w),
                                            JDPContext.off())
    ty, _, tst = tm2._causal_depthwise_conv(torch.from_numpy(u), torch.from_numpy(w),
                                            DPContext.off())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **PINS)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **PINS)
    y1, _, s1 = tm2._causal_depthwise_conv(torch.from_numpy(u[:, :5]),
                                           torch.from_numpy(w), DPContext.off())
    y2, _, s2 = tm2._causal_depthwise_conv(torch.from_numpy(u[:, 5:]),
                                           torch.from_numpy(w), DPContext.off(), s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), ty, **PINS)
    torch.testing.assert_close(s2, tst, **PINS)
    ctx = DPContext.norm_mode(B, "fused")
    ny, _, _ = tm2._causal_depthwise_conv(torch.from_numpy(u), torch.from_numpy(w), ctx)
    torch.testing.assert_close(ny, ty, **PINS)


def _layer_params(rng, jarch):
    p = {}
    for k, s in jm2.mamba_spec(jarch).items():
        if s.init == "ones":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif s.init == "mamba_dt":
            v = rng.uniform(-5.0, -2.0, s.shape)
        elif s.init == "mamba_alog":
            v = np.log(rng.uniform(1.0, 16.0, s.shape))
        else:
            v = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        p[k] = v.astype(np.float32)
    return p


@pytest.mark.parametrize("name,T", [("mamba2-1.3b", 32), ("jamba-1.5-large-398b", 37)])
def test_mamba_apply_and_decode_match_jax(name, T):
    """The mixer off (y and its cache) and three decode steps after a
    prefill, each from the other package's state: mamba2's one group, and
    jamba's 8 groups at a length where the chunkings differ."""
    jarch, tarch = _cfgs(name)
    rng = np.random.default_rng(2)
    p = _layer_params(rng, jarch)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    x = rng.standard_normal((3, T + 3, jarch.d_model)).astype(np.float32)
    jy, _, (jconv, jssm) = jax.jit(lambda pp, xx: jm2.mamba_apply(
        pp, xx, JDPContext.off(), jarch, want_cache=True))(jp, jnp.asarray(x[:, :T]))
    jdecode = jax.jit(lambda pp, xx, c, s: jm2.mamba_decode(pp, xx, c, s, jarch))
    ty, _, (tconv, tssm) = tm2.mamba_apply(tp, torch.from_numpy(x[:, :T]),
                                           DPContext.off(), tarch, want_cache=True)
    tol = PINS if T % tarch.mamba.chunk == 0 else SSD_TOL
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), **PINS)
    np.testing.assert_allclose(tssm.numpy(), np.asarray(jssm), **tol)
    for t in range(T, T + 3):
        jy, (jconv, jssm) = jdecode(jp, jnp.asarray(x[:, t:t + 1]), jconv, jssm)
        ty, (tconv, tssm) = tm2.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                             tconv, tssm, tarch)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **tol)
        np.testing.assert_allclose(tssm.numpy(), np.asarray(jssm), **tol)
    # decode chains: the last step equals a full-length prefill's last row
    full, _, _ = tm2.mamba_apply(tp, torch.from_numpy(x), DPContext.off(), tarch)
    torch.testing.assert_close(ty[:, 0], full[:, -1], **SSD_TOL)


@functools.lru_cache(maxsize=None)
def _norms_case():
    """One layer's params, inputs and output cotangent (example 1's all
    zero), and the ground truth: each example's squared gradient norm over
    the layer's params, by vmap of grad in the JAX package."""
    jarch, _ = _cfgs()
    rng = np.random.default_rng(4)
    p = _layer_params(rng, jarch)
    B, T = 3, 32
    x = rng.standard_normal((B, T, jarch.d_model)).astype(np.float32)
    r = rng.standard_normal((B, T, jarch.d_model)).astype(np.float32)
    r[1] = 0.0

    def loss(pp, xb, rb):
        y, _, _ = jm2.mamba_apply(pp, xb[None], JDPContext.off(), jarch, remat="none")
        return jnp.sum(y[0] * rb)
    g = jax.jit(jax.vmap(jax.grad(loss), in_axes=(None, 0, 0)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(r))
    want = sum(np.sum(np.asarray(v).reshape(B, -1) ** 2, -1)
               for v in jax.tree.leaves(g))
    return p, x, r, want


@pytest.mark.parametrize("strategy", ["materialize", "gram", "auto", "fused"])
def test_layer_norms_match_jax(strategy):
    """One Mamba layer's per-example norms² through the port's sites (the
    in and out projections, the five taps) under every rule, the kernels'
    wrappers on (their plain versions on the CPU), against the JAX
    package's per-example gradients; an all-zero cotangent gives exactly
    0.  The checkpointed scan (``block``) gives the same."""
    _, tarch = _cfgs()
    p, x, r, want = _norms_case()
    B = x.shape[0]
    for remat in ("none", "block"):
        ctx = DPContext.norm_mode(B, strategy, use_kernels=True)
        acc0 = ctx.acc
        tp = {k: torch.from_numpy(v) for k, v in p.items()}
        y, ctx, _ = tm2.mamba_apply(tp, torch.from_numpy(x), ctx, tarch, remat=remat)
        (nsq,) = torch.autograd.grad(((y * torch.from_numpy(r)).sum(), ctx.acc), (acc0,),
                                     (torch.ones(()), torch.zeros(B)))
        np.testing.assert_allclose(nsq.numpy(), want, **PINS)
        assert nsq[1].item() == 0.0 and (nsq[[0, 2]] > 0).all()
