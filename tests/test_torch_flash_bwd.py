"""The port's ``flash_attn_bwd`` (its plain version on the CPU) against the
JAX package's Pallas kernel pair in interpret mode and its autodiff oracle
``repro.kernels.ref.flash_attn_bwd_ref``; causal and not, GQA (rep > 1),
ragged T.  And ``ops.flash_attention``'s backward against torch autograd
of the plain forward.

Seeded numpy inputs through both; float32.  Tolerance rtol 1e-4 /
atol 1e-5: the backward recomputes p = exp(s - lse) from the saved row
logsumexp, so on top of summation order the two differ by exp's rounding
(the test_fused_norms.py tolerance for the kernel pair).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attn import flash_attn_bwd as j_flash_attn_bwd
from repro_torch.kernels import flash_attn as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-4, atol=1e-5)
# (BH, KV rows, T, hd, causal)
SHAPES = [(4, 2, 37, 16, True), (6, 3, 20, 8, False), (3, 1, 70, 12, True)]


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax_kernel_pair(shape):
    BH, KVR, T, hd, causal = shape
    rep = BH // KVR
    rng = np.random.default_rng(0)
    q, k, v, do = (_rand(rng, n, T, hd) for n in (BH, KVR, KVR, BH))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attn_fwd(tq, tk, tv, causal=causal, rep=rep)
    before = tfa.BWD_LAUNCHES
    got = tfa.flash_attn_bwd(tq, tk, tv, o, lse, tdo, causal=causal, rep=rep)
    assert tfa.BWD_LAUNCHES == before          # the CPU takes the plain version
    want = j_flash_attn_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(o.numpy()), jnp.asarray(lse.numpy()),
                            jnp.asarray(do), causal=causal, rep=rep,
                            interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_shim_backward_matches_jax_oracle(causal):
    """ops.flash_attention_bwd in the model's 5-D layout (recompute + the
    backward pair) against autodiff of the JAX package's plain attention."""
    rng = np.random.default_rng(1)
    B, T, KV, rep, hd = 2, 19, 2, 2, 8
    q, do = _rand(rng, B, T, KV, rep, hd), _rand(rng, B, T, KV, rep, hd)
    k, v = _rand(rng, B, T, KV, hd), _rand(rng, B, T, KV, hd)
    got = tops.flash_attention_bwd(*map(torch.from_numpy, (q, k, v, do)), causal)
    want = jref.flash_attn_bwd_ref(*map(jnp.asarray, (q, k, v, do)), causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # and the JAX shim's Pallas route agrees as well
    jd = jops.flash_attention_bwd(*map(jnp.asarray, (q, k, v, do)), causal)
    for g, w in zip(got, jd):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_matches_plain_autograd(causal):
    rng = np.random.default_rng(2)
    B, T, KV, rep, hd = 2, 13, 3, 2, 16
    q = torch.from_numpy(_rand(rng, B, T, KV, rep, hd)).requires_grad_()
    k = torch.from_numpy(_rand(rng, B, T, KV, hd)).requires_grad_()
    v = torch.from_numpy(_rand(rng, B, T, KV, hd)).requires_grad_()
    do = torch.from_numpy(_rand(rng, B, T, KV, rep, hd))
    o = tops.flash_attention(q, k, v, causal)
    got = torch.autograd.grad(o, (q, k, v), do)
    o_ref = tref.flash_attn_ref(q, k, v, causal)
    want = torch.autograd.grad(o_ref, (q, k, v), do)
    torch.testing.assert_close(o, o_ref, **TOL)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, **TOL)


def test_zero_do_rows_give_exact_zeros():
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(_rand(rng, n, 24, 8)) for n in (4, 2, 2, 4))
    do[0:2] = 0.0                       # both query heads of kv head 0
    do[3, 5:9] = 0.0
    o, lse = tfa.flash_attn_fwd(q, k, v, causal=True, rep=2)
    dq, dk, dv = tfa.flash_attn_bwd(q, k, v, o, lse, do, causal=True, rep=2)
    assert (dq[0:2] == 0).all() and (dq[3, 5:9] == 0).all()
    assert (dk[0] == 0).all() and (dv[0] == 0).all()


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(4, 8, 16)
    o, lse = tfa.flash_attn_fwd(q, q[:2], q[:2], rep=2)
    with pytest.raises(ValueError):
        tfa.flash_attn_bwd(q, q[:2], q[:2], o, lse[:, :4], q, rep=2)
    with pytest.raises(TypeError):
        tfa.flash_attn_bwd(q, q[:2], q[:2], o, lse.double(), q, rep=2)
