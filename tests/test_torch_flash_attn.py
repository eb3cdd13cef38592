"""Port's flash attention forward vs the JAX package's Pallas kernel.

On the CPU the port's wrapper takes its plain version, which is what is
held to the JAX kernel here (run in interpret mode, as the JAX package's own
tests run it).  Inputs are numpy, made from a seed, fed to both.  f32
throughout; tolerance rtol 2e-4 / atol 2e-5 as in tests/test_kernels.py.
The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import flash_attn as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attn as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    # the reference is full float32: TF32 would keep ~3 digits on a card
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

# (B, T, KV, rep, hd, causal): the four configs of tests/test_kernels.py
# plus hd=96 (phi3) with GQA and a ragged length, causal and not
CONFIGS = [(2, 16, 2, 2, 8, True), (1, 33, 1, 3, 20, True),
           (2, 24, 4, 1, 96, True), (1, 16, 2, 2, 8, False),
           (1, 70, 2, 3, 96, True), (1, 37, 2, 2, 96, False)]


def _inputs(B, T, KV, rep, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, KV, rep, hd), dtype=np.float32)
    k = rng.standard_normal((B, T, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, T, KV, hd), dtype=np.float32)
    return q, k, v


def _flat(q, k, v):
    B, T, KV, rep, hd = q.shape
    qf = q.transpose(0, 2, 3, 1, 4).reshape(B * KV * rep, T, hd)
    kf = k.transpose(0, 2, 1, 3).reshape(B * KV, T, hd)
    vf = v.transpose(0, 2, 1, 3).reshape(B * KV, T, hd)
    return np.ascontiguousarray(qf), np.ascontiguousarray(kf), \
        np.ascontiguousarray(vf)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_fwd_matches_pallas_kernel(cfg):
    B, T, KV, rep, hd, causal = cfg
    qf, kf, vf = _flat(*_inputs(B, T, KV, rep, hd))
    o_j, lse_j = jfa.flash_attn_fwd(jnp.asarray(qf), jnp.asarray(kf),
                                    jnp.asarray(vf), causal=causal, rep=rep,
                                    interpret=True)
    before = tfa.LAUNCHES
    o_t, lse_t = tfa.flash_attn_fwd(torch.from_numpy(qf), torch.from_numpy(kf),
                                    torch.from_numpy(vf), causal=causal,
                                    rep=rep)
    assert tfa.LAUNCHES == before      # a CPU tensor never launches the kernel
    assert o_t.dtype == torch.float32 and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_layout_shim_matches_plain_attention(cfg):
    B, T, KV, rep, hd, causal = cfg
    q, k, v = _inputs(B, T, KV, rep, hd, seed=1)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal)
    want = jref.flash_attn_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal)
    assert got.shape == (B, T, KV, rep, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # the port's own 5-D oracle agrees as well
    np.testing.assert_allclose(
        tref.flash_attn_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal).numpy(),
        np.asarray(want), rtol=RTOL, atol=ATOL)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(6, 8, 16)
    with pytest.raises(ValueError):
        tfa.flash_attn_fwd(q, torch.zeros(4, 8, 16), torch.zeros(4, 8, 16),
                           rep=2)                       # 6 // 2 != 4 kv rows
    with pytest.raises(TypeError):
        tfa.flash_attn_fwd(q, torch.zeros(3, 8, 16, dtype=torch.float64),
                           torch.zeros(3, 8, 16), rep=2)


def test_shim_refuses_gradients():
    """Under no_grad the shim is the forward alone and records no graph;
    with a gradient to track it is differentiable through the backward
    kernels (held against plain autograd in tests/test_torch_flash_bwd.py)."""
    q = torch.zeros(1, 4, 1, 1, 8, requires_grad=True)
    k = torch.zeros(1, 4, 1, 8)
    with torch.no_grad():
        o = tops.flash_attention(q, k, k, True)
    assert o.shape == q.shape and o.grad_fn is None
    o = tops.flash_attention(q, k, k, True)
    assert o.grad_fn is not None
    (g,) = torch.autograd.grad(o.sum(), q)
    assert g.shape == q.shape
