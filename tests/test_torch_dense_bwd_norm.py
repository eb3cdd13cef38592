"""The port's ``dense_bwd_norm`` (its plain version on the CPU) against the
JAX package's Pallas kernel in interpret mode and its oracle
``repro.kernels.ref.dense_bwd_ref``: ragged T / d_in / d_out, grouped
weights (E > 1), and all-zero gy rows, which must give exact zeros.

Inputs are seeded numpy arrays handed to both.  Tolerance: float32 at
rtol 1e-5 / atol 1e-4 for gx (the test_fused_norms.py sweep's) and rtol
1e-5 for nsq: the two differ only in summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_bwd import dense_bwd_norm as j_dense_bwd_norm
from repro_torch.kernels import fused_bwd as tfb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pegrad_norm as tpn

# (BG, T, di, do, E): one tile, ragged in every dim, grouped, a T past 128
SHAPES = [(2, 16, 24, 40, 1), (3, 37, 100, 70, 1), (4, 9, 33, 17, 2),
          (2, 130, 20, 150, 1)]


def _arrays(shape, seed=0):
    BG, T, di, do, E = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BG, T, di), dtype=np.float32),
            rng.standard_normal((BG, T, do), dtype=np.float32),
            rng.standard_normal((E, di, do), dtype=np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax_kernel_and_oracle(shape):
    x, gy, w = _arrays(shape)
    before = tfb.LAUNCHES
    gx, nsq = tfb.dense_bwd_norm(*map(torch.from_numpy, (x, gy, w)))
    assert tfb.LAUNCHES == before          # the CPU takes the plain version
    assert gx.dtype == torch.float32 and nsq.dtype == torch.float32
    jgx, jnsq = j_dense_bwd_norm(jnp.asarray(x), jnp.asarray(gy),
                                 jnp.asarray(w), interpret=True)
    rgx, rnsq = jref.dense_bwd_ref(jnp.asarray(x), jnp.asarray(gy),
                                   jnp.asarray(w if w.shape[0] > 1 else w[0]))
    for want_gx, want_nsq in ((jgx, jnsq), (rgx, rnsq)):
        np.testing.assert_allclose(gx.numpy(), np.asarray(want_gx), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(nsq.numpy(), np.asarray(want_nsq), rtol=1e-5)


def test_zero_gy_rows_give_exact_zeros():
    """The masked-Poisson contract: all-zero gy rows -> exactly zero gx rows
    and norms², and the other rows as in the compacted batch."""
    x, gy, w = _arrays((5, 21, 30, 26, 1), seed=1)
    keep = np.array([True, False, True, False, True])
    gy[~keep] = 0.0
    gx, nsq = tfb.dense_bwd_norm(*map(torch.from_numpy, (x, gy, w)))
    assert (gx.numpy()[~keep] == 0.0).all() and (nsq.numpy()[~keep] == 0.0).all()
    gx_c, nsq_c = tfb.dense_bwd_norm(
        *map(torch.from_numpy, (x[keep], gy[keep], w)))
    np.testing.assert_array_equal(gx.numpy()[keep], gx_c.numpy())
    np.testing.assert_array_equal(nsq.numpy()[keep], nsq_c.numpy())


@pytest.mark.parametrize("w_ndim", [2, 3])
def test_layout_shim_matches_jax_shim(w_ndim):
    """ops.dense_bwd_norm: (B,G,T,d) operands, w (di,do) or (G,di,do), the
    group norms² summed per example, as repro.kernels.ops does."""
    rng = np.random.default_rng(2)
    B, G, T, di, do = 2, 3, 11, 11, 7
    x = rng.standard_normal((B, G, T, di), dtype=np.float32)
    gy = rng.standard_normal((B, G, T, do), dtype=np.float32)
    w = rng.standard_normal((G, di, do) if w_ndim == 3 else (di, do),
                            dtype=np.float32)
    gx, nsq = tops.dense_bwd_norm(*map(torch.from_numpy, (x, gy, w)))
    jgx, jnsq = jops.dense_bwd_norm(jnp.asarray(x), jnp.asarray(gy),
                                    jnp.asarray(w))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(nsq.numpy(), np.asarray(jnsq), rtol=1e-5)


def test_halves_equal_the_fused_outputs():
    """pegrad_norm and dense_dgrad are dense_bwd_norm's two halves: equal
    outputs on the same inputs (bit for bit, here as on the card)."""
    x, gy, w = map(torch.from_numpy, _arrays((3, 19, 33, 17, 3), seed=4))
    gx, nsq = tfb.dense_bwd_norm(x, gy, w)
    assert torch.equal(tfb.dense_dgrad(gy, w), gx)
    assert torch.equal(tpn.pegrad_norm(x, gy), nsq)


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError):
        tfb.dense_bwd_norm(x, torch.zeros(2, 4, 6), torch.zeros(1, 7, 6))
    with pytest.raises(TypeError):
        tfb.dense_bwd_norm(x, torch.zeros(2, 4, 6, dtype=torch.float64),
                           torch.zeros(1, 8, 6))
