"""The port's ``pegrad_norm`` and ``dense_dgrad`` (their plain versions on
the CPU) against the JAX package's Pallas kernels in interpret mode: ragged
T / d_in / d_out, grouped weights (E = 1 and 4), float32 and bf16, the
layout shims over G, and all-zero gy rows, which must give exact zeros and
leave the other rows as in the compacted batch.

Inputs are seeded numpy arrays handed to both.  Tolerances: float32 at
rtol 2e-4 / atol 2e-5 (tests/test_kernels.py); bf16 norms² at rtol 3e-2
(tests/test_kernels.py's bf16 pin: the two round the product's inputs at
other places) and bf16 gx within 1e-2 of its largest entry (one bf16
rounding of the output on each side).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.fused_bwd import dense_dgrad as j_dense_dgrad
from repro.kernels.pegrad_norm import pegrad_norm as j_pegrad_norm
from repro_torch.kernels import fused_bwd as tfb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pegrad_norm as tpn

F32_TOL = dict(rtol=2e-4, atol=2e-5)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (BG, T, di, do): one tile, ragged in every dim, a T past 128
SHAPES = [(2, 16, 24, 40), (3, 37, 100, 70), (2, 130, 20, 150)]


def _pair(a, dtype):
    """The same values in both frameworks: rounded to bf16 once, in JAX,
    and handed to torch through float32 (exact for bf16 values)."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(a).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_pegrad_norm_matches_jax_kernel(shape, dtype):
    BG, T, di, do = shape
    rng = np.random.default_rng(0)
    jx, tx = _pair(_rand(rng, BG, T, di), dtype)
    jgy, tgy = _pair(_rand(rng, BG, T, do), dtype)
    before = tpn.LAUNCHES
    got = tpn.pegrad_norm(tx, tgy)
    assert tpn.LAUNCHES == before           # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (BG,)
    want = np.asarray(j_pegrad_norm(jx, jgy, interpret=True))
    tol = F32_TOL if dtype == "float32" else dict(rtol=3e-2)
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E", [1, 4])
def test_dense_dgrad_matches_jax_kernel(E, dtype):
    rng = np.random.default_rng(1)
    BG, T, di, do = 4, 37, 100, 70
    jgy, tgy = _pair(_rand(rng, BG, T, do), dtype)
    jw, tw = _pair(_rand(rng, E, di, do), dtype)
    before = tfb.DGRAD_LAUNCHES
    got = tfb.dense_dgrad(tgy, tw)
    assert tfb.DGRAD_LAUNCHES == before
    assert got.dtype == DTYPES[dtype][1] and got.shape == (BG, T, di)
    want = np.asarray(j_dense_dgrad(jgy, jw, interpret=True).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max())


def test_zero_gy_rows_give_exact_zeros_and_the_compacted_rows():
    """The masked-Poisson contract for both kernels' plain versions, with
    the JAX kernels on the compacted batch."""
    rng = np.random.default_rng(2)
    x, gy, w = _rand(rng, 5, 21, 30), _rand(rng, 5, 21, 26), _rand(rng, 2, 30, 26)
    keep = np.array([True, False, True, False, True])
    gy[~keep] = 0.0
    tx, tgy, tw = map(torch.from_numpy, (x, gy, w))
    nsq, gx = tpn.pegrad_norm(tx, tgy), tfb.dense_dgrad(tgy, tw)
    assert (nsq.numpy()[~keep] == 0.0).all() and (gx.numpy()[~keep] == 0.0).all()
    np.testing.assert_allclose(
        nsq.numpy()[keep],
        np.asarray(j_pegrad_norm(jnp.asarray(x[keep]), jnp.asarray(gy[keep]),
                                 interpret=True)), **F32_TOL)
    # row b uses w[b % E]: the kept rows 0, 2, 4 all use group 0
    np.testing.assert_allclose(
        gx.numpy()[keep],
        np.asarray(j_dense_dgrad(jnp.asarray(gy[keep]), jnp.asarray(w[:1]),
                                 interpret=True)), **F32_TOL)


@pytest.mark.parametrize("w_ndim", [2, 3])
def test_layout_shims_match_jax_shims(w_ndim):
    """ops.pegrad_norm sums the G group norms² per example; ops.dense_dgrad
    takes w (di,do) or (G,di,do), as repro.kernels.ops does."""
    rng = np.random.default_rng(3)
    B, G, T, di, do = 2, 3, 11, 13, 7
    x, gy = _rand(rng, B, G, T, di), _rand(rng, B, G, T, do)
    w = _rand(rng, *((G, di, do) if w_ndim == 3 else (di, do)))
    tx, tgy, tw = map(torch.from_numpy, (x, gy, w))
    np.testing.assert_allclose(
        tops.pegrad_norm(tx, tgy).numpy(),
        np.asarray(jops.pegrad_norm(jnp.asarray(x), jnp.asarray(gy))), **F32_TOL)
    np.testing.assert_allclose(
        tops.dense_dgrad(tgy, tw).numpy(),
        np.asarray(jops.dense_dgrad(jnp.asarray(gy), jnp.asarray(w))), **F32_TOL)


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError):
        tpn.pegrad_norm(x, torch.zeros(3, 4, 6))
    with pytest.raises(TypeError):
        tpn.pegrad_norm(x, torch.zeros(2, 4, 6, dtype=torch.float64))
    with pytest.raises(ValueError):
        tfb.dense_dgrad(torch.zeros(2, 4, 6), torch.zeros(1, 8, 5))
    with pytest.raises(TypeError):
        tfb.dense_dgrad(torch.zeros(2, 4, 6), torch.zeros(1, 8, 6, dtype=torch.float64))


def test_norm_path_asks_only_about_cuda_tensors():
    """``norm_path`` reports the path of a launch on the card; a CPU tensor
    never launches the kernel, so there is no path to report."""
    x = torch.zeros(2, 4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tpn.norm_path(x, torch.zeros(2, 4, 16, dtype=torch.bfloat16))
    assert tpn.PATHS == ("cuda-cores", "wgmma+tma", "wgmma+loads")
