"""The port's ``clip_reduce`` (its plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode and its oracle
``repro.kernels.ref.clip_reduce_ref``: ragged B and N, float32 and bf16
gradients, the ``ops`` shim, and zeroed clip factors, which must give the
reduction over the remaining rows (the compacted batch).

Seeded numpy inputs.  Tolerances: rtol 2e-4 / atol 2e-5 (tests/test_kernels.py's
float32 pin; the sums run in float32 in another order); bf16 gradients
reach both as the same bf16 values and are summed in float32, so the same
pin holds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.clip_reduce import clip_reduce as j_clip_reduce
from repro_torch.kernels import clip_reduce as tcr
from repro_torch.kernels import ops as tops

TOL = dict(rtol=2e-4, atol=2e-5)


def _arrays(B, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    g = jnp.asarray(rng.standard_normal((B, N), dtype=np.float32)).astype(dtype)
    c = rng.uniform(0.1, 1.0, B).astype(np.float32)
    tg = torch.from_numpy(np.array(g.astype(jnp.float32)))
    if dtype == jnp.bfloat16:
        tg = tg.to(torch.bfloat16)
    return g, jnp.asarray(c), tg, torch.from_numpy(c)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,N", [(3, 1000), (8, 130), (1, 7), (11, 2048)])
def test_matches_jax_kernel_and_oracle(B, N, dtype):
    g, c, tg, tc = _arrays(B, N, dtype)
    before = tcr.LAUNCHES
    got = tcr.clip_reduce(tg, tc)
    assert tcr.LAUNCHES == before            # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (N,)
    for want in (j_clip_reduce(g, c, interpret=True), jref.clip_reduce_ref(g, c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_zero_clip_factors_equal_the_compacted_batch():
    g, c, tg, tc = _arrays(9, 517, jnp.float32, seed=1)
    keep = np.array([1, 0, 1, 1, 0, 1, 0, 0, 1], dtype=bool)
    tcm = torch.where(torch.from_numpy(keep), tc, torch.zeros_like(tc))
    got = tcr.clip_reduce(tg, tcm)
    want = j_clip_reduce(g[keep], c[keep], interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               tcr.clip_reduce(tg[keep], tc[keep]).numpy(), **TOL)


def test_shim_matches_jax_shim():
    g, c, tg, tc = _arrays(4, 300, jnp.float32, seed=2)
    np.testing.assert_allclose(tops.clip_reduce(tg, tc).numpy(),
                               np.asarray(jops.clip_reduce(g, c)), **TOL)


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        tcr.clip_reduce(torch.zeros(3, 5), torch.zeros(4))
    with pytest.raises(ValueError):
        tcr.clip_reduce(torch.zeros(3, 5, 2), torch.zeros(3))
    with pytest.raises(TypeError):
        tcr.clip_reduce(torch.zeros(3, 5, dtype=torch.int32), torch.zeros(3))
