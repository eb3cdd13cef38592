"""The port's ``clip_reduce`` (its plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode and its oracle
``repro.kernels.ref.clip_reduce_ref``: ragged B and N, float32 and bf16
gradients, a fresh sum and one added into a running sum (``out=``), the
``ops`` shim, and zeroed clip factors, which must give the reduction over
the remaining rows (the compacted batch).

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


@pytest.mark.parametrize("mode", ["fresh", "out"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,N", [(3, 1000), (8, 130), (1, 7), (11, 2048)])
def test_matches_jax_kernel_and_oracle(B, N, dtype, mode):
    """``fresh`` returns a new (N,) sum; ``out`` adds it into a running
    float32 sum in place (``out=``), which must equal that sum plus the JAX
    package's reduction."""
    g, c, tg, tc = _arrays(B, N, dtype)
    acc0 = np.random.default_rng(7).standard_normal(N).astype(np.float32)
    before = tcr.LAUNCHES
    if mode == "fresh":
        got = tcr.clip_reduce(tg, tc)
    else:
        acc = torch.from_numpy(acc0.copy())
        got = tcr.clip_reduce(tg, tc, out=acc)
        assert got is acc
    assert tcr.LAUNCHES == before            # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (N,)
    base = 0.0 if mode == "fresh" else acc0
    for want in (j_clip_reduce(g, c, interpret=True), jref.clip_reduce_ref(g, c)):
        np.testing.assert_allclose(got.numpy(), base + np.asarray(want), **TOL)


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
    for bad in (torch.zeros(4), torch.zeros(5, dtype=torch.float64), torch.zeros(5, 1)):
        with pytest.raises(ValueError, match="out"):
            tcr.clip_reduce(torch.zeros(3, 5), torch.zeros(3), out=bad)


def test_shim_adds_into_out():
    """``ops.clip_reduce(..., out=)``, the call ``clipping.clip_and_sum``
    makes: the running sum after two microbatches equals the JAX shim's two
    sums added."""
    g1, c1, tg1, tc1 = _arrays(4, 300, jnp.float32, seed=3)
    g2, c2, tg2, tc2 = _arrays(4, 300, jnp.float32, seed=4)
    acc = torch.zeros(300)
    tops.clip_reduce(tg1, tc1, out=acc)
    tops.clip_reduce(tg2, tc2, out=acc)
    np.testing.assert_allclose(
        acc.numpy(), np.asarray(jops.clip_reduce(g1, c1)) + np.asarray(jops.clip_reduce(g2, c2)),
        **TOL)
