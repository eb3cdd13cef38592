"""The port's ``gram_norm`` (its plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode and its oracle
``repro.kernels.ref.gram_norm_ref``, in all four (square x mask) forms,
with ids drawn from a small vocab (tokens repeat) and a T that pads to the
kernel's tile.  Seeded numpy inputs; float32, rtol 1e-5 (summation order
only; the test_kernels.py tolerance)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.gram_norm import gram_norm as j_gram_norm
from repro_torch.core import norms as tnorms
from repro_torch.kernels import gram_norm as tgn
from repro_torch.kernels import ops as tops


def _arrays(BG=3, T=45, di=12, do=20, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BG, T, di), dtype=np.float32),
            rng.standard_normal((BG, T, do), dtype=np.float32),
            rng.integers(0, 6, (BG, T)).astype(np.int32))


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_matches_jax_kernel_and_oracle(masked, square):
    x, gy, ids = _arrays()
    tids = torch.from_numpy(ids) if masked else None
    jids = jnp.asarray(ids) if masked else None
    before = tgn.LAUNCHES
    got = tgn.gram_norm(torch.from_numpy(x), torch.from_numpy(gy), tids,
                        square=square)
    assert tgn.LAUNCHES == before and got.dtype == torch.float32
    want_k = j_gram_norm(jnp.asarray(x), jnp.asarray(gy), jids, bt=16,
                         interpret=True, square=square)
    want_r = jref.gram_norm_ref(jnp.asarray(x), jnp.asarray(gy), jids, square)
    for want in (want_k, want_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_embedding_rule_matches_table_scatter():
    """The masked, square=False form is the embedding-table norm²: equal to
    the sorted segment sum and to an explicit table scatter."""
    _, gy, ids = _arrays(seed=1)
    t_gy, t_ids = torch.from_numpy(gy), torch.from_numpy(ids)
    via_kernel = tnorms.embed_nsq(t_ids, t_gy, use_kernels=True)
    via_sort = tnorms.embed_nsq(t_ids, t_gy, use_kernels=False)
    want = jref.embed_table_nsq_ref(ids, gy, vocab=6)
    np.testing.assert_allclose(via_kernel.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(via_sort.numpy(), want, rtol=1e-5)


def test_zero_gy_rows_give_exact_zeros():
    x, gy, ids = _arrays(seed=2)
    gy[1] = 0.0
    for square in (True, False):
        out = tgn.gram_norm(torch.from_numpy(x), torch.from_numpy(gy),
                            torch.from_numpy(ids), square=square)
        assert out[1].item() == 0.0 and (out.numpy()[[0, 2]] > 0).all()


def test_layout_shim_matches_jax_shim():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 10, 8), dtype=np.float32)
    gy = rng.standard_normal((2, 3, 10, 5), dtype=np.float32)
    got = tops.gram_norm(torch.from_numpy(x), torch.from_numpy(gy))
    want = jops.gram_norm(jnp.asarray(x), jnp.asarray(gy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
