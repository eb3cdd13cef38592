"""Augmentation multiplicity and the image data of the port against the JAX
package's.

``augment_expand`` gives the JAX package's arrays bit for bit (view 0 the
image, views k >= 1 flip plus pad-4 crop from the same Philox streams,
rows b-major / k-minor, labels and mask repeated over K) and returns the
batch itself at K = 1; the synthetic image source's ``image_batch`` and
``image_examples``, and the image branches of ``batch_for`` and
``poisson_batch_for``, give the JAX package's arrays bit for bit.  One
``dpsgd_r`` (fused, the kernels' plain versions) and one ``dpsgd`` step of
each image model at augmult 1 and 4, σ = 0, against the JAX package's, and
a Poisson-masked batch against its compacted batch in the port.

Pins: rtol 1e-5 / atol 2e-6 (ROADMAP's pins for the port's parity tests),
also for the masked batch's clipped sum against the compacted one's (the
weight gradients of a conv sum over positions and rows in another order
at another row count); the norms² of the real examples at rtol 1e-5 /
atol 1e-8 (``tests/test_dp_properties.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, SHAPES as JSHAPES, reduced as jreduced
from repro.configs.base import DPConfig as JDPConfig
from repro.core import make_noisy_grad_fn as j_make_noisy_grad_fn
from repro.data import pipeline as jpipe
from repro.models import build_model_for as j_build
from repro_torch import interop
from repro_torch.configs import SHAPES, get_arch, reduced
from repro_torch.configs.base import DPConfig, ShapeConfig
from repro_torch.core import algo as talgo
from repro_torch.data import pipeline as tpipe
from repro_torch.models import build_model_for
from test_torch_cnn import image_params

PINS = dict(rtol=1e-5, atol=2e-6)
ARCHS = ("cnn-cifar10", "vit-cifar10")


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("k", [2, 4])
def test_augment_expand_matches_jax(k):
    """A Poisson-padded batch (rows 3 and 4 all zero, masked out): every
    leaf bit for bit; the padded rows stay all zero in every view."""
    rng = np.random.default_rng(k)
    imgs = rng.standard_normal((5, 8, 8, 3)).astype(np.float32)
    imgs[3:] = 0.0
    batch = {"images": imgs, "labels": rng.integers(0, 10, 5).astype(np.int32),
             "mask": np.array([True, True, True, False, False])}
    got = tpipe.augment_expand(batch, k, seed=3, step=7)
    _equal(got, jpipe.augment_expand(batch, k, seed=3, step=7))
    assert got["images"].shape[0] == 5 * k
    assert not got["images"][3 * k:].any()
    np.testing.assert_array_equal(got["images"][::k], imgs)       # view 0
    assert tpipe.augment_expand(batch, 1, 3, 7) is batch


@pytest.mark.parametrize("name", ARCHS)
def test_image_batches_match_jax(name):
    """``image_batch`` (per shard too), ``image_examples``, and the image
    branches of ``batch_for`` and ``poisson_batch_for`` (with their
    ``"mask"``), at the full image shape."""
    tarch, jarch = get_arch(name), JARCHS[name]
    tsrc, jsrc = tpipe.SyntheticSource(10, seed=2), jpipe.SyntheticSource(10, seed=2)
    _equal(tsrc.image_batch(5, 6, 32, 3, 10, shard=1, n_shards=2),
           jsrc.image_batch(5, 6, 32, 3, 10, shard=1, n_shards=2))
    idx = np.array([0, 17, 999_999])
    _equal(tsrc.image_examples(idx, 32, 3, 10), jsrc.image_examples(idx, 32, 3, 10))
    tshape = ShapeConfig("t", 1, 6, "train")
    jshape = JSHAPES["train_4k"].__class__("t", 1, 6, "train")
    _equal(tpipe.batch_for(tsrc, tarch, tshape, 4),
           jpipe.batch_for(jsrc, jarch, jshape, 4))
    got = tpipe.poisson_batch_for(tsrc, tarch, tshape, 4, capacity=12,
                                  sample_rate=6e-6)
    _equal(got, jpipe.poisson_batch_for(jsrc, jarch, jshape, 4, capacity=12,
                                        sample_rate=6e-6))
    assert got["mask"].any() and not got["mask"].all()
    assert SHAPES["train_4k"].global_batch == 256


def _models(name):
    jm = j_build(jreduced(JARCHS[name]), param_dtype="float32",
                 compute_dtype="float32", remat="none")
    params = image_params(jm, seed=5)
    tm = build_model_for(reduced(get_arch(name)),
                         interop.params_from_numpy(params, "cpu"),
                         dtype=torch.float32, device="cpu", remat="none")
    tm.requires_grad_(True)
    return jm, params, tm


def _batch(k, B=3):
    rng = np.random.default_rng(11)
    batch = {"images": rng.standard_normal((B, 8, 8, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, B).astype(np.int32)}
    return tpipe.augment_expand(batch, k, seed=0, step=0)


def _dp(algo, k, C):
    return dict(algo=algo, augmult=k, clip_norm=C, noise_multiplier=0.0,
                norm_strategy="fused")


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("algo", ["dpsgd_r", "dpsgd"])
@pytest.mark.parametrize("name", ARCHS)
def test_clipped_step_matches_jax(name, algo, k):
    """The noised (σ = 0) clipped mean of one batch of 3 examples x K
    views, at a clip norm that clips some examples."""
    jm, params, tm = _models(name)
    batch = _batch(k)
    tb = {key: torch.from_numpy(v) for key, v in batch.items()}
    nsq, _ = talgo.norm_pass(tm.loss_fn, tm.params, tb,
                             DPConfig(norm_strategy="fused", augmult=k))
    n = np.sort(np.sqrt(nsq.numpy()))
    C = float(n[0] + n[1]) / 2            # between two norms: no tie at C
    jfn = j_make_noisy_grad_fn(jm.loss_fn, JDPConfig(**_dp(algo, k, C)))
    want, wm = jax.jit(jfn)(params, jax.tree.map(jnp.asarray, batch),
                            jax.random.PRNGKey(0))
    tfn = talgo.make_noisy_grad_fn(tm.loss_fn, DPConfig(use_kernels=True,
                                                        **_dp(algo, k, C)))
    got, tmets = tfn(tm.params, tb, torch.Generator())
    for key in ("loss", "grad_norm_mean", "clipped_frac"):
        np.testing.assert_allclose(float(tmets[key]), float(wm[key]), **PINS)
    assert 0.0 < float(tmets["clipped_frac"]) < 1.0
    for a, b in zip(got, jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **PINS)


@pytest.mark.parametrize("algo", ["dpsgd_r", "dpsgd"])
@pytest.mark.parametrize("name", ARCHS)
def test_masked_views_equal_compacted(name, algo):
    """K 4: a batch of 3 examples padded to 5 (two all-zero examples, each
    with its 4 views masked out) gives the compacted batch's clipped sum
    and norms², the padded examples' norms² exactly 0."""
    _, _, tm = _models(name)
    k = 4
    rng = np.random.default_rng(12)
    imgs = rng.standard_normal((5, 8, 8, 3)).astype(np.float32)
    imgs[3:] = 0.0
    padded = {"images": imgs, "labels": rng.integers(0, 10, 5).astype(np.int32),
              "mask": np.array([True] * 3 + [False] * 2)}
    padded = tpipe.augment_expand(padded, k, seed=0, step=1)
    compact = {key: v[:3 * k] for key, v in padded.items() if key != "mask"}
    fn = talgo.make_clipped_sum_fn(tm.loss_fn, DPConfig(**_dp(algo, k, 1.0),
                                                        use_kernels=True))
    gp, (_, nsq_p) = fn(tm.params, {key: torch.from_numpy(v)
                                    for key, v in padded.items()})
    gc, (_, nsq_c) = fn(tm.params, {key: torch.from_numpy(v)
                                    for key, v in compact.items()})
    assert nsq_p.shape == (5,) and torch.all(nsq_p[3:] == 0.0)
    np.testing.assert_allclose(nsq_p[:3].numpy(), nsq_c.numpy(), rtol=1e-5,
                               atol=1e-8)
    for a, b in zip(gp, gc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PINS)
