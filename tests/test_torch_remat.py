"""The port's activation checkpointing (``models/layers.py`` ``remat_wrap``,
policies ``none | block | sites``) against its own ``remat="none"`` and
against the JAX package run under the same policy: the reduced phi3 in
float32 (2 layers, B 4 x T 16), JAX-initialised weights carried across with
``interop``, seeded numpy tokens, ``dpsgd_r`` with the fused route and
kernels (their plain versions on the CPU), σ = 0, unmasked and on a
Poisson-masked batch.  Also: under ``sites`` a region keeps exactly the
tagged site operands, and every backward recomputes every block once.

Pins, the reference's (``tests/test_memory.py``): ``block`` against
``sites`` bit for bit; against ``none`` losses and norms² equal and the
update within rtol 1e-5 / atol 2e-6 (bit for bit here: the CPU's recompute
is deterministic and the graph the backward walks is the same); the port
against the JAX package at rtol 1e-5 / atol 2e-6 (matmuls in another
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import DPConfig as JDPConfig
from repro.core import make_noisy_grad_fn as j_make_noisy_grad_fn
from repro.models.transformer import build_model
from repro_torch import interop
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import DPConfig
from repro_torch.core import algo as talgo
from repro_torch.core import sites as tsites
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import Model

ARCH, B, T = "phi3-mini-3.8b", 4, 16
MASK = np.array([True, False, True, True])
PINS = dict(rtol=1e-5, atol=2e-6)
POLICIES = ("none", "block", "sites")


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.fixture(scope="module")
def weights():
    """JAX-initialised weights (as numpy), a seeded batch, its masked twin
    (padded rows all-zero tokens) and a clip norm among the norms."""
    jm = build_model(jreduced(JARCHS[ARCH]), param_dtype="float32",
                     compute_dtype="float32", remat="none")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, jm.arch.vocab, (B, T + 1))
    toks = toks.astype(np.int32)
    masked = toks.copy()
    masked[~MASK] = 0
    nsq, _ = talgo.norm_pass(_port(params, "none").loss_fn,
                             _port(params, "none").params,
                             {"tokens": torch.from_numpy(toks)},
                             DPConfig(norm_strategy="fused"))
    return params, toks, masked, float(np.sqrt(np.median(nsq.numpy())))


def _port(params, remat):
    tm = Model(treduced(TARCHS[ARCH]), interop.params_from_numpy(params, "cpu"),
               dtype=torch.float32, device="cpu", remat=remat)
    tm.requires_grad_(True)
    return tm


def _batch(toks, masked):
    batch = {"tokens": torch.from_numpy(toks)}
    if masked:
        batch["mask"] = torch.from_numpy(MASK)
    return batch


def _update(tm, batch, C, algo="dpsgd_r"):
    dp = DPConfig(algo=algo, norm_strategy="fused", use_kernels=True,
                  noise_multiplier=0.0, clip_norm=C)
    fn = talgo.make_noisy_grad_fn(tm.loss_fn, dp, expected_batch_size=float(B))
    return fn(tm.params, batch, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("masked", [False, True])
def test_policies_agree(weights, masked):
    """Losses and pass-1 norms² equal across the three policies; the σ = 0
    update of block equal to sites bit for bit and to none at the pins."""
    params, toks, mtoks, C = weights
    batch = _batch(mtoks if masked else toks, masked)
    data, mask = talgo.split_mask(batch)
    out = {}
    for remat in POLICIES:
        tm = _port(params, remat)
        nsq, losses = talgo.norm_pass(tm.loss_fn, tm.params, data,
                                      DPConfig(norm_strategy="fused",
                                               use_kernels=True), mask)
        out[remat] = (nsq, losses, _update(tm, batch, C)[0])
    if masked:
        assert (out["sites"][0][~torch.from_numpy(MASK)] == 0).all()
    for remat in ("block", "sites"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert torch.equal(out[remat][1], out["none"][1])
        for got, want in zip(out[remat][2], out["none"][2]):
            torch.testing.assert_close(got, want, **PINS)
    for got, want in zip(out["block"][2], out["sites"][2]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("remat", POLICIES)
def test_policy_matches_jax(weights, remat):
    """Each policy against the JAX package's dpsgd_r under the same policy,
    unmasked and on the masked batch: update and metrics.  The reference
    takes the unmasked batch with a mask of ones (the same update and
    metrics), so both batches share one compile."""
    params, toks, mtoks, C = weights
    jm = build_model(jreduced(JARCHS[ARCH]), param_dtype="float32",
                     compute_dtype="float32", remat=remat)
    jdp = JDPConfig(algo="dpsgd_r", norm_strategy="fused",
                    noise_multiplier=0.0, clip_norm=C)
    jfn = jax.jit(j_make_noisy_grad_fn(jm.loss_fn, jdp,
                                       expected_batch_size=float(B)))
    tm = _port(params, remat)
    jparams = jax.tree.map(jnp.asarray, params)
    for masked in (False, True):
        t = mtoks if masked else toks
        jbatch = {"tokens": jnp.asarray(t),
                  "mask": jnp.asarray(MASK if masked else np.ones_like(MASK))}
        jgrads, jmet = jfn(jparams, jbatch, jax.random.PRNGKey(0))
        grads, met = _update(tm, _batch(t, masked), C)
        for g, w in zip(grads, jax.tree.leaves(jgrads)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **PINS)
        for k in ("loss", "grad_norm_mean", "clipped_frac", "realized_batch"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5)
        assert 0 < float(met["clipped_frac"]) < 1


@pytest.mark.parametrize("remat", ["block", "sites"])
@pytest.mark.parametrize("mode", ["norm", "off"])
def test_regions_keep_exactly_the_tagged_site_operands(weights, monkeypatch,
                                                       remat, mode):
    """Each block's region, in the norm pass and in the plain pass: under
    ``sites`` the saved tensors it keeps are exactly those in the tagged
    site operands' storages (the four distinct dense inputs of a layer:
    the two rmsnorm outputs, the attention output and the MLP product),
    and it recomputes the rest; under ``block`` it keeps none."""
    params, toks, _, _ = weights
    seen = []
    orig = tsites.is_saved_operand

    def spy(t, saved):
        kept = orig(t, saved)
        # the record is emptied when its region's run ends: take what it
        # holds now
        seen.append((saved, tsites._storage_key(t), kept,
                     set(saved) if saved is not None else set()))
        return kept

    monkeypatch.setattr(tsites, "is_saved_operand", spy)
    tm = _port(params, remat)
    data = {"tokens": torch.from_numpy(toks)}
    if mode == "norm":
        talgo.norm_pass(tm.loss_fn, tm.params, data,
                        DPConfig(norm_strategy="fused", use_kernels=True))
    else:
        talgo.reweighted_grads(tm.loss_fn, tm.params, data, torch.ones(B))
    regions = {}
    for saved, key, kept, tagged in seen:
        regions.setdefault(id(saved), (saved, set(), set(), []))
        _, keys, tags, flags = regions[id(saved)]
        flags.append(kept)
        tags |= tagged
        if kept:
            keys.add(key)
    # sites: a record for the forward of each of the 2 blocks and for its
    # recompute in the backward; block: no record at all
    assert len(regions) == (4 if remat == "sites" else 1)
    for saved, kept_keys, tags, flags in regions.values():
        assert not all(flags)              # the rest is recomputed
        if remat == "block":
            assert saved is None and not any(flags)
        else:
            assert kept_keys == tags and len(tags) == 4
            assert not saved               # emptied when the run ended


@pytest.mark.parametrize("remat,algo,regions,each", [("none", "dpsgd_r", 0, 0),
                                                    ("block", "dpsgd_r", 4, 1),
                                                    ("sites", "dpsgd_r1f", 2, 2),
                                                    ("block", "sgd", 2, 1)])
def test_each_backward_recomputes_each_block_once(weights, monkeypatch, remat,
                                                  algo, regions, each):
    """2 blocks: dpsgd_r's two passes (a forward each) recompute each of
    their blocks once; dpsgd_r1f's one forward gives 2 regions, each
    recomputed by both pullbacks; sgd's one backward recomputes each block
    once.  The update is that of ``none``."""
    params, toks, _, C = weights
    calls = []
    orig = tlayers._Region._recompute

    def counting(self):
        calls.append(self)
        return orig(self)

    monkeypatch.setattr(tlayers._Region, "_recompute", counting)
    got, _ = _update(_port(params, remat), _batch(toks, False), C, algo)
    per_region = {}
    for r in calls:
        per_region[id(r)] = per_region.get(id(r), 0) + 1
    assert len(per_region) == regions
    assert all(n == each for n in per_region.values())
    want_grads, _ = _update(_port(params, "none"), _batch(toks, False), C, algo)
    for g, w in zip(got, want_grads):
        torch.testing.assert_close(g, w, **PINS)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="known policies"):
        tlayers.remat_wrap(lambda x, acc, saved=None: (x, acc), "everything")


def _live_tensor_bytes():
    import gc
    import warnings
    gc.collect()
    storages = {}
    with warnings.catch_warnings():
        # the scan touches torch's deprecated module aliases too
        warnings.simplefilter("ignore", FutureWarning)
        for o in gc.get_objects():
            if isinstance(o, torch.Tensor):
                st = o.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


@pytest.mark.parametrize("remat,algo", [("block", "dpsgd_r"), ("sites", "dpsgd_r"),
                                        ("sites", "dpsgd_r1f"), ("sites", "sgd")])
def test_no_activation_outlives_its_step(weights, remat, algo):
    """Once a step's gradients are out, nothing a checkpointed region kept
    or recomputed is left alive: the live tensors after a second step are
    those after the first (a record of tagged operands still held by the
    saved tensors' pack hooks would close a cycle through autograd's nodes
    and keep them, and the graph behind them, step after step)."""
    params, toks, _, C = weights
    tm = _port(params, remat)
    _update(tm, _batch(toks, False), C, algo)
    before = _live_tensor_bytes()
    _update(tm, _batch(toks, False), C, algo)
    assert _live_tensor_bytes() == before
