"""The port's DP core against the JAX package's: norm rules and the site
registry against ``repro.core.norms`` / ``repro.core.sites``; the reduced
phi3's pass-1 per-example norms² under every norm strategy, with and
without kernels, and the σ = 0 update of ``make_noisy_grad_fn`` against
JAX's ``dpsgd_r``, unmasked and on a Poisson-masked batch (which must also
give the compacted batch's update, and exact-zero norms² on padded rows);
ε against ``repro.core.accountant.compute_epsilon``.

Seeded numpy inputs and JAX-initialised weights (``interop``) go through
both; float32.  Tolerances: the rules and sites at rtol 1e-5 (summation
order only); the whole model's norms² at rtol 2e-4 and its update at
rtol 1e-4 / atol 1e-6 (two layers of matmuls in another order, and the
norm² feeds the clip factor; atol for the entries near zero); ε at rtol 1e-12 (the same pure-Python
arithmetic).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import DPConfig as JDPConfig
from repro.core import DPContext as JDPContext
from repro.core import algo as jalgo
from repro.core import make_noisy_grad_fn as j_make_noisy_grad_fn
from repro.core import norms as jnorms
from repro.core import sites as jsites
from repro.core.accountant import compute_epsilon as j_compute_epsilon
from repro.models.transformer import build_model
from repro_torch import interop, tree
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import DPConfig, MoEConfig
from repro_torch.core import algo as talgo
from repro_torch.core import noise
from repro_torch.core import norms as tnorms
from repro_torch.core import sites as tsites
from repro_torch.core.accountant import compute_epsilon
from repro_torch.core.context import DPContext
from repro_torch.models.transformer import Model

RULE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


# ---------------------------------------------------------------------------
# norm rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunked", [False, True])
def test_dense_rules_match_jax(chunked, monkeypatch):
    """materialize and gram, whole and chunked (a tiny chunk budget makes
    both rules loop over several chunks)."""
    if chunked:
        monkeypatch.setattr(tnorms, "MAX_CHUNK_ELEMS", 64)
    rng = np.random.default_rng(0)
    x, gy = _rand(rng, 3, 2, 12, 10), _rand(rng, 3, 2, 12, 6)
    tx, tgy = torch.from_numpy(x), torch.from_numpy(gy)
    for t_rule, j_rule in ((tnorms.dense_nsq_materialize, jnorms.dense_nsq_materialize),
                           (tnorms.dense_nsq_gram, jnorms.dense_nsq_gram)):
        np.testing.assert_allclose(t_rule(tx, tgy).numpy(),
                                   np.asarray(j_rule(jnp.asarray(x), jnp.asarray(gy))),
                                   **RULE_TOL)


def test_small_rules_and_view_folds_match_jax():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 5, (3, 14)).astype(np.int32)
    gy = _rand(rng, 3, 14, 8)
    np.testing.assert_allclose(
        tnorms.embed_nsq(torch.from_numpy(ids), torch.from_numpy(gy)).numpy(),
        np.asarray(jnorms._embed_nsq_sorted(jnp.asarray(ids), jnp.asarray(gy))),
        **RULE_TOL)
    gp = _rand(rng, 4, 3, 5)
    np.testing.assert_allclose(tnorms.tap_nsq(torch.from_numpy(gp)).numpy(),
                               np.asarray(jnorms.tap_nsq(jnp.asarray(gp))), **RULE_TOL)
    np.testing.assert_allclose(tnorms.bias_nsq(torch.from_numpy(gp)).numpy(),
                               np.asarray(jnorms.bias_nsq(jnp.asarray(gp))), **RULE_TOL)
    x4 = _rand(rng, 6, 2, 5, 3)
    for k in (1, 2, 3):
        folded = tnorms.fold_views4(torch.from_numpy(x4), k)
        np.testing.assert_array_equal(folded.numpy(),
                                      np.asarray(jnorms.fold_views4(jnp.asarray(x4), k)))
        np.testing.assert_array_equal(tnorms.unfold_views4(folded, k).numpy(), x4)


# phi3-mini's dense sites at full width (d 3072, d_ff 8192, padded vocab
# 32256) -> what "auto" picks at B 8 x T 512 and at B 2 x T 2048: gram
# wins while T < di·do/(di+do) (1536, 2234, 2234, 2805), ties go to
# materialize (the first-registered rule)
PHI3_SITES = {(3072, 3072): ("gram", "materialize"), (3072, 8192): ("gram", "gram"),
              (8192, 3072): ("gram", "gram"), (3072, 32256): ("gram", "gram")}


def test_strategy_resolution_matches_jax():
    cases = [(((2, 16, 8), (8, 4)), (2, 16, 4)),
             (((2, 512, 64), (64, 64)), (2, 512, 64)),
             (((4, 8, 256), (256, 512)), (4, 8, 512))]
    for (di, do), picks in PHI3_SITES.items():
        for (B, T), pick in zip(((8, 512), (2, 2048)), picks):
            cases.append((((B, T, di), (di, do)), (B, T, do)))
            assert tsites.resolve_strategy("dense", "auto", *cases[-1]) == pick
    for op_shapes, gy_shape in cases:
        for strat in ("auto", "materialize", "gram", "fused"):
            assert tsites.resolve_strategy("dense", strat, op_shapes, gy_shape) \
                == jsites.resolve_strategy("dense", strat, op_shapes, gy_shape)
    assert tsites.resolve_strategy("attention", "gram", ((2, 8, 2, 1, 4),),
                                   (2, 8, 2, 1, 4)) == "fused"
    with pytest.raises(ValueError, match="registered strategies"):
        tsites.resolve_strategy("dense", "nope", ((2, 3, 4), (4, 5)), (2, 3, 5))
    with pytest.raises(KeyError, match="registered site kinds"):
        tsites.get_site("moe_dense")


# ---------------------------------------------------------------------------
# sites: gradients and norms² of one call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,use_kernels", [("fused", True), ("fused", False),
                                                  ("materialize", False),
                                                  ("materialize", True),
                                                  ("gram", True), ("auto", True)])
def test_dense_site_grads_and_norms(strategy, use_kernels):
    """Through the site the operand gradients are those of the plain op,
    and the accumulator's gradient is the per-example norm² — against the
    JAX site and an explicit per-example weight gradient."""
    rng = np.random.default_rng(2)
    B, T, di, do = 3, 9, 10, 6
    x, w, r = _rand(rng, B, T, di), _rand(rng, di, do), _rand(rng, B, T, do)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ctx = DPContext.norm_mode(B, strategy, use_kernels)
    acc0 = ctx.acc
    y, ctx = ctx.dense(tx, tw)
    gx, gw, nsq = torch.autograd.grad(((y * torch.from_numpy(r)).sum(), ctx.acc),
                                      (tx, tw, acc0),
                                      (torch.ones(()), torch.zeros(B)))
    torch.testing.assert_close(gx, torch.from_numpy(r) @ torch.from_numpy(w).t(),
                               **RULE_TOL)
    torch.testing.assert_close(gw, torch.einsum("bti,bto->io", tx.detach(),
                                                torch.from_numpy(r)), **RULE_TOL)
    per_ex = np.einsum("bti,bto->bio", x, r)
    np.testing.assert_allclose(nsq.numpy(), (per_ex ** 2).sum((1, 2)), rtol=1e-5)
    j = jsites.site_nsq(jsites.SiteSpec("dense", strategy, use_kernels),
                        (jnp.asarray(x), jnp.asarray(w)), jnp.asarray(r))
    np.testing.assert_allclose(nsq.numpy(), np.asarray(j), rtol=1e-5)


def test_detached_weight_gets_no_gradient():
    """Pass 1 runs on detached params: the site computes the input gradient
    and the norm², and no weight gradient (its callback is told so)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_rand(rng, 2, 5, 4)).requires_grad_()
    w = torch.from_numpy(_rand(rng, 4, 3))
    seen = []
    orig = tsites.get_site("dense").fused_bwd["fused"]

    def spy(spec, operands, gy, needs):
        seen.append(tuple(needs))
        return orig(spec, operands, gy, needs)

    site = tsites.get_site("dense")
    tsites._REGISTRY["dense"] = dataclasses.replace(site, fused_bwd={"fused": spy})
    try:
        acc0 = torch.zeros(2, requires_grad=True)
        y, ctx = DPContext(acc=acc0, mode="norm", strategy="fused").dense(x, w)
        gx, nsq = torch.autograd.grad((y.sum(), ctx.acc), (x, acc0),
                                      (torch.ones(()), torch.zeros(2)))
    finally:
        tsites._REGISTRY["dense"] = site
    assert seen == [(True, False)]
    assert gx.shape == x.shape and (nsq > 0).all()


@pytest.mark.parametrize("use_kernels", [True, False])
def test_attention_site_zero_norm_and_grads(use_kernels):
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(4)
    B, T, KV, rep, hd = 2, 11, 2, 2, 8
    q = torch.from_numpy(_rand(rng, B, T, KV, rep, hd)).requires_grad_()
    k = torch.from_numpy(_rand(rng, B, T, KV, hd)).requires_grad_()
    v = torch.from_numpy(_rand(rng, B, T, KV, hd)).requires_grad_()
    do = torch.from_numpy(_rand(rng, B, T, KV, rep, hd))
    acc0 = torch.zeros(B, requires_grad=True)
    ctx = DPContext(acc=acc0, mode="norm", strategy="fused", use_kernels=use_kernels)
    o, ctx = ctx.attention(q, k, v)
    *grads, nsq = torch.autograd.grad(((o * do).sum(), ctx.acc), (q, k, v, acc0),
                                      (torch.ones(()), torch.zeros(B)))
    assert (nsq == 0).all()
    want = torch.autograd.grad(tref.flash_attn_ref(q, k, v, True), (q, k, v), do)
    for g, w_ in zip(grads, want):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the reduced phi3, end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def phi3():
    """The reduced phi3 in both packages on the same (JAX-initialised)
    weights, a seeded batch, and JAX's fused pass-1 norms² and losses."""
    B, T = 3, 16
    jm = build_model(jreduced(JARCHS["phi3-mini-3.8b"]), param_dtype="float32",
                     compute_dtype="float32", remat="none")
    params = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, jm.arch.vocab, (B, T + 1))
    toks = toks.astype(np.int32)

    @jax.jit
    def side_channel(p):
        def pass1(p, acc0):
            ctx = JDPContext(acc=acc0, mode="norm", strategy="fused")
            losses, ctx = jm.loss_fn(p, {"tokens": jnp.asarray(toks)}, ctx)
            return (jnp.sum(losses), ctx.acc), losses
        _, pull, losses = jax.vjp(pass1, p, jnp.zeros((B,), jnp.float32),
                                  has_aux=True)
        return pull((jnp.ones(()), jnp.zeros((B,), jnp.float32)))[1], losses

    nsq, losses = side_channel(params)
    return jm, params, toks, np.asarray(nsq), np.asarray(losses)


def _port_model(params):
    tm = Model(treduced(TARCHS["phi3-mini-3.8b"]),
               interop.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
               dtype=torch.float32, device="cpu")
    tm.requires_grad_(True)
    return tm


@pytest.mark.parametrize("strategy,use_kernels", [("fused", True), ("fused", False),
                                                  ("gram", False),
                                                  ("materialize", True),
                                                  ("auto", True)])
def test_pass1_norms_match_jax(phi3, strategy, use_kernels):
    jm, params, toks, want_nsq, want_losses = phi3
    tm = _port_model(params)
    dp = DPConfig(norm_strategy=strategy, use_kernels=use_kernels)
    nsq, losses = talgo.norm_pass(tm.loss_fn, tm.params,
                                  {"tokens": torch.from_numpy(toks)}, dp)
    np.testing.assert_allclose(nsq.numpy(), want_nsq, rtol=2e-4)
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-5)
    assert all(p.grad is None for p in tm.parameters())    # pass 1 forms none


@pytest.mark.parametrize("grad_accum", [1, 3])
def test_sigma0_update_matches_jax_dpsgd_r(phi3, grad_accum):
    """make_noisy_grad_fn at σ = 0, fused + use_kernels (the plain versions
    on the CPU), against JAX's dpsgd_r with the fused route; the clip
    norm sits among the per-example norms so some examples are clipped."""
    jm, params, toks, nsq, _ = phi3
    tm = _port_model(params)
    C = float(np.sqrt(np.median(nsq)))
    jdp = JDPConfig(algo="dpsgd_r", norm_strategy="fused", noise_multiplier=0.0,
                    clip_norm=C)
    jgrads, jmet = jax.jit(j_make_noisy_grad_fn(jm.loss_fn, jdp))(
        params, {"tokens": jnp.asarray(toks)}, jax.random.PRNGKey(0))
    dp = DPConfig(algo="dpsgd_r", norm_strategy="fused", use_kernels=True,
                  noise_multiplier=0.0, clip_norm=C)
    fn = talgo.make_noisy_grad_fn(tm.loss_fn, dp, grad_accum=grad_accum)
    grads, met = fn(tm.params, {"tokens": torch.from_numpy(toks)},
                    torch.Generator().manual_seed(0))
    jl = jax.tree.leaves(jgrads)
    assert len(grads) == len(jl)
    for g, w in zip(grads, jl):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
    for k in ("loss", "grad_norm_mean", "grad_norm_max", "clipped_frac"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=2e-4)
    assert 0 < float(met["clipped_frac"]) < 1


# a Poisson-padded batch: rows 1 and 4 are padding (all-zero tokens)
KEEP = np.array([True, False, True, True, False])


def _masked_batch(vocab, T=16, seed=5):
    toks = np.random.default_rng(seed).integers(0, vocab, (KEEP.size, T + 1))
    toks = toks.astype(np.int32)
    toks[~KEEP] = 0
    return toks


@pytest.mark.parametrize("strategy", ["fused", "materialize"])
def test_masked_sigma0_update_matches_jax_and_the_compacted_batch(phi3, strategy):
    """σ = 0, use_kernels, normalised by an expected batch of 4 (q·N):
    the masked update equals JAX's masked dpsgd_r and the port's own update
    on the compacted batch; the padded rows' norms² are exactly zero."""
    jm, params, _, _, _ = phi3
    tm = _port_model(params)
    toks = _masked_batch(jm.arch.vocab)
    batch = {"tokens": torch.from_numpy(toks), "mask": torch.from_numpy(KEEP)}
    nsq, _ = talgo.norm_pass(tm.loss_fn, tm.params, {"tokens": batch["tokens"]},
                             DPConfig(norm_strategy=strategy, use_kernels=True),
                             batch["mask"].float())
    assert (nsq[~torch.from_numpy(KEEP)] == 0.0).all() and (nsq[KEEP] > 0).all()
    C = float(np.sqrt(np.median(nsq[KEEP].numpy())))
    dp = DPConfig(algo="dpsgd_r", norm_strategy=strategy, use_kernels=True,
                  noise_multiplier=0.0, clip_norm=C)
    fn = talgo.make_noisy_grad_fn(tm.loss_fn, dp, expected_batch_size=4.0)
    grads, met = fn(tm.params, batch, torch.Generator().manual_seed(0))
    compact, cmet = fn(tm.params, {"tokens": torch.from_numpy(toks[KEEP])},
                       torch.Generator().manual_seed(0))
    jdp = JDPConfig(algo="dpsgd_r", norm_strategy=strategy, noise_multiplier=0.0,
                    clip_norm=C)
    jgrads, jmet = jax.jit(j_make_noisy_grad_fn(jm.loss_fn, jdp,
                                                expected_batch_size=4.0))(
        params, {"tokens": jnp.asarray(toks), "mask": jnp.asarray(KEEP)},
        jax.random.PRNGKey(0))
    for g, c, w in zip(grads, compact, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-4, atol=1e-6)
    for k in ("loss", "grad_norm_mean", "grad_norm_max", "clipped_frac",
              "realized_batch"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=2e-4)
        np.testing.assert_allclose(float(met[k]), float(cmet[k]), rtol=2e-4)
    assert float(met["realized_batch"]) == 3.0


def test_all_rows_masked_give_noise_only_and_sgd_is_masked(phi3):
    """Every row padded: the clipped sum is zero and the update is the
    noise alone.  ``sgd`` averages the real rows only: the masked batch's
    gradient is the compacted batch's."""
    jm, params, _, _, _ = phi3
    tm = _port_model(params)
    toks = torch.from_numpy(_masked_batch(jm.arch.vocab))
    dp = DPConfig(algo="dpsgd_r", norm_strategy="materialize", use_kernels=True,
                  noise_multiplier=1.0, clip_norm=0.5)
    fn = talgo.make_noisy_grad_fn(tm.loss_fn, dp, expected_batch_size=4.0)
    grads, met = fn(tm.params, {"tokens": toks, "mask": torch.zeros(5, dtype=torch.bool)},
                    torch.Generator().manual_seed(3))
    noise_only = [torch.zeros_like(g) for g in grads]
    noise.add_noise_(noise_only, torch.Generator().manual_seed(3), 1.0, 0.5, 4.0)
    for g, n in zip(grads, noise_only):
        torch.testing.assert_close(g, n, rtol=0.0, atol=0.0)
    assert float(met["realized_batch"]) == 0.0
    sgd = talgo.make_noisy_grad_fn(tm.loss_fn, DPConfig(algo="sgd"))
    keep = torch.from_numpy(KEEP)
    masked, mmet = sgd(tm.params, {"tokens": toks, "mask": keep}, None)
    compact, cmet = sgd(tm.params, {"tokens": toks[keep]}, None)
    for a, b in zip(masked, compact):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(mmet["loss"]), float(cmet["loss"]), rtol=1e-6)
    assert float(mmet["realized_batch"]) == 3.0


def test_view_helpers_match_jax():
    m = np.array([1, 1, 0, 0, 1, 1], dtype=np.float32)
    c = np.array([0.5, 2.0, 1.0], dtype=np.float32)
    for k in (1, 2):
        for t_fn, j_fn, arg in ((talgo._example_mask, jalgo._example_mask, m),
                                (talgo._view_seed, jalgo._view_seed, m),
                                (talgo._expand_rows, jalgo._expand_rows, c)):
            np.testing.assert_array_equal(t_fn(torch.from_numpy(arg), k).numpy(),
                                          np.asarray(j_fn(jnp.asarray(arg), k)))
    data, mask = talgo.split_mask({"tokens": torch.zeros(2, 3),
                                   "mask": torch.tensor([True, False])})
    assert list(data) == ["tokens"] and mask.dtype == torch.float32
    assert mask.tolist() == [1.0, 0.0]


def test_unported_options_raise():
    """What the port has not taken over raises and names ROADMAP: a MoE
    arch through ``reduced`` and its MoE layers in a Model (augmult and
    adaptive clipping are ported); an unknown algorithm raises too."""
    moe = dataclasses.replace(TARCHS["phi3-mini-3.8b"], family="moe",
                              moe=MoEConfig(num_experts=4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        treduced(moe)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(moe, device="cpu")
    loss_fn = lambda p, b, c: (None, c)
    with pytest.raises(ValueError, match="unknown dp.algo"):
        talgo.make_noisy_grad_fn(loss_fn, DPConfig(algo="nope"))


@pytest.mark.parametrize("steps,B,N,sigma,delta", [
    (1000, 256, 60000, 1.1, 1e-5), (4, 8, 1_000_000, 1.0, 1e-5),
    (10_000, 4096, 1_000_000, 0.8, 1e-6), (3, 8, 1_000_000, 0.0, 1e-5),
    (0, 8, 100, 1.0, 1e-5)])
def test_epsilon_matches_jax(steps, B, N, sigma, delta):
    got = compute_epsilon(steps, B, N, sigma, delta)
    want = j_compute_epsilon(steps, B, N, sigma, delta)
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
