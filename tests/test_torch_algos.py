"""The port's ``dpsgd`` (vanilla DP-SGD, ``dp.microbatch`` examples at a
time) and ``dpsgd_r1f`` (one forward, two pullbacks) against the JAX
package's same algorithms and against the port's ``dpsgd_r``: the reduced
phi3 in float32 (2 layers, B 4 x T 16), JAX-initialised weights carried
across with ``interop``, seeded numpy tokens, σ = 0, a clip norm among the
per-example norms so some examples are clipped.  Also: the clipping
functions against ``repro.core.clipping``, a Poisson-masked batch against
its compacted batch, and the work of each of ``dpsgd_r1f``'s pullbacks,
counted on the rule functions.

Pins: rtol 1e-5 / atol 2e-6 for every update, the reference's remat pin
(``tests/test_memory.py``), tighter than its three-algorithm identity
(``tests/test_dp_core.py``, rtol 1e-3); the masked batch against the
compacted one at rtol 1e-5 / atol 1e-8 (``tests/test_dp_properties.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import DPConfig as JDPConfig
from repro.core import clipping as jclipping
from repro.core import make_noisy_grad_fn as j_make_noisy_grad_fn
from repro.models.transformer import build_model
from repro_torch import interop
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import DPConfig
from repro_torch.core import algo as talgo
from repro_torch.core import clipping as tclipping
from repro_torch.core import sites as tsites
from repro_torch.kernels import ops as kops
from repro_torch.models.transformer import Model

ARCH, B, T = "phi3-mini-3.8b", 4, 16
PINS = dict(rtol=1e-5, atol=2e-6)
# a Poisson-padded batch of 5 rows: rows 1 and 4 are padding
KEEP = np.array([True, False, True, True, False])


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.fixture(scope="module")
def weights():
    """JAX-initialised weights (as numpy), a seeded batch and a clip norm
    among its per-example norms."""
    jm = build_model(jreduced(JARCHS[ARCH]), param_dtype="float32",
                     compute_dtype="float32", remat="none")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(1).integers(0, jm.arch.vocab, (B, T + 1))
    toks = toks.astype(np.int32)
    tm = _port(params, "none")
    nsq, _ = talgo.norm_pass(tm.loss_fn, tm.params,
                             {"tokens": torch.from_numpy(toks)},
                             DPConfig(norm_strategy="fused"))
    return params, toks, float(np.sqrt(np.median(nsq.numpy())))


def _port(params, remat):
    tm = Model(treduced(TARCHS[ARCH]), interop.params_from_numpy(params, "cpu"),
               dtype=torch.float32, device="cpu", remat=remat)
    tm.requires_grad_(True)
    return tm


def _dp(algo, C, **kw):
    return dict(algo=algo, clip_norm=C, noise_multiplier=0.0,
                norm_strategy="fused", **kw)


def _port_update(tm, toks, dp, denom=float(B), mask=None):
    fn = talgo.make_noisy_grad_fn(tm.loss_fn, DPConfig(use_kernels=True, **dp),
                                  expected_batch_size=denom)
    batch = {"tokens": torch.from_numpy(toks)}
    if mask is not None:
        batch["mask"] = torch.from_numpy(mask)
    return fn(tm.params, batch, torch.Generator().manual_seed(0))


def _jax_update(params, toks, dp, remat):
    jm = build_model(jreduced(JARCHS[ARCH]), param_dtype="float32",
                     compute_dtype="float32", remat=remat)
    fn = jax.jit(j_make_noisy_grad_fn(jm.loss_fn, JDPConfig(**dp),
                                      expected_batch_size=float(B)))
    return fn(jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(toks)},
              jax.random.PRNGKey(0))


def _check(port, jax_out, dpsgd_r):
    (grads, met), (jgrads, jmet) = port, jax_out
    for g, w, r in zip(grads, jax.tree.leaves(jgrads), dpsgd_r[0]):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PINS)
        torch.testing.assert_close(g, r, **PINS)
    for k in ("loss", "grad_norm_mean", "grad_norm_max", "clipped_frac"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5)
        np.testing.assert_allclose(float(met[k]), float(dpsgd_r[1][k]), rtol=1e-5)
    assert 0 < float(met["clipped_frac"]) < 1


@pytest.mark.parametrize("use_kernels", [False, True])
def test_clip_and_sum_matches_jax(use_kernels):
    """Per-example norms² and the clipped sum of seeded per-example
    gradient leaves, one example masked, against the JAX package's
    ``clipping``: the plain version and ``clip_reduce``'s (its plain
    version on the CPU), float32, rtol 1e-6 (summation order)."""
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s, dtype=np.float32) * 0.1
             for s in ((4, 3, 5, 6), (4, 7), (4, 2, 9))]
    mask = np.array([1.0, 1.0, 0.0, 1.0], dtype=np.float32)
    C = 0.5
    want, want_nsq = jclipping.clip_and_sum([jnp.asarray(g) for g in grads], C,
                                            mask=jnp.asarray(mask))
    out = [torch.zeros(g.shape[1:]) for g in grads]
    nsq = tclipping.clip_and_sum([torch.from_numpy(g) for g in grads], C, out,
                                 torch.from_numpy(mask), use_kernels)
    np.testing.assert_allclose(nsq.numpy(), np.asarray(want_nsq), rtol=1e-6)
    np.testing.assert_allclose(
        tclipping.tree_per_example_norm_sq([torch.from_numpy(g) for g in grads])
        .numpy(), np.asarray(jclipping.tree_per_example_norm_sq(
            [jnp.asarray(g) for g in grads])), rtol=1e-6)
    assert 0.0 < float(tclipping.clip_factors(nsq, C).min()) < 1.0
    for o, w in zip(out, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("max_elems", [None, 100, 7])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_flat_clip_and_sum_matches_jax_leaf_by_leaf(use_kernels, max_elems):
    """``clipping.flat_stacks``' one buffer of per-example gradients, filled
    through its strided leaf views as ``dpsgd`` fills it, reduced by one
    ``clip_and_sum`` (one ``clip_reduce`` into the flat running sum with
    kernels): each leaf view of the sum equals the JAX package's
    ``clip_and_sum`` of that leaf, and the norms² its norms², float32, rtol
    1e-6 (summation order).  The row is padded with zero columns to a
    multiple of ``ROW_ALIGN`` (16-byte rows in bf16), which add nothing.
    ``max_elems`` bounds the temporaries: blocks of whole rows (100) or
    column slices of one row (7, below the row's 88 elements)."""
    rng = np.random.default_rng(4)
    shapes = ((3, 5, 6), (7,), (2, 9), ())
    B = 4
    grads = [rng.standard_normal((B,) + s, dtype=np.float32) * 0.1 for s in shapes]
    mask = np.array([1.0, 0.0, 1.0, 1.0], dtype=np.float32)
    leaves = [torch.zeros(s) for s in shapes]
    bufs, sums, stacks, summed = tclipping.flat_stacks(leaves, B)
    n = sum(int(np.prod(s)) for s in shapes)
    assert [tuple(b.shape) for b in bufs] == [(B, -(-n // tclipping.ROW_ALIGN)
                                               * tclipping.ROW_ALIGN)]
    assert not stacks[0].is_contiguous()          # strided views of the buffer
    for st, g in zip(stacks, grads):
        for i in range(B):
            st[i].copy_(torch.from_numpy(np.asarray(g[i])))
    assert bool((bufs[0][:, n:] == 0).all())
    C = 0.5
    want, want_nsq = jclipping.clip_and_sum([jnp.asarray(g) for g in grads], C,
                                            mask=jnp.asarray(mask))
    launches = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kops, "clip_reduce",
                   lambda *a, _f=kops.clip_reduce, **k: launches.append(1) or _f(*a, **k))
        kw = {} if max_elems is None else dict(max_elems=max_elems)
        nsq = tclipping.clip_and_sum(bufs, C, sums, torch.from_numpy(mask),
                                     use_kernels, **kw)
    assert len(launches) == (1 if use_kernels else 0)
    np.testing.assert_allclose(nsq.numpy(), np.asarray(want_nsq), rtol=1e-6)
    assert 0.0 < float(tclipping.clip_factors(nsq, C).min()) < 1.0
    for o, w in zip(summed, want):
        assert o.shape == w.shape and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_flat_stacks_group_by_dtype():
    """One buffer and one running sum per parameter dtype, in the order of
    the dtypes' first leaves, each leaf's views inside its own; the flat
    reduction over both groups equals ``clip_and_sum`` over the leaves one
    by one (the same float32 sums, column for column)."""
    leaves = [torch.zeros(3, 4), torch.zeros(5, dtype=torch.bfloat16),
              torch.zeros(2, 3), torch.zeros(7, dtype=torch.bfloat16)]
    bufs, sums, stacks, summed = tclipping.flat_stacks(leaves, 3)
    assert [(b.dtype, b.shape[1]) for b in bufs] == [(torch.float32, 24),
                                                    (torch.bfloat16, 16)]
    for st, leaf, idx in zip(stacks, leaves, (0, 1, 0, 1)):
        assert st.dtype == leaf.dtype and st.shape == (3,) + leaf.shape
        assert st.untyped_storage().data_ptr() == bufs[idx].untyped_storage().data_ptr()
    for sm, idx in zip(summed, (0, 1, 0, 1)):
        assert sm.untyped_storage().data_ptr() == sums[idx].untyped_storage().data_ptr()
    rng = np.random.default_rng(5)
    for st in stacks:
        st.copy_(torch.from_numpy(rng.standard_normal(tuple(st.shape))
                                  .astype(np.float32)).to(st.dtype))
    nsq = tclipping.clip_and_sum(bufs, 1.0, sums, use_kernels=True)
    out = [torch.zeros(leaf.shape) for leaf in leaves]
    want = tclipping.clip_and_sum([st.contiguous() for st in stacks], 1.0, out,
                                  use_kernels=True)
    torch.testing.assert_close(nsq, want, rtol=1e-6, atol=0.0)
    for a, b in zip(summed, out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("microbatch,remat", [(1, "none"), (2, "block"),
                                              (4, "sites")])
def test_dpsgd_matches_jax_and_dpsgd_r(weights, microbatch, remat):
    """Vanilla DP-SGD at microbatch 1, 2 and 4 (4 = the whole batch), each
    under one remat policy, against the JAX package's dpsgd at the same
    microbatch and policy, and against the port's dpsgd_r."""
    params, toks, C = weights
    tm = _port(params, remat)
    dp = _dp("dpsgd", C, microbatch=microbatch)
    _check(_port_update(tm, toks, dp), _jax_update(params, toks, dp, remat),
           _port_update(tm, toks, _dp("dpsgd_r", C)))


@pytest.mark.parametrize("remat", ["none", "block", "sites"])
def test_dpsgd_r1f_matches_jax_and_dpsgd_r(weights, remat):
    """One forward and two pullbacks, under every remat policy (under
    ``sites`` both pullbacks go through regions that keep the tagged
    operands), against the JAX package's dpsgd_r1f under the same policy
    and the port's dpsgd_r."""
    params, toks, C = weights
    tm = _port(params, remat)
    dp = _dp("dpsgd_r1f", C)
    _check(_port_update(tm, toks, dp), _jax_update(params, toks, dp, remat),
           _port_update(tm, toks, _dp("dpsgd_r", C)))


@pytest.mark.parametrize("algo,remat", [("dpsgd", "block"),
                                        ("dpsgd_r1f", "sites")])
def test_masked_equals_compacted(weights, algo, remat):
    """A Poisson-masked batch gives the update of the same batch with its
    padded rows removed, normalised by the same expected batch; the padded
    rows' norms² are exactly zero (a padded example's gradient, or its
    cotangent seed, is zero)."""
    params, _, C = weights
    toks = np.random.default_rng(5).integers(0, 64, (KEEP.size, T + 1))
    toks = toks.astype(np.int32)
    toks[~KEEP] = 0
    tm = _port(params, remat)
    dp = _dp(algo, C, microbatch=1 if algo == "dpsgd" else 0)
    gm, mm = _port_update(tm, toks, dp, denom=3.0, mask=KEEP)
    gc, mc = _port_update(tm, toks[KEEP], dp, denom=3.0)
    for a, b in zip(gm, gc):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)
    for k in ("loss", "grad_norm_mean", "clipped_frac", "realized_batch"):
        np.testing.assert_allclose(float(mm[k]), float(mc[k]), rtol=1e-5)
    assert float(mm["realized_batch"]) == 3.0
    fn = talgo.make_clipped_sum_fn(tm.loss_fn, DPConfig(use_kernels=True, **dp))
    _, (_, nsq) = fn(tm.params, {"tokens": torch.from_numpy(toks),
                                 "mask": torch.from_numpy(KEEP)})
    keep = torch.from_numpy(KEEP)
    assert (nsq[~keep] == 0.0).all() and (nsq[keep] > 0.0).all()


@pytest.mark.parametrize("strategy", ["fused", "materialize"])
def test_dpsgd_r1f_pulls_split_the_work(weights, monkeypatch, strategy):
    """Pull 1 of dpsgd_r1f forms no parameter gradient and pull 2 no norm²,
    counted on the rule functions: the norm rules (``site_nsq``; with the
    fused route ``dense_bwd_norm``) and the parameter-gradient products
    (dense's ``_dense_gw``; tap's and embed's backwards asked for their
    parameter).  The reduced phi3 has 21 parameterised sites: per layer
    two rmsnorm taps and q, k, v, o, w1, w3, w2; the embedding, the final
    norm's tap and the head."""
    params, toks, C = weights
    log = []

    class Pull(tsites.Pull):
        def __setattr__(self, name, value):
            log.append(("stage", value))
            super().__setattr__(name, value)

    def spy(event, fn):
        def wrapped(*args, **kwargs):
            log.append((event, None))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tsites, "Pull", Pull)
    monkeypatch.setattr(tsites, "site_nsq", spy("norm", tsites.site_nsq))
    monkeypatch.setattr(kops, "dense_bwd_norm", spy("norm", kops.dense_bwd_norm))
    monkeypatch.setattr(kops, "dense_dgrad", spy("dgrad", kops.dense_dgrad))
    monkeypatch.setattr(tsites, "_dense_gw", spy("wgrad", tsites._dense_gw))
    for kind, param in (("tap", 0), ("embed", 1)):
        site = tsites.get_site(kind)

        def bwd(spec, operands, gy, needs, _bwd=site.bwd, _i=param):
            if needs[_i]:
                log.append(("wgrad", None))
            return _bwd(spec, operands, gy, needs)
        monkeypatch.setitem(tsites._REGISTRY, kind,
                            tsites.dataclasses.replace(site, bwd=bwd))
    tm = _port(params, "none")
    got, _ = _port_update(tm, toks, dict(_dp("dpsgd_r1f", C),
                                         norm_strategy=strategy))
    stages = [i for i, (e, _) in enumerate(log) if e == "stage"]
    assert [log[i][1] for i in stages] == ["both", "norms", "grads"]
    pull1, pull2 = log[stages[1]:stages[2]], log[stages[2]:]

    def count(part, event):
        return sum(e == event for e, _ in part)
    assert count(pull1, "norm") == 21 and count(pull1, "wgrad") == 0
    assert count(pull2, "norm") == 0 and count(pull2, "wgrad") == 21
    # with kernels, pull 2's activation gradients go through dense_dgrad
    assert count(pull2, "dgrad") == (15 if strategy == "fused" else 0)
    want, _ = _port_update(_port(params, "none"), toks,
                           dict(_dp("dpsgd_r", C), norm_strategy=strategy))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **PINS)
