"""The port's ``conv2d`` and ``bias`` sites and its CNN against the JAX
package's, on seeded numpy inputs in float32.

The conv2d site at stride 1 and 2 and kernel 1, 3 and 4: its forward, its
im2col patches against ``jax.lax.conv_general_dilated_patches`` (the
stride-2 cases show JAX's SAME padding rule, which puts the odd pixel on
the high side where PyTorch's symmetric ``padding=`` would shift every
window), and under each norm rule (``materialize``, ``gram``, ``fused``;
the port's kernel routes, which on the CPU take the kernels' plain
versions, and its plain rules) the input and weight gradients and the
per-example norms², with augmentation multiplicity folded in.  The bias
rule likewise.  The reduced CNN (seeded numpy weights in the JAX
package's param tree, through ``interop``): per-example losses and norms²
under the three rules.

Pins: rtol 1e-5 / atol 2e-6 (ROADMAP's pins for the port's parity tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.context import DPContext as JDPContext
from repro.core.sites import conv_norm_dims as j_conv_norm_dims
from repro.core.sites import get_site as j_get_site
from repro.models import build_model_for as j_build
from repro.models.cnn import iter_conv_sites as j_iter_conv_sites
from repro_torch import interop
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import DPConfig
from repro_torch.core import algo as talgo
from repro_torch.core import sites as tsites
from repro_torch.core.context import DPContext
from repro_torch.models import build_model_for
from repro_torch.models.cnn import iter_conv_sites

PINS = dict(rtol=1e-5, atol=2e-6)
RULES = ("materialize", "gram", "fused")
# (image size, Cin, Cout, kernel, stride, augmult K)
CONV_CASES = [(8, 3, 4, 3, 1, 1), (8, 3, 4, 3, 2, 2), (7, 4, 5, 3, 2, 1),
              (8, 4, 6, 1, 2, 2), (8, 3, 8, 4, 4, 1)]


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **PINS)


def image_params(jm, seed=0):
    """Seeded numpy weights in the JAX model's param tree: N(0, 1/fan_in)
    for weights, 1 + N(0, 0.1²) for norm scales, N(0, 0.1²) for biases and
    the position embedding, so every leaf is nonzero.  (The JAX package's
    own init, run eagerly, takes seconds on the CPU.)"""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if len(a.shape) == 1:
            base = 1.0 if ("ln" in name or "norm" in name) else 0.0
            return (base + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if "pos" in name:
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1]))
        return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jm.abstract_params())


def _jax_site(kind, x, w, gy, K, strategy, **kw):
    """(y, operand grads, norms²) of one JAX site in norm mode."""
    B = x.shape[0] // K

    def f(x_, w_, acc):
        ctx = JDPContext(acc=acc, mode="norm", strategy=strategy,
                         use_kernels=False, augmult=K)
        y, ctx = getattr(ctx, kind)(x_, w_, **kw)
        return y, ctx.acc

    (y, _), pull = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.zeros((B,)))
    gx, gw, nsq = pull((jnp.asarray(gy), jnp.zeros((B,))))
    return y, gx, gw, nsq


def _port_site(kind, x, w, gy, K, strategy, use_kernels, **kw):
    B = x.shape[0] // K
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    ctx = DPContext.norm_mode(B, strategy, use_kernels, K, "cpu")
    acc0 = ctx.acc
    y, ctx = getattr(ctx, kind)(xt, wt, **kw)
    gx, gw, nsq = torch.autograd.grad((y, ctx.acc), (xt, wt, acc0),
                                      (torch.from_numpy(gy), torch.zeros(B)))
    return y.detach(), gx, gw, nsq


@pytest.mark.parametrize("strategy", RULES)
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "s{}k{}K{}H{}".format(
    c[4], c[3], c[5], c[0]))
def test_conv2d_site_matches_jax(case, strategy):
    """Forward, dx, dw and the norms² of one conv2d site under a norm rule,
    through the port's plain rules and its kernel routes."""
    H, cin, cout, k, s, K = case
    rng = np.random.default_rng(sum(case))
    x = rng.standard_normal((2 * K, H, H, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    jy = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (s, s),
                                      "SAME", dimension_numbers=("NHWC", "HWIO",
                                                                 "NHWC"))
    gy = rng.standard_normal(jy.shape).astype(np.float32)
    y, gx, gw, nsq = _jax_site("conv2d", x, w, gy, K, strategy, stride=s)
    for use_kernels in (False, True):
        ty, tgx, tgw, tnsq = _port_site("conv2d", x, w, gy, K, strategy,
                                        use_kernels, stride=s)
        assert ty.shape == y.shape
        _close(ty, y)
        _close(tgx, gx)
        _close(tgw, gw)
        _close(tnsq, nsq)


@pytest.mark.parametrize("stride,k", [(1, 1), (1, 3), (2, 1), (2, 3)])
def test_conv_patches_and_padding_match_jax(stride, k):
    """The im2col patches (Cin-major features) equal
    ``conv_general_dilated_patches`` with SAME padding bit for bit, and
    the flat weight makes the forward a matmul of them; at stride 2 and k
    3 the padding is (0, 1), which PyTorch's symmetric ``padding=1``
    would get wrong."""
    rng = np.random.default_rng(stride * 10 + k)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    spec = tsites.SiteSpec("conv2d", meta=(stride, "SAME"))
    pat = tsites._conv_patches(spec, torch.from_numpy(x), torch.from_numpy(w))
    want = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), filter_shape=(k, k), window_strides=(stride, stride),
        padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_array_equal(pat.numpy(), np.asarray(want))
    y = tsites._conv2d_fwd(spec, torch.from_numpy(x), torch.from_numpy(w))
    _close(pat @ tsites._conv_wflat(torch.from_numpy(w)), y)
    pads = tsites._same_pads(8, k, stride)
    assert pads == {(1, 1): (0, 0), (1, 3): (1, 1), (2, 1): (0, 0),
                    (2, 3): (0, 1)}[(stride, k)]
    if (stride, k) == (2, 3):
        sym = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(w).permute(3, 2, 0, 1), stride=2, padding=1)
        assert sym.shape[-2:] == y.shape[1:3]
        assert not torch.allclose(sym.permute(0, 2, 3, 1), y)


@pytest.mark.parametrize("K,rank", [(1, 2), (1, 4), (4, 2), (4, 4)])
def test_bias_site_matches_jax(K, rank):
    """The bias site's forward, gradients and rule (K views folded into the
    summed position axis), on a dense output and on a feature map."""
    rng = np.random.default_rng(K * 10 + rank)
    shape = (2 * K, 6) if rank == 2 else (2 * K, 3, 3, 6)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    gy = rng.standard_normal(shape).astype(np.float32)
    y, gx, gb, nsq = _jax_site("bias", x, b, gy, K, "auto")
    ty, tgx, tgb, tnsq = _port_site("bias", x, b, gy, K, "auto", True)
    for got, want in ((ty, y), (tgx, gx), (tgb, gb), (tnsq, nsq)):
        _close(got, want)


def test_conv_sites_and_flops_match_jax():
    """``iter_conv_sites``, ``conv_norm_dims`` and every rule's FLOP
    formula (what ``auto`` resolves by) equal the JAX package's at the
    full CNN's shapes."""
    for name in ("cnn-cifar10", "cnn-cifar10-reduced"):
        tarch = get_arch("cnn-cifar10")
        jarch = JARCHS["cnn-cifar10"]
        if name.endswith("reduced"):
            tarch, jarch = reduced(tarch), jreduced(jarch)
        got = list(iter_conv_sites(tarch, 16))
        want = list(j_iter_conv_sites(jarch, 16))
        assert got == want
        jsite, tsite = j_get_site("conv2d"), tsites.get_site("conv2d")
        for _, shapes, gy in got:
            assert tsites.conv_norm_dims(shapes, gy) == j_conv_norm_dims(shapes, gy)
            for rule in RULES:
                assert tsite.flops[rule](shapes, gy) == jsite.flops[rule](shapes, gy)
            assert tsites.resolve_strategy("conv2d", "auto", shapes, gy) in RULES
    assert len(got) == 6      # stem; s0b0 w1, w2; s1b0 w1, w2, proj


@pytest.fixture(scope="module")
def cnn():
    """The reduced CNN: JAX model, seeded weights (numpy), the port's model
    on them, and a seeded batch of 3 images."""
    jm = j_build(jreduced(JARCHS["cnn-cifar10"]), param_dtype="float32",
                 compute_dtype="float32", remat="none")
    params = image_params(jm)
    tm = build_model_for(reduced(get_arch("cnn-cifar10")),
                         interop.params_from_numpy(params, "cpu"),
                         dtype=torch.float32, device="cpu", remat="none")
    rng = np.random.default_rng(3)
    images = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 3).astype(np.int32)
    return jm, params, tm, {"images": images, "labels": labels}


def jax_norms(jm, params, batch, strategy):
    """(per-example losses, norms²) of the JAX model's norm pass under
    ``strategy`` (plain rules), jitted: eagerly it takes seconds."""
    B = batch["labels"].shape[0]

    def run(p, b):
        def f(p_, acc):
            ctx = JDPContext(acc=acc, mode="norm", strategy=strategy,
                             use_kernels=False)
            losses, ctx = jm.loss_fn(p_, b, ctx)
            return (jnp.sum(losses), ctx.acc), losses

        _, pull, losses = jax.vjp(f, p, jnp.zeros((B,)), has_aux=True)
        _, nsq = pull((jnp.ones(()), jnp.zeros((B,))))
        return losses, nsq

    return jax.jit(run)(params, batch)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("strategy", RULES)
def test_cnn_losses_and_norms_match_jax(cnn, strategy, use_kernels):
    """Per-example losses and norms² of the reduced CNN (stride-2 stage
    with its 1 x 1 projection, channel RMSNorm taps, the bias and dense
    head) under each norm rule."""
    jm, params, tm, batch = cnn
    losses, nsq = jax_norms(jm, params, batch, strategy)
    dp = DPConfig(norm_strategy=strategy, use_kernels=use_kernels)
    tnsq, tlosses = talgo.norm_pass(tm.loss_fn, tm.params,
                                    {k: torch.from_numpy(v) for k, v in batch.items()},
                                    dp)
    _close(tlosses, losses)
    _close(tnsq, nsq)
