"""Port's layers vs the JAX package's, called with ``DPContext.off()``.

Same numpy inputs (seeded) through both; f32; atol 1e-5 (rtol 1e-5): the
two differ only in summation order inside the matmuls and reductions.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.context import DPContext
from repro.models import layers as JL
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.core.context import DPContext as TDPContext
from repro_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH_NAMES = ["phi3-mini-3.8b", "stablelm-3b", "starcoder2-7b", "chatglm3-6b"]


@pytest.fixture(autouse=True)
def _no_tf32():
    # the reference is full float32: TF32 would keep ~3 digits on a card
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _cfgs(name):
    return jreduced(JARCHS[name]), treduced(TARCHS[name])


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _attn_params(rng, cfg):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": _rand(rng, d, H * hd, scale=d ** -0.5),
            "wk": _rand(rng, d, KV * hd, scale=d ** -0.5),
            "wv": _rand(rng, d, KV * hd, scale=d ** -0.5),
            "wo": _rand(rng, H * hd, d, scale=(H * hd) ** -0.5)}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 5, 64), _rand(rng, 64)
    want, _ = JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale), DPContext.off(),
                         1e-5)
    got, _ = TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale),
                        TDPContext.off(), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pct", [1.0, 0.5, 0.25])
def test_rope(pct):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 9, 4, 16)
    pos = rng.integers(0, 60, (2, 9)).astype(np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, pct)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, pct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "starcoder2-7b"])
def test_mlp_apply(name):
    """swiglu (phi3) and gelu (starcoder2)."""
    jcfg, tcfg = _cfgs(name)
    rng = np.random.default_rng(2)
    d, f = jcfg.d_model, jcfg.d_ff
    p = {"w1": _rand(rng, d, f, scale=d ** -0.5),
         "w2": _rand(rng, f, d, scale=f ** -0.5)}
    if jcfg.mlp_act == "swiglu":
        p["w3"] = _rand(rng, d, f, scale=d ** -0.5)
    x = _rand(rng, 2, 7, d)
    want, _ = JL.mlp_apply(_j(p), jnp.asarray(x), DPContext.off(), jcfg)
    got, _ = TL.mlp_apply(_t(p), torch.from_numpy(x), TDPContext.off(), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_attn_apply(name):
    """Prefill attention: the port's flash path (plain version on the CPU)
    against the JAX blocked-causal path, output and cached k/v."""
    jcfg, tcfg = _cfgs(name)
    rng = np.random.default_rng(3)
    p = _attn_params(rng, jcfg)
    B, T = 2, 11
    x = _rand(rng, B, T, jcfg.d_model)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    want, _, (jk, jv) = JL.attn_apply(_j(p), jnp.asarray(x), DPContext.off(),
                                      jcfg, jnp.asarray(pos))
    got, _, (tk, tv) = TL.attn_apply(_t(p), torch.from_numpy(x),
                                     TDPContext.off(), tcfg,
                                     torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_attn_decode(name):
    jcfg, tcfg = _cfgs(name)
    rng = np.random.default_rng(4)
    p = _attn_params(rng, jcfg)
    B, S, KV, hd = 3, 12, jcfg.n_kv_heads, jcfg.hd
    x = _rand(rng, B, 1, jcfg.d_model)
    ck, cv = _rand(rng, B, S, KV, hd), _rand(rng, B, S, KV, hd)
    pos = np.array([0, 5, 11], np.int32)
    want, (jk, jv) = JL.attn_decode(_j(p), jnp.asarray(x),
                                    (jnp.asarray(ck), jnp.asarray(cv)),
                                    jnp.asarray(pos), jcfg)
    got, (tk, tv) = TL.attn_decode(_t(p), torch.from_numpy(x),
                                   (torch.from_numpy(ck.copy()),
                                    torch.from_numpy(cv.copy())),
                                   torch.from_numpy(pos).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_attn_decode_paged(name):
    """Paged decode with sentinel table entries: row 1's current block is
    the sentinel (its write must be dropped, as JAX's mode="drop"), row 2's
    table ends in sentinels (clamped gathers, masked), and row 0 writes
    the last pool row, the clamp target of every sentinel."""
    jcfg, tcfg = _cfgs(name)
    rng = np.random.default_rng(5)
    p = _attn_params(rng, jcfg)
    nb, bs, KV, hd = 6, 4, jcfg.n_kv_heads, jcfg.hd
    x = _rand(rng, 3, 1, jcfg.d_model)
    ck, cv = _rand(rng, nb, bs, KV, hd), _rand(rng, nb, bs, KV, hd)
    tables = np.array([[0, 5, 6], [1, 6, 6], [2, 3, 6]], np.int32)
    pos = np.array([6, 5, 7], np.int32)
    want, (jk, jv) = JL.attn_decode_paged(
        _j(p), jnp.asarray(x), (jnp.asarray(ck), jnp.asarray(cv)),
        jnp.asarray(tables), jnp.asarray(pos), jcfg)
    got, (tk, tv) = TL.attn_decode_paged(
        _t(p), torch.from_numpy(x),
        (torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())),
        torch.from_numpy(tables).long(), torch.from_numpy(pos).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    # only rows 0 and 2 wrote (blocks 5 and 3); the dropped row wrote nowhere
    untouched = np.ones(nb, bool)
    untouched[[3, 5]] = False
    np.testing.assert_array_equal(tk.numpy()[untouched], ck[untouched])


def test_put_rows_is_exact_under_collision():
    """A dropped row whose clamped target is the cell a kept row writes
    leaves exactly the kept value (bf16, where a rounding would show)."""
    pool = torch.randn(3, 2, 4).to(torch.bfloat16)
    val = torch.randn(2, 4).to(torch.bfloat16)
    before = pool.clone()
    TL.put_rows(pool, torch.tensor([2, 3]), torch.tensor([1, 1]), val)
    assert torch.equal(pool[2, 1], val[0])
    before[2, 1] = val[0]
    assert torch.equal(pool, before)


def test_config_copies_match():
    """The port's configs (and reduced variants) equal the JAX package's
    on every field the port keeps; the MoE and Mamba configs and the image
    families' frontends (``moe``, ``mamba``, ``cnn``, ``vit``, classes of
    their own in each package) field by field."""
    for name in ARCH_NAMES + ["deepseek-moe-16b", "grok-1-314b", "mamba2-1.3b",
                              "jamba-1.5-large-398b", "cnn-cifar10", "vit-cifar10"]:
        for j, t in ((JARCHS[name], TARCHS[name]), _cfgs(name)):
            for f in dataclasses.fields(t):
                got, want = getattr(t, f.name), getattr(j, f.name)
                if f.name in ("moe", "mamba", "cnn", "vit"):
                    got, want = dataclasses.asdict(got), dataclasses.asdict(want)
                assert got == want, (name, f.name)
            assert t.hd == j.hd and t.pattern() == j.pattern()
            assert t.n_classes == j.n_classes
            assert t.image_shape() == j.image_shape()
