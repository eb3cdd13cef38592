"""Port's Model vs the JAX package's on shared weights: prefill logits and
caches, then four decode steps (contiguous and paged), for the reduced
dense presets.  Params come from the JAX init through
``interop.params_from_numpy``; f32; logits at rtol 1e-4 / atol 1e-4
(summation order differs inside matmuls, over two layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models.transformer import build_model
from repro_torch import interop, resolve_device
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import ATTN, MAMBA
from repro_torch.models.transformer import Model, group_layers

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH_NAMES = ["phi3-mini-3.8b", "stablelm-3b", "starcoder2-7b", "chatglm3-6b"]


@pytest.fixture(autouse=True)
def _no_tf32():
    # the reference is full float32: TF32 would keep ~3 digits on a card
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _pair(name):
    jm = build_model(jreduced(JARCHS[name]), param_dtype="float32",
                     compute_dtype="float32")
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(treduced(TARCHS[name]),
               interop.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
               dtype=torch.float32, device="cpu")
    return jm, params, tm


def _close(t_tree, j_tree):
    """Same nesting, leaves within TOL (jax.tree orders both alike)."""
    jl = jax.tree.leaves(j_tree)
    tl = jax.tree.leaves(interop.params_to_numpy(t_tree))
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_and_decode_match_jax(name):
    jm, params, tm = _pair(name)
    vocab = jm.arch.vocab
    rng = np.random.default_rng(0)
    B, T, S = 2, 12, 24
    toks = rng.integers(0, vocab, (B, T)).astype(np.int32)
    lengths = np.array([12, 7], np.int32)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, S,
                        lengths=jnp.asarray(lengths))
    tl, tc = tm.prefill(torch.from_numpy(toks), S,
                        lengths=torch.from_numpy(lengths))
    assert tl.shape == (B, 1, jl.shape[-1])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close(tc, jc)

    pos = lengths.copy()
    for _ in range(4):
        nxt = np.argmax(np.asarray(jl)[:, 0, :vocab], -1).astype(np.int32)
        jl, jc = jm.decode_step(params, jc, {"tokens": jnp.asarray(nxt)[:, None]},
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tc, torch.from_numpy(nxt)[:, None],
                                torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1
    _close(tc, jc)


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "chatglm3-6b"])
def test_paged_decode_matches_jax(name):
    """Paged decode through block tables (one slot with no table: every
    entry sentinel) against the JAX paged path."""
    jm, params, tm = _pair(name)
    vocab, bs, nb = jm.arch.vocab, 4, 8
    rng = np.random.default_rng(1)
    tables = np.array([[3, 0, 5, 8], [8, 8, 8, 8], [1, 2, 4, 6]], np.int32)
    jc = jm.init_paged_cache(nb, bs)
    tc = tm.init_paged_cache(nb, bs)
    pos = np.array([0, 0, 0], np.int32)
    toks = rng.integers(0, vocab, (3,)).astype(np.int32)
    for _ in range(6):
        jl, jc = jm.decode_step_paged(params, jc,
                                      {"tokens": jnp.asarray(toks)[:, None]},
                                      jnp.asarray(pos), jnp.asarray(tables))
        tl, tc = tm.decode_step_paged(tc, torch.from_numpy(toks)[:, None],
                                      torch.from_numpy(pos).long(),
                                      torch.from_numpy(tables).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        toks = np.argmax(np.asarray(jl)[:, 0, :vocab], -1).astype(np.int32)
        pos = pos + 1
    _close(tc, jc)


def test_cache_and_param_layouts():
    """Scanned blocks carry a leading (reps,) axis, dense w is (d_in,
    d_out), and every param is registered on the module."""
    jm, params, tm = _pair("starcoder2-7b")
    pre, period, reps = group_layers(tm.arch)
    assert tm.params["blocks"][0]["attn"]["wq"].shape == \
        (reps, tm.arch.d_model, tm.arch.n_heads * tm.arch.hd)
    c = tm.init_cache(3, 16)
    assert c["blocks"][0][0].shape == (reps, 3, 16, tm.arch.n_kv_heads,
                                       tm.arch.hd)
    assert len(list(tm.parameters())) == len(jax.tree.leaves(params))
    assert not any(p.requires_grad for p in tm.parameters())


def test_seeded_init_is_deterministic():
    arch = treduced(TARCHS["phi3-mini-3.8b"])
    a = Model(arch, dtype=torch.float32, device="cpu", seed=3)
    b = Model(arch, dtype=torch.float32, device="cpu", seed=3)
    c = Model(arch, dtype=torch.float32, device="cpu", seed=4)
    for (n, x), (_, y), (_, z) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      c.named_parameters()):
        assert torch.equal(x, y), n
        if "ln" not in n and "norm" not in n:
            assert not torch.equal(x, z), n
    w = a.params["blocks"][0]["mlp"]["w2"]           # N(0, 1/fan_in)
    assert abs(w.std().item() * arch.d_ff ** 0.5 - 1.0) < 0.1
    assert abs(a.params["embed"].std().item() / 0.02 - 1.0) < 0.1


def test_unported_layers_and_missing_cuda_raise(monkeypatch):
    """Mamba layers and embedding-input archs are ported (a hybrid pattern
    builds, its paged decode raises; an ``embed_stub`` arch builds with no
    embedding table); no CUDA device and no ``device="cpu"`` raises."""
    import dataclasses
    hybrid = dataclasses.replace(treduced(TARCHS["phi3-mini-3.8b"]),
                                 layer_pattern=(MAMBA, ATTN))
    model = Model(hybrid, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="attention layers only"):
        model.decode_step_paged(None, None, None, None)
    stub = Model(dataclasses.replace(hybrid, embed_stub=True), dtype=torch.float32,
                 device="cpu")
    assert "embed" not in stub.params and "embed" in model.params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(treduced(TARCHS["phi3-mini-3.8b"]))
    assert resolve_device("cpu").type == "cpu"
