"""The port's embedding-input models (``embed_stub``: musicgen-medium's
audio backbone and chameleon-34b's VLM backbone, whose frontends are
stubs) against the JAX package's, reduced, on weights drawn with numpy
from the JAX initialisers' distributions (the norm scales perturbed, so
chameleon's q and k norms are told apart) and carried across with
``interop``; float32, TF32 off.

Inputs are precomputed (B, T, d) embeddings with (B, T) labels.  Losses,
norms² through every route, the σ = 0 update at the reference's pins
(rtol 1e-5 / atol 2e-6); prefill and decode logits at the JAX
transformer's own 1e-4.  The synthetic and Poisson embeds batches bit for
bit.  The engines and the serving launcher take token ids only, as the
JAX package's do, and refuse these archs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import DPConfig as JDPConfig, OptimConfig as JOptimConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import algo as jalgo
from repro.data import pipeline as jpipeline
from repro.models.transformer import _map_spec as j_map_spec
from repro.models.transformer import build_model
from repro.models.transformer import group_layers as j_group_layers
from repro.models.transformer import model_spec as j_model_spec
from repro.optim import make_optimizer as j_make_optimizer
from repro_torch import interop, tree
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core import algo as talgo
from repro_torch.core.context import DPContext
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import Model
from repro_torch.serve import Engine, HostLoopEngine
from repro_torch.train import Trainer

PINS = dict(rtol=1e-5, atol=2e-6)
TOL = dict(rtol=1e-4, atol=1e-4)
MUSICGEN, CHAMELEON = "musicgen-medium", "chameleon-34b"
NAMES = [MUSICGEN, CHAMELEON]
B, T, D = 4, 16, 64


@pytest.fixture(autouse=True)
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _init_leaf(rng, p, shape):
    if p.init in ("ones", "zeros"):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    std = 0.02 if p.init == "embed" else 1.0 / np.sqrt(p.shape[-2])
    return (std * rng.standard_normal(shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The JAX model of the reduced arch (remat none: the same numbers, a
    quicker compile) and numpy params in its layout, seeded."""
    jarch = jreduced(JARCHS[name])
    jm = build_model(jarch, param_dtype="float32", compute_dtype="float32",
                     remat="none")
    reps = j_group_layers(jarch)[2]
    rng = np.random.default_rng(0)
    return jm, j_map_spec(j_model_spec(jarch), lambda p, path: _init_leaf(
        rng, p, ((reps,) if path[0] == "blocks" else ()) + p.shape))


def _port(name, remat="block"):
    _, params = _weights(name)
    tm = Model(treduced(TARCHS[name]), interop.params_from_numpy(params, "cpu"),
               dtype=torch.float32, device="cpu", remat=remat)
    tm.requires_grad_(True)
    return tm


def _batch(seed=1):
    """The reference's synthetic embeds batch: {"embeds", "labels"}."""
    return jpipeline.SyntheticSource(vocab=256, seed=seed).batch(
        0, B, T, embed_dim=D)


def _dp(**kw):
    return dict(dict(algo="dpsgd_r", clip_norm=0.5, noise_multiplier=0.0,
                     norm_strategy="fused"), **kw)


@functools.lru_cache(maxsize=None)
def _jax_clipped_sum(name):
    jm, params = _weights(name)
    fn = jax.jit(jalgo.make_clipped_sum_fn(jm.loss_fn, JDPConfig(**_dp())))
    grads, (losses, nsq) = fn(jax.tree.map(jnp.asarray, params),
                              jax.tree.map(jnp.asarray, _batch()))
    return ([np.asarray(g) for g in jax.tree.leaves(grads)], np.asarray(losses),
            np.asarray(nsq))


@pytest.mark.parametrize("name", NAMES)
def test_configs_and_reduced_match_jax(name):
    """Every field the port's ArchConfig has equals the reference's, full
    and reduced (``use_fsdp``, the FSDP sharding option, among them); the model
    has no embedding table, and its spec is the reference's without one."""
    def same(t, j, path=""):
        if not dataclasses.is_dataclass(t):
            assert t == j, path
            return
        for f in dataclasses.fields(t):
            same(getattr(t, f.name), getattr(j, f.name), f"{path}.{f.name}")

    for t_arch, j_arch in ((TARCHS[name], JARCHS[name]),
                           (treduced(TARCHS[name]), jreduced(JARCHS[name]))):
        same(t_arch, j_arch)
        assert t_arch.embed_stub and "embed" not in j_model_spec(j_arch)
    tm = _port(name)
    assert "embed" not in tm.params
    assert len(tree.leaves(tm.params)) == len(jax.tree.leaves(_weights(name)[1]))


@pytest.mark.parametrize("name", NAMES)
def test_losses_norms_and_clipped_sums_match_jax(name):
    """The per-example losses of ``loss_fn`` on an embeds batch; pass 1's
    norms² through ``fused`` (the kernels' plain versions on the CPU),
    ``materialize`` and the plain rules against the reference's side
    channel (chameleon's q and k norm taps among the sites); the σ = 0
    clipped sums of the fused route, some examples clipped."""
    jgrads, jlosses, jnsq = _jax_clipped_sum(name)
    tm = _port(name)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with torch.no_grad():
        losses, _ = tm.loss_fn(tm.params, batch, DPContext.off())
    np.testing.assert_allclose(losses.numpy(), jlosses, **PINS)
    fn = talgo.make_clipped_sum_fn(tm.loss_fn, DPConfig(use_kernels=True, **_dp()))
    grads, (losses, nsq) = fn(tm.params, batch)
    np.testing.assert_allclose(nsq.numpy(), jnsq, **PINS)
    np.testing.assert_allclose(losses.detach().numpy(), jlosses, **PINS)
    assert len(grads) == len(jgrads)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), w, **PINS)
    for route, kernels in (("materialize", True), ("fused", False)):
        dp = DPConfig(use_kernels=kernels, **_dp(norm_strategy=route))
        nsq, losses = talgo.norm_pass(tm.loss_fn, tm.params, batch, dp)
        np.testing.assert_allclose(nsq.numpy(), jnsq, **PINS, err_msg=route)
        np.testing.assert_allclose(losses.detach().numpy(), jlosses, **PINS)
    assert (jnsq > 0.25).any()               # clipped at C 0.5


@pytest.mark.parametrize("name", NAMES)
def test_trainer_step_matches_jax(name, tmp_path):
    """One Trainer step (dpsgd_r fused, σ = 0, SGD, ``remat="block"``) on
    the embeds batch: the loss and every updated parameter against the
    JAX optimizer's update from the JAX clipped sum over B."""
    optim = dict(name="sgd", lr=0.5, schedule="constant")
    _, params0 = _weights(name)
    jgrads, jlosses, _ = _jax_clipped_sum(name)
    jopt = j_make_optimizer(JOptimConfig(**optim))
    jp0 = jax.tree.leaves(params0)
    want, _ = jopt.apply([g / B for g in jgrads], jopt.init(jp0), jp0, 0)
    tt = Trainer(_port(name), TrainConfig(
        steps=1, remat="block", param_dtype="float32", compute_dtype="float32",
        ckpt_dir=str(tmp_path), dp=DPConfig(use_kernels=True, **_dp()),
        optim=OptimConfig(**optim)), ShapeConfig("t", T, B, "train"))
    st = tt.init_state()
    metrics = tt.train_step(st, {k: torch.from_numpy(v) for k, v in _batch().items()})
    np.testing.assert_allclose(float(metrics["loss"]), jlosses.mean(), **PINS)
    for g, w, w0 in zip(tree.leaves(st.params), want, jp0):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **PINS)
        assert not np.array_equal(np.asarray(w), w0)


def _emb(rng, *shape):
    return (0.5 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_jax(name):
    """``prefill`` on right-padded embeddings with ``lengths`` and three
    contiguous decode steps fed embeddings: logits and caches; for
    chameleon also ``decode_step_paged`` through block tables (one slot
    with every entry the sentinel)."""
    jm, params = _weights(name)
    jp = jax.tree.map(jnp.asarray, params)
    tm = _port(name)
    rng = np.random.default_rng(2)
    S = 24
    emb, lengths = _emb(rng, 2, 12, D), np.array([12, 7], np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"embeds": jnp.asarray(emb)}, S, jnp.asarray(lengths))
    tl, tc = tm.prefill(torch.from_numpy(emb), S, lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = lengths.copy()
    decode = jax.jit(jm.decode_step)
    for _ in range(3):
        e = _emb(rng, 2, 1, D)
        jl, jc = decode(jp, jc, {"embeds": jnp.asarray(e)}, jnp.asarray(pos))
        tl, tc = tm.decode_step(tc, torch.from_numpy(e), torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1
    for got, want in zip(tree.leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if name != CHAMELEON:
        return
    tables = np.array([[3, 0, 5, 8], [8, 8, 8, 8], [1, 2, 4, 6]], np.int32)
    jc, tc = jm.init_paged_cache(8, 4), tm.init_paged_cache(8, 4)
    pos = np.zeros((3,), np.int32)
    paged = jax.jit(jm.decode_step_paged)
    for _ in range(3):
        e = _emb(rng, 3, 1, D)
        jl, jc = paged(jp, jc, {"embeds": jnp.asarray(e)}, jnp.asarray(pos),
                       jnp.asarray(tables))
        tl, tc = tm.decode_step_paged(tc, torch.from_numpy(e),
                                      torch.from_numpy(pos).long(),
                                      torch.from_numpy(tables).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1


@pytest.mark.parametrize("name", NAMES)
def test_embeds_batches_match_jax_bit_for_bit(name):
    """``batch_for`` (a shard of two) and ``poisson_batch_for`` (padded
    with all-zero embeds and labels, the mask as for tokens) give the
    reference's arrays bit for bit; the memmap source refuses embeds."""
    t_arch, j_arch = treduced(TARCHS[name]), jreduced(JARCHS[name])
    ts = tpipeline.SyntheticSource(vocab=t_arch.vocab, seed=3)
    js = jpipeline.SyntheticSource(vocab=j_arch.vocab, seed=3)
    got = [tpipeline.batch_for(ts, t_arch, ShapeConfig("t", T, 4, "train"), 5, 1, 2),
           tpipeline.poisson_batch_for(ts, t_arch, ShapeConfig("t", T, 4, "train"),
                                       7, capacity=10, sample_rate=5e-6)]
    want = [jpipeline.batch_for(js, j_arch, JShapeConfig("t", T, 4, "train"), 5, 1, 2),
            jpipeline.poisson_batch_for(js, j_arch, JShapeConfig("t", T, 4, "train"),
                                        7, capacity=10, sample_rate=5e-6)]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])
    assert got[0]["embeds"].shape == (2, T, D)
    real = int(got[1]["mask"].sum())
    assert 0 < real < 10 and not got[1]["embeds"][real:].any()
    assert not got[1]["labels"][real:].any()


def test_memmap_source_refuses_embeds(tmp_path):
    path = tmp_path / "toks.bin"
    np.arange(4096, dtype=np.int32).tofile(path)
    src = tpipeline.MemmapSource(str(path), vocab=256)
    with pytest.raises(ValueError, match="tokens only"):
        src.batch(0, 2, 8, embed_dim=D)
    with pytest.raises(ValueError, match="tokens only"):
        src.examples(np.arange(2), 8, embed_dim=D)


def test_launcher_trains_and_serving_refuses(tmp_path, capsys):
    """``launch/train.py --arch musicgen-medium --reduced`` trains on the
    CPU (the planner's trace of an embeds batch among it) and prints ε;
    the engines and the serving launcher refuse an embedding-input arch
    at construction, as the JAX launcher does."""
    ttrain.main(["--arch", MUSICGEN, "--reduced", "--steps", "1", "--batch", "2",
                 "--seq", "8", "--device", "cpu", "--dtype", "float32",
                 "--set", "log_every=1", "--set", f"ckpt_dir={tmp_path}"])
    out = capsys.readouterr().out
    assert "[train] memory: estimated peak" in out and "[trainer] step" in out
    assert "privacy spent: eps=" in out
    tm = _port(CHAMELEON)
    for make in (lambda: Engine(tm), lambda: HostLoopEngine(tm),
                 lambda: tserve.main(["--arch", CHAMELEON, "--reduced", "--device",
                                      "cpu", "--dtype", "float32"])):
        with pytest.raises(ValueError, match="drives token-input archs"):
            make()
