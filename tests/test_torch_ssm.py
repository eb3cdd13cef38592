"""The port's SSM and hybrid decoders (``models/mamba2.py`` in
``models/transformer.py``, the engines' equal-length waves) against the JAX
package's, whole models, on JAX-initialised weights carried across with
``interop`` (drawn with numpy from the JAX initialisers' distributions),
float32, TF32 off.

Sequences of 32 tokens at chunk 16, where the two packages' chunkings
agree: losses, norms² and updates at the reference's pins, rtol 1e-5 /
atol 2e-6 (prefill logits at the JAX transformer's own 1e-4).  Greedy
streams exactly.  The models: mamba2-reduced (2 Mamba layers), the
two-layer hybrid cut of jamba (attention with its dense FFN, then Mamba
with the MoE FFN, as phase 14 of ``chip_smoke.py`` cuts the full model)
and jamba-reduced (its 8-layer period).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import ATTN as JATTN, MAMBA as JMAMBA
from repro.configs.base import DPConfig as JDPConfig, OptimConfig as JOptimConfig
from repro.core import algo as jalgo
from repro.core.accountant import PrivacyAccountant as JPrivacyAccountant
from repro.core.context import DPContext as JDPContext
from repro.models.transformer import _map_spec as j_map_spec
from repro.models.transformer import build_model
from repro.models.transformer import group_layers as j_group_layers
from repro.models.transformer import model_spec as j_model_spec
from repro.optim import make_optimizer as j_make_optimizer
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch import interop, tree
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import (ATTN, MAMBA, DPConfig, OptimConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.core import algo as talgo
from repro_torch.core.accountant import PrivacyAccountant
from repro_torch.core.context import DPContext
from repro_torch.models.transformer import Model
from repro_torch.serve import Engine, HostLoopEngine, Request
from repro_torch.train import Trainer

PINS = dict(rtol=1e-5, atol=2e-6)
MAMBA2, JAMBA, CUT = "mamba2-1.3b", "jamba-1.5-large-398b", "jamba-cut"
B, T = 4, 32


@pytest.fixture(autouse=True)
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _archs(name):
    """(JAX, port) reduced configs; ``CUT`` is jamba's layers 4-5 (attention
    with a dense FFN, Mamba with the MoE FFN) at reduced width."""
    if name == CUT:
        return (dataclasses.replace(jreduced(JARCHS[JAMBA]), n_layers=2,
                                    layer_pattern=(JATTN, JMAMBA)),
                dataclasses.replace(treduced(TARCHS[JAMBA]), n_layers=2,
                                    layer_pattern=(ATTN, MAMBA)))
    return jreduced(JARCHS[name]), treduced(TARCHS[name])


def _init_leaf(rng, p, shape):
    """A leaf drawn with numpy from the JAX initialiser's distribution."""
    if p.init in ("ones", "zeros"):
        return np.full(shape, 1.0 if p.init == "ones" else 0.0, np.float32)
    if p.init == "mamba_dt":
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
        return (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    if p.init == "mamba_alog":
        return np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
    std = 0.02 if p.init == "embed" else 1.0 / np.sqrt(p.shape[-2])
    return (std * rng.standard_normal(shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The JAX model (remat none: the same numbers, a quicker compile) and
    numpy params in its layout, seeded."""
    jarch, _ = _archs(name)
    jm = build_model(jarch, param_dtype="float32", compute_dtype="float32",
                     remat="none")
    reps = j_group_layers(jarch)[2]
    rng = np.random.default_rng(0)
    return jm, j_map_spec(j_model_spec(jarch), lambda p, path: _init_leaf(
        rng, p, ((reps,) if path[0] == "blocks" else ()) + p.shape))


def _port(name, remat="block"):
    _, params = _weights(name)
    tm = Model(_archs(name)[1], interop.params_from_numpy(params, "cpu"),
               dtype=torch.float32, device="cpu", remat=remat)
    tm.requires_grad_(True)
    return tm


def _toks(seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, T + 1)).astype(np.int32)


def _dp(**kw):
    return dict(dict(algo="dpsgd_r", clip_norm=0.5, noise_multiplier=0.0,
                     norm_strategy="fused"), **kw)


@functools.lru_cache(maxsize=None)
def _jax_clipped_sum(name):
    jm, params = _weights(name)
    fn = jax.jit(jalgo.make_clipped_sum_fn(jm.loss_fn, JDPConfig(**_dp())))
    grads, (losses, nsq) = fn(jax.tree.map(jnp.asarray, params),
                              {"tokens": jnp.asarray(_toks())})
    return ([np.asarray(g) for g in jax.tree.leaves(grads)], np.asarray(losses),
            np.asarray(nsq))


@pytest.mark.parametrize("name", [MAMBA2, CUT])
def test_losses_norms_and_clipped_sums_match_jax(name):
    """One dpsgd_r step at σ = 0: per-example losses, norms² and the
    clipped sums of the fused route (the kernels' plain versions, the
    scan's per-chunk checkpoint under ``block``) against the JAX package's;
    every other norm route's norms² against the same; some examples
    clipped."""
    jgrads, jlosses, jnsq = _jax_clipped_sum(name)
    tm = _port(name)
    toks = {"tokens": torch.from_numpy(_toks())}
    for route in ("fused", "materialize", "gram", "auto"):
        fn = talgo.make_clipped_sum_fn(tm.loss_fn, DPConfig(use_kernels=True,
                                                            **_dp(norm_strategy=route)))
        grads, (losses, nsq) = fn(tm.params, toks)
        np.testing.assert_allclose(nsq.numpy(), jnsq, **PINS, err_msg=route)
        np.testing.assert_allclose(losses.detach().numpy(), jlosses, **PINS)
        if route == "fused":
            assert len(grads) == len(jgrads)
            for g, w in zip(grads, jgrads):
                np.testing.assert_allclose(g.numpy(), w, **PINS)
    assert (jnsq > 0.25).any()               # clipped at C 0.5


def test_mamba2_trainer_step_matches_jax(tmp_path):
    """One Trainer step of mamba2-reduced (dpsgd_r fused, σ = 0, SGD,
    ``remat="block"``) from the JAX weights on the batch above: the loss
    and every updated parameter against the JAX optimizer's update from the
    JAX clipped sum over B (the private update at σ = 0); the accountants'
    ε at the Trainer's sampling rate."""
    optim = dict(name="sgd", lr=0.5, schedule="constant")
    _, params0 = _weights(MAMBA2)
    jgrads, jlosses, _ = _jax_clipped_sum(MAMBA2)
    jopt = j_make_optimizer(JOptimConfig(**optim))
    jp0 = jax.tree.leaves(params0)
    want, _ = jopt.apply([g / B for g in jgrads], jopt.init(jp0), jp0, 0)
    tt = Trainer(_port(MAMBA2), TrainConfig(
        steps=1, remat="block", param_dtype="float32", compute_dtype="float32",
        ckpt_dir=str(tmp_path), dp=DPConfig(use_kernels=True, **_dp()),
        optim=OptimConfig(**optim)), ShapeConfig("t", T, B, "train"))
    st = tt.init_state()
    metrics = tt.train_step(st, {"tokens": torch.from_numpy(_toks())})
    np.testing.assert_allclose(float(metrics["loss"]), jlosses.mean(), **PINS)
    assert len(want) == len(tree.leaves(st.params))
    for g, w, w0 in zip(tree.leaves(st.params), want, jp0):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **PINS)
        assert not np.array_equal(np.asarray(w), w0)
    args = (B, tt.source.dataset_size, 1.0, 1e-5)
    assert tt.accountant.sample_rate == B / tt.source.dataset_size
    np.testing.assert_allclose(PrivacyAccountant(*args).epsilon_at(1),
                               JPrivacyAccountant(*args).epsilon_at(1), rtol=1e-12)


def _requests(n, seed, max_new=None, lengths=(4, 14)):
    """tests/test_serve_engine.py's stream: prompts of 4-13 tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for uid in range(n):
        prompt = rng.integers(0, 256, int(rng.integers(*lengths))).astype(np.int32)
        out.append((uid, prompt, max_new or int(rng.integers(1, 8))))
    return out


def _run(engine, req_cls, stream):
    for uid, prompt, max_new in stream:
        engine.submit(req_cls(uid=uid, prompt=prompt, max_new=max_new))
    return engine.run(max_steps=200)


@pytest.mark.parametrize("name,n,seed,lengths", [(MAMBA2, 5, 5, (4, 14)),
                                                 (CUT, 4, 6, (5, 7))])
def test_greedy_streams_match_jax(name, n, seed, lengths):
    """The port's engine (equal-length waves, unpadded) and host loop
    against the JAX engine, exactly: mamba2-reduced on
    ``tests/test_serve_engine.py``'s Mamba case (5 requests, 2 slots, 64
    positions), and the hybrid cut on prompts of two lengths (a wave of two
    equal ones among them), whose MoE layer routes each wave as the JAX
    engine does.  The schedule is the JAX engine's: the same prefill
    waves, decode steps and most slots busy at once.  ``paged=True``
    raises."""
    jm, params = _weights(name)
    tm = _port(name)
    stream = _requests(n, seed, 4 if name == MAMBA2 else None, lengths)
    kw = dict(max_batch=2, cache_len=64)
    jeng = JEngine(jm, jax.tree.map(jnp.asarray, params), **kw)
    want = _run(jeng, JRequest, stream)
    eng = Engine(tm, **kw)
    assert eng.has_mamba and eng.sched.same_length_waves
    assert _run(eng, Request, stream) == want
    for key in ("prefill_waves", "decode_steps", "max_active"):
        assert eng.stats[key] == jeng.stats[key], key
    assert _run(HostLoopEngine(tm, **kw), Request, stream) == want
    assert all(len(want[uid]) == m for uid, _, m in stream)
    if name == CUT:
        assert eng.stats["prefill_waves"] < n
    with pytest.raises(ValueError, match="attention-only"):
        Engine(tm, paged=True, **kw)
    with pytest.raises(ValueError, match="attention-only"):
        tm.init_paged_cache(4, 16)


def test_prefill_and_decode_match_jax():
    """The hybrid cut's prefill logits and its attention and Mamba caches
    (attention padded to the cache length, the Mamba state as the prompt
    leaves it), then two decode steps, at the JAX transformer's 1e-4."""
    jm, params = _weights(CUT)
    jp = jax.tree.map(jnp.asarray, params)
    tm = _port(CUT)
    toks = _toks(4)[:, :T]
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, T + 8)
    tl, tc = tm.prefill(torch.from_numpy(toks), T + 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for got, want in zip(tree.leaves(tc), jax.tree.leaves(jc)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    pos = np.full((B,), T, np.int32)
    for _ in range(2):
        nxt = np.argmax(np.asarray(jl)[:, 0, :256], -1).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(nxt)[:, None]},
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tc, torch.from_numpy(nxt)[:, None],
                                torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        pos = pos + 1


@pytest.fixture(scope="module")
def jamba_loss():
    """jamba-reduced (8 layers: Mamba x 4, attention, Mamba x 3, MoE on
    every odd layer, one 8-layer block) and its JAX losses, compiled
    once."""
    jm, params = _weights(JAMBA)
    fn = jax.jit(lambda p, b: jm.loss_fn(p, b, JDPContext.off())[0])
    return np.asarray(fn(jax.tree.map(jnp.asarray, params),
                         {"tokens": jnp.asarray(_toks(3))}))


def test_jamba_reduced_losses_match_jax(jamba_loss):
    from repro_torch.models.transformer import group_layers
    tm = _port(JAMBA)
    assert group_layers(tm.arch) == (0, 8, 1)
    with torch.no_grad():
        losses, _ = tm.loss_fn(tm.params, {"tokens": torch.from_numpy(_toks(3))},
                               DPContext.off())
    np.testing.assert_allclose(losses.numpy(), jamba_loss, **PINS)
