"""Quantile-adaptive clipping in the port against the JAX package's.

The update (``noisy_fraction_below``, ``updated_clip``, ``update``) with no
count noise, and with noise through the JAX package's own draw injected
(the two packages' generators cannot give the same bits); the clip
mechanism's composed ε and its split to the digit; the adaptive metrics
of one ``make_noisy_grad_fn`` step of the reduced CNN (σ = 0, no count
noise); the Trainer's rider (``{"opt": ..., "clip": {"clip_norm": C}}``)
and its resume drill, whose clip trajectory a restore continues bit for
bit; and a checkpoint with the rider written by either package and
restored by the other, every leaf bit for bit.

Pins: rtol 1e-5 / atol 2e-6 where float32 arithmetic is compared (ROADMAP's
pins); ε and checkpoints exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import DPConfig as JDPConfig
from repro.configs.base import OptimConfig as JOptimConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import adaptive_clip as jclip
from repro.core import make_noisy_grad_fn as j_make_noisy_grad_fn
from repro.core.accountant import PrivacyAccountant as JAccountant
from repro.models import build_model_for as j_build
from repro.train import Trainer as JTrainer
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch import interop, tree
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import DPConfig, OptimConfig, ShapeConfig, TrainConfig
from repro_torch.core import adaptive_clip as tclip
from repro_torch.core import algo as talgo
from repro_torch.core.accountant import PrivacyAccountant
from repro_torch.models import build_model_for
from repro_torch.train import Trainer
from repro_torch.train import checkpoint as C
from test_torch_cnn import image_params

PINS = dict(rtol=1e-5, atol=2e-6)
NSQ = np.array([0.25, 4.0, 0.0, 9.0, 1.0, 0.81], np.float32)
MASK = np.array([1.0, 1.0, 0.0, 1.0, 1.0, 1.0], np.float32)


@pytest.mark.parametrize("clip,quantile,lr", [(1.0, 0.5, 0.2), (2.5, 0.9, 0.7),
                                              (0.3, 0.1, 1.0)])
def test_update_without_noise_matches_jax(clip, quantile, lr):
    dp = DPConfig(clip_quantile=quantile, clip_lr=lr, clip_count_noise=0.0)
    jdp = JDPConfig(clip_quantile=quantile, clip_lr=lr, clip_count_noise=0.0)
    jstate, jfrac = jclip.update({"clip_norm": jnp.float32(clip)},
                                 jnp.asarray(NSQ), jnp.asarray(MASK), jdp, 5.0,
                                 jax.random.PRNGKey(0))
    state, frac = tclip.update({"clip_norm": torch.tensor(clip)},
                               torch.from_numpy(NSQ), torch.from_numpy(MASK),
                               dp, 5.0, torch.Generator())
    np.testing.assert_allclose(float(frac), float(jfrac), **PINS)
    np.testing.assert_allclose(float(state["clip_norm"]),
                               float(jstate["clip_norm"]), **PINS)
    assert state["clip_norm"].dtype == torch.float32


def test_update_with_the_jax_draw_injected():
    """With count noise σ_b = 10 the JAX package draws one standard normal
    from its key; given that draw, the port's fraction and next C equal
    its."""
    jdp, dp = JDPConfig(clip_count_noise=10.0), DPConfig(clip_count_noise=10.0)
    key = jax.random.PRNGKey(3)
    jstate, jfrac = jclip.update({"clip_norm": jnp.float32(1.0)},
                                 jnp.asarray(NSQ), jnp.asarray(MASK), jdp, 5.0,
                                 key)
    draw = torch.tensor(float(jax.random.normal(key, (), jnp.float32)))
    state, frac = tclip.update({"clip_norm": torch.tensor(1.0)},
                               torch.from_numpy(NSQ), torch.from_numpy(MASK),
                               dp, 5.0, draw=draw)
    np.testing.assert_allclose(float(frac), float(jfrac), **PINS)
    np.testing.assert_allclose(float(state["clip_norm"]),
                               float(jstate["clip_norm"]), **PINS)
    assert abs(float(frac) - 4.0 / 5.0) > 1e-3       # the noise is in it


@pytest.mark.parametrize("noise,steps", [(10.0, 1000), (2.0, 500), (0.5, 50)])
def test_composed_epsilon_matches_jax(noise, steps):
    """The clip mechanism composed beside the gradient mechanism: total
    and per-mechanism ε equal the JAX package's to the digit."""
    dp = DPConfig(clip_count_noise=noise, noise_multiplier=1.1)
    jdp = JDPConfig(clip_count_noise=noise, noise_multiplier=1.1)
    acc = PrivacyAccountant(256, 50_000, 1.1, 1e-5)
    jacc = JAccountant(256, 50_000, 1.1, 1e-5)
    acc.compose(tclip.mechanism(dp, 256 / 50_000))
    jacc.compose(jclip.mechanism(jdp, 256 / 50_000))
    assert tuple(acc.mechanisms[1]) == tuple(jacc.mechanisms[1])
    assert acc.epsilon_at(steps) == jacc.epsilon_at(steps)
    assert acc.epsilon_breakdown(steps) == jacc.epsilon_breakdown(steps)
    assert acc.epsilon_at(steps) > PrivacyAccountant(256, 50_000, 1.1,
                                                     1e-5).epsilon_at(steps)


@pytest.fixture(scope="module")
def cnn():
    jm = j_build(jreduced(JARCHS["cnn-cifar10"]), param_dtype="float32",
                 compute_dtype="float32", remat="none")
    params = image_params(jm, seed=2)
    return jm, params


def test_noisy_grad_fn_adaptive_metrics_match_jax(cnn):
    """One dpsgd_r step of the reduced CNN at K 2 with the clip norm
    passed in: clip_norm, clip_frac_below and clip_norm_next (σ = 0, no
    count noise) and the clipped mean equal the JAX package's."""
    jm, params = cnn
    tm = build_model_for(reduced(get_arch("cnn-cifar10")),
                         interop.params_from_numpy(params, "cpu"),
                         dtype=torch.float32, device="cpu", remat="none")
    tm.requires_grad_(True)
    rng = np.random.default_rng(0)
    batch = {"images": rng.standard_normal((8, 8, 8, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, 8).astype(np.int32)}
    kw = dict(algo="dpsgd_r", norm_strategy="fused", augmult=2,
              adaptive_clip=True, noise_multiplier=0.0, clip_count_noise=0.0,
              clip_lr=0.5, clip_quantile=0.25)
    jfn = j_make_noisy_grad_fn(jm.loss_fn, JDPConfig(**kw))
    want, wm = jax.jit(jfn)(params, batch, jax.random.PRNGKey(0),
                            jnp.float32(4.0))
    tfn = talgo.make_noisy_grad_fn(tm.loss_fn, DPConfig(use_kernels=True, **kw))
    got, m = tfn(tm.params, {k: torch.from_numpy(v) for k, v in batch.items()},
                 torch.Generator(), clip_norm=torch.tensor(4.0))
    for key in ("clip_norm", "clip_frac_below", "clip_norm_next", "loss",
                "clipped_frac"):
        np.testing.assert_allclose(float(m[key]), float(wm[key]), **PINS)
    assert 0.0 < float(m["clip_frac_below"]) < 1.0
    for a, b in zip(got, jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **PINS)


def _cfg(tmp_path, steps, package="torch"):
    DP, Opt, TC = ((JDPConfig, JOptimConfig, JTrainConfig) if package == "jax"
                   else (DPConfig, OptimConfig, TrainConfig))
    return TC(arch="cnn-cifar10-reduced", steps=steps, log_every=1,
              ckpt_every=2, ckpt_dir=str(tmp_path), ckpt_async=False,
              remat="none", param_dtype="float32", compute_dtype="float32",
              dp=DP(algo="dpsgd_r", augmult=2,
                    noise_multiplier=1.0, adaptive_clip=True,
                    clip_count_noise=2.0, clip_lr=0.3),
              optim=Opt(lr=1e-3, total_steps=steps))


def _port_trainer(params, cfg):
    tm = build_model_for(reduced(get_arch("cnn-cifar10")),
                         interop.params_from_numpy(params, "cpu"),
                         dtype=torch.float32, device="cpu", remat="none")
    return Trainer(tm, cfg, ShapeConfig("t", 1, 4, "train"))


def test_resume_drill_continues_the_clip_trajectory(cnn, tmp_path):
    """Four steps straight, against two, a restore into a fresh model and
    Trainer, and two more: the clip norm after every step, the params and
    the optimizer state equal bit for bit; adaptive clipping off keeps the
    plain optimizer state and the gradient mechanism alone."""
    _, params = cnn
    full = _port_trainer(params, _cfg(tmp_path / "a", 4))
    s_full = full.run(full.init_state(), install_signals=False)
    assert [m.name for m in full.accountant.mechanisms] == ["grad", "clip"]
    assert len({h["clip_norm"] for h in full.history}) == 4   # C moved
    half = _port_trainer(params, _cfg(tmp_path / "b", 4))
    half.run(half.init_state(), steps=2, install_signals=False)
    resumed = _port_trainer(params, _cfg(tmp_path / "b", 4))
    state = resumed.restore_or_init()
    assert state.step == 2
    state = resumed.run(state, install_signals=False)
    assert [h["clip_norm"] for h in half.history + resumed.history] == \
        [h["clip_norm"] for h in full.history]
    for a, b in zip(C.flatten(state), C.flatten(s_full)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    off = _port_trainer(params, dataclasses.replace(
        _cfg(tmp_path / "c", 1), dp=DPConfig(adaptive_clip=False)))
    assert not off.adaptive_clip and "clip" not in off.init_state().opt_state
    assert [m.name for m in off.accountant.mechanisms] == ["grad"]


def _bits(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_package_restore_with_the_clip_rider(cnn, tmp_path, writer):
    """The port's TrainState after one adaptive step of the reduced CNN
    (the clip norm moved off 1.0), written by one package and restored by
    the other into its own Trainer's state: the step, the clip norm (the
    first optimizer-state leaf in both) and every other leaf bit for
    bit."""
    _, params = cnn
    ttr = _port_trainer(params, _cfg(tmp_path / "t", 1))
    ts = ttr.run(ttr.init_state(), install_signals=False)   # saves step 1
    want = [_bits(a) for a in C.flatten(ts)]
    want[0] = want[0].astype(np.int32)         # the step: an int32 on disk
    n_params = len(tree.leaves(ttr.model.params))
    assert want[1 + n_params].shape == () and float(want[1 + n_params]) != 1.0
    jtr = JTrainer(j_build(jreduced(JARCHS["cnn-cifar10"]), param_dtype="float32",
                           compute_dtype="float32", remat="none"),
                   _cfg(tmp_path / "j", 1, "jax"), JShapeConfig("t", 1, 4, "train"))
    like = jax.eval_shape(lambda: jtr.init_state(jax.random.PRNGKey(0)))
    assert "clip" in like.opt_state
    if writer == "jax":
        jstate = jax.tree.unflatten(jax.tree.structure(like),
                                    [jnp.asarray(a) for a in want])
        JCheckpointManager(str(tmp_path / "j"), use_async=False).save(jstate, 1)
        fresh = _port_trainer(params, _cfg(tmp_path / "j", 1))
        got = C.CheckpointManager(str(tmp_path / "j")).restore(fresh.init_state())
        assert got.step == 1
        got = [_bits(a) for a in C.flatten(got)]
        got[0] = got[0].astype(np.int32)
    else:
        back = JCheckpointManager(str(tmp_path / "t")).restore(like)
        got = [_bits(a) for a in jax.tree.leaves(back)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
