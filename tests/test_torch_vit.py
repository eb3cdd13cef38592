"""The port's ViT against the JAX package's, on seeded numpy weights in the
JAX param tree (through ``interop``) and seeded images, in float32.

Per-example losses and norms² of the reduced ViT (patch embedding as a
conv2d site at stride = patch, the position tap, bidirectional attention,
the mean-pool head) under each norm rule, through the port's plain rules
and its kernel routes (on the CPU the kernels' plain versions; under
``fused`` the attention site's flash backward, non-causal); the plain
forward through ``ops.flash_attention`` non-causal; and two Trainer steps
of the whole recipe, Poisson sampling, augmentation multiplicity 8 and
adaptive clipping, against the JAX package's Trainer from the same
weights, at σ = 0 and no count noise, so both are deterministic.

Pins: rtol 1e-5 / atol 2e-6 (ROADMAP's pins for the port's parity tests).
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
from repro.core.context import DPContext as JDPContext
from repro.models import build_model_for as j_build
from repro.train import Trainer as JTrainer
from repro_torch import interop, tree
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import DPConfig, OptimConfig, ShapeConfig, TrainConfig
from repro_torch.core import algo as talgo
from repro_torch.core.context import DPContext
from repro_torch.models import build_model_for
from repro_torch.train import Trainer
from test_torch_cnn import image_params, jax_norms

PINS = dict(rtol=1e-5, atol=2e-6)
ARCH = "vit-cifar10"


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **PINS)


@pytest.fixture(scope="module")
def vit():
    jm = j_build(jreduced(JARCHS[ARCH]), param_dtype="float32",
                 compute_dtype="float32", remat="none")
    params = image_params(jm, seed=1)
    tm = build_model_for(reduced(get_arch(ARCH)),
                         interop.params_from_numpy(params, "cpu"),
                         dtype=torch.float32, device="cpu", remat="none")
    rng = np.random.default_rng(4)
    images = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 3).astype(np.int32)
    return jm, params, tm, {"images": images, "labels": labels}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("strategy", ["materialize", "gram", "fused"])
def test_vit_losses_and_norms_match_jax(vit, strategy, use_kernels):
    jm, params, tm, batch = vit
    losses, nsq = jax_norms(jm, params, batch, strategy)
    tnsq, tlosses = talgo.norm_pass(
        tm.loss_fn, tm.params, _torch(batch),
        DPConfig(norm_strategy=strategy, use_kernels=use_kernels))
    _close(tlosses, losses)
    _close(tnsq, nsq)


def test_vit_plain_forward_matches_jax(vit):
    """Off mode: the port's attention is ``ops.flash_attention``
    non-causal (its plain version on the CPU), the JAX package's the full
    softmax; the remat policy changes nothing."""
    jm, params, tm, batch = vit
    want, _ = jax.jit(lambda p, b: jm.loss_fn(p, b, JDPContext.off()))(params, batch)
    for remat in ("none", "block"):
        tm.remat = remat
        got, _ = tm.loss_fn(tm.params, _torch(batch), DPContext.off())
        _close(got, want)
    tm.remat = "none"


def _recipe(package, tmp_path):
    """The full recipe's config for ``package`` ("jax" or "torch"): dpsgd_r
    fused, Poisson sampling at an expected 4 examples, K 8, adaptive
    clipping from C 0.5, σ = 0 and no count noise; SGD at a constant
    rate, two steps."""
    DP, Opt, TC = ((JDPConfig, JOptimConfig, JTrainConfig) if package == "jax"
                   else (DPConfig, OptimConfig, TrainConfig))
    return TC(arch=ARCH + "-reduced", steps=2, log_every=1, ckpt_every=100,
              ckpt_dir=str(tmp_path / package), remat="block",
              param_dtype="float32", compute_dtype="float32",
              dp=DP(algo="dpsgd_r", norm_strategy="fused", sampling="poisson",
                    augmult=8, adaptive_clip=True, clip_norm=0.5,
                    noise_multiplier=0.0, clip_count_noise=0.0, clip_lr=0.5),
              optim=Opt(name="sgd", lr=0.5, momentum=0.0, schedule="constant"))


def test_two_trainer_steps_of_the_recipe_match_jax(vit, tmp_path):
    jm, params, _, _ = vit
    jtr = JTrainer(j_build(jreduced(JARCHS[ARCH]), param_dtype="float32",
                           compute_dtype="float32", remat="block"),
                   _recipe("jax", tmp_path), JShapeConfig("t", 1, 4, "train"))
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    jstate = dataclasses.replace(jstate, params=jax.tree.map(jnp.asarray, params))
    jstate = jtr.run(jstate, install_signals=False)

    tm = build_model_for(reduced(get_arch(ARCH)),
                         interop.params_from_numpy(params, "cpu"),
                         dtype=torch.float32, device="cpu")
    ttr = Trainer(tm, _recipe("torch", tmp_path), ShapeConfig("t", 1, 4, "train"))
    assert [m.name for m in ttr.accountant.mechanisms] == ["grad", "clip"]
    assert ttr.capacity == jtr.capacity
    batch = ttr.make_batch(0)
    assert batch["images"].shape[0] == 8 * ttr.capacity
    tstate = ttr.run(ttr.init_state(), install_signals=False)

    for key in ("loss", "realized_batch", "clip_norm", "clip_frac_below",
                "clip_norm_next"):
        got = [h[key] for h in ttr.history]
        want = [h[key] for h in jtr.history]
        np.testing.assert_allclose(got, want, **PINS)
    assert ttr.history[-1]["clip_norm_next"] != 0.5      # C moved
    _close(tstate.opt_state["clip"]["clip_norm"],
           jstate.opt_state["clip"]["clip_norm"])
    for a, b in zip(tree.leaves(tstate.params), jax.tree.leaves(jstate.params)):
        _close(a.detach(), b)
