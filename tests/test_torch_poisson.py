"""Poisson sampling in the port against the JAX package: the sampled
indices, the capacity, the padded batch and its mask, the physical batch
size, the truncation warning, and a Poisson ``Trainer`` run (reduced phi3,
float32, σ = 0, ``materialize`` + kernels) against the JAX ``Trainer``.

Data and the capacity are bit-exact (the same numpy Philox draws); the
loss trajectory at rtol 1e-4 and the update's metrics as in
tests/test_torch_train.py; ε at rtol 1e-12 (the same pure-Python
arithmetic).
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import (DPConfig as JDPConfig, OptimConfig as JOptimConfig,
                                ShapeConfig as JShapeConfig,
                                TrainConfig as JTrainConfig)
from repro.core.accountant import PrivacyAccountant as JPrivacyAccountant
from repro.data import pipeline as jpipe
from repro.models.transformer import build_model
from repro.train import Trainer as JTrainer
from repro.train.trainer import physical_batch_size as j_physical_batch_size
from repro_torch import interop
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core.accountant import PrivacyAccountant
from repro_torch.data import pipeline as tpipe
from repro_torch.models.transformer import Model
from repro_torch.train import Trainer
from repro_torch.train.trainer import physical_batch_size

ARCH = "phi3-mini-3.8b"


@pytest.mark.parametrize("seed,step,N,q", [(0, 0, 1_000_000, 8e-6),
                                           (3, 17, 60_000, 256 / 60_000),
                                           (1, 2 ** 40, 1000, 0.5),
                                           (2, 5, 100, 0.0)])
def test_sample_indices_and_capacity_match_jax(seed, step, N, q):
    np.testing.assert_array_equal(tpipe.poisson_sample_indices(seed, step, N, q),
                                  jpipe.poisson_sample_indices(seed, step, N, q))
    for B, mult in ((8, 1), (256, 5), (4, 3)):
        assert tpipe.poisson_capacity(B, q, multiple=mult) == \
            jpipe.poisson_capacity(B, q, multiple=mult)
    assert tpipe.poisson_capacity(8, 8e-6) == 25      # the chip's Poisson run


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 1), (7, 3), (2, 2 ** 33)])
def test_poisson_batches_match_jax(seed, step):
    shape = ShapeConfig("t", 9, 6, "train")
    jshape = JShapeConfig("t", 9, 6, "train")
    src = tpipe.SyntheticSource(vocab=300, seed=seed, dataset_size=200)
    jsrc = jpipe.SyntheticSource(vocab=300, seed=seed, dataset_size=200)
    arch, jarch = treduced(TARCHS[ARCH]), jreduced(JARCHS[ARCH])
    got = tpipe.poisson_batch_for(src, arch, shape, step)
    want = jpipe.poisson_batch_for(jsrc, jarch, jshape, step)
    assert sorted(got) == sorted(want) == ["mask", "tokens"]
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["tokens"][~got["mask"]] == 0).all()
    np.testing.assert_array_equal(
        src.examples(np.array([0, 5, 199]), 9)["tokens"],
        jsrc.examples(np.array([0, 5, 199]), 9)["tokens"])


def test_truncation_warns_like_jax():
    shape, jshape = ShapeConfig("t", 4, 50, "train"), JShapeConfig("t", 4, 50, "train")
    src = tpipe.SyntheticSource(vocab=50, dataset_size=100)
    jsrc = jpipe.SyntheticSource(vocab=50, dataset_size=100)
    with pytest.warns(RuntimeWarning, match="exceeds capacity"):
        got = tpipe.poisson_batch_for(src, treduced(TARCHS[ARCH]), shape, 0,
                                      capacity=10)
    with pytest.warns(RuntimeWarning, match="exceeds capacity"):
        want = jpipe.poisson_batch_for(jsrc, jreduced(JARCHS[ARCH]), jshape, 0,
                                       capacity=10)
    assert got["mask"].all() and got["tokens"].shape[0] == 10
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("sampling,accum,shards", [("fixed", 1, 1), ("poisson", 1, 1),
                                                   ("poisson", 5, 1), ("poisson", 4, 6),
                                                   ("poisson", 3, 2)])
def test_physical_batch_size_matches_jax(sampling, accum, shards):
    """The capacity is a multiple of lcm(grad_accum · dp.microbatch,
    shards), as in the JAX package (microbatch 0 counts as 1)."""
    for mb in (0, 3):
        cfg = TrainConfig(grad_accum=accum,
                          dp=DPConfig(sampling=sampling, microbatch=mb))
        jcfg = JTrainConfig(grad_accum=accum,
                            dp=JDPConfig(sampling=sampling, microbatch=mb))
        for B, N in ((8, 1_000_000), (256, 60_000)):
            got = physical_batch_size(cfg, ShapeConfig("t", 16, B, "train"), N,
                                      shards)
            assert got == j_physical_batch_size(
                jcfg, JShapeConfig("t", 16, B, "train"), N, shards)
            assert (got % math.lcm(accum * max(mb, 1), shards) == 0
                    or sampling == "fixed")


def test_poisson_trainer_matches_jax_trainer(tmp_path):
    """Three Poisson steps (expected batch 4 of the synthetic N = 1e6, so
    the draws vary and pad to a capacity of 16) through both Trainers from
    the same weights."""
    common = dict(steps=3, log_every=1, remat="none", param_dtype="float32",
                  compute_dtype="float32")
    dp = dict(algo="dpsgd_r", norm_strategy="materialize", noise_multiplier=0.0,
              clip_norm=0.5, sampling="poisson")
    optim = dict(name="adamw", lr=1e-3, schedule="constant")
    shape = (16, 4)                                  # T, expected batch
    jm = build_model(jreduced(JARCHS[ARCH]), param_dtype="float32",
                     compute_dtype="float32", remat="none")
    jcfg = JTrainConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                        dp=JDPConfig(**dp), optim=JOptimConfig(**optim), **common)
    jt = JTrainer(jm, jcfg, JShapeConfig("t", *shape, "train"))
    jst = jt.init_state(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, jst.params)

    tm = Model(treduced(TARCHS[ARCH]), interop.params_from_numpy(params0, "cpu"),
               dtype=torch.float32, device="cpu")
    tt = Trainer(tm, TrainConfig(ckpt_dir=str(tmp_path / "torch"),
                                 dp=DPConfig(use_kernels=True, **dp),
                                 optim=OptimConfig(**optim), **common),
                 ShapeConfig("t", *shape, "train"))
    assert tt.capacity == jt.capacity == 16
    assert tt.sample_rate == jt.sample_rate
    batches = [tt.make_batch(s) for s in range(3)]
    for s, b in enumerate(batches):
        want = jt.make_batch(s)
        for k in ("tokens", "mask"):
            np.testing.assert_array_equal(b[k].numpy(), want[k])
    assert len({int(b["mask"].sum()) for b in batches}) > 1   # the draws vary
    jt.run(jst, install_signals=False)
    tt.run(tt.init_state())
    assert len(tt.history) == len(jt.history) == 3
    for got, want in zip(tt.history, jt.history):
        assert got["realized_batch"] == want["realized_batch"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["epsilon"], want["epsilon"], rtol=1e-12)
    args = (4, 1_000_000, 1.0, 1e-5)
    jacc, tacc = JPrivacyAccountant(*args), PrivacyAccountant(*args)
    for step in range(1, 4):
        np.testing.assert_allclose(tacc.epsilon_at(step), jacc.epsilon_at(step),
                                   rtol=1e-12)
