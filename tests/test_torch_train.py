"""The port's training runtime against the JAX package's: the Trainer on the
reduced phi3 in float32 at σ = 0 for 3 steps on the same synthetic batches
(loss trajectory and ε), one AdamW and one SGD step against
``repro.optim``, the synthetic data stream, and the launcher on the CPU
(fixed batches with the fused route; Poisson batches with materialize).

Tolerances: the loss trajectory at rtol 1e-4 (float32; the two differ in
summation order inside each step, and AdamW's first steps move each
weight by about ±lr whatever the gradient's size, so a gradient entry
near zero can move its weight the other way); optimizer steps at
rtol 1e-6 (elementwise float32 arithmetic in another order); ε at 1e-12
(the same pure-Python arithmetic); data bit-exact.
"""
import dataclasses
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
from repro.data.pipeline import SyntheticSource as JSyntheticSource
from repro.models.transformer import build_model
from repro.optim import make_optimizer as j_make_optimizer
from repro.train import Trainer as JTrainer
from repro_torch import interop
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core.accountant import PrivacyAccountant
from repro_torch.data.pipeline import SyntheticSource
from repro_torch.launch import train as tlaunch
from repro_torch.models.transformer import Model
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer

STEPS = 3


@pytest.mark.parametrize("algo", ["dpsgd_r", "sgd"])
def test_trainer_matches_jax_trainer(tmp_path, algo):
    common = dict(steps=STEPS, log_every=1, remat="none",
                  param_dtype="float32", compute_dtype="float32")
    dp = dict(algo=algo, norm_strategy="fused", noise_multiplier=0.0,
              clip_norm=0.5)
    optim = dict(name="adamw", lr=1e-3, schedule="constant")
    jcfg = JTrainConfig(ckpt_dir=str(tmp_path), ckpt_every=STEPS + 10,
                        dp=JDPConfig(**dp), optim=JOptimConfig(**optim), **common)
    jm = build_model(jreduced(JARCHS["phi3-mini-3.8b"]), param_dtype="float32",
                     compute_dtype="float32", remat="none")
    jt = JTrainer(jm, jcfg, JShapeConfig("t", 16, 4, "train"))
    jst = jt.init_state(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, jst.params)
    jt.run(jst, install_signals=False)

    tcfg = TrainConfig(ckpt_dir=str(tmp_path / "torch"),
                       dp=DPConfig(use_kernels=True, **dp),
                       optim=OptimConfig(**optim), **common)
    tm = Model(treduced(TARCHS["phi3-mini-3.8b"]),
               interop.params_from_numpy(params0, "cpu"), dtype=torch.float32,
               device="cpu")
    tt = Trainer(tm, tcfg, ShapeConfig("t", 16, 4, "train"))
    st = tt.run(tt.init_state())
    assert st.step == STEPS and len(tt.history) == STEPS == len(jt.history)
    for got, want in zip(tt.history, jt.history):
        assert got["step"] == want["step"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["epsilon"], want["epsilon"], rtol=1e-12)
    # σ = 0 spends ε = inf in both; the accountants agree at σ = 1 too
    assert tt.accountant.sample_rate == jt.accountant.sample_rate
    args = (4, tt.source.dataset_size, 1.0, 1e-5)
    jacc, tacc = JPrivacyAccountant(*args), PrivacyAccountant(*args)
    for step in range(1, STEPS + 1):
        np.testing.assert_allclose(tacc.epsilon_at(step), jacc.epsilon_at(step),
                                   rtol=1e-12)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_step_matches_jax(name):
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 7), dtype=np.float32),
              "b": [rng.standard_normal((3,), dtype=np.float32)]}
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape, dtype=np.float32),
                         params)
    cfg = dict(name=name, lr=3e-3, warmup_steps=2, total_steps=9,
               weight_decay=0.1)
    jopt = j_make_optimizer(JOptimConfig(**cfg))
    jstate = jopt.init(params)
    jp = params
    topt = make_optimizer(OptimConfig(**cfg))
    tp = [torch.from_numpy(a.copy()) for a in jax.tree.leaves(params)]
    tstate = topt.init(tp)
    for step in range(3):
        jp, jstate = jopt.apply(grads, jstate, jp, step)
        topt.apply([torch.from_numpy(g) for g in jax.tree.leaves(grads)],
                   tstate, tp, step)
    for got, want in zip(tp, jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_synthetic_batches_match_jax():
    for seed, step in ((0, 0), (3, 17), (1, 2 ** 40)):
        got = SyntheticSource(vocab=256, seed=seed).batch(step, 4, 9)
        want = JSyntheticSource(vocab=256, seed=seed).batch(step, 4, 9)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    tlaunch.main(["--arch", "phi3-mini-3.8b", "--reduced", "--steps", "2",
                  "--batch", "2", "--seq", "8", "--device", "cpu",
                  "--dtype", "float32", "--set", f"ckpt_dir={tmp_path}",
                  "--set", "dp.norm_strategy=fused",
                  "--set", "dp.use_kernels=true", "--set", "log_every=1"])
    out = capsys.readouterr().out
    assert out.count("[trainer] step") == 2
    assert "finished at step 2; privacy spent: eps=" in out


def test_launcher_trains_poisson_materialize_on_the_cpu(tmp_path, capsys):
    """Poisson batches through the materialize kernel route (the plain
    versions on the CPU): each step's line names its realized batch and
    the capacity (25 at an expected batch of 8 of N = 1e6)."""
    tlaunch.main(["--arch", "phi3-mini-3.8b", "--reduced", "--steps", "2",
                  "--seq", "8", "--device", "cpu", "--dtype", "float32",
                  "--set", f"ckpt_dir={tmp_path}", "--set", "dp.sampling=poisson",
                  "--set", "dp.norm_strategy=materialize",
                  "--set", "dp.use_kernels=true", "--set", "log_every=1"])
    out = capsys.readouterr().out
    assert "capacity 25 rows" in out
    assert out.count("of capacity 25") == 2
    assert "finished at step 2; privacy spent: eps=" in out


def test_launcher_trains_dpsgd_under_sites_remat_on_the_cpu(tmp_path, capsys):
    """Vanilla DP-SGD two examples at a time, under remat="sites", through
    the launcher on the CPU (``clip_reduce``'s plain version)."""
    tlaunch.main(["--arch", "phi3-mini-3.8b", "--reduced", "--steps", "2",
                  "--batch", "4", "--seq", "8", "--device", "cpu",
                  "--dtype", "float32", "--set", f"ckpt_dir={tmp_path}",
                  "--set", "remat=sites",
                  "--set", "dp.algo=dpsgd", "--set", "dp.microbatch=2",
                  "--set", "dp.use_kernels=true", "--set", "log_every=1"])
    out = capsys.readouterr().out
    assert "remat sites; dp dpsgd" in out
    assert out.count("[trainer] step") == 2
    assert "finished at step 2; privacy spent: eps=" in out


@pytest.mark.parametrize("pair", ["pp_stages=2", "mem.auto_microbatch=true",
                                  "zero1=false", "mesh.shape=4,2", "tune.seed=1",
                                  "pp_microbatches=2", "compress_pod_grads=true"])
def test_unported_overrides_raise(pair):
    """A ``--set`` key of the JAX package whose feature the port lacks
    raises; it is not accepted and then ignored."""
    with pytest.raises(NotImplementedError, match="not ported"):
        tlaunch.main(["--arch", "phi3-mini-3.8b", "--reduced", "--steps", "1",
                      "--device", "cpu", "--set", pair])


def test_remat_and_dtypes_are_held(tmp_path):
    """remat defaults to "block", as in the JAX package, an unknown policy
    raises and names the known ones, and the Trainer trains the model
    under its config's policy; the model's parameter and compute types must
    be the config's, and float32 params computed in bf16 train (the
    launcher builds such a model from ``param_dtype`` and
    ``compute_dtype``)."""
    assert TrainConfig().remat == "block" == JTrainConfig().remat
    for policy in ("none", "block", "sites"):
        assert TrainConfig(remat=policy).remat == policy
    with pytest.raises(ValueError, match=r"unknown remat.*'block', 'none', 'sites'"):
        TrainConfig(remat="everything")
    with pytest.raises(ValueError, match="unknown remat"):
        Model(treduced(TARCHS["phi3-mini-3.8b"]), dtype=torch.float32,
              device="cpu", remat="everything")
    tm = Model(treduced(TARCHS["phi3-mini-3.8b"]), dtype=torch.float32,
               device="cpu")
    assert tm.remat == "block"
    Trainer(tm, TrainConfig(param_dtype="float32", compute_dtype="float32",
                            remat="sites"), ShapeConfig("t", 8, 2, "train"))
    assert tm.remat == "sites"
    shape = ShapeConfig("t", 8, 2, "train")
    with pytest.raises(ValueError, match="param_dtype='bfloat16'"):
        Trainer(tm, TrainConfig(), shape)
    with pytest.raises(ValueError, match="compute_dtype='bfloat16'"):
        Trainer(tm, TrainConfig(param_dtype="float32"), shape)
    Trainer(tm, TrainConfig(param_dtype="float32", compute_dtype="float32"),
            shape)
    split = Model(treduced(TARCHS["phi3-mini-3.8b"]), dtype=torch.bfloat16,
                  param_dtype=torch.float32, device="cpu")
    tr = Trainer(split, TrainConfig(param_dtype="float32", ckpt_dir=str(tmp_path)),
                 shape)
    state = tr.run(tr.init_state(), steps=1, install_signals=False)
    assert state.step == 1 and math.isfinite(tr.history[-1]["loss"])
    assert all(p.dtype == torch.float32 for p in split.parameters())
    tlaunch.main(["--arch", "phi3-mini-3.8b", "--reduced", "--steps", "1",
                  "--batch", "2", "--seq", "8", "--device", "cpu",
                  "--set", "param_dtype=float32", "--set", f"ckpt_dir={tmp_path}"])
