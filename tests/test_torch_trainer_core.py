"""The port's training core beside the JAX package's: the resume drill
(N steps straight equal k steps, a restore into a fresh model and
Trainer, and N - k more, bit for bit on the CPU), retries (a retried step
is bit-identical; a failure inside the step leaves the state as it was; a
failure in the update is not retried), preemption, the straggler
watchdog, the memmap source against ``repro.data.MemmapSource`` (fixed and
Poisson batches and ε), and float32 params computed in bf16 against the
JAX package's ``param_dtype``/``compute_dtype``.

The reduced phi3 (2 layers, d 64) at B 4 x T 16 throughout.  Pins: bit
equality where one package runs twice (resume, retry); ε at rtol 1e-12
(the same arithmetic); split types at a bf16 tolerance stated at the test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import DPConfig as JDPConfig, ShapeConfig as JShapeConfig
from repro.core import make_noisy_grad_fn as j_make_noisy_grad_fn
from repro.core.accountant import PrivacyAccountant as JPrivacyAccountant
from repro.data import make_source as j_make_source
from repro.data import poisson_batch_for as j_poisson_batch_for
from repro.models.transformer import build_model
from repro_torch import interop, tree
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core import algo as talgo
from repro_torch.data import make_source, poisson_batch_for
from repro_torch.launch import train as tlaunch
from repro_torch.models.transformer import Model
from repro_torch.train import Trainer

ARCH = "phi3-mini-3.8b"
SHAPE = ShapeConfig("t", 16, 4, "train")


def _cfg(tmp_path, **kw):
    base = dict(steps=4, log_every=1, ckpt_every=2, ckpt_dir=str(tmp_path),
                remat="block", param_dtype="float32", compute_dtype="float32",
                dp=DPConfig(algo="dpsgd_r", norm_strategy="fused",
                            use_kernels=True, clip_norm=1.0,
                            noise_multiplier=0.7),
                optim=OptimConfig(name="adamw", lr=1e-2, warmup_steps=2,
                                  total_steps=4))
    base.update(kw)
    return TrainConfig(**base)


def _trainer(cfg, seed=0, **kw):
    model = Model(treduced(TARCHS[ARCH]), dtype=torch.float32, device="cpu",
                  seed=seed)
    return Trainer(model, cfg, SHAPE, **kw)


def _leaves(state):
    return [t.detach().clone() for t in tree.leaves(state.params)
            + tree.leaves(state.opt_state)]


def _assert_bits(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "tokens.bin"
    np.random.default_rng(5).integers(0, 1000, 20_000, dtype=np.int32).tofile(path)
    return str(path)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """4 steps of the default config without a fault: (leaves, losses)."""
    tr = _trainer(_cfg(tmp_path_factory.mktemp("straight")))
    st = tr.run(tr.init_state(), install_signals=False)
    return _leaves(st), [h["loss"] for h in tr.history]


@pytest.mark.parametrize("optim,memmap", [("adamw", False), ("adam8bit", True)])
def test_resume_drill_is_exact(tmp_path, corpus, straight, optim, memmap):
    """4 steps straight against 2 steps, a restore into a fresh model (other
    init seed) and Trainer, and 2 more: every param and optimizer leaf and
    every logged loss bit for bit."""
    kw = {}
    if optim != "adamw":
        kw["optim"] = OptimConfig(name=optim, lr=1e-2, warmup_steps=2,
                                  total_steps=4, block_size=64)
    if memmap:
        kw["data_source"] = f"memmap:{corpus}"
    if kw:
        tr = _trainer(_cfg(tmp_path / "a", **kw))
        st = tr.run(tr.init_state(), install_signals=False)
        straight = _leaves(st), [h["loss"] for h in tr.history]
    first = _trainer(_cfg(tmp_path / "b", **kw))
    first.run(first.init_state(), steps=2, install_signals=False)
    assert first.ckpt.steps() == [2]
    resumed = _trainer(_cfg(tmp_path / "b", **kw), seed=1)
    sb = resumed.restore_or_init()
    assert sb.step == 2
    sb = resumed.run(sb, install_signals=False)
    assert sb.step == 4 and resumed.ckpt.steps() == [2, 4]
    _assert_bits(straight[0], _leaves(sb))
    assert straight[1][2:] == [h["loss"] for h in resumed.history]


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    args = ["--arch", "phi3-mini-3.8b", "--reduced", "--batch", "2", "--seq",
            "8", "--device", "cpu", "--dtype", "float32", "--set",
            f"ckpt_dir={tmp_path}", "--set", "log_every=1"]
    tlaunch.main(args + ["--steps", "2"])
    tlaunch.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert f"[trainer] restored step 2 from {tmp_path}" in out
    assert out.count("[trainer] step") == 3
    assert "finished at step 3; privacy spent: eps=" in out


@pytest.mark.parametrize("inside", [False, True])
def test_retried_step_is_bit_identical(tmp_path, straight, inside, capsys):
    """A failure at step 2, before the step or inside it, is retried; the
    run ends with the clean run's bits."""
    failing = _trainer(_cfg(tmp_path), inject_failure_at=2,
                       inject_inside_step=inside)
    sf = failing.run(failing.init_state(), install_signals=False)
    assert failing._injected and sf.step == 4
    assert "step 2 attempt 0 failed: injected transient failure" in \
        capsys.readouterr().out
    _assert_bits(straight[0], _leaves(sf))


def test_failure_inside_the_step_leaves_the_state(tmp_path, monkeypatch):
    """The injected failure fires inside the gradient function after pass
    1 (pass 2's forward) and leaves params, optimizer state and step as
    they were."""
    tr = _trainer(_cfg(tmp_path), inject_failure_at=0, inject_inside_step=True)
    state = tr.init_state()
    passes = []
    orig = talgo.norm_pass
    monkeypatch.setattr(talgo, "norm_pass",
                        lambda *a, **k: passes.append(1) or orig(*a, **k))
    before = _leaves(state)
    with pytest.raises(RuntimeError, match="inside the step"):
        tr.gradients(state, tr.make_batch(0))
    assert passes == [1] and state.step == 0
    _assert_bits(before, _leaves(state))


def test_failure_in_the_update_is_not_retried(tmp_path, capsys):
    tr = _trainer(_cfg(tmp_path))

    def broken(*a):
        raise RuntimeError("update failed")
    tr.opt = dataclasses.replace(tr.opt, apply=broken)
    with pytest.raises(RuntimeError, match="update failed"):
        tr.run(tr.init_state(), install_signals=False)
    assert "retrying" not in capsys.readouterr().out


def test_preemption_saves_and_exits(tmp_path, capsys):
    """SIGTERM during step 1 (the handler's flag, set from the batch
    maker): the step finishes, a checkpoint of step 2 is written, the run
    leaves."""
    tr = _trainer(_cfg(tmp_path, steps=50, ckpt_every=100))
    make = tr.make_batch

    def make_batch(step):
        if step == 1:
            tr._handle_preempt(15, None)
        return make(step)
    tr.make_batch = make_batch
    st = tr.run(tr.init_state(), install_signals=False)
    assert st.step == 2 and tr.ckpt.steps() == [2]
    assert "preempted at step 1; checkpoint saved, exiting" in capsys.readouterr().out


def test_watchdog_names_the_straggler(tmp_path, capsys):
    tr = _trainer(_cfg(tmp_path))
    for step, dt in enumerate([1.0, 1.1, 0.9, 1.0, 1.0, 3.5]):
        tr._watchdog(step, dt)
    tr._watchdog(6, 2.9)
    out = capsys.readouterr().out
    assert "WATCHDOG straggler: step 5 took 3.50s (median 1.00s)" in out
    assert "step 6" not in out


def test_memmap_source_matches_jax(tmp_path, corpus):
    """Fixed and Poisson batches from one token file, keyed by (seed, step),
    and ε priced at q = B/N over its token count, as the JAX package."""
    src, jsrc = make_source(f"memmap:{corpus}", 1000, 3), \
        j_make_source(f"memmap:{corpus}", 1000, 3)
    assert src.dataset_size == jsrc.dataset_size == 20_000
    for step in (0, 7, 2 ** 40):
        np.testing.assert_array_equal(src.batch(step, 4, 16)["tokens"],
                                      jsrc.batch(step, 4, 16)["tokens"])
    arch, jarch = treduced(TARCHS[ARCH]), jreduced(JARCHS[ARCH])
    for step in (0, 3):
        got = poisson_batch_for(src, arch, SHAPE, step, capacity=16)
        want = j_poisson_batch_for(jsrc, jarch, JShapeConfig("t", 16, 4, "train"),
                                   step, capacity=16)
        for k in ("tokens", "mask"):
            np.testing.assert_array_equal(got[k], want[k])
    tr = _trainer(_cfg(tmp_path, data_source=f"memmap:{corpus}",
                       dp=DPConfig(sampling="poisson", noise_multiplier=1.0)))
    assert tr.sample_rate == 4 / 20_000
    jacc = JPrivacyAccountant(batch_size=4, dataset_size=20_000,
                              noise_multiplier=1.0, delta=1e-5,
                              sample_rate=4 / 20_000)
    for step in (1, 10, 100):
        np.testing.assert_allclose(tr.accountant.epsilon_at(step),
                                   jacc.epsilon_at(step), rtol=1e-12)


def test_split_types_match_jax(tmp_path):
    """float32 params computed in bf16: one dpsgd_r fused step at σ = 0
    against the JAX package from the same weights and tokens.  The port
    casts each weight to bf16 where it is used, so every product is bf16.
    The JAX package's own float32/bfloat16 pair cannot run this model: the
    bf16 activations meet float32 weights, type promotion turns the
    scanned block's carry float32, and ``lax.scan`` refuses it (asserted
    below); so the reference is its all-float32 step, and the two differ by
    bf16 rounding: loss and per-example norms at rtol 5e-3 (1.4e-3 seen),
    each gradient leaf within 3e-2 of its largest entry (2.0e-2 seen).  The gradients come back
    float32, the parameter type, and a Trainer trains on them."""
    arch = jreduced(JARCHS[ARCH])
    params = jax.tree.map(np.asarray, build_model(
        arch, param_dtype="float32", compute_dtype="float32",
        remat="none").init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(1).integers(0, arch.vocab, (4, 17)).astype(np.int32)
    dp = dict(algo="dpsgd_r", norm_strategy="fused", clip_norm=0.5,
              noise_multiplier=0.0)

    def jax_step(compute_dtype):
        jm = build_model(arch, param_dtype="float32", compute_dtype=compute_dtype,
                         remat="none")
        return jax.jit(j_make_noisy_grad_fn(jm.loss_fn, JDPConfig(**dp)))(
            jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(toks)},
            jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match="carry"):
        jax_step("bfloat16")
    jgrads, jmet = jax_step("float32")
    tm = Model(treduced(TARCHS[ARCH]), interop.params_from_numpy(params, "cpu"),
               dtype=torch.bfloat16, param_dtype=torch.float32, device="cpu",
               remat="none")
    tm.requires_grad_(True)
    fn = talgo.make_noisy_grad_fn(tm.loss_fn, DPConfig(use_kernels=True, **dp))
    grads, met = fn(tm.params, {"tokens": torch.from_numpy(toks)},
                    torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    for k in ("loss", "grad_norm_mean", "grad_norm_max"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=5e-3)
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 3e-2 * np.abs(w).max()
    cfg = TrainConfig(param_dtype="float32", compute_dtype="bfloat16",
                      remat="none", ckpt_dir=str(tmp_path), dp=DPConfig(**dp))
    tr = Trainer(tm, cfg, SHAPE)
    st = tr.init_state()
    tr.train_step(st, tr.make_batch(0))
    assert st.step == 1 and all(p.dtype == torch.float32 for p in tm.parameters())
