"""The port's memory planner (``repro_torch/launch/memory.py``) against the
JAX package's (``repro/launch/memory.py``), and the reference's own pins
(``tests/test_memory.py``) held on the port.

* The pure sizing functions (``per_example_grad_bytes``,
  ``per_device_peak_bytes``, ``_accum_candidates``, ``abstract_batch``)
  and the copied analytical model (``repro_torch.sim``) equal the JAX
  package's exactly, over grids of configs and ``tests/test_dataflow.py``'s
  inputs.
* The port's estimate of a step (a fake-tensor trace of the Trainer's own
  step) sits within ``TOLERANCE_FACTOR`` (4, the reference's) of the JAX
  package's jaxpr estimate of the same step, on the reduced models in
  float32.
* The reference's pins: ``none >= sites >= block``; vanilla DP-SGD's
  transient exceeds SGD's by at least 0.8 x the per-example spill and its
  peak is at least 1.3 x SGD's; a grad_accum split shrinks the estimate;
  the five auto-microbatch behaviours.
* The Trainer picks the split under a budget, and its update equals the
  JAX Trainer's at that grad_accum (rtol 1e-5, atol 2e-6, σ = 0, SGD: an
  update linear in the gradient).
* The trace has no side effects (params, optimizer state, generators and
  kernel launch counts are as they were), the kernel wrappers' fake
  branches make their launches' allocations and launch nothing, and a
  CUDA tensor that is not fake still goes to the launch (a mock stands in
  for the card).
"""
import contextlib
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import (DPConfig as JDPConfig, OptimConfig as JOptimConfig,
                                ShapeConfig as JShapeConfig,
                                TrainConfig as JTrainConfig)
from repro.launch import memory as jmem
from repro.models import build_model_for as j_build_model_for
from repro.sim import dataflow as jdf
from repro.sim import models as jsm
from repro.train import Trainer as JTrainer
from repro_torch import interop, tree
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import (DPConfig, MemConfig, OptimConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.core import sites
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import clip_reduce as _cr
from repro_torch.kernels import flash_attn as _fa
from repro_torch.kernels import fused_bwd as _fb
from repro_torch.kernels import gram_norm as _gn
from repro_torch.kernels import pegrad_norm as _pn
from repro_torch.launch import memory as tmem
from repro_torch.models import build_model_for
from repro_torch.sim import dataflow as tdf
from repro_torch.sim import models as tsm
from repro_torch.train import Trainer
from repro_torch.train.trainer import physical_batch_size

PHI3 = "phi3-mini-3.8b"
PINS = dict(rtol=1e-5, atol=2e-6)


def _port_model(name, remat="block", params=None, n_layers=None):
    arch = treduced(TARCHS[name])
    if n_layers is not None:
        arch = dataclasses.replace(arch, n_layers=n_layers)
    m = build_model_for(arch, params, dtype=torch.float32, device="cpu",
                        remat=remat)
    m.requires_grad_(True)
    return m


def _cfg(name=PHI3, remat="block", **kw):
    return TrainConfig(arch=name, remat=remat, param_dtype="float32",
                       compute_dtype="float32", steps=1, log_every=1,
                       ckpt_every=10**9, ckpt_async=False, **kw)


def _jcfg(name=PHI3, remat="block", **kw):
    return JTrainConfig(arch=name, remat=remat, param_dtype="float32",
                        compute_dtype="float32", steps=1, log_every=1,
                        ckpt_every=10**9, ckpt_async=False, **kw)


def _estimate(model, cfg, B, T, **kw):
    return tmem.estimate_train_memory(
        model, cfg, tmem.abstract_batch(model.arch, B, T), **kw)


# ---------------------------------------------------------------------------
# the pure sizing functions and the analytical model, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["sgd", "dpsgd", "dpsgd_r", "dpsgd_r1f"])
def test_per_example_grad_bytes_matches_jax(algo):
    for enabled, B, accum, mb, k in itertools.product(
            (True, False), (4, 16, 48), (1, 2, 4), (0, 1, 3), (1, 4)):
        kw = dict(enabled=enabled, algo=algo, microbatch=mb, augmult=k)
        for n in (1, 1234, 10**9):
            assert tmem.per_example_grad_bytes(DPConfig(**kw), B * k, accum, n) \
                == jmem.per_example_grad_bytes(JDPConfig(**kw), B * k, accum, n)


def test_per_device_peak_bytes_matches_jax():
    for peak, params, opt, bf in itertools.product(
            (100, 10**9 + 7), (0, 10, 12345), (0, 30, 99), (0.0, 0.5, 0.9)):
        est = {"peak_bytes": peak, "params_bytes": params,
               "opt_state_bytes": opt, "block_params_fraction": bf}
        for shards, stages in itertools.product((1, 2, 3, 8), (1, 2, 4)):
            assert tmem.per_device_peak_bytes(est, shards, stages) \
                == jmem.per_device_peak_bytes(est, shards, stages)


def test_accum_candidates_match_jax():
    for sampling, B, mb, shards in itertools.product(
            ("fixed", "poisson"), (1, 8, 12, 30, 64), (0, 1, 2, 3), (1, 2, 3)):
        dp = dict(sampling=sampling, microbatch=mb)
        shape = ShapeConfig("t", 16, B, "train")
        got = tmem._accum_candidates(_cfg(dp=DPConfig(**dp)), shape, shards)
        want = jmem._accum_candidates(_jcfg(dp=JDPConfig(**dp)),
                                      JShapeConfig("t", 16, B, "train"), shards)
        assert got == want, (sampling, B, mb, shards)


@pytest.mark.parametrize("name", [PHI3, "cnn-cifar10", "vit-cifar10",
                                  "chatglm3-6b"])
def test_abstract_batch_matches_jax(name):
    for B, T, k in itertools.product((1, 8), (16, 512), (1, 4)):
        got = tmem.abstract_batch(TARCHS[name], B, T, augmult=k)
        want = jmem.abstract_batch(JARCHS[name], B, T, augmult=k)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(want[key].shape), key
            assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)


def _fields(x):
    """A record of either package's sim as a tuple (the two packages' classes
    differ, their fields do not)."""
    return dataclasses.astuple(x)


def test_sim_matches_jax():
    """``repro_torch.sim`` is ``repro.sim`` on ``tests/test_dataflow.py``'s
    inputs: the same numbers, exactly."""
    accels = ("WS", "OS", "OS_PPU", "DIVA_NOPPU", "DIVA")
    gemms = [(128, 128, 128), (8, 4096, 1024), (1024, 8, 1024), (1, 1, 1),
             (300, 77, 513), (256, 4096, 256)]
    for a in accels:
        ta, ja = getattr(tdf, a), getattr(jdf, a)
        for g in gemms:
            assert tdf.util(ta, g) == jdf.util(ja, g)
            assert tdf.gemm_cycles(ta, g) == jdf.gemm_cycles(ja, g)
            assert tdf.gemm_time(ta, g) == jdf.gemm_time(ja, g)
        for fn in ("bert_base", "vgg16", "lstm_small"):
            for algo in ("sgd", "dpsgd", "dpsgd_r"):
                assert _fields(tdf.dp_training_time(
                    ta, getattr(tsm, fn)(), batch=8, algo=algo)) == _fields(
                    jdf.dp_training_time(ja, getattr(jsm, fn)(), batch=8,
                                         algo=algo))
        ts = [(128, 256, 512, 2.0), (64, 64, 64, 1.0)]
        for kw in ({}, dict(ew_flops=1e9, n_devices=4),
                   dict(coll_bytes=100e9, ici_bw=50e9)):
            assert _fields(tdf.traced_step_time(ta, ts, **kw)) == \
                _fields(jdf.traced_step_time(ja, ts, **kw))
    for batch in (1, 2, 8, 64, 1024):
        assert tdf.pegrad_spill_bytes(batch, 1234) == \
            jdf.pegrad_spill_bytes(batch, 1234)
    # the presets' GEMM tables, from the port's registry: the SSM and
    # hybrid families too (mamba2's tied embeddings leave out the head)
    for name in (PHI3, "cnn-cifar10", "vit-cifar10", "deepseek-moe-16b",
                 "mamba2-1.3b", "jamba-1.5-large-398b"):
        tarch = treduced(TARCHS[name])
        got = tsm.layers_for_arch(tarch, seq_len=32)
        want = jsm.layers_for_arch(jreduced(JARCHS[name]), seq_len=32)
        assert [_fields(x) for x in got] == [_fields(x) for x in want], name


# ---------------------------------------------------------------------------
# estimates against the JAX package's
# ---------------------------------------------------------------------------

CROSS_CELLS = [(PHI3, "dpsgd_r", "block"), (PHI3, "dpsgd", "none"),
               ("cnn-cifar10", "dpsgd_r1f", "sites"),
               ("deepseek-moe-16b", "dpsgd_r", "sites")]


@pytest.mark.parametrize("name,algo,remat", CROSS_CELLS)
def test_estimate_within_tolerance_of_jax(name, algo, remat):
    jarch = jreduced(JARCHS[name])
    jmodel = j_build_model_for(jarch, param_dtype="float32",
                               compute_dtype="float32", remat=remat)
    want = jmem.estimate_train_memory(
        jmodel, _jcfg(name, remat, dp=JDPConfig(algo=algo)),
        jmem.abstract_batch(jarch, 8, 32))
    got = _estimate(_port_model(name, remat), _cfg(name, remat,
                                                   dp=DPConfig(algo=algo)), 8, 32)
    assert got["arg_bytes"] == pytest.approx(want["arg_bytes"], rel=1e-3)
    for k in ("params_bytes", "grad_bytes", "per_example_grad_bytes"):
        assert got[k] == want[k], k
    ratio = got["peak_bytes"] / want["peak_bytes"]
    assert tmem.within_tolerance(ratio), (name, algo, remat, got["peak_bytes"],
                                          want["peak_bytes"], ratio)


# ---------------------------------------------------------------------------
# the reference's pins, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [PHI3, "cnn-cifar10"])
def test_remat_policies_order_the_estimates(name):
    """Storing everything needs more than checkpointing, and ``sites``
    (block inputs and the saved site operands) sits above ``block``.  The
    CNN is the full cnn-cifar10 at B 32, as in the reference: tracing
    allocates nothing, and the reduced CNN is too shallow for remat to
    pay."""
    peaks = {}
    for remat in ("none", "block", "sites"):
        cfg = _cfg(name, remat, dp=DPConfig(algo="dpsgd_r"))
        if name == "cnn-cifar10":
            model = build_model_for(TARCHS[name], dtype=torch.float32,
                                    device="cpu", remat=remat)
            model.requires_grad_(True)
            B, T = 32, 0
        else:
            model, B, T = _port_model(name, remat), 8, 64
        peaks[remat] = _estimate(model, cfg, B, T)["peak_bytes"]
    assert peaks["none"] >= peaks["sites"] >= peaks["block"], peaks


def test_dp_footprint_ratio_pin():
    """Vanilla DP-SGD's transient holds the spilled per-example gradients
    (``sim/dataflow.pegrad_spill_bytes``) on top of an SGD step's, and its
    peak is at least 1.3 x SGD's at the same batch (paper §III's capacity
    blowup).  The port's ``dpsgd`` takes one example at a time where the
    JAX package vmaps over the batch, so the SGD step it holds beside the
    spill is one example's: the reference's gap is taken against SGD on one
    example here, the ratio against SGD at the batch as there."""
    B, model = 8, _port_model(PHI3, n_layers=1)
    ests = {algo: _estimate(model, _cfg(dp=DPConfig(algo=algo)), B, 32)
            for algo in ("sgd", "dpsgd", "dpsgd_r")}
    one = _estimate(model, _cfg(dp=DPConfig(algo="sgd")), 1, 32)
    param_elems = ests["sgd"]["grad_bytes"] // 4
    spill = tdf.pegrad_spill_bytes(B, param_elems)
    assert ests["dpsgd"]["per_example_grad_bytes"] == int(spill)
    assert ests["dpsgd_r"]["per_example_grad_bytes"] == 4 * B
    assert ests["sgd"]["per_example_grad_bytes"] == 0
    gap = ests["dpsgd"]["transient_bytes"] - one["transient_bytes"]
    assert gap >= 0.8 * spill, (gap, spill)
    ratio = ests["dpsgd"]["peak_bytes"] / ests["sgd"]["peak_bytes"]
    assert ratio >= 1.3, ratio


def test_remat_and_grad_accum_shape_the_estimate():
    """``remat="none"`` estimates more transient than ``"block"`` (on
    ``dpsgd_r``, whose peak the activations set: the port's ``dpsgd`` holds
    one example's activations, and its spill sets its peak under every
    policy), and a grad_accum split shrinks ``dpsgd``'s estimate."""
    cfg = _cfg(remat="none", dp=DPConfig(algo="dpsgd_r"))
    full = _estimate(_port_model(PHI3, "none"), cfg, 16, 32)
    ck = _estimate(_port_model(PHI3, "block"),
                   dataclasses.replace(cfg, remat="block"), 16, 32)
    assert full["transient_bytes"] > ck["transient_bytes"]
    cfg = _cfg(remat="none", dp=DPConfig(algo="dpsgd"))
    model = _port_model(PHI3, "none", n_layers=1)
    whole = _estimate(model, cfg, 8, 16)
    split = _estimate(model, dataclasses.replace(cfg, grad_accum=4), 8, 16)
    assert split["peak_bytes"] < whole["peak_bytes"]


# ---------------------------------------------------------------------------
# budget-driven auto-microbatching
# ---------------------------------------------------------------------------

def _budget(budget, **dp):
    return _cfg(dp=DPConfig(**dp),
                mem=MemConfig(hbm_budget_bytes=int(budget), auto_microbatch=True))


def test_auto_microbatch_budget_too_small_raises():
    with pytest.raises(ValueError, match="no microbatch split fits"):
        tmem.pick_grad_accum(_port_model(PHI3, n_layers=1), _budget(1),
                             ShapeConfig("t", 16, 2, "train"))


def test_auto_microbatch_unlimited_budget_is_noop(tmp_path):
    cfg = dataclasses.replace(_cfg(mem=MemConfig(auto_microbatch=True)),
                              ckpt_dir=str(tmp_path))
    trainer = Trainer(_port_model(PHI3, n_layers=1), cfg,
                      ShapeConfig("t", 16, 4, "train"))
    assert trainer.cfg.grad_accum == 1
    assert trainer.mem_estimate is None


def test_auto_microbatch_divisibility_error_is_distinct():
    with pytest.raises(ValueError, match="no feasible grad_accum"):
        tmem.pick_grad_accum(_port_model(PHI3, n_layers=1),
                             _budget(10**12, algo="dpsgd", microbatch=3),
                             ShapeConfig("t", 16, 8, "train"))


def test_auto_microbatch_picks_largest_fitting_split():
    model, shape = _port_model(PHI3, n_layers=1), ShapeConfig("t", 16, 4, "train")
    base = _cfg(dp=DPConfig(algo="dpsgd"))
    peak = {g: _estimate(model, dataclasses.replace(base, grad_accum=g), 4,
                         16)["peak_bytes"] for g in (1, 2, 4)}
    assert peak[4] < peak[1]
    budget = (peak[1] + peak[4]) // 2
    g, est = tmem.pick_grad_accum(model, _budget(budget, algo="dpsgd"), shape)
    assert 1 < g <= 4
    assert est["peak_bytes"] <= budget
    # the pick is maximal-microbatch: one step fewer accum does not fit
    assert all(peak[c] > budget for c in (1, 2, 4) if c < g)


def test_auto_microbatch_respects_poisson_lcm_rounding(tmp_path):
    """The chosen split keeps the padded Poisson capacity divisible by
    grad_accum x microbatch x batch-axis width (3 wide here), and the
    Trainer (one device) runs at the split it picks."""
    model, shape = _port_model(PHI3, n_layers=1), ShapeConfig("t", 16, 4, "train")
    base = _cfg(dp=DPConfig(algo="dpsgd_r", sampling="poisson"))
    est1 = tmem.estimate_train_memory(
        model, base, tmem.abstract_batch(
            model.arch, physical_batch_size(base, shape, 1_000_000, shards=3),
            16), expected_batch_size=8.0)
    peak1 = tmem.per_device_peak_bytes(est1, 3)
    cfg = _budget(peak1 * 0.98, algo="dpsgd_r", sampling="poisson")
    g, est = tmem.pick_grad_accum(model, cfg, shape, shards=3)
    assert g > 1
    assert est["capacity"] % (g * 3) == 0, (est["capacity"], g)
    one = tmem.estimate_train_memory(
        model, base, tmem.abstract_batch(
            model.arch, physical_batch_size(base, shape, 1_000_000), 16),
        expected_batch_size=4.0)["peak_bytes"]
    cfg = dataclasses.replace(
        _budget(one * 0.98, algo="dpsgd_r", sampling="poisson"),
        ckpt_dir=str(tmp_path))
    trainer = Trainer(model, cfg, shape)
    assert trainer.cfg.grad_accum > 1
    assert trainer.capacity % trainer.cfg.grad_accum == 0
    trainer.run(trainer.init_state(), steps=1, install_signals=False)


def test_trainer_split_matches_jax_trainer(tmp_path, capsys):
    """Under a budget between the port's estimates at grad_accum 1 and 2
    the Trainer picks 2, says so, and its first update equals the JAX
    Trainer's at grad_accum 2 (σ = 0, SGD, so the update is linear in the
    clipped sum)."""
    shape = dict(seq_len=16, global_batch=4, kind="train")
    dp = dict(algo="dpsgd", clip_norm=0.05, noise_multiplier=0.0)
    optim = dict(name="sgd", lr=1.0, schedule="constant")
    jarch = dataclasses.replace(jreduced(JARCHS[PHI3]), n_layers=1)
    jm = j_build_model_for(jarch, param_dtype="float32",
                           compute_dtype="float32", remat="none")
    jt = JTrainer(jm, dataclasses.replace(
        _jcfg(remat="none", dp=JDPConfig(**dp), optim=JOptimConfig(**optim)),
        grad_accum=2, ckpt_dir=str(tmp_path / "jax")),
        JShapeConfig("t", **shape), jit_step=False)
    jst = jt.init_state(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, jst.params)
    jst = jt.run(jst, steps=1, install_signals=False)

    model = _port_model(PHI3, "none", interop.params_from_numpy(params0, "cpu"),
                        n_layers=1)
    base = _cfg(remat="none", dp=DPConfig(**dp), optim=OptimConfig(**optim))
    peak = {g: _estimate(model, dataclasses.replace(base, grad_accum=g), 4,
                         16)["peak_bytes"] for g in (1, 2)}
    assert peak[2] < peak[1]
    cfg = dataclasses.replace(
        base, ckpt_dir=str(tmp_path / "torch"),
        mem=MemConfig(hbm_budget_bytes=(peak[1] + peak[2]) // 2,
                      auto_microbatch=True))
    tt = Trainer(model, cfg, ShapeConfig("t", **shape))
    assert tt.cfg.grad_accum == 2 and tt.mem_estimate["grad_accum"] == 2
    assert "auto_microbatch: grad_accum 1 -> 2" in capsys.readouterr().out
    tt.run(tt.init_state(), steps=1, install_signals=False)
    got = [p.detach().numpy() - p0 for p, p0 in
           zip(tree.leaves(model.params), jax.tree.leaves(params0))]
    want = [np.asarray(p) - p0 for p, p0 in
            zip(jax.tree.leaves(jst.params), jax.tree.leaves(params0))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **PINS)


def test_memory_report_on_the_cpu(tmp_path):
    """The estimate of the Trainer's config at its batch's shapes; on the
    CPU there is no allocator peak to measure, and nothing is stepped."""
    tr = Trainer(_port_model(PHI3, n_layers=1), dataclasses.replace(
        _cfg(), ckpt_dir=str(tmp_path)), ShapeConfig("t", 16, 4, "train"))
    state = tr.init_state()
    rep = tr.memory_report(state, tr.make_batch(0), measure=True)
    assert rep["peak_bytes"] > rep["arg_bytes"] > 0
    assert "measured_peak_bytes" not in rep and state.step == 0


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def _counts():
    return (_cr.LAUNCHES, _fb.LAUNCHES, _fb.DGRAD_LAUNCHES, _pn.LAUNCHES,
            _gn.LAUNCHES, _fa.LAUNCHES, _fa.BWD_LAUNCHES)


@pytest.mark.parametrize("algo", ["dpsgd_r", "dpsgd"])
def test_trace_has_no_side_effects(tmp_path, algo):
    """An estimate (here through the Trainer, adaptive clip on) leaves the
    params, the optimizer state, the clip state, the remat policy, the
    step's noise and every launch count as they were."""
    model = _port_model(PHI3, "sites", n_layers=1)
    cfg = dataclasses.replace(
        _cfg(remat="sites", dp=DPConfig(algo=algo, adaptive_clip=True,
                                        noise_multiplier=1.0,
                                        norm_strategy="fused",
                                        use_kernels=True)),
        ckpt_dir=str(tmp_path))
    tr = Trainer(model, cfg, ShapeConfig("t", 16, 4, "train"))
    state = tr.init_state()
    tr.train_step(state, tr.make_batch(0))
    before = [t.clone() for t in tree.leaves([state.params, state.opt_state])]
    draw = torch.randn(8, generator=tr.noise_generator(state.step))
    rng = torch.get_rng_state()
    counts, remat = _counts(), model.remat
    rep = tr.memory_report(state, tr.make_batch(state.step))
    tmem.estimate_train_memory(model, dataclasses.replace(cfg, remat="none"),
                               tmem.abstract_batch(model.arch, 4, 16))
    assert rep["peak_bytes"] > 0 and rep["remat"] == "sites"
    after = tree.leaves([state.params, state.opt_state])
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b) and not kbuild.is_fake(a)
    assert torch.equal(torch.randn(8, generator=tr.noise_generator(state.step)),
                       draw)
    assert torch.equal(torch.get_rng_state(), rng)
    assert _counts() == counts and model.remat == remat == "sites"
    assert state.step == 1


def _fake_cuda(*specs):
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    with mode:
        return mode, [torch.empty(s, dtype=d, device="cuda") for s, d in specs]


def test_wrappers_on_fake_cuda_tensors_allocate_and_launch_nothing():
    """Each wrapper, given fake CUDA tensors, makes the allocations of its
    launch (the counted workspace), launches nothing and counts nothing:
    the planner's trace of the card's kernel routes."""
    bf = torch.bfloat16
    BG, T, di, do, S = 2, 96, 200, 136, 64
    mode, (x, gy, w, g, c, q, k, o, lse) = _fake_cuda(
        ((BG, T, di), bf), ((BG, T, do), bf), ((1, di, do), bf),
        ((3, 1000), bf), ((3,), torch.float32), ((4, T, 32), bf),
        ((2, S, 32), bf), ((4, T, 32), bf), ((4, T), torch.float32))
    tiles = -(-di // _fb.TILE) * -(-do // _fb.TILE)
    cases = {
        "dense_bwd_norm": (lambda: _fb.dense_bwd_norm(x, gy, w),
                           BG * T * di * 2 + BG * tiles * 4),
        "dense_dgrad": (lambda: _fb.dense_dgrad(gy, w), BG * T * di * 2),
        "pegrad_norm": (lambda: _pn.pegrad_norm(x, gy), BG * tiles * 4),
        "gram_norm": (lambda: _gn.gram_norm(x, gy),
                      BG * (-(-T // _gn.TILE)) * (-(-T // _gn.TILE) + 1) // 2 * 4),
        "clip_reduce": (lambda: _cr.clip_reduce(g, c), 1000 * 4),
        "flash_attn_fwd": (lambda: _fa.flash_attn_fwd(q, k, k, rep=2),
                           4 * T * 32 * 2 + 4 * T * 4),
        "flash_attn_bwd": (lambda: _fa.flash_attn_bwd(q, k, k, o, lse, o, rep=2),
                           4 * T * 4 + 4 * T * 32 * 4 + 2 * 4 * S * 32 * 4),
    }
    counts = _counts()
    with mode:
        for name, (fn, workspace) in cases.items():
            est, _ = tmem.traced_peak_bytes(fn, [x, gy, w, g, c, q, k, o, lse])
            # the launch's own buffers (and the few small sums after it)
            assert est.transient_bytes >= workspace, (name, est, workspace)
            assert est.transient_bytes <= 3 * workspace, (name, est, workspace)
    assert _counts() == counts


def test_a_cuda_tensor_that_is_not_fake_goes_to_the_launch(monkeypatch):
    """The fake branch is taken for fake tensors only: a CUDA tensor (the
    fake one here, declared real) reaches the launch and counts it; a mock
    stands in for the card's library and stream."""
    mode, (g, c) = _fake_cuda(((3, 1000), torch.float32),
                              ((3,), torch.float32))
    calls = []
    monkeypatch.setattr(kbuild, "is_fake", lambda t: False)
    monkeypatch.setattr(kbuild, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(_cr, "_kernel", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    before = _cr.LAUNCHES
    with mode:
        _cr.clip_reduce(g, c)
    assert len(calls) == 1 and _cr.LAUNCHES == before + 1


def test_storage_key_under_real_meta_and_fake_tensors():
    """``remat="sites"`` keys saved operands by storage: views share a key,
    distinct storages differ, for real, meta and fake tensors alike (a
    data pointer is 0 for every meta storage and raises for a fake one)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def check(a, b):
        assert sites._storage_key(a) == sites._storage_key(a[1:].view(-1))
        assert sites._storage_key(a) != sites._storage_key(b)
        saved = {}
        site = sites.get_site("dense")
        sites.name_saved_operands(site, (a, b), saved)
        sites.name_saved_operands(site, (a[1:], b), saved)
        assert len(saved) == 1 and sites.is_saved_operand(a.view(-1), saved)
        assert not sites.is_saved_operand(b, saved)

    check(torch.zeros(4, 4), torch.zeros(4, 4))
    check(torch.zeros(4, 4, device="meta"), torch.zeros(4, 4, device="meta"))
    with FakeTensorMode():
        check(torch.zeros(4, 4), torch.zeros(4, 4))


def test_sites_trace_counts_each_saved_operand_once():
    """Under ``remat="sites"`` the trace keeps each site operand once: the
    estimate above ``block``'s is at most the operands' bytes, each storage
    counted once however many sites read it (q, k and v read one x)."""
    B, T = 8, 64
    model = _port_model(PHI3, "sites")
    cfg = _cfg(remat="sites", dp=DPConfig(algo="dpsgd_r"))
    sites_est = _estimate(model, cfg, B, T)
    block_est = _estimate(_port_model(PHI3, "block"),
                          dataclasses.replace(cfg, remat="block"), B, T)
    arch, d = model.arch, model.arch.d_model
    # the saved operands of one layer: x into qkv, o into wo, x into w1/w3,
    # h into w2 (f32), per block of the model
    per_layer = 4 * B * T * (d + arch.n_heads * arch.hd + d + arch.d_ff)
    extra = sites_est["transient_bytes"] - block_est["transient_bytes"]
    assert 0 < extra <= 2 * arch.n_layers * per_layer, (extra, per_layer)
