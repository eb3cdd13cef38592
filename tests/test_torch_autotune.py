"""The port's launch autotuner (``repro_torch/launch/autotune.py``) against
the JAX package's (``repro/launch/autotune.py``), and the reference's own
pins (``tests/test_autotune.py``) held on the port.

* The plan machinery: ``LaunchPlan``'s round trip, ``apply`` and width;
  ``PlanSpace.build``'s dims equal to the reference's for the reduced phi3
  (``sgd`` and ``dpsgd_r``), ``cnn-cifar10`` and deepseek-moe; the static
  infeasibility reasons word for word (and the port's own for a mesh the
  launcher does not run); ``spearman`` with ties.
* The solve on the reference test's 18-plan ``sgd`` space without
  measurement: the port's exhaustive solve has the reference's feasible
  set and winner, the two packages' predicted seconds rank alike
  (Spearman >= 0.8), and two GA solves with one seed give one plan.  The
  collective term takes the reference's link bandwidth here
  (``repro.launch.roofline.ICI_BW``); the port's own is the H100's.
* Four ``dpsgd_r`` plans (each norm strategy at ``block``): each predicted
  second within 25% of the reference's, ranked as the reference ranks
  them (a reference tie within 1e-6 may fall either way).
* A measured CPU solve is never slower than the default; only a refused
  trace makes a plan infeasible (and never a kernel plan on the card); the
  three Trainer plan behaviours; the budget error with its byte gap; the
  launcher's ``--autotune`` on the CPU, in one process and in a 2-rank
  gloo world where every rank trains rank 0's winner.

Each JAX solve runs once, in a process of its own beside the port's
solve (``jax_side``), and the 2-rank launcher starts beside them; the
port's later solves reuse the exhaustive solve's traces (a trace is a pure
function of the plan's knobs).
"""
import concurrent.futures
import multiprocessing
import os
import re
import subprocess
import sys

import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import (DPConfig as JDPConfig, ShapeConfig as JShapeConfig,
                                TrainConfig as JTrainConfig, TuneConfig as JTuneConfig)
from repro.launch import autotune as ja
from repro.launch.roofline import ICI_BW
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tb
from repro_torch.launch import autotune as ta
from repro_torch.launch import train as tlaunch

PHI3 = "phi3-mini-3.8b"
JARCH, TARCH = jreduced(JARCHS[PHI3]), tconfigs.reduced(tconfigs.get_arch(PHI3))
JSHAPE = JShapeConfig("autotune_test", 32, 4, "train")
TSHAPE = tb.ShapeConfig("autotune_test", 32, 4, "train")
MESH = [(1, 1)]


def _jcfg(**kw):
    kw.setdefault("dp", JDPConfig(enabled=False, algo="sgd"))
    return JTrainConfig(arch=JARCH.name, param_dtype="float32",
                        compute_dtype="float32", **kw)


def _tcfg(**kw):
    kw.setdefault("dp", tb.DPConfig(enabled=False, algo="sgd"))
    return tb.TrainConfig(arch=TARCH.name, param_dtype="float32",
                          compute_dtype="float32", **kw)


def _scorer(cfg, traces=None):
    s = ta.PlanScorer(TARCH, cfg, TSHAPE, device="cpu", link_bw=ICI_BW)
    if traces is not None:
        s._traces = dict(traces)
    return s


STRATEGIES = ("auto", "materialize", "gram", "fused")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_exhaustive():
    return ja.solve(JARCH, _jcfg(tune=JTuneConfig(method="exhaustive", topk=18)),
                    JSHAPE, mesh_shapes=MESH, measure=False)


def _jax_dpsgd_r_seconds():
    js = ja.PlanScorer(JARCH, _jcfg(dp=JDPConfig(algo="dpsgd_r")), JSHAPE)
    return [js.score(ja.LaunchPlan(remat="block", norm_strategy=s)).pred_seconds
            for s in STRATEGIES]


def _two_rank_launcher(ckpt_dir):
    """The 2-rank gloo launcher of ``test_launcher_autotune_two_ranks_train_one_plan``,
    started."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train", "--arch", PHI3,
         "--reduced", "--steps", "1", "--batch", "4", "--seq", "8", "--device", "cpu",
         "--dtype", "float32", "--autotune", "--set", "dp.algo=sgd",
         "--set", "tune.method=ga", "--set", "tune.population=2",
         "--set", "tune.generations=1", "--set", "tune.topk=1",
         "--set", "tune.measure_iters=1", "--set", f"ckpt_dir={ckpt_dir}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The reference's exhaustive solve and its four ``dpsgd_r`` plans'
    seconds, computed in a process of their own, and the 2-rank launcher,
    started: all three run beside the port's work in this process."""
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    launcher = _two_rank_launcher(tmp_path_factory.mktemp("two_ranks"))
    try:
        yield dict(exhaustive=pool.submit(_jax_exhaustive),
                   dpsgd_r=pool.submit(_jax_dpsgd_r_seconds), launcher=launcher)
    finally:
        pool.shutdown(cancel_futures=True)
        if launcher.poll() is None:
            launcher.kill()
            launcher.communicate()


@pytest.fixture(scope="module")
def ex_reports(jax_side):
    """The reference's and the port's exhaustive solves of the 18-plan
    space, and the port's scorer (its traces)."""
    cfg = _tcfg(tune=tb.TuneConfig(method="exhaustive", topk=18))
    scorer = _scorer(cfg)
    tr = ta.solve(TARCH, cfg, TSHAPE, mesh_shapes=MESH, measure=False, device="cpu",
                  link_bw=ICI_BW, scorer=scorer)
    return jax_side["exhaustive"].result(), tr, scorer._traces


def _key(plan):
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in plan.as_dict().items()))


# ---------------------------------------------------------------------------
# the plan machinery
# ---------------------------------------------------------------------------

def test_plan_config_roundtrip_and_width():
    cfg = _tcfg(grad_accum=2, remat="sites", compress_pod_grads=True,
                dp=tb.DPConfig(algo="dpsgd_r", norm_strategy="gram"))
    plan = ta.LaunchPlan.from_config(cfg, mesh_shape=(2, 1))
    assert plan.grad_accum == 2 and plan.remat == "sites"
    assert plan.norm_strategy == "gram" and plan.compress_grads
    cfg2 = plan.apply(_tcfg(dp=tb.DPConfig(algo="dpsgd_r")))
    assert (cfg2.grad_accum, cfg2.remat, cfg2.compress_pod_grads,
            cfg2.dp.norm_strategy, cfg2.mesh.shape) == (2, "sites", True, "gram", (2, 1))
    assert ta.LaunchPlan.from_config(cfg2) == plan
    assert plan.as_dict() == ja.LaunchPlan(**{**plan.as_dict(), "mesh_shape": (2, 1)}
                                           ).as_dict()
    for shape, width in (((1, 1), 1), ((16, 16), 16), ((2, 16, 16), 32), ((4,), 4)):
        assert ta.LaunchPlan(mesh_shape=shape).width == width \
            == ja.LaunchPlan(mesh_shape=shape).width


@pytest.mark.parametrize("name,algo", [(PHI3, "sgd"), (PHI3, "dpsgd_r"),
                                       ("cnn-cifar10", "dpsgd_r"),
                                       ("deepseek-moe-16b", "dpsgd"),
                                       ("deepseek-moe-16b", "dpsgd_r")])
def test_space_dims_match_jax(name, algo):
    jarch, tarch = jreduced(JARCHS[name]), tconfigs.reduced(tconfigs.get_arch(name))
    for kernels in (False, True):
        for meshes in (MESH, [(1, 1), (2, 1)]):
            js = ja.PlanSpace.build(jarch, JTrainConfig(dp=JDPConfig(algo=algo)), JSHAPE,
                                    mesh_shapes=meshes, include_kernels=kernels)
            ts = ta.PlanSpace.build(tarch, tb.TrainConfig(dp=tb.DPConfig(algo=algo)),
                                    TSHAPE, mesh_shapes=meshes, include_kernels=kernels)
            assert ts.dims == js.dims and ts.size == js.size
            assert ts.default.as_dict() == js.default.as_dict()
    for g in ts.genomes():
        assert ts.genome_of(ts.plan_of(g)) == g


def test_static_reasons_word_for_word():
    jcfg, tcfg = _jcfg(dp=JDPConfig(algo="dpsgd")), _tcfg(dp=tb.DPConfig(algo="dpsgd"))
    js, ts = ja.PlanScorer(JARCH, jcfg, JSHAPE), _scorer(tcfg)
    plans = [dict(grad_accum=2), dict(grad_accum=3), dict(grad_accum=2, microbatch=3),
             dict(grad_accum=1, mesh_shape=(8, 1)), dict(remat="all"),
             dict(pp_stages=3), dict(pp_stages=2), dict(grad_accum=0)]
    for kw in plans:
        want = js._static_infeasible(ja.LaunchPlan(**kw))
        assert ts._static_infeasible(ta.LaunchPlan(**kw)) == want, kw
    assert ts._static_infeasible(ta.LaunchPlan(grad_accum=2)) == ""
    # a mesh the autotuner does not run: the launcher's reason under
    # --autotune, word for word
    reason = ts._static_infeasible(ta.LaunchPlan(mesh_shape=(1, 2)))
    assert reason == tlaunch.unported_mesh_reason(TARCH, {"model": 2}, autotune=True)
    assert "'model' mesh axis (tensor parallelism) is not ported" in reason


def test_spearman_with_ties_matches_jax():
    for xs, ys in (([1, 2, 3], [10, 20, 30]), ([1, 2, 3], [30, 20, 10]),
                   ([1, 2], [5, 5]), ([1], [2]), ([0.001, 5, 1e9], [1, 2, 3]),
                   ([1, 1, 2], [1, 2, 3]), ([3, 1, 2, 2, 5], [1, 1, 4, 2, 0])):
        assert ta.spearman(xs, ys) == ja.spearman(xs, ys)
    r = ta.spearman([1, 1, 2], [1, 2, 3])
    assert r is not None and 0 < r < 1


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

def test_exhaustive_solve_matches_jax(ex_reports):
    jr, tr, _ = ex_reports
    assert tr.method == jr.method == "exhaustive"
    assert tr.space_size == jr.space_size == 18 and tr.traces == 18
    jp = {_key(s.plan): s.pred_seconds for s in jr.predicted}
    tp = {_key(s.plan): s.pred_seconds for s in tr.predicted}
    assert set(tp) == set(jp) and len(tp) == 18          # the feasible set
    assert _key(tr.plan) == _key(jr.plan)                 # the winner
    keys = sorted(jp)
    rho = ta.spearman([jp[k] for k in keys], [tp[k] for k in keys])
    assert rho >= 0.8, rho
    times = [s.pred_seconds for s in tr.predicted]
    assert times == sorted(times)
    import json
    json.dumps(tr.as_dict())


def test_same_seed_same_winning_plan(ex_reports):
    traces = ex_reports[2]
    cfg = _tcfg(tune=tb.TuneConfig(method="ga", seed=7, population=6, generations=3,
                                   topk=2))
    r1, r2 = (ta.solve(TARCH, cfg, TSHAPE, mesh_shapes=MESH, measure=False,
                       scorer=_scorer(cfg, traces)) for _ in range(2))
    assert r1.plan == r2.plan and r1.seed == r2.seed == 7
    assert [s.plan for s in r1.predicted] == [s.plan for s in r2.predicted]
    assert r1.cache_hits > 0 and r1.evals == r2.evals
    assert r1.plan == ex_reports[1].plan          # the 18-plan optimum


def test_dpsgd_r_plans_within_a_quarter_of_jax(jax_side):
    ts = _scorer(_tcfg(dp=tb.DPConfig(algo="dpsgd_r")))
    strategies = STRATEGIES
    got = [ts.score(ta.LaunchPlan(remat="block", norm_strategy=s)).pred_seconds
           for s in strategies]
    want = jax_side["dpsgd_r"].result()
    for s, g, w in zip(strategies, got, want):
        assert abs(g - w) <= 0.25 * w, (s, g, w)
    for i in range(4):
        for j in range(4):
            if want[i] < want[j] * (1 - 1e-6):
                assert got[i] < got[j], (strategies[i], strategies[j], got, want)


def test_measured_solve_never_slower_than_default(ex_reports):
    cfg = _tcfg(tune=tb.TuneConfig(method="exhaustive", topk=1, measure_iters=2))
    rep = ta.solve(TARCH, cfg, TSHAPE, mesh_shapes=MESH, measure=True, device="cpu",
                   scorer=_scorer(cfg, ex_reports[2]))
    assert rep.measured and rep.traces == 0
    by_plan = {_key(ta.LaunchPlan(**{**r["plan"], "mesh_shape": tuple(
        r["plan"]["mesh_shape"])})): r for r in rep.measured}
    win, dflt = by_plan[_key(rep.plan)], by_plan[_key(rep.default_plan)]
    assert win["seconds"] <= dflt["seconds"]
    assert all(r["measured_peak_bytes"] is None for r in rep.measured)   # the CPU
    assert rep.rank_correlation is None or -1.0 <= rep.rank_correlation <= 1.0


def test_infeasible_budget_raises_with_gap(ex_reports):
    cfg = _tcfg(mem=tb.MemConfig(hbm_budget_bytes=1024),
                tune=tb.TuneConfig(method="exhaustive"))
    with pytest.raises(ValueError, match="over budget") as ei:
        ta.solve(TARCH, cfg, TSHAPE, mesh_shapes=MESH, measure=False,
                 scorer=_scorer(cfg, ex_reports[2]))
    msg = str(ei.value)
    assert "best infeasible candidate" in msg and "hbm_budget_bytes=1024" in msg
    assert re.search(r"\d+ B over budget", msg)
    # nothing passes the static checks: the reasons, no budget gap
    with pytest.raises(ValueError, match="no feasible launch plan"):
        ta.solve(TARCH, _tcfg(tune=tb.TuneConfig(method="exhaustive")), TSHAPE,
                 mesh_shapes=[(8, 1)], measure=False, device="cpu")


def test_only_a_refused_trace_is_infeasible(monkeypatch):
    """A trace that raises ``ValueError`` or ``NotImplementedError`` (a
    refused combination) makes the plan infeasible with its reason; any
    other error propagates, and so does a kernel plan's refusal on the
    card, where routing around it would pick a plain plan instead."""
    def raising(exc):
        def trace(self, plan, capacity):
            raise exc
        return trace

    plan, plain = ta.LaunchPlan(use_kernels=True), ta.LaunchPlan()
    monkeypatch.setattr(ta.PlanScorer, "_trace", raising(ValueError("no rule")))
    s = _scorer(_tcfg()).score(plan)
    assert not s.feasible and s.reason == "trace failed: ValueError: no rule"
    cuda = ta.PlanScorer(TARCH, _tcfg(), TSHAPE, device="cuda")
    assert not cuda.score(plain).feasible
    with pytest.raises(ValueError, match="no rule"):
        cuda.score(plan)
    monkeypatch.setattr(ta.PlanScorer, "_trace", raising(RuntimeError("a fault")))
    with pytest.raises(RuntimeError, match="a fault"):
        _scorer(_tcfg()).score(plan)


# ---------------------------------------------------------------------------
# the Trainer and the launcher
# ---------------------------------------------------------------------------

def _model(pp_stages=1):
    from repro_torch.models import build_model_for
    return build_model_for(TARCH, dtype=torch.float32, param_dtype=torch.float32,
                           device="cpu", seed=0, remat="block", pp_stages=pp_stages)


def test_trainer_accepts_plan(tmp_path):
    from repro_torch.train import Trainer
    plan = ta.LaunchPlan(grad_accum=2, remat="none", norm_strategy="gram",
                         mesh_shape=(1, 1))
    tr = Trainer(_model(), _tcfg(dp=tb.DPConfig(algo="dpsgd_r"),
                                 ckpt_dir=str(tmp_path)), TSHAPE, plan=plan)
    assert (tr.cfg.grad_accum, tr.cfg.remat, tr.cfg.dp.norm_strategy) == (2, "none", "gram")
    assert tr.model.remat == "none" and tr.plan is plan


def test_trainer_rejects_mismatched_pipeline_stages(tmp_path):
    from repro_torch.train import Trainer
    plan = ta.LaunchPlan(pp_stages=2, mesh_shape=(1, 1))
    with pytest.raises(ValueError, match="pp_stages"):
        Trainer(_model(), _tcfg(ckpt_dir=str(tmp_path)), TSHAPE, plan=plan)
    Trainer(_model(pp_stages=2), _tcfg(ckpt_dir=str(tmp_path)), TSHAPE, plan=plan)


def test_trainer_plan_skips_auto_microbatch(tmp_path):
    from repro_torch.train import Trainer
    # an impossible budget would make the auto-microbatch search raise;
    # a plan pre-empts that search
    cfg = _tcfg(mem=tb.MemConfig(hbm_budget_bytes=1, auto_microbatch=True),
                ckpt_dir=str(tmp_path))
    tr = Trainer(_model(), cfg, TSHAPE, plan=ta.LaunchPlan(mesh_shape=(1, 1)))
    assert tr.mem_estimate is None


def test_launcher_autotune_on_the_cpu(tmp_path, capsys):
    tlaunch.main(["--arch", PHI3, "--reduced", "--steps", "2", "--batch", "2",
                  "--seq", "8", "--device", "cpu", "--dtype", "float32", "--autotune",
                  "--set", "dp.algo=sgd", "--set", "tune.method=ga",
                  "--set", "tune.population=4", "--set", "tune.generations=1",
                  "--set", "tune.topk=2", "--set", "tune.measure_iters=1",
                  "--set", "log_every=1", "--set", f"ckpt_dir={tmp_path}"])
    out = capsys.readouterr().out
    m = re.search(r"\[train\] autotune \(ga, seed=0\): searched (\d+) plans, (\d+) "
                  r"traces \((\d+) cache hits\); winner (LaunchPlan\(.*\))", out)
    assert m and int(m.group(1)) == 12, out
    assert "[train] autotune predicted-vs-measured rank correlation" in out
    plan = eval(m.group(4), {"LaunchPlan": ta.LaunchPlan})
    assert f"remat {plan.remat}; dp sgd" in out
    assert out.count("[trainer] step") == 2
    assert "finished at step 2; privacy spent: eps=" in out


def test_launcher_autotune_two_ranks_train_one_plan(jax_side):
    """A 2-rank gloo world (started with the module's JAX side): rank 0
    solves over the (2, 1) space (its compression gene included) and every
    rank trains its winner."""
    launcher = jax_side["launcher"]
    stdout = launcher.communicate(timeout=120)[0]
    run = subprocess.CompletedProcess(launcher.args, launcher.returncode, stdout)
    assert run.returncode == 0, run.stdout[-4000:]
    m = re.search(r"\[train\] autotune \(ga, seed=0\): .*; winner (LaunchPlan\(.*\))",
                  run.stdout)
    assert m, run.stdout[-4000:]
    took = dict(re.findall(r"\[train\] rank (\d) of 2 trains the autotune winner "
                           r"(LaunchPlan\(.*\))", run.stdout))
    assert took == {"0": m.group(1), "1": m.group(1)}, run.stdout[-4000:]
    plan = eval(m.group(1), {"LaunchPlan": ta.LaunchPlan})
    assert plan.mesh_shape == (2, 1)
    assert f"compress_pod_grads={plan.compress_grads}" in run.stdout
    assert run.stdout.count("finished at step 1; privacy spent") == 2
