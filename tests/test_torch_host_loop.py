"""The port's host-loop engine (``repro_torch/serve/host_loop.py``) against
the port's ``Engine`` and the JAX package's ``HostLoopEngine``: the cases
of ``tests/test_serve_engine.py`` that use the host loop, on the reduced
stablelm-3b in float32 on the CPU with JAX-initialised weights carried
across (``interop.params_from_numpy``).

Greedy streams are compared bit for bit (token ids equal): the host loop
prefills one request at a time where the engine prefills padded waves, and
in float32 on the CPU both give the same argmax.  Also the two historical
fixes the host loop keeps (``max_new=1`` frees its slot at admit;
requests admitted before ``run()`` are kept), the step budget's attached
results, submit validation, and the launcher's ``--engine host-loop``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models.transformer import build_model
from repro.serve import HostLoopEngine as JHostLoopEngine
from repro.serve import Request as JRequest
from repro_torch import interop
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.launch import serve as tlaunch
from repro_torch.models.transformer import Model
from repro_torch.serve import (Engine, HostLoopEngine, Request,
                               StepBudgetExceeded)

ARCH = "stablelm-3b"


@pytest.fixture(scope="module")
def served():
    jm = build_model(jreduced(JARCHS[ARCH]), param_dtype="float32",
                     compute_dtype="float32")
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(treduced(TARCHS[ARCH]),
               interop.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
               dtype=torch.float32, device="cpu")
    return jm, params, tm


def _requests(vocab, n, rng, max_new=None):
    """(uid, prompt, max_new) as ``tests/test_serve_engine.py`` draws them."""
    out = []
    for uid in range(n):
        prompt = rng.integers(0, vocab, int(rng.integers(4, 14))).astype(np.int32)
        out.append((uid, prompt, max_new or int(rng.integers(1, 8))))
    return out


def _serve(engine, reqs, cls=Request, max_steps=500):
    for uid, prompt, max_new in reqs:
        engine.submit(cls(uid=uid, prompt=prompt, max_new=max_new))
    return engine.run(max_steps=max_steps)


@pytest.mark.parametrize("seed", [2, 7])
def test_matches_engine_and_jax_host_loop(served, seed):
    """Greedy streams of the port's host loop equal the port's engine's and
    the JAX host loop's on the same weights and request stream, bit for
    bit; the engine reads the device far less often."""
    jm, params, tm = served
    reqs = _requests(tm.arch.vocab, 5, np.random.default_rng(seed))
    hl = HostLoopEngine(tm, max_batch=2, cache_len=64)
    got = _serve(hl, reqs)
    eng = Engine(tm, max_batch=2, cache_len=64)
    assert _serve(eng, reqs) == got
    want = _serve(JHostLoopEngine(jm, params, max_batch=2, cache_len=64), reqs,
                  JRequest)
    assert got == want
    assert sorted(got) == list(range(5))
    assert all(len(got[uid]) == m for uid, _, m in reqs)
    assert hl.stats["host_syncs"] == sum(m for _, _, m in reqs)
    assert eng.stats["host_syncs"] < hl.stats["host_syncs"]
    assert set(hl.ttft) == set(range(5))


def test_max_new_1_terminates(served):
    """A ``max_new=1`` request frees its slot at admit, so ``run()``
    ends."""
    _, _, tm = served
    eng = HostLoopEngine(tm, max_batch=2, cache_len=64)
    out = _serve(eng, [(uid, np.arange(1, 5 + uid, dtype=np.int32), 1)
                       for uid in range(3)], max_steps=50)
    assert sorted(out) == [0, 1, 2]
    assert all(len(v) == 1 for v in out.values())
    assert eng.stats["decode_steps"] == 0


def test_preadmitted_requests_are_kept(served):
    """Requests admitted into slots before ``run()`` are served with the
    rest."""
    _, _, tm = served
    eng = HostLoopEngine(tm, max_batch=2, cache_len=64)
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=np.arange(1, 7, dtype=np.int32),
                           max_new=3))
    eng._admit()        # two requests enter slots before run() is called
    out = eng.run(max_steps=100)
    assert sorted(out) == [0, 1, 2]
    assert all(len(v) == 3 for v in out.values())


def test_step_budget_attaches_completed_results(served):
    _, _, tm = served
    eng = HostLoopEngine(tm, max_batch=1, cache_len=64)
    with pytest.raises(StepBudgetExceeded) as ei:
        _serve(eng, [(0, np.arange(1, 6, dtype=np.int32), 2),
                     (1, np.arange(1, 6, dtype=np.int32), 30)], max_steps=5)
    assert len(ei.value.results[0]) == 2     # finished before the overrun


def test_submit_validation(served):
    _, _, tm = served
    eng = HostLoopEngine(tm, max_batch=1, cache_len=16)
    with pytest.raises(ValueError):
        eng.submit(Request(uid=0, prompt=np.ones((4,), np.int32), max_new=0))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=1, prompt=np.ones((12,), np.int32), max_new=5))


def test_seeded_stochastic_run_repeats(served):
    """Sampled streams come from the seeded numpy generator: a second run
    with the same seed repeats them."""
    _, _, tm = served
    reqs = _requests(tm.arch.vocab, 4, np.random.default_rng(3), max_new=5)

    def run():
        eng = HostLoopEngine(tm, max_batch=2, cache_len=64, seed=11)
        for uid, prompt, max_new in reqs:
            eng.submit(Request(uid=uid, prompt=prompt, max_new=max_new,
                               temperature=0.9))
        return eng.run(max_steps=100)

    first = run()
    assert first == run()
    assert all(0 <= t < tm.arch.vocab for v in first.values() for t in v)


def test_launcher_runs_the_host_loop(capsys):
    tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--dtype",
                  "float32", "--engine", "host-loop", "--requests", "3",
                  "--max-new", "4", "--policy", "shortest-prompt"])
    out = capsys.readouterr().out
    assert "--deadline/--policy are ignored by the host-loop" in out
    assert "3 requests, 12 tokens" in out
    assert "'host_syncs': 12" in out
