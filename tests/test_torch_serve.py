"""Port's serving tier vs the JAX package's on shared weights.

Greedy outputs of the port's ``Engine`` equal the JAX ``Engine``'s on the
same request stream (contiguous and paged, mixed lengths, slot churn); the
copied ledger and block pool behave identically; a seeded stochastic run
repeats.  Sampling bits differ between the packages (torch.Generator vs
jax.random), so only greedy streams are compared across them.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models.transformer import build_model
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve.ledger import PrivacyLedger as JLedger
from repro.serve.ledger import RequestCharge as JCharge
from repro.serve.paging import BlockPool as JPool
from repro_torch import interop
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.ledger import PrivacyLedger as TLedger
from repro_torch.serve.ledger import RequestCharge as TCharge
from repro_torch.serve.paging import BlockPool as TPool
from repro_torch.serve.scheduler import Request as TRequest


@pytest.fixture(autouse=True)
def _no_tf32():
    # the reference is full float32: TF32 would keep ~3 digits on a card
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@pytest.fixture(scope="module")
def served():
    jm = build_model(jreduced(JARCHS["phi3-mini-3.8b"]), param_dtype="float32",
                     compute_dtype="float32")
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model(treduced(TARCHS["phi3-mini-3.8b"]),
               interop.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
               dtype=torch.float32, device="cpu")
    return jm, params, tm


def _stream(vocab, n=6, seed=1, temperature=0.0, users=False):
    """(uid, prompt, max_new, temperature, user): mixed prompt lengths and
    budgets, so three slots churn over six requests."""
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, vocab, int(rng.integers(4, 30))).astype(np.int32),
             int(rng.integers(1, 9)), temperature,
             f"tenant-{uid % 2}" if users else None) for uid in range(n)]


def _run(engine, req_cls, stream):
    for uid, prompt, max_new, temp, user in stream:
        engine.submit(req_cls(uid=uid, prompt=prompt, max_new=max_new,
                              temperature=temp, user=user))
    return engine.run(max_steps=500)


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_matches_jax_engine(served, paged):
    jm, params, tm = served
    stream = _stream(jm.arch.vocab)
    kw = dict(max_batch=3, cache_len=48, paged=paged, block_size=8,
              num_blocks=12 if paged else None)
    want = _run(JEngine(jm, params, **kw), JRequest, stream)
    eng = TEngine(tm, **kw)
    got = _run(eng, TRequest, stream)
    assert got == want
    assert all(len(got[uid]) == m for uid, _, m, _, _ in stream)
    assert eng.stats["prefill_waves"] >= 2 and eng.stats["max_active"] == 3
    if paged:
        assert eng.pool.free_blocks == eng.pool.num_blocks   # all returned


@pytest.mark.parametrize("paged", [False, True])
def test_deadline_eviction_and_readmit_match_jax(served, paged):
    """A request evicted mid-decode by its deadline (fake clock, advancing
    per observation) returns the same partial output as in the JAX engine;
    its slot is reset on the device and the next request readmitted into
    it matches as well."""
    jm, params, tm = served

    def fake_clock():
        t = {"now": 0.0}

        def clock():
            t["now"] += 0.5
            return t["now"]
        return clock

    kw = dict(max_batch=2, cache_len=32, decode_chunk=2, paged=paged,
              block_size=8, num_blocks=8 if paged else None)
    stream = [(0, np.arange(1, 6, dtype=np.int32), 8, 0.0, None),
              (1, np.arange(2, 7, dtype=np.int32), 16, 0.0, None)]
    later = [(2, np.arange(3, 9, dtype=np.int32), 6, 0.0, None)]
    outs = []
    for eng, req in ((JEngine(jm, params, clock=fake_clock(), **kw), JRequest),
                     (TEngine(tm, clock=fake_clock(), **kw), TRequest)):
        for uid, prompt, max_new, temp, _ in stream:
            eng.submit(req(uid=uid, prompt=prompt, max_new=max_new,
                           temperature=temp, deadline=3.0 if uid else None))
        first = eng.run(max_steps=100)
        assert 0 < len(first[1]) < 16 and eng.stats["evicted"] == 1
        assert np.asarray(eng.dev["remaining"]).tolist() == [0, 0]
        if paged:
            assert (np.asarray(eng.dev["tables"]) == eng.pool.sentinel).all()
        outs.append((first, _run(eng, req, later)))
    assert outs[1] == outs[0]


def test_ledger_matches_jax(served):
    """The engines gate on the copied ledger identically: same outputs,
    same refusals, same composed ε per user (to 1e-12)."""
    jm, params, tm = served
    stream = _stream(jm.arch.vocab, seed=2, users=True)
    # q=0.01, sigma=4 composes to eps 0.05540, 0.05592, 0.05643 after 1, 2,
    # 3 requests (delta 1e-6): each tenant gets two of its three admitted
    budget = 0.056
    jl = JLedger(budget, 1e-6, policy="refuse",
                 default_charge=JCharge(0.01, 4.0))
    tl = TLedger(budget, 1e-6, policy="refuse",
                 default_charge=TCharge(0.01, 4.0))
    want = _run(JEngine(jm, params, max_batch=3, cache_len=48, ledger=jl),
                JRequest, stream)
    eng = TEngine(tm, max_batch=3, cache_len=48, ledger=tl)
    got = _run(eng, TRequest, stream)
    assert got == want
    assert eng.stats["refused"] > 0
    for user in ("tenant-0", "tenant-1"):
        assert abs(tl.epsilon(user) - jl.epsilon(user)) <= 1e-12
    assert tl.state_dict() == jl.state_dict()


def test_block_pool_matches_jax():
    """Alloc/free sequences with prefix sharing give identical chains."""
    rng = np.random.default_rng(3)
    head = rng.integers(0, 50, 16).astype(np.int32)
    jp, tp = JPool(20, 4), TPool(20, 4)
    held = []
    for i in range(12):
        tail = rng.integers(0, 50, int(rng.integers(0, 9))).astype(np.int32)
        prompt = np.concatenate([head[:int(rng.integers(0, 17))], tail])
        if len(prompt) == 0:
            prompt = head[:1]
        total = len(prompt) + int(rng.integers(1, 6))
        a, b = jp.alloc(prompt, total), tp.alloc(prompt, total)
        assert a == b
        if a is not None:
            held.append(a)
        if held and rng.random() < 0.5:
            chain = held.pop(int(rng.integers(0, len(held))))
            jp.free(chain)
            tp.free(chain)
        assert jp.free_blocks == tp.free_blocks and jp.stats == tp.stats


def test_seeded_stochastic_run_repeats(served):
    _, _, tm = served
    stream = _stream(tm.arch.vocab, seed=4, temperature=0.8)
    runs = [_run(TEngine(tm, max_batch=3, cache_len=48, seed=7), TRequest,
                 stream) for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(0 <= t < tm.arch.vocab for out in runs[0].values() for t in out)
