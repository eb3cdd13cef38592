"""The port's MoE family (``models/moe.py``, the ``moe_dense`` site, the MoE
branch of ``models/transformer.py``) against the JAX package's, on seeded
numpy inputs and JAX-initialised weights carried across with ``interop``,
float32, TF32 off.

Routing is held exactly (integer outputs equal, ties and drops included);
dispatch and combine at rtol 1e-6; the ``moe_dense`` site's gx, gw and
norms² under every rule and kernel route (the kernels' plain versions on
the CPU) at rtol 1e-5 / atol 2e-6, the reference's pins.  The models,
reduced: deepseek-moe-16b (a dense and an MoE layer, one block: below 18
layers ``group_layers`` takes every layer into one period, as the JAX
package does) and grok-1-314b (two MoE blocks): the loss with its aux term
in one ``dpsgd_r`` fused step at σ = 0 (norms², losses, clipped sums),
the other algorithms and remat policies against it, padded rows, prefill
and decode logits, greedy streams of the engines, a ``sharded-v1``
checkpoint read by both packages; the expert weights' init std against
the reference's 1/√d_in.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import DPConfig as JDPConfig
from repro.configs.base import OptimConfig as JOptimConfig
from repro.core import algo as jalgo
from repro.core import sites as jsites
from repro.core.context import DPContext as JDPContext
from repro.models import moe as jmoe
from repro.models.transformer import build_model
from repro.models.transformer import group_layers as j_group_layers
from repro.optim import make_optimizer as j_make_optimizer
from repro.serve import Engine as JEngine
from repro.serve import HostLoopEngine as JHostLoopEngine
from repro.serve import Request as JRequest
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.state import TrainState as JTrainState
from repro_torch import interop, tree
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import DPConfig, OptimConfig
from repro_torch.core import algo as talgo
from repro_torch.core import sites as tsites
from repro_torch.core.context import DPContext
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import Model, group_layers, model_spec
from repro_torch.optim import make_optimizer
from repro_torch.serve import Engine, HostLoopEngine, Request
from repro_torch.train import checkpoint as C
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.state import TrainState

DS, GROK = "deepseek-moe-16b", "grok-1-314b"
PINS = dict(rtol=1e-5, atol=2e-6)
B, T = 4, 16


@pytest.fixture(autouse=True)
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _archs(name):
    """(JAX, port) reduced configs, 2 layers each."""
    return jreduced(JARCHS[name]), treduced(TARCHS[name])


@functools.lru_cache(maxsize=None)
def _weights(name):
    jarch, _ = _archs(name)
    jm = build_model(jarch, param_dtype="float32", compute_dtype="float32",
                     remat="none")
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _port(name, remat="none"):
    jm, params = _weights(name)
    tm = Model(_archs(name)[1], interop.params_from_numpy(params, "cpu"),
               dtype=torch.float32, device="cpu", remat=remat)
    tm.requires_grad_(True)
    return tm


def _toks(seed=1, rows=B):
    return np.random.default_rng(seed).integers(0, 256, (rows, T + 1)).astype(np.int32)


# ---------------------------------------------------------------------------
# routing, dispatch, combine
# ---------------------------------------------------------------------------

def test_capacity_matches_jax():
    for name in (DS, GROK):
        for cf in (1.25, 0.5, 4.0):
            m = dataclasses.replace(TARCHS[name].moe, capacity_factor=cf)
            jm = dataclasses.replace(JARCHS[name].moe, capacity_factor=cf)
            for t in (1, 7, 16, 512, 4096):
                assert tmoe.capacity(m, t) == jmoe.capacity(jm, t), (name, cf, t)
    assert tmoe.capacity(TARCHS[DS].moe, 512) == 60       # the chip's shapes
    assert tmoe.capacity(TARCHS[GROK].moe, 512) == 160
    assert tmoe.capacity(TARCHS[DS].moe, 1) == 1          # decode


def _probs(kind, rng, shape):
    if kind == "ties":      # 3 levels: most rows have tied top entries
        p = rng.integers(0, 3, shape).astype(np.float32) + 1.0
        return p / p.sum(-1, keepdims=True)
    z = rng.standard_normal(shape).astype(np.float32)
    return np.exp(z) / np.exp(z).sum(-1, keepdims=True)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_route_matches_jax(kind, cf):
    """Experts, slots and keep equal; gates at rtol 1e-6.  Capacity
    factor 0.5 drops tokens."""
    rng = np.random.default_rng(0)
    Bq, Tq, E, K = 3, 16, 8, 2
    probs = _probs(kind, rng, (Bq, Tq, E))
    cap = jmoe.capacity(dataclasses.replace(JARCHS[GROK].moe, capacity_factor=cf), Tq)
    want = jmoe._route(jnp.asarray(probs), K, cap)
    got = tmoe._route(torch.from_numpy(probs), K, cap)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    if cf == 0.5:
        assert not got[3].all()


def test_dispatch_and_combine_match_jax():
    rng = np.random.default_rng(1)
    Bq, Tq, E, K, d = 2, 16, 4, 2, 8
    cap = 5                                 # some drops
    probs = _probs("random", rng, (Bq, Tq, E))
    x = rng.standard_normal((Bq, Tq, d)).astype(np.float32)
    ye = rng.standard_normal((Bq, E, cap, d)).astype(np.float32)
    jr = jmoe._route(jnp.asarray(probs), K, cap)
    tr = tmoe._route(torch.from_numpy(probs), K, cap)
    np.testing.assert_allclose(
        tmoe._dispatch(torch.from_numpy(x), *tr[1:], E, cap).numpy(),
        np.asarray(jmoe._dispatch(jnp.asarray(x), *jr[1:], E, cap)), rtol=1e-6)
    np.testing.assert_allclose(
        tmoe._combine(torch.from_numpy(ye), *tr).numpy(),
        np.asarray(jmoe._combine(jnp.asarray(ye), *jr)), rtol=1e-6, atol=1e-7)
    assert not tr[3].all()


@pytest.mark.parametrize("name", [DS, GROK])
def test_moe_apply_matches_jax(name):
    """y and the per-example aux of one MoE FFN on seeded weights."""
    jarch, tarch = _archs(name)
    rng = np.random.default_rng(2)
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
         for k, s in jmoe.moe_spec(jarch).items()}
    x = rng.standard_normal((3, T, jarch.d_model)).astype(np.float32)
    wy, _, waux = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), JDPContext.off(), jarch)
    gy, _, gaux = tmoe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                 torch.from_numpy(x), DPContext.off(), tarch)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **PINS)
    np.testing.assert_allclose(gaux.numpy(), np.asarray(waux), rtol=1e-6)


# ---------------------------------------------------------------------------
# the moe_dense site
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,use_kernels", [
    ("materialize", False), ("materialize", True), ("gram", False),
    ("gram", True), ("fused", False), ("fused", True)])
def test_moe_dense_site_matches_jax(strategy, use_kernels):
    """gx, gw and norms² through the port's site (its kernel routes with
    ``use_kernels``) against the JAX site's plain backward and rule of the
    same name; an all-zero gy example gives a norm² of exactly 0."""
    rng = np.random.default_rng(3)
    Bq, E, Cq, di, do = 3, 4, 5, 6, 7
    x = rng.standard_normal((Bq, E, Cq, di)).astype(np.float32)
    w = rng.standard_normal((E, di, do)).astype(np.float32)
    r = rng.standard_normal((Bq, E, Cq, do)).astype(np.float32)
    r[1] = 0.0
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ctx = DPContext.norm_mode(Bq, strategy, use_kernels)
    acc0 = ctx.acc
    y, ctx = ctx.moe_dense(tx, tw)
    gx, gw, nsq = torch.autograd.grad(((y * torch.from_numpy(r)).sum(), ctx.acc),
                                      (tx, tw, acc0),
                                      (torch.ones(()), torch.zeros(Bq)))
    spec = jsites.SiteSpec("moe_dense", strategy, False)
    ops = (jnp.asarray(x), jnp.asarray(w))
    site = jsites.get_site("moe_dense")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(site.fwd(spec, *ops)),
                               **PINS)
    if strategy == "fused":
        (jgx, jgw), jnsq = site.fused_bwd["fused"](spec, ops, jnp.asarray(r))
    else:
        jgx, jgw = site.bwd(spec, ops, jnp.asarray(r))
        jnsq = jsites.site_nsq(spec, ops, jnp.asarray(r))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **PINS)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), **PINS)
    np.testing.assert_allclose(nsq.numpy(), np.asarray(jnsq), **PINS)
    assert nsq[1].item() == 0.0 and (nsq[[0, 2]] > 0).all()


def test_moe_dense_strategy_resolution_matches_jax():
    """``auto`` and every rule resolve as in the JAX package, at the
    reduced shape and at deepseek's and grok's expert shapes (B 8 x T 512:
    C 60 and 160); at deepseek's C 60 ``auto`` picks ``gram``."""
    cases = [(((2, 4, 10, 64), (4, 64, 64)), (2, 4, 10, 64)),
             (((8, 64, 60, 2048), (64, 2048, 1408)), (8, 64, 60, 1408)),
             (((8, 64, 60, 1408), (64, 1408, 2048)), (8, 64, 60, 2048)),
             (((8, 8, 160, 6144), (8, 6144, 32768)), (8, 8, 160, 32768))]
    for ops, gy in cases:
        for strat in ("auto", "materialize", "gram", "fused"):
            assert tsites.resolve_strategy("moe_dense", strat, ops, gy) == \
                jsites.resolve_strategy("moe_dense", strat, ops, gy)
    assert tsites.resolve_strategy("moe_dense", "auto", *cases[1]) == "gram"


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def test_grouping_matches_jax():
    """The layer grouping as the JAX package's at every depth: deepseek
    from 18 layers on (28 in full) a dense prelude layer and scanned MoE
    reps, below that one block of all its layers.  (The losses with their
    aux term are held in the dpsgd_r step below.)"""
    for name in (DS, GROK):
        for n in (2, 3, 6, 17, 18, 28, 64):
            t, j = (dataclasses.replace(a, n_layers=n)
                    for a in (TARCHS[name], JARCHS[name]))
            assert group_layers(t) == j_group_layers(j), (name, n)
    assert group_layers(TARCHS[DS]) == (1, 1, 27)


def _dp(algo, **kw):
    return dict(algo=algo, clip_norm=0.5, noise_multiplier=0.0,
                norm_strategy="fused", **kw)


def _clipped_sum(tm, toks, **dp):
    fn = talgo.make_clipped_sum_fn(tm.loss_fn, DPConfig(use_kernels=True, **dp))
    grads, (losses, nsq) = fn(tm.params, {"tokens": torch.from_numpy(toks)})
    return grads, losses, nsq


def _seeded(name, remat):
    """The port's model of ``name`` from its own seeded init."""
    tm = Model(_archs(name)[1], dtype=torch.float32, device="cpu", remat=remat)
    tm.requires_grad_(True)
    return tm


@functools.lru_cache(maxsize=None)
def _dpsgd_r_seeded(name):
    return _clipped_sum(_seeded(name, "none"), _toks(), **_dp("dpsgd_r"))


def test_dpsgd_r_fused_step_matches_jax():
    """One dpsgd_r step through the fused route and the kernels' plain
    versions: norms², losses and the clipped sums against the JAX
    package's (its plain fused route), some examples clipped."""
    jm, params = _weights(DS)
    fn = jax.jit(jalgo.make_clipped_sum_fn(jm.loss_fn, JDPConfig(**_dp("dpsgd_r"))))
    jgrads, (jlosses, jnsq) = fn(jax.tree.map(jnp.asarray, params),
                                 {"tokens": jnp.asarray(_toks())})
    grads, losses, nsq = _clipped_sum(_port(DS), _toks(), **_dp("dpsgd_r"))
    np.testing.assert_allclose(nsq.numpy(), np.asarray(jnsq), **PINS)
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jlosses), **PINS)
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PINS)
    assert (nsq > 0.25).any()               # clipped at C 0.5


@pytest.mark.parametrize("name,algo,remat,kw", [
    (DS, "dpsgd_r", "block", {}), (DS, "dpsgd_r", "sites", {}),
    (DS, "dpsgd_r1f", "none", {}), (DS, "dpsgd_r1f", "sites", {}),
    (DS, "dpsgd", "block", dict(microbatch=2)), (GROK, "dpsgd_r", "sites", {}),
    (GROK, "dpsgd_r1f", "block", {})])
def test_algorithms_and_remat_match_dpsgd_r(name, algo, remat, kw):
    """Every algorithm and remat policy gives dpsgd_r's (remat none) norms²
    and clipped sums: routing is recomputed inside a checkpointed block
    and gives the same slots, and grok's aux total rides through its two
    blocks' checkpoints."""
    grads, losses, nsq = _clipped_sum(_seeded(name, remat), _toks(), **_dp(algo, **kw))
    wgrads, wlosses, wnsq = _dpsgd_r_seeded(name)
    torch.testing.assert_close(nsq, wnsq, **PINS)
    torch.testing.assert_close(losses, wlosses, **PINS)
    for g, w in zip(grads, wgrads):
        torch.testing.assert_close(g, w, **PINS)


@pytest.mark.parametrize("route", ["fused", "materialize", "gram"])
def test_padded_rows_route_and_give_exact_zeros(route):
    """A Poisson-padded row still routes (its tokens fill expert slots),
    but its loss cotangent is zero: every route's norm² there is exactly
    0.0, and the kept rows' norms² are those of the compacted batch."""
    tm = _port(DS)
    toks = _toks(7, 5)
    keep = np.array([True, False, True, True, False])
    dp = DPConfig(use_kernels=True, **dict(_dp("dpsgd_r"), norm_strategy=route))
    fn = talgo.make_clipped_sum_fn(tm.loss_fn, dp)
    _, (_, nsq) = fn(tm.params, {"tokens": torch.from_numpy(toks),
                                 "mask": torch.from_numpy(keep)})
    _, (_, want) = fn(tm.params, {"tokens": torch.from_numpy(toks[keep])})
    assert (nsq[~torch.from_numpy(keep)] == 0.0).all()
    torch.testing.assert_close(nsq[torch.from_numpy(keep)], want, **PINS)


def test_prefill_and_decode_match_jax():
    """Right-padded prefill and two decode steps, logits at rtol/atol 1e-4
    (the JAX package's own transformer pin); grok's MoE FFN is held in
    ``test_moe_apply_matches_jax``."""
    jm, params = _weights(DS)
    jp = jax.tree.map(jnp.asarray, params)
    tm = _port(DS)
    toks = _toks(4, 3)[:, :T]
    lengths = np.array([16, 9, 3], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 24,
                        lengths=jnp.asarray(lengths))
    tl, tc = tm.prefill(torch.from_numpy(toks), 24, lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    pos = lengths.copy()
    for _ in range(2):
        nxt = np.argmax(np.asarray(jl)[:, 0, :256], -1).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(nxt)[:, None]},
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tc, torch.from_numpy(nxt)[:, None],
                                torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        pos = pos + 1


def _stream(n=5, seed=1):
    """Prompts of 4-14 tokens: every prefill wave pads to 16, so each
    engine compiles (JAX) one prefill shape."""
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, 256, int(rng.integers(4, 15))).astype(np.int32),
             int(rng.integers(1, 7))) for uid in range(n)]


def _run(engine, req_cls, stream):
    for uid, prompt, max_new in stream:
        engine.submit(req_cls(uid=uid, prompt=prompt, max_new=max_new))
    return engine.run(max_steps=500)


def test_engine_greedy_matches_jax():
    """The port's contiguous and paged engines against the JAX engine: a
    prompt's routing depends on its wave's padded length, so each is held
    to an engine that waves and pads alike (the JAX contiguous engine; its
    paged engine gives the contiguous one's streams, as the port's does)."""
    jm, params = _weights(DS)
    tm = _port(DS)
    stream = _stream()
    kw = dict(max_batch=2, cache_len=32, block_size=8)
    want = _run(JEngine(jm, jax.tree.map(jnp.asarray, params), **kw), JRequest, stream)
    for paged in (False, True):
        eng = Engine(tm, paged=paged, num_blocks=8 if paged else None, **kw)
        got = _run(eng, Request, stream)
        assert got == want, paged
        assert eng.stats["prefill_waves"] >= 2
    assert all(len(got[uid]) == m for uid, _, m in stream)


def test_host_loop_greedy_matches_jax():
    """The host loop prefills one prompt at a time at its own length:
    held to the JAX host loop (prompts of one length, one JAX compile)."""
    jm, params = _weights(DS)
    rng = np.random.default_rng(5)
    stream = [(uid, rng.integers(0, 256, 6).astype(np.int32), 2 + uid)
              for uid in range(3)]
    want = _run(JHostLoopEngine(jm, jax.tree.map(jnp.asarray, params), max_batch=2,
                                cache_len=32), JRequest, stream)
    got = _run(HostLoopEngine(_port(DS), max_batch=2, cache_len=32), Request, stream)
    assert got == want


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_read_by_both_packages(tmp_path, writer):
    """A ``sharded-v1`` checkpoint of the MoE TrainState (params and AdamW
    moments, filled with seeded values) written by one package, every leaf
    restored bit for bit by the other."""
    jm, params = _weights(DS)
    opt = j_make_optimizer(JOptimConfig(name="adamw", lr=1e-2))
    jp = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(6)
    ost = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape)
                                             .astype(a.dtype)), opt.init(jp))
    jstate = JTrainState(step=jnp.asarray(1, jnp.int32), params=jp, opt_state=ost)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tstate = TrainState(step=0, params=tparams, opt_state=make_optimizer(
        OptimConfig(name="adamw")).init(tree.leaves(tparams)))
    want = [np.asarray(a) for a in jax.tree.leaves(jstate)][1:]
    if writer == "jax":
        for t in C.flatten(tstate)[1:]:
            t.zero_()
        JCheckpointManager(str(tmp_path), use_async=False).save(jstate, 1)
        got = [t.numpy() for t in C.flatten(CheckpointManager(str(tmp_path))
                                            .restore(tstate))[1:]]
    else:
        with torch.no_grad():
            for t, a in zip(C.flatten(tstate)[1:], want):
                t.copy_(torch.from_numpy(a))
        tstate.step = 1
        CheckpointManager(str(tmp_path), use_async=False).save(tstate, 1)
        like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jstate)
        got = [np.asarray(a) for a in
               jax.tree.leaves(JCheckpointManager(str(tmp_path)).restore(like))[1:]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_expert_init_std_and_full_configs():
    """Expert stacks draw N(0, 1/d_in) as the reference does (fan_in the
    spec's second-to-last dim, not the product over E); the full configs'
    specs hold the reference's parameter counts (16.37B and 314B) without
    allocating them."""
    arch = dataclasses.replace(treduced(TARCHS[DS]), d_model=128, n_layers=2)
    m = Model(arch, dtype=torch.float32, device="cpu", seed=0).params
    moe = m["blocks"][1]["moe"]            # one block: a dense, an MoE layer
    assert moe["we1"].shape == (1, 4, 128, 64)
    for k, fan_in in (("we1", 128), ("we3", 128), ("we2", 64), ("router", 128),
                      ("ws1", 128)):
        assert abs(moe[k].std().item() * fan_in ** 0.5 - 1.0) < 0.1, k
    jm, params = _weights(DS)
    jstd = np.asarray(params["blocks"][1]["moe"]["we1"]).std() * np.sqrt(64)
    assert abs(jstd - 1.0) < 0.1
    for name in (DS, GROK):
        pre, _, reps = group_layers(TARCHS[name])
        spec = model_spec(TARCHS[name])
        n = sum(int(np.prod(p.shape)) for p in tree.leaves(spec["prelude"]))
        n += reps * sum(int(np.prod(p.shape)) for p in tree.leaves(spec["blocks"]))
        n += sum(int(np.prod(spec[k].shape)) for k in ("embed", "final_norm", "head"))
        assert n == JARCHS[name].param_count(), name


def test_launchers_take_moe_overrides(tmp_path, capsys):
    """``--arch deepseek-moe-16b --reduced`` trains and serves on the CPU,
    with ``--set moe.*`` reaching the arch."""
    ttrain.main(["--arch", DS, "--reduced", "--steps", "1", "--batch", "2",
                 "--seq", "16", "--device", "cpu", "--dtype", "float32",
                 "--set", "dp.norm_strategy=fused", "--set", "dp.use_kernels=true",
                 "--set", "moe.capacity_factor=0.5", "--set", "log_every=1",
                 "--set", f"ckpt_dir={tmp_path}"])
    out = capsys.readouterr().out
    # the planner's trace goes through the routing and the dispatch scatter
    assert "[trainer] step" in out and "capacity_factor=0.5" in out
    assert "[train] memory: estimated peak" in out
    tserve.main(["--arch", GROK, "--reduced", "--device", "cpu", "--dtype",
                 "float32", "--requests", "2", "--max-new", "2", "--set",
                 "moe.top_k=1"])
    out = capsys.readouterr().out
    assert "[serve] 2 requests" in out and "top_k=1" in out
