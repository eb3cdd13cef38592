"""Pipeline stages across processes (a ``stage`` axis above 1) against the
JAX package's single-device run of the pipelined model, in two gloo worlds
on the CPU run side by side (one process a rank, joined through
``env://``; the child script is ``CHILD`` below): 2 ranks on a (1, 2)
``data,stage`` mesh and 4 ranks on (2, 2) with ZeRO-1, each of their
checks a case of ``test_stage_world``.

The worlds train reduced phi3-mini (2 layers, ``pp_stages`` 2, 2
microbatches: each stage rank holds one layer) in float32 at σ = 0, from
weights drawn with numpy from a seed in the reference's layout and cut
into each rank's blocks; the stage ranks of one ``data`` coordinate take
the same examples:

* the losses and per-example norms² under the fused route with kernels
  (their plain versions on the CPU) and the gram and materialize routes,
  against the reference's;
* the clipped sums of ``sgd``, ``dpsgd_r`` and ``dpsgd_r1f`` at ``remat``
  ``none`` and ``block`` and at ``grad_accum`` 2, the stage slices
  gathered whole, and the metrics, against the reference on the whole
  batch; a replicated leaf's sum alike, bit for bit, on every stage rank;
* a Poisson-masked ``dpsgd_r`` step, ``pp_stages`` 4 on the 2-wide axis
  (4 layers) and, on (1, 2), a ``dpsgd_r`` step of reduced deepseek-moe
  with every layer MoE, so that the aux total crosses the stages, against
  the reference's single-device pipelined run of the same, and beside it
  against the port's own one-process pipelined run;
* seeded init's slices equal the whole init's bit for bit; each rank holds
  its blocks and the whole of the rest; both worlds' fingerprints agree;
* on (1, 2), the sends, broadcasts and all-reduces one rank's ``TrainStep``
  records, against ``launch/costs.py`` ``traced_rank_collectives``;
* on (2, 2): two AdamW steps (ZeRO-1 over ``data``) and ``update_norm``
  against a world of one; at σ > 0 a block slice's noise alike on the data
  ranks and not on the stage ranks; the stage-cut checkpoint restored
  whole in one process, and a world of one's restored into the slices.

``test_stage_refusal``'s cases: what the port does not run on a ``stage``
axis raises ``NotImplementedError`` naming ROADMAP.

Pins: rtol 1e-5 / atol 2e-6 (the reference's); exact equality where the
arithmetic is the same.
"""
import concurrent.futures
import dataclasses
import functools
import multiprocessing
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import DPConfig as JDPConfig
from repro.core.algo import make_clipped_sum_fn
from repro.models import build_model_for as j_build_model_for
from repro_torch import tree
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import DPConfig, OptimConfig, ShapeConfig, TrainConfig
from repro_torch.launch.train import unported_mesh_reason
from repro_torch.models.transformer import Model
from repro_torch.train import Trainer

ROOT = os.path.join(os.path.dirname(__file__), "..")
PINS = dict(rtol=1e-5, atol=2e-6)
B, T = 8, 16
PHI3, DEEPSEEK = "phi3-mini-3.8b", "deepseek-moe-16b"
ALGOS = ("sgd", "dpsgd_r", "dpsgd_r1f")
RUNS = ("none", "block", "accum2")
ROUTES = (("fused", 1), ("gram", 0), ("materialize", 0))
METRICS = ("loss", "grad_norm_mean", "grad_norm_max", "clipped_frac")
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
SIGMA = 1.0


CHILD = textwrap.dedent('''
    import dataclasses, datetime, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import DPConfig, OptimConfig, ShapeConfig, TrainConfig
    from repro_torch.core import algo
    from repro_torch.dist import runtime
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.models.transformer import Model
    from repro_torch.train import Trainer
    from repro_torch.train.trainer import TrainStep

    out, shape = sys.argv[1], tuple(int(x) for x in sys.argv[2].split(","))
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60))
    rank = dist.get_rank()
    inp = np.load(out + "/../inputs.npz")
    C, res, mine = float(inp["C"]), {}, {}
    mesh = make_mesh(shape, ("data", "stage"))
    bax = ("data",) if shape[0] > 1 else None
    arch = reduced(ARCHS["phi3-mini-3.8b"])
    moe = reduced(ARCHS["deepseek-moe-16b"])
    moe = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe, moe_skip_first=0))
    batch = {"tokens": inp["toks"]}

    def build(remat="none", sharded=True, arch=arch, prefix="p", S=2):
        """The given weights (seeded when there are none), whole, or cut
        into this rank's blocks."""
        m = Model(arch, dtype=torch.float32, device="cpu", remat=remat, seed=5,
                  pp_stages=S, pp_microbatches=2)
        if prefix:
            with torch.no_grad():
                for i, p in enumerate(tree.leaves(m.params)):
                    p.copy_(torch.from_numpy(inp[f"{prefix}{i}"]))
        if sharded:
            m = Model(arch, tree.tree_map(torch.Tensor.detach, m.params),
                      dtype=torch.float32, device="cpu", remat=remat, pp_stages=S,
                      pp_microbatches=2, mesh=mesh)
        return m.requires_grad_(True)

    def local(batch):
        index, count = runtime.batch_shard()
        rows = len(next(iter(batch.values()))) // count
        return {k: torch.from_numpy(v[index * rows:(index + 1) * rows])
                for k, v in batch.items()}

    def whole(x, p):
        sh = runtime.stage_shard_of(p)
        return x if sh is None else runtime.all_gather(x, runtime.stage_group(), sh.dim)

    def dp(name="dpsgd_r", **kw):
        return DPConfig(**dict(dict(enabled=name != "sgd", algo=name,
                                    clip_norm=C, noise_multiplier=0.0), **kw))

    def grads(tag, m, cfg, accum=1, batch=batch):
        fn = algo.make_noisy_grad_fn(m.loss_fn, cfg, grad_accum=accum)
        g, met = fn(m.params, local(batch), torch.Generator().manual_seed(0))
        for i, (x, p) in enumerate(zip(g, tree.leaves(m.params))):
            res[f"{tag}/g{i}"] = whole(x, p).numpy()
        for k, v in met.items():
            res[f"{tag}/{k}"] = float(v)
        return g, met

    def one_process(tag, m, cfg, batch):
        """The port's one-process pipelined run of the same step."""
        with runtime.suspended():
            g, met = algo.make_noisy_grad_fn(m.loss_fn, cfg)(
                m.params, {k: torch.from_numpy(v) for k, v in batch.items()},
                torch.Generator().manual_seed(0))
        for i, x in enumerate(g):
            res[f"{tag}/g{i}"] = x.numpy()
        for k, v in met.items():
            res[f"{tag}/{k}"] = float(v)

    with runtime.layout(mesh, bax):
        group = runtime.batch_group()
        m = build()
        res["gathered_exact"] = all(
            np.array_equal(whole(p.detach(), p).numpy(), inp[f"p{i}"])
            for i, p in enumerate(tree.leaves(m.params)))
        res["fp"] = runtime.verify_init_consistency(m.params)
        mine["held"] = sum(p.numel() for p in m.parameters())
        # losses and norms² under the routes
        data = local(batch)
        for route, kern in (("fused", 1), ("gram", 0), ("materialize", 0)):
            nsq, losses = algo.norm_pass(m.loss_fn, m.params, data,
                                         dp(norm_strategy=route, use_kernels=bool(kern)))
            res[f"nsq/{route}"] = runtime.all_gather(nsq, group).numpy()
            res[f"losses/{route}"] = runtime.all_gather(losses, group).numpy()
        for run in ("none", "block", "accum2"):
            m.remat = "none" if run == "none" else "block"
            for name in ("sgd", "dpsgd_r", "dpsgd_r1f"):
                g, _ = grads(f"{name}/{run}", m, dp(name, norm_strategy="fused",
                                                    use_kernels=True),
                             accum=2 if run == "accum2" else 1)
        # the whole leaves' sums of the last step, every rank's
        mine["whole"] = [x.numpy() for x, p in zip(g, tree.leaves(m.params))
                         if runtime.stage_shard_of(p) is None]
        m.remat = "none"
        # a Poisson mask, and 4 stages on the 2-wide axis, against the
        # port's one-process pipelined run
        masked = dict(batch, mask=inp["mask"])
        grads("mask", m, dp(), batch=masked)
        if rank == 0:
            one_process("mask1", build(sharded=False), dp(), masked)
        arch4 = dataclasses.replace(arch, n_layers=4)
        dp4 = dp(clip_norm=float(inp["C4"]), norm_strategy="fused")
        grads("s4", build(arch=arch4, prefix="q", S=4), dp4)
        if rank == 0:
            one_process("s41", build(arch=arch4, prefix="q", S=4, sharded=False), dp4,
                        batch)
        if shape[0] == 1:
            # every layer MoE: the aux total rides with its microbatch
            mdp = dp(clip_norm=float(inp["mC"]), norm_strategy="fused", use_kernels=True)
            grads("moe", build(arch=moe, prefix="mp"), mdp)
            if rank == 0:
                one_process("moe1", build(arch=moe, prefix="mp", sharded=False), mdp,
                            batch)
            # one rank's recorded collectives against the traced ones
            cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                              pp_stages=2, dp=dp(norm_strategy="fused"))
            step = TrainStep(m, cfg)
            state = step.init_state(m.params, m.device)
            with runtime.metered() as records:
                step(state, local(batch), torch.Generator().manual_seed(0))
            mine["records"] = [(r["kind"], r["bytes"], r["group"]) for r in records]

        if shape[0] > 1:
            # σ > 0: a block slice's noise is keyed by its stage index
            g0, _ = grads("quiet", m, dp())
            g1, _ = grads("noisy", m, dp(noise_multiplier=float(inp["sigma"])))
            sl = [runtime.stage_shard_of(p) is not None for p in tree.leaves(m.params)]
            mine["noise"] = torch.cat([(a - b).reshape(-1) for a, b, s in
                                       zip(g1, g0, sl) if s]).numpy()
            mine["shared"] = torch.cat([(a - b).reshape(-1) for a, b, s in
                                        zip(g1, g0, sl) if not s]).numpy()

            # two AdamW steps, ZeRO-1 over data, against a world of one
            tshape = ShapeConfig("t", inp["toks"].shape[1] - 1, 8, "train")
            cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                              remat="block", steps=2, zero1=True, pp_stages=2,
                              pp_microbatches=2, ckpt_dir=out + "/ck2",
                              dp=DPConfig(clip_norm=C, noise_multiplier=0.0,
                                          norm_strategy="fused", use_kernels=True),
                              optim=OptimConfig(name="adamw", lr=1e-3, eps=1e-3,
                                                schedule="constant"))
            tr = Trainer(build(), cfg, tshape, mesh=mesh)
            state = tr.init_state()
            with runtime.suspended():
                tr1 = Trainer(build(sharded=False),
                              dataclasses.replace(cfg, ckpt_dir=out + "/ck1"), tshape)
                state1 = tr1.init_state()
            for step in range(2):
                met = tr.train_step(state, tr.make_batch(step))
                res[f"adamw/update_norm{step}"] = float(met["update_norm"])
                with runtime.suspended():
                    met1 = tr1.train_step(state1, tr1.make_batch(step))
                res[f"w1/update_norm{step}"] = float(met1["update_norm"])
            worst = (0.0, "")
            for i, (p, p1) in enumerate(zip(tree.leaves(state.params),
                                            tree.leaves(state1.params))):
                sh = runtime.stage_shard_of(p)
                cut = (lambda x: x) if sh is None else sh.of
                z1 = tr.step_fn.shards[i]
                pairs = [("p", p, cut(p1))] + [
                    (k, state.opt_state[k][i],
                     tr.step_fn._slice(cut(state1.opt_state[k][i]), z1))
                    for k in ("m", "v", "master")]
                for k, a, b in pairs:
                    a, b = a.detach().numpy(), b.detach().numpy()
                    ex = float(np.max(np.abs(a - b) - (2e-6 + 1e-5 * np.abs(b))))
                    worst = max(worst, (ex, f"{k}{i} {float(np.abs(b).max())}"))
            mine["adamw_excess"] = worst
            tr.ckpt.save(state, 2, shards=tr.step_fn.ckpt_shards(state))
            # a whole checkpoint (one process's layout) into the slices
            with runtime.suspended():
                tr1.ckpt.save(state1, 2)
            back = Trainer(build(), dataclasses.replace(cfg, ckpt_dir=out + "/ck1"),
                           tshape, mesh=mesh)
            got = back.restore_or_init()
            want = []
            for i, (x, p) in enumerate(zip(tree.leaves(state1.params),
                                           tree.leaves(state.params))):
                sh = runtime.stage_shard_of(p)
                want.append(x if sh is None else sh.of(x))
            for k in sorted(state1.opt_state):
                for i, (x, p) in enumerate(zip(state1.opt_state[k],
                                               tree.leaves(state.params))):
                    sh = runtime.stage_shard_of(p)
                    want.append(back.step_fn._slice(x if sh is None else sh.of(x),
                                                    back.step_fn.shards[i]))
            mine["restored_slices_exact"] = got.step == 2 and all(
                torch.equal(a, b) for a, b in zip(
                    tree.leaves(got.params) + tree.leaves(got.opt_state), want))
            if rank == 0:
                for i, p1 in enumerate(tree.leaves(state1.params)):
                    res[f"w1/p{i}"] = p1.detach().numpy()

    # seeded init: the slices of the whole init, row blocks too
    exact = True
    for draw in (transformer.DRAW_ELEMS, 100):
        transformer.DRAW_ELEMS = draw
        sl = Model(arch, dtype=torch.float32, device="cpu", seed=3, pp_stages=2, mesh=mesh)
        wh = Model(arch, dtype=torch.float32, device="cpu", seed=3)
        for p, w in zip(tree.leaves(sl.params), tree.leaves(wh.params)):
            sh = runtime.stage_shard_of(p)
            exact &= torch.equal(p, w if sh is None else sh.of(w))
    mine["init_exact"] = bool(exact)

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank == 0:
        for r, d in enumerate(every):
            for k, v in d.items():
                res[f"rank{r}/{k}"] = np.array(v, dtype=object) if k in ("whole", "records") else v
        np.savez(out + "/results.npz", **res)
    dist.barrier()
    dist.destroy_process_group()
''')


def _jax_model(arch, stages=2):
    return j_build_model_for(arch, param_dtype="float32", compute_dtype="float32",
                             remat="none", pp_stages=stages, pp_microbatches=2)


def _numpy_params(jm, seed):
    """Weights in the reference's layout drawn with numpy: a vector (a norm
    scale) 1 + N(0, 0.1²), a matrix or stack N(0, 1/fan_in), fan_in its
    second-to-last dim."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        shape = leaf.shape
        if len(shape) == 1:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    return jax.tree.map(draw, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))


def _jax_steps(jm, params, name, C, *batches):
    """The reference's clipped sums on each whole batch, with the
    per-example losses and norms² beside them (one compile for batches of
    one structure): its noisy gradients at σ = 0 are the sums over the
    examples (B; ``sgd``: the mean), and its metrics those of
    ``make_noisy_grad_fn`` on them, taken over the examples a Poisson
    ``mask`` keeps."""
    fn = jax.jit(make_clipped_sum_fn(jm.loss_fn, JDPConfig(
        enabled=name != "sgd", algo=name, clip_norm=C)))
    return [_reference(fn(params, jax.tree.map(jnp.asarray, b)), name, C, b)
            for b in batches]


def _reference(out, name, C, batch):
    summed, (losses, nsq) = out
    losses, n = np.asarray(losses), np.sqrt(np.maximum(np.asarray(nsq), 0.0))
    keep = np.asarray(batch.get("mask", np.ones(B)), np.float64)
    met = {"loss": (losses * keep).sum() / keep.sum()}
    if name != "sgd":
        met.update(grad_norm_mean=(n * keep).sum() / keep.sum(),
                   grad_norm_max=(n * keep).max(),
                   clipped_frac=((n > C) * keep).sum() / keep.sum(),
                   realized_batch=keep.sum())
    return [np.asarray(g) / B for g in jax.tree.leaves(summed)], met, losses, n * n


@functools.lru_cache(maxsize=None)
def _jax_cases():
    """The reference models and weights: reduced phi3 at ``pp_stages`` 2
    (``p``, seed 0), the all-MoE deepseek cut at 2 (``mp``, seed 1) and
    phi3's 4-layer cut at 4 (``q``, seed 2), each {name: (model, params)}."""
    phi3 = jreduced(JARCHS[PHI3])
    jmoe = jreduced(JARCHS[DEEPSEEK])
    models = {"p": _jax_model(phi3),
              "mp": _jax_model(dataclasses.replace(
                  jmoe, moe=dataclasses.replace(jmoe.moe, moe_skip_first=0))),
              "q": _jax_model(dataclasses.replace(phi3, n_layers=4), stages=4)}
    return {k: (jm, _numpy_params(jm, seed))
            for seed, (k, jm) in enumerate(models.items())}


def _warm():
    _jax_cases()


def _jax_step_of(prefix, name, C, batch):
    """The reference's step on the ``prefix`` model of ``_jax_cases``: what
    a spawned process runs, so that its tracing runs beside this one's."""
    return _jax_steps(*_jax_cases()[prefix], name, C, batch)[0]


def _tmoe():
    arch = treduced(TARCHS[DEEPSEEK])
    return dataclasses.replace(arch, moe=dataclasses.replace(arch.moe, moe_skip_first=0))


def _clip_norm(arch, params, batch, stages=2):
    """A clip norm some examples exceed: the median per-example norm of
    the port's one-process run of ``arch`` on ``params``."""
    from repro_torch import interop
    from repro_torch.core import algo
    m = Model(arch, interop.params_from_numpy(params, "cpu"), dtype=torch.float32,
              device="cpu", pp_stages=stages, pp_microbatches=2)
    nsq, _ = algo.norm_pass(m.loss_fn, m.params, {"tokens": torch.from_numpy(
        batch["tokens"])}, DPConfig())
    return float(np.sqrt(np.median(nsq.numpy())))


def _world(out, name, shape, env):
    """The ranks of one world, one process each, joined through ``env://``
    on a free port of this host."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    n = shape[0] * shape[1]
    return [subprocess.Popen(
        [sys.executable, str(out / "child.py"), str(out / name),
         ",".join(map(str, shape))],
        env={**env, "RANK": str(r), "WORLD_SIZE": str(n), "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start both worlds, compute the JAX references while they run, and
    return ({mesh: results}, references)."""
    out = tmp_path_factory.mktemp("stage")
    # the MoE reference traces in a process of its own, started first: its
    # imports take as long as the inputs here
    spawned = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    spawned.submit(_warm)
    rng = np.random.default_rng(13)
    cases = _jax_cases()
    (jm, params), (_, qparams), (_, mparams) = cases["p"], cases["q"], cases["mp"]
    batch = {"tokens": rng.integers(0, jm.arch.vocab, (B, T + 1)).astype(np.int32)}
    mask = np.arange(B) % 3 != 1
    C = _clip_norm(treduced(TARCHS[PHI3]), params, batch)
    C4 = _clip_norm(dataclasses.replace(treduced(TARCHS[PHI3]), n_layers=4), qparams,
                    batch, stages=4)
    mC = _clip_norm(_tmoe(), mparams, batch)
    inp = dict(toks=batch["tokens"], C=C, C4=C4, mC=mC, sigma=SIGMA, mask=mask)
    for prefix, tree_ in (("p", params), ("q", qparams), ("mp", mparams)):
        for i, p in enumerate(jax.tree.leaves(tree_)):
            inp[f"{prefix}{i}"] = p
    np.savez(out / "inputs.npz", **inp)
    (out / "child.py").write_text(CHILD)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    procs = {}
    for name, shape in MESHES.items():
        (out / name).mkdir()
        procs[name] = _world(out, name, shape, env)
    try:
        jobs = {"moe": spawned.submit(_jax_step_of, "mp", "dpsgd_r", mC, batch)}
        # XLA compiles without the GIL, so these build side by side; the
        # whole batch (a mask of ones) and the Poisson mask share a compile
        ones = dict(batch, mask=np.ones(B, np.float32))
        with concurrent.futures.ThreadPoolExecutor(len(ALGOS) + 1) as pool:
            jobs.update({name: pool.submit(_jax_steps, jm, params, name, C, batch)
                         for name in ALGOS if name != "dpsgd_r"})
            jobs["dpsgd_r"] = pool.submit(_jax_steps, jm, params, "dpsgd_r", C, ones,
                                          dict(batch, mask=mask.astype(np.float32)))
            jobs["s4"] = pool.submit(_jax_steps, *cases["q"], "dpsgd_r", C4, batch)
            want = {k: job.result() for k, job in jobs.items()}
        want = dict(want, mask=want["dpsgd_r"][1], s4=want["s4"][0],
                    **{name: want[name][0] for name in ALGOS})
        logs = {k: [p.communicate(timeout=150)[0] for p in ranks]
                for k, ranks in procs.items()}
    finally:
        spawned.shutdown(cancel_futures=True)
        for ranks in procs.values():
            for p in ranks:
                p.kill()
    for k, ranks in procs.items():
        for p, log in zip(ranks, logs[k]):
            assert p.returncode == 0, log[-4000:]
    res = {k: dict(np.load(out / k / "results.npz", allow_pickle=True))
           for k in MESHES}
    return dict(res=res, want=want, nsq=want["dpsgd_r"][3],
                losses=want["dpsgd_r"][2], out=out, C=C)


def _check_norms(mesh, route):
    """Losses and norms² of every rank's examples, gathered, against the
    reference's."""
    def check(worlds):
        res = worlds["res"][mesh]
        np.testing.assert_allclose(res[f"nsq/{route}"], worlds["nsq"], **PINS)
        np.testing.assert_allclose(res[f"losses/{route}"], worlds["losses"], **PINS)
    return check


def _assert_grads(res, tag, jg, jmet, *_):
    assert f"{tag}/g{len(jg)}" not in res, tag
    for i, w in enumerate(jg):
        np.testing.assert_allclose(res[f"{tag}/g{i}"], w, **PINS,
                                   err_msg=f"{tag} leaf {i}")
    for k in METRICS + ("realized_batch",):
        if k in jmet:
            np.testing.assert_allclose(res[f"{tag}/{k}"], float(jmet[k]),
                                       rtol=1e-5, err_msg=f"{tag} {k}")


def _check_algo(mesh, name):
    """The stage slices' clipped sums, gathered whole, and the metrics at
    remat none and block and at grad_accum 2; some examples clip."""
    def check(worlds):
        res = worlds["res"][mesh]
        for run in RUNS:
            _assert_grads(res, f"{name}/{run}", *worlds["want"][name])
        if name == "dpsgd_r":
            assert 0 < res["dpsgd_r/none/clipped_frac"] < 1
    return check


def _check_one_process(mesh, tag):
    """A Poisson-masked step (``mask``), pp_stages 4 on the 2-wide axis
    (``s4``) and an all-MoE deepseek cut (``moe``, on (1, 2): the aux term
    crossed the stages in the losses; some examples clip) against the
    reference's single-device pipelined run of the same, and against the
    port's one-process pipelined run."""
    def check(worlds):
        res = worlds["res"][mesh]
        _assert_grads(res, tag, *worlds["want"][tag])
        leaves = [k for k in res if k.startswith(f"{tag}1/g")]
        assert leaves
        for k in leaves:
            np.testing.assert_allclose(res[k.replace(f"{tag}1/", f"{tag}/")],
                                       res[k], **PINS, err_msg=k)
        for k in METRICS + ("realized_batch",):
            np.testing.assert_allclose(res[f"{tag}/{k}"], res[f"{tag}1/{k}"],
                                       rtol=1e-5, err_msg=k)
        if tag == "mask":
            assert res["mask/realized_batch"] == int(np.sum(np.arange(B) % 3 != 1))
        if tag in ("moe", "s4"):
            assert 0 < res[f"{tag}/clipped_frac"] < 1
    return check


def _check_whole_alike(mesh):
    """The leaves every stage rank holds whole get the same clipped sum,
    bit for bit, on every rank (their owner's, broadcast)."""
    def check(worlds):
        res = worlds["res"][mesh]
        ranks = [k for k in res if k.endswith("/whole")]
        assert len(ranks) == MESHES[mesh][0] * MESHES[mesh][1]
        first = res[ranks[0]]
        assert len(first) == 3          # embed, final_norm, head
        for k in ranks[1:]:
            for a, b in zip(first, res[k]):
                np.testing.assert_array_equal(a, b)
    return check


def _check_init(mesh):
    def check(worlds):
        res = worlds["res"][mesh]
        assert res["gathered_exact"]
        n = MESHES[mesh][0] * MESHES[mesh][1]
        assert all(res[f"rank{r}/init_exact"] for r in range(n))
    return check


def _check_param_bytes(mesh):
    """Each rank holds 1/W of every block leaf and the whole of the rest."""
    def check(worlds):
        model = Model(treduced(TARCHS[PHI3]), dtype=torch.float32, device="cpu")
        blocks = sum(p.numel() for p in tree.leaves(model.abstract_params()["blocks"]))
        total = sum(p.numel() for p in tree.leaves(model.abstract_params()))
        width = MESHES[mesh][1]
        for r in range(MESHES[mesh][0] * width):
            assert worlds["res"][mesh][f"rank{r}/held"] == total - blocks + blocks // width
    return check


def _check_trace(worlds):
    """Rank 0's recorded sends, broadcasts and all-reduces of a ``dpsgd_r``
    ``TrainStep`` on (1, 2) equal what ``traced_rank_collectives`` traces
    for the first stage rank."""
    from repro_torch.launch.costs import traced_rank_collectives
    from repro_torch.launch.memory import abstract_batch
    arch = treduced(TARCHS[PHI3])
    model = Model(arch, dtype=torch.float32, device="cpu", pp_stages=2,
                  pp_microbatches=2)
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32", pp_stages=2,
                      dp=DPConfig(clip_norm=1.0, noise_multiplier=0.0,
                                  norm_strategy="fused"))
    traced = traced_rank_collectives(model, cfg, abstract_batch(arch, B, T), 1,
                                     stages=2)
    got = [tuple(r) for r in worlds["res"]["1x2"]["rank0/records"]]
    assert got == [(r["kind"], r["bytes"], r["group"]) for r in traced]
    # two passes' forward activations of 2 microbatches, plus the accumulator
    # and the aux total of pass 1's, and pass 2's aux total
    kinds = {k for k, _, _ in got}
    assert kinds == {"send", "all-reduce", "broadcast"}, kinds
    sends = sum(b for k, b, _ in got if k == "send")
    assert sends == 2 * B * T * arch.d_model * 4 + B * 4 + 2 * B * 4
    # the last stage rank sends the cotangents of the same tensors back and
    # its (B,) float32 losses after each forward
    last = [tuple(r) for r in worlds["res"]["1x2"]["rank1/records"]]
    assert sum(b for k, b, _ in last if k == "send") == sends + 2 * B * 4
    assert sorted(r for r in last if r[0] != "send") == \
        sorted(r for r in got if r[0] != "send")


def _check_adamw(worlds):
    """Two AdamW steps on (2, 2), ZeRO-1 over data: every rank's block
    slices, its whole leaves and its (data-cut) optimizer state within the
    pins of a world of one's; ``update_norm`` alike."""
    res = worlds["res"]["2x2"]
    for r in range(4):
        excess, where = res[f"rank{r}/adamw_excess"]
        assert float(excess) <= 0.0, (r, where, excess)
    for step in range(2):
        np.testing.assert_allclose(res[f"adamw/update_norm{step}"],
                                   res[f"w1/update_norm{step}"], rtol=1e-5)


def _check_noise(worlds):
    """(data, stage) of rank r is (r // 2, r % 2): a block slice's noise is
    one on the data ranks, another on the stage ranks, of std σC/denom; the
    whole leaves' noise is one on every rank."""
    res = worlds["res"]["2x2"]
    noise = [res[f"rank{r}/noise"] for r in range(4)]
    assert noise[0].size >= 10_000
    np.testing.assert_array_equal(noise[0], noise[2])
    np.testing.assert_array_equal(noise[1], noise[3])
    assert not np.allclose(noise[0], noise[1])
    want = SIGMA * worlds["C"] / B
    for x in noise:
        assert abs(x.std() / want - 1) < 0.05, (x.std(), want)
    shared = [res[f"rank{r}/shared"] for r in range(4)]
    for x in shared[1:]:
        np.testing.assert_array_equal(x, shared[0])
    assert np.abs(shared[0]).max() > 0


def _check_ckpt_whole(worlds):
    """The 4-rank checkpoint (each stage rank's blocks a region of the
    ``layers`` dim, their state cut over data too) restored whole in one
    process: a world of one's params."""
    tm = Model(treduced(TARCHS[PHI3]), dtype=torch.float32, device="cpu", remat="none")
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      ckpt_dir=str(worlds["out"] / "2x2" / "ck2"),
                      optim=OptimConfig(name="adamw"))
    state = Trainer(tm, cfg, ShapeConfig("t", T, B, "train")).restore_or_init()
    assert state.step == 2
    for i, p in enumerate(tree.leaves(state.params)):
        np.testing.assert_allclose(p.detach().numpy(),
                                   worlds["res"]["2x2"][f"w1/p{i}"], **PINS,
                                   err_msg=f"leaf {i}")


def _check_ckpt_into_slices(worlds):
    """A world of one's checkpoint restored into every rank's blocks and
    their ZeRO-1-cut optimizer state, bit for bit."""
    res = worlds["res"]["2x2"]
    assert all(res[f"rank{r}/restored_slices_exact"] for r in range(4))


def _check_fingerprint(worlds):
    """Both worlds' slices record the same structure and no bytes of the
    sliced leaves, so their fingerprints agree."""
    assert int(worlds["res"]["1x2"]["fp"]) == int(worlds["res"]["2x2"]["fp"])


CHECKS = {
    **{f"{mesh}-norms-{route}": _check_norms(mesh, route)
       for mesh in MESHES for route, _ in ROUTES},
    **{f"{mesh}-grads-{name}": _check_algo(mesh, name)
       for mesh in MESHES for name in ALGOS},
    **{f"{mesh}-{tag}-one-process": _check_one_process(mesh, tag)
       for mesh in MESHES for tag in ("mask", "s4")},
    **{f"{mesh}-whole-leaves-alike": _check_whole_alike(mesh) for mesh in MESHES},
    **{f"{mesh}-init-exact": _check_init(mesh) for mesh in MESHES},
    **{f"{mesh}-param-bytes": _check_param_bytes(mesh) for mesh in MESHES},
    "1x2-moe-one-process": _check_one_process("1x2", "moe"),
    "1x2-traced-collectives": _check_trace,
    "2x2-adamw-zero1": _check_adamw,
    "2x2-noise-by-stage-index": _check_noise,
    "2x2-ckpt-to-whole": _check_ckpt_whole,
    "2x2-ckpt-whole-to-slices": _check_ckpt_into_slices,
    "fingerprint-rule": _check_fingerprint,
}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_stage_world(worlds, check):
    CHECKS[check](worlds)


# ---------------------------------------------------------------------------
# refusals: on a stage axis above 1, each raises NotImplementedError naming
# ROADMAP
# ---------------------------------------------------------------------------

def _mesh(stage=2, model=1):
    return types.SimpleNamespace(axis_names=("data", "stage", "model"),
                                 shape=(1, stage, model),
                                 get_local_rank=lambda axis: 0)


def _reduced(name, **kw):
    return dataclasses.replace(treduced(TARCHS[name]), **kw)


def _model(arch=None, **kw):
    kw.setdefault("pp_stages", 2)
    return Model(arch or _reduced(PHI3), dtype=torch.float32, device="cpu",
                 mesh=_mesh(), **kw)


def _dpsgd_step():
    from repro_torch.core import algo
    m = _model().requires_grad_(True)
    fn = algo.make_noisy_grad_fn(m.loss_fn, DPConfig(algo="dpsgd"))
    fn(m.params, {"tokens": torch.zeros((2, 5), dtype=torch.long)}, torch.Generator())


def _engine(model):
    from repro_torch.serve import Engine
    return Engine(model)


def _nccl_layout():
    """A stage layout whose group reads NCCL, as the launcher picks when
    every rank has a card."""
    from unittest import mock
    from repro_torch.dist import runtime
    mesh = types.SimpleNamespace(axis_names=("data", "stage"), shape=(1, 2),
                                 get_local_rank=lambda axis: 0,
                                 get_group=lambda axis: None)
    with mock.patch.object(runtime.dist, "is_initialized", return_value=True), \
            mock.patch.object(runtime.dist, "get_world_size", return_value=2), \
            mock.patch.object(runtime.dist, "get_backend", return_value="nccl"):
        with runtime.layout(mesh, None):
            pass


REFUSALS = {
    "pp-stages": (lambda: _model(pp_stages=1), "pp_stages=1"),
    "model-axis": (lambda: Model(_reduced(PHI3), dtype=torch.float32, device="cpu",
                                 pp_stages=2, mesh=_mesh(model=2)), "'model' axis"),
    "fsdp": (lambda: _model(_reduced(PHI3, use_fsdp=True)), "use_fsdp"),
    "mamba": (lambda: _model(_reduced("mamba2-1.3b")), "Mamba layers"),
    "dpsgd": (_dpsgd_step, "dp.algo='dpsgd'"),
    "adam8bit": (lambda: Trainer(_model(), TrainConfig(
        param_dtype="float32", compute_dtype="float32", pp_stages=2,
        optim=OptimConfig(name="adam8bit")), ShapeConfig("t", T, B, "train")
        ).init_state(), "adam8bit"),
    "serving": (lambda: _engine(_model()), "pipeline stage slices"),
    "nccl": (_nccl_layout, "a 'stage' axis on nccl"),
}

LAUNCHER_REFUSALS = {
    "launcher-divisor": (dict(arch=_reduced(PHI3), sizes={"stage": 2}), "pp_stages=1"),
    "launcher-image": (dict(arch=TARCHS["cnn-cifar10"], sizes={"stage": 2},
                            cfg=TrainConfig(pp_stages=2)), "image family"),
    "launcher-model-axis": (dict(arch=_reduced(PHI3), sizes={"stage": 2, "model": 2},
                                 cfg=TrainConfig(pp_stages=2)), "'model' axis"),
    "launcher-autotune": (dict(arch=_reduced(PHI3), sizes={"stage": 2}, autotune=True,
                               cfg=TrainConfig(pp_stages=2)), "runs in one process"),
    "launcher-dpsgd": (dict(arch=_reduced(PHI3), sizes={"stage": 2}, cfg=TrainConfig(
        pp_stages=2, dp=DPConfig(algo="dpsgd"))), "dp.algo='dpsgd'"),
    "launcher-compress": (dict(arch=_reduced(PHI3), sizes={"stage": 2, "data": 2},
                               cfg=TrainConfig(pp_stages=2, compress_pod_grads=True)),
                          "compress_pod_grads"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS) + sorted(LAUNCHER_REFUSALS))
def test_stage_refusal(case):
    if case in REFUSALS:
        fn, what = REFUSALS[case]
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1") as err:
            fn()
        assert what in str(err.value), str(err.value)
    else:
        kw, what = LAUNCHER_REFUSALS[case]
        reason = unported_mesh_reason(kw.pop("arch"), kw.pop("sizes"), **kw)
        assert what in reason and "ROADMAP queue 1" in reason, reason
    # what the port runs on the same axis: no reason
    assert unported_mesh_reason(TARCHS[PHI3], {"stage": 2, "data": 2},
                                TrainConfig(zero1=True, pp_stages=2)) == ""
    assert unported_mesh_reason(TARCHS[DEEPSEEK], {"stage": 2},
                                TrainConfig(pp_stages=4)) == ""
