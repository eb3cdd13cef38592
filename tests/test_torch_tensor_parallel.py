"""Tensor parallelism over the ``model`` axis against the JAX package's
single-device run, in two gloo worlds on the CPU run side by side
(``torch.distributed.run --standalone``; the child script is ``CHILD``
below): 2 ranks on a (1, 2) ``data,model`` mesh and 4 ranks on (2, 2),
each of their checks a case of ``test_tensor_parallel_world``.

The worlds train reduced phi3-mini with ``vocab=250`` (its padded 256
columns carry 6 padding columns, all in the last model slice), in float32
at σ = 0, from JAX-initialised weights cut into each rank's slices; the
ranks of one ``data`` coordinate take the same examples:

* the losses and per-example norms² under every norm route, with and
  without kernels, against the reference's;
* the clipped sums of ``sgd``, ``dpsgd_r`` and ``dpsgd_r1f`` at ``remat``
  ``none`` and ``block`` and at ``grad_accum`` 2, the slices gathered
  whole, and the metrics, against the reference on the whole batch;
* on (1, 2), a ``dpsgd_r`` step of reduced musicgen-medium (embedding
  inputs) against the reference's;
* the norm scales' gradients bit for bit alike on every model rank;
* seeded init's slices equal the whole init's bit for bit (row blocks
  too);
* on the (2, 2) world: two AdamW steps' slices and optimizer state
  (ZeRO-1 over ``data``) and ``update_norm`` against a world of one; at
  σ > 0 a model slice's noise alike on the data ranks and not on the model
  ranks, with std σC/denom; the 4-rank checkpoint restored whole by the
  port and by ``repro.train.checkpoint``, and a world of one's restored
  into the slices;
* prefill and ``SERVE_STEPS`` greedy decode steps on the slices against
  the reference's single-device ``prefill`` and ``decode_step``: the whole
  logits at the pins, the tokens equal, each rank's cache its KV heads;
* the collectives a rank meters for one train step, the prefill and one
  decode step against the dry-run's traced cell of that configuration
  (``launch/dryrun.py``).

``test_tensor_parallel_refusal``'s cases: what the port does not run on a
``model`` axis raises ``NotImplementedError`` naming ROADMAP.

Pins: rtol 1e-5 / atol 2e-6 (the reference's) where a sum over the ranks
reorders; exact equality where the arithmetic is the same.
"""
import concurrent.futures
import dataclasses
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
from repro.configs.base import OptimConfig as JOptimConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import make_noisy_grad_fn as j_make_noisy_grad_fn
from repro.core.algo import make_clipped_sum_fn
from repro.models.transformer import build_model
from repro.optim import make_optimizer as j_make_optimizer
from repro.train import checkpoint as jcheckpoint
from repro.train.state import TrainState as JTrainState
from repro.train.trainer import make_opt_init
from repro_torch import tree
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.launch.train import unported_mesh_reason
from repro_torch.models.transformer import Model
from repro_torch.train import Trainer

ROOT = os.path.join(os.path.dirname(__file__), "..")
PINS = dict(rtol=1e-5, atol=2e-6)
B, T, VOCAB = 8, 16, 250
PHI3, MUSICGEN = "phi3-mini-3.8b", "musicgen-medium"
ALGOS = ("sgd", "dpsgd_r", "dpsgd_r1f")
RUNS = ("none", "block", "accum2")
ROUTES = ("fused", "materialize", "gram", "auto")
METRICS = ("loss", "grad_norm_mean", "grad_norm_max", "clipped_frac")
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
SIGMA = 1.0
# serving on the slices: prompts of SERVE_T tokens into a cache of SERVE_S,
# then SERVE_STEPS greedy decode steps
SERVE_B, SERVE_T, SERVE_S, SERVE_STEPS = 4, 8, 12, 4


def _tarch():
    return dataclasses.replace(treduced(TARCHS[PHI3]), vocab=VOCAB)


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

    out, shape = sys.argv[1], tuple(int(x) for x in sys.argv[2].split(","))
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60))
    rank = dist.get_rank()
    inp = np.load(out + "/../inputs.npz")
    C, res, mine = float(inp["C"]), {}, {}
    mesh = make_mesh(shape, ("data", "model"))
    bax = ("data",) if shape[0] > 1 else None
    arch = dataclasses.replace(reduced(ARCHS["phi3-mini-3.8b"]), vocab=int(inp["vocab"]))
    batch = {"tokens": inp["toks"]}
    def build(remat="none", sharded=True, arch=arch, prefix="p"):
        """The JAX weights, whole, or cut into this rank's slices."""
        m = Model(arch, dtype=torch.float32, device="cpu", remat=remat)
        with torch.no_grad():
            for i, p in enumerate(tree.leaves(m.params)):
                p.copy_(torch.from_numpy(inp[f"{prefix}{i}"]))
        if sharded:
            m = Model(arch, tree.tree_map(torch.Tensor.detach, m.params),
                      dtype=torch.float32, device="cpu", remat=remat, mesh=mesh)
        return m.requires_grad_(True)

    def local(batch):
        index, count = runtime.batch_shard()
        rows = len(next(iter(batch.values()))) // count
        return {k: torch.from_numpy(v[index * rows:(index + 1) * rows])
                for k, v in batch.items()}

    def whole(x, p):
        sh = runtime.model_shard_of(p)
        return x if sh is None else runtime.all_gather(x, runtime.model_group(), sh.dim)

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

    with runtime.layout(mesh, bax):
        group = runtime.batch_group()
        m = build()
        # the cut slices are the whole params' slices, and the fingerprint
        # of the slices is agreed by every rank
        res["gathered_exact"] = all(
            np.array_equal(whole(p.detach(), p).numpy(), inp[f"p{i}"])
            for i, p in enumerate(tree.leaves(m.params)))
        if shape[0] == 1:
            # an embedding-input decoder (no embedding table; gelu FFN)
            mg = reduced(ARCHS["musicgen-medium"])
            grads("mg", build(arch=mg, prefix="mgp"),
                  dp(clip_norm=float(inp["mgC"]), norm_strategy="fused", use_kernels=True),
                  batch={"embeds": inp["mgembeds"], "labels": inp["mglabels"]})
        res["fp"] = runtime.verify_init_consistency(m.params)
        mine["held"] = sum(p.numel() for p in m.parameters())
        # losses and norms² under every route, with and without kernels
        data = local(batch)
        for route in ("fused", "materialize", "gram", "auto"):
            for kern in (False, True):
                nsq, losses = algo.norm_pass(m.loss_fn, m.params, data,
                                             dp(norm_strategy=route, use_kernels=kern))
                tag = f"nsq/{route}/{int(kern)}"
                res[tag] = runtime.all_gather(nsq, group).numpy()
                res[f"losses/{route}/{int(kern)}"] = runtime.all_gather(losses, group).numpy()
        for run in ("none", "block", "accum2"):
            m.remat = "none" if run == "none" else "block"
            for name in ("sgd", "dpsgd_r", "dpsgd_r1f"):
                g, _ = grads(f"{name}/{run}", m, dp(name, norm_strategy="fused",
                                                    use_kernels=True),
                             accum=2 if run == "accum2" else 1)
        # the norm scales' gradients of the last step, every rank's
        mine["scales"] = [x.numpy() for x, p in zip(g, tree.leaves(m.params))
                          if runtime.model_shard_of(p) is None]

        if shape[0] > 1:
            # σ > 0: a slice's noise is keyed by its model index
            m.remat = "none"
            g0, _ = grads("quiet", m, dp())
            g1, _ = grads("noisy", m, dp(noise_multiplier=float(inp["sigma"])))
            sl = [runtime.model_shard_of(p) is not None for p in tree.leaves(m.params)]
            mine["noise"] = torch.cat([(a - b).reshape(-1) for a, b, s in
                                       zip(g1, g0, sl) if s]).numpy()
            mine["shared"] = torch.cat([(a - b).reshape(-1) for a, b, s in
                                        zip(g1, g0, sl) if not s]).numpy()

            # two AdamW steps, ZeRO-1 over data, against a world of one
            tshape = ShapeConfig("t", inp["toks"].shape[1] - 1, 8, "train")
            cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                              remat="block", steps=2, zero1=True,
                              ckpt_dir=out + "/ck2",
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
                sh = runtime.model_shard_of(p)
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
                sh = runtime.model_shard_of(p)
                want.append(x if sh is None else sh.of(x))
            for k in sorted(state1.opt_state):
                for i, (x, p) in enumerate(zip(state1.opt_state[k],
                                               tree.leaves(state.params))):
                    sh = runtime.model_shard_of(p)
                    want.append(back.step_fn._slice(x if sh is None else sh.of(x),
                                                    back.step_fn.shards[i]))
            mine["restored_slices_exact"] = got.step == 2 and all(
                torch.equal(a, b) for a, b in zip(
                    tree.leaves(got.params) + tree.leaves(got.opt_state), want))
            if rank == 0:
                for i, p1 in enumerate(tree.leaves(state1.params)):
                    res[f"w1/p{i}"] = p1.detach().numpy()

        # prefill and the contiguous decode on the slices: a data
        # coordinate's ranks take its rows; logits whole, greedy over the
        # vocabulary; the collectives of the prefill and the first decode
        # step metered
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import traced_mesh
        from repro_torch.train.trainer import TrainStep
        sm, V, S = build(), int(inp["vocab"]), int(inp["cache_len"])
        prompts = local({"p": inp["ptoks"]})["p"]
        with runtime.metered() as rec:
            logits, cache = sm.prefill(prompts, S)
        mine["prefill_records"] = dryrun.collective_summary(rec)
        steps, toks = [logits], [logits[:, -1, :V].argmax(-1)]
        for i in range(int(inp["steps"])):
            pos = torch.full((len(prompts),), prompts.shape[1] + i)
            with runtime.metered() as rec:
                logits, cache = sm.decode_step(cache, toks[-1][:, None], pos)
            if i == 0:
                mine["decode_records"] = dryrun.collective_summary(rec)
            steps.append(logits)
            toks.append(logits[:, -1, :V].argmax(-1))
        res["serve/logits"] = runtime.all_gather(torch.stack(steps), group, 1).numpy()
        res["serve/tokens"] = runtime.all_gather(torch.stack(toks), group, 1).numpy()
        mine["cache_shapes"] = [tuple(t.shape) for t in tree.leaves(cache)]
        # one train step of the dry-run's train cell, metered
        tm = build(remat="block")
        tshape = ShapeConfig("t", inp["toks"].shape[1] - 1, len(inp["toks"]), "train")
        cfg = dryrun.train_config(tm.arch, tshape, traced_mesh(shape, ("data", "model")),
                                  dtype="float32")
        step = TrainStep(tm, cfg, mesh=mesh)
        st = step.init_state(tm.params, "cpu")
        with runtime.metered() as rec:
            step(st, local(batch), torch.Generator().manual_seed(0))
        mine["train_records"] = dryrun.collective_summary(rec)

    # seeded init: the slices of the whole init, row blocks too
    exact = True
    for draw in (transformer.DRAW_ELEMS, 100):
        transformer.DRAW_ELEMS = draw
        sl = Model(arch, dtype=torch.float32, device="cpu", seed=3, mesh=mesh)
        wh = Model(arch, dtype=torch.float32, device="cpu", seed=3)
        for p, w in zip(tree.leaves(sl.params), tree.leaves(wh.params)):
            sh = runtime.model_shard_of(p)
            exact &= torch.equal(p, w if sh is None else sh.of(w))
    mine["init_exact"] = bool(exact)

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank == 0:
        for r, d in enumerate(every):
            for k, v in d.items():
                res[f"rank{r}/{k}"] = np.array(v, dtype=object) if k == "scales" else v
        np.savez(out + "/results.npz", **res)
    dist.barrier()
    dist.destroy_process_group()
''')


def _jarch():
    return dataclasses.replace(jreduced(JARCHS[PHI3]), vocab=VOCAB)


def _jax_model(arch=None):
    return build_model(arch or _jarch(), param_dtype="float32",
                       compute_dtype="float32", remat="none")


def _jax_grads(jm, params, dp, batch):
    fn = jax.jit(j_make_noisy_grad_fn(jm.loss_fn, dp))
    return fn(params, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))


def _jax_norms(jm, params, batch):
    """The reference's per-example norms² and losses on the whole batch."""
    _, (losses, nsq) = jax.jit(make_clipped_sum_fn(jm.loss_fn, JDPConfig(
        norm_strategy="materialize")))(params, jax.tree.map(jnp.asarray, batch))
    return np.asarray(nsq), np.asarray(losses)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start both worlds, compute the JAX references while they run, and
    return ({mesh: results}, references)."""
    out = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(11)
    jm = _jax_model()
    params = jm.init(jax.random.PRNGKey(0))
    toks = rng.integers(0, VOCAB, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks}
    nsq, losses = _jax_norms(jm, params, batch)
    C = float(np.sqrt(np.median(nsq)))
    ptoks = rng.integers(0, VOCAB, (SERVE_B, SERVE_T)).astype(np.int32)
    inp = dict(toks=toks, C=C, sigma=SIGMA, vocab=VOCAB, ptoks=ptoks,
               cache_len=SERVE_S, steps=SERVE_STEPS)
    for i, p in enumerate(jax.tree.leaves(params)):
        inp[f"p{i}"] = np.asarray(p)
    # musicgen-medium reduced: embeddings in, no embedding table
    mg = _jax_model(jreduced(JARCHS[MUSICGEN]))
    mg_params = mg.init(jax.random.PRNGKey(1))
    mg_batch = {"embeds": rng.standard_normal((B, T, mg.arch.d_model)).astype(np.float32),
                "labels": rng.integers(0, mg.arch.vocab, (B, T)).astype(np.int32)}
    inp.update(mgC=float(np.sqrt(np.median(_jax_norms(mg, mg_params, mg_batch)[0]))),
               mgembeds=mg_batch["embeds"], mglabels=mg_batch["labels"])
    for i, p in enumerate(jax.tree.leaves(mg_params)):
        inp[f"mgp{i}"] = np.asarray(p)
    np.savez(out / "inputs.npz", **inp)
    (out / "child.py").write_text(CHILD)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    procs = {}
    for name, shape in MESHES.items():
        (out / name).mkdir()
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(shape[0] * shape[1]), str(out / "child.py"),
             str(out / name), ",".join(map(str, shape))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            jobs = {name: pool.submit(_jax_grads, jm, params, JDPConfig(
                enabled=name != "sgd", algo=name, clip_norm=C, noise_multiplier=0.0),
                batch) for name in ALGOS}
            jobs["mg"] = pool.submit(_jax_grads, mg, mg_params, JDPConfig(
                clip_norm=inp["mgC"], noise_multiplier=0.0), mg_batch)
            jobs["serve"] = pool.submit(_jax_serve, jm, params, ptoks)
            cells = _dryrun_cells(out)
            want = {k: job.result() for k, job in jobs.items()}
        logs = {k: p.communicate(timeout=150)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for k, p in procs.items():
        assert p.returncode == 0, logs[k][-4000:]
    res = {k: dict(np.load(out / k / "results.npz", allow_pickle=True))
           for k in MESHES}
    return dict(res=res, want=want, nsq=nsq, losses=losses, out=out,
                params=params, C=C, cells=cells)


def _jax_serve(jm, params, ptoks):
    """The reference's single-device prefill and ``SERVE_STEPS`` greedy
    ``decode_step``s: the logits of each (steps + 1, B, 1, Vpad) and the
    greedy tokens (steps + 1, B)."""
    logits, cache = jax.jit(jm.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(ptoks)}, SERVE_S)
    decode = jax.jit(jm.decode_step)
    steps, toks = [logits], [jnp.argmax(logits[:, -1, :VOCAB], -1)]
    for i in range(SERVE_STEPS):
        pos = jnp.full((SERVE_B,), SERVE_T + i, jnp.int32)
        logits, cache = decode(params, cache, {"tokens": toks[-1][:, None]}, pos)
        steps.append(logits)
        toks.append(jnp.argmax(logits[:, -1, :VOCAB], -1))
    return np.asarray(jnp.stack(steps)), np.asarray(jnp.stack(toks))


def _dryrun_cells(out):
    """The dry-run's train, prefill and decode cells of the worlds'
    configurations on traced meshes of their shapes (float32, the CPU)."""
    from repro_torch.launch import dryrun
    shapes = {"train": ShapeConfig("t", T, B, "train"),
              "prefill": ShapeConfig("p", SERVE_T, SERVE_B, "prefill"),
              "decode": ShapeConfig("d", SERVE_S, SERVE_B, "decode")}
    cells = {}
    for mesh, shape in MESHES.items():
        for kind, sh in shapes.items():
            rec = dryrun.run_cell(_tarch(), sh, mesh, str(out / "dryrun"),
                                  mesh_shape=",".join(map(str, shape)),
                                  mesh_axes="data,model", device="cpu", dtype="float32")
            assert rec["ok"], rec
            cells[mesh, kind] = rec
    return cells


def _check_norms(mesh, route):
    """Losses and norms² of every rank's examples, gathered, against the
    reference's, with and without kernels."""
    def check(worlds):
        res = worlds["res"][mesh]
        for kern in (0, 1):
            np.testing.assert_allclose(res[f"nsq/{route}/{kern}"], worlds["nsq"],
                                       **PINS, err_msg=f"{route} kernels={kern}")
            np.testing.assert_allclose(res[f"losses/{route}/{kern}"],
                                       worlds["losses"], **PINS)
    return check


def _check_algo(mesh, name):
    """The slices' clipped sums, gathered whole, and the metrics at remat
    none and block and at grad_accum 2; some examples clip."""
    def check(worlds):
        res = worlds["res"][mesh]
        jg, jmet = worlds["want"][name]
        for run in RUNS:
            tag = f"{name}/{run}"
            for i, w in enumerate(jax.tree.leaves(jg)):
                np.testing.assert_allclose(res[f"{tag}/g{i}"], np.asarray(w), **PINS,
                                           err_msg=f"{tag} leaf {i}")
            for k in METRICS:
                if k in jmet:
                    np.testing.assert_allclose(res[f"{tag}/{k}"], float(jmet[k]),
                                               rtol=1e-5, err_msg=f"{tag} {k}")
        if name == "dpsgd_r":
            assert 0 < res["dpsgd_r/none/clipped_frac"] < 1
    return check


def _check_embed_inputs(worlds):
    """Reduced musicgen-medium (embeddings in, a gelu FFN, the head the one
    vocabulary-parallel leaf) on (1, 2): a ``dpsgd_r`` step's clipped sums
    and metrics against the reference's; some examples clip."""
    res = worlds["res"]["1x2"]
    jg, jmet = worlds["want"]["mg"]
    for i, w in enumerate(jax.tree.leaves(jg)):
        np.testing.assert_allclose(res[f"mg/g{i}"], np.asarray(w), **PINS,
                                   err_msg=f"leaf {i}")
    for k in METRICS:
        np.testing.assert_allclose(res[f"mg/{k}"], float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    assert 0 < res["mg/clipped_frac"] < 1


def _check_scales(mesh):
    """The norm scales' gradients are alike, bit for bit, on every rank."""
    def check(worlds):
        res = worlds["res"][mesh]
        ranks = [k for k in res if k.endswith("/scales")]
        assert len(ranks) == MESHES[mesh][0] * MESHES[mesh][1]
        first = res[ranks[0]]
        assert len(first) == 3          # the stacked ln1 and ln2, final_norm
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
    """Each rank holds 1/m of every sliced leaf and the whole of the rest."""
    def check(worlds):
        from repro_torch.dist import sharding
        model = Model(_tarch(), dtype=torch.float32, device="cpu")
        spec = sharding.model_shards(_mesh(*MESHES[mesh]), model, index=0)
        leaves = tree.leaves(model.abstract_params())
        whole = sum(p.numel() for p in leaves)
        sliced = sum(p.numel() for p, path in zip(leaves, _paths(model))
                     if _entry(spec, path) is not None)
        assert sliced > 0.9 * whole
        width = MESHES[mesh][1]
        n = MESHES[mesh][0] * width
        for r in range(n):
            assert worlds["res"][mesh][f"rank{r}/held"] == whole - sliced + sliced // width
    return check


def _paths(model):
    from repro_torch.dist import sharding
    return [path for path, _, _ in sharding._paired(model.abstract_params(),
                                                    model.logical_axes())]


def _entry(t, path):
    for k in path:
        t = t[k]
    return t


def _check_adamw(worlds):
    """Two AdamW steps on (2, 2), ZeRO-1 over data: every rank's param
    slices and its (data-cut) optimizer state within the pins of a world
    of one's; ``update_norm`` alike.  At lr = eps = 1e-3: AdamW's first
    update is lr·g/(|g| + eps), whose change under a change Δg of an
    element is at most lr·|Δg|/eps, so at the default eps 1e-8 an element
    whose gradient is near 1e-8 turns the row-parallel sums' reordering
    (~1e-9 here) into a change of ~1e-1·lr, which the second step's
    gradients then spread past the pins (2e-5 at lr 1e-2); lr = eps bounds
    the change by |Δg| itself."""
    res = worlds["res"]["2x2"]
    for r in range(4):
        excess, where = res[f"rank{r}/adamw_excess"]
        assert float(excess) <= 0.0, (r, where, excess)
    for step in range(2):
        np.testing.assert_allclose(res[f"adamw/update_norm{step}"],
                                   res[f"w1/update_norm{step}"], rtol=1e-5)


def _check_noise(worlds):
    """(data, model) of rank r is (r // 2, r % 2): a slice's noise is one
    on the data ranks, another on the model ranks, of std σC/denom; the
    norm scales' noise is one on every rank."""
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


def _restore_port(worlds):
    tm = Model(_tarch(), dtype=torch.float32, device="cpu", remat="none")
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      ckpt_dir=str(worlds["out"] / "2x2" / "ck2"),
                      optim=OptimConfig(name="adamw"))
    return Trainer(tm, cfg, ShapeConfig("t", T, B, "train")).restore_or_init()


def _check_ckpt_port(worlds):
    """The 4-rank checkpoint (model slices, their state cut over data too)
    restored whole in one process by the port: a world of one's params."""
    state = _restore_port(worlds)
    assert state.step == 2
    for i, p in enumerate(tree.leaves(state.params)):
        np.testing.assert_allclose(p.detach().numpy(),
                                   worlds["res"]["2x2"][f"w1/p{i}"], **PINS,
                                   err_msg=f"leaf {i}")


def _check_ckpt_jax(worlds):
    """The same checkpoint restored by ``repro.train.checkpoint``: bit for
    bit the port's restore."""
    jcfg = JTrainConfig(optim=JOptimConfig(name="adamw"))
    params = worlds["params"]
    jstate = jcheckpoint.CheckpointManager(str(worlds["out"] / "2x2" / "ck2")).restore(
        JTrainState.create(params, make_opt_init(jcfg, j_make_optimizer(
            jcfg.optim))(params)))
    state = _restore_port(worlds)
    assert int(jstate.step) == 2
    for a, b in zip(tree.leaves(state.params) + tree.leaves(state.opt_state),
                    jax.tree.leaves(jstate.params) + jax.tree.leaves(jstate.opt_state)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def _check_ckpt_into_slices(worlds):
    """A world of one's checkpoint restored into every rank's model slices
    and their ZeRO-1-cut optimizer state, bit for bit."""
    res = worlds["res"]["2x2"]
    assert all(res[f"rank{r}/restored_slices_exact"] for r in range(4))


def _check_fingerprint(worlds):
    """Both worlds' slices record the same structure and no bytes of the
    sliced leaves, so their fingerprints agree."""
    assert int(worlds["res"]["1x2"]["fp"]) == int(worlds["res"]["2x2"]["fp"])


def _check_serve(mesh):
    """Prefill and ``SERVE_STEPS`` greedy decode steps on the slices
    against the reference's single-device run: the whole logits of every
    step at the pins, the greedy tokens equal, and each rank's cache
    holding its KV heads alone."""
    def check(worlds):
        res = worlds["res"][mesh]
        logits, toks = worlds["want"]["serve"]
        np.testing.assert_allclose(res["serve/logits"], logits, **PINS)
        np.testing.assert_array_equal(res["serve/tokens"], toks)
        width = MESHES[mesh][1]
        kv = _tarch().n_kv_heads
        for r in range(MESHES[mesh][0] * width):
            shapes = res[f"rank{r}/cache_shapes"]
            assert len(shapes) == 2 and all(
                tuple(s)[-2:] == (kv // width, _tarch().hd) for s in shapes), shapes
    return check


def _check_dryrun_records(mesh):
    """The collectives every rank meters for one train step (the dry-run's
    train config), the prefill and one decode step equal the records of
    rank 0's traced program in the dry-run cell of that configuration."""
    def check(worlds):
        res = worlds["res"][mesh]
        def norm(records):
            return [(str(k), int(b), int(g), int(n)) for k, b, g, n in records]
        for kind in ("train", "prefill", "decode"):
            want = norm(worlds["cells"][mesh, kind]["collective_records"])
            assert want, kind
            for r in range(MESHES[mesh][0] * MESHES[mesh][1]):
                got = norm(res[f"rank{r}/{kind}_records"])
                assert got == want, (kind, r, got, want)
    return check


CHECKS = {
    **{f"{mesh}-norms-{route}": _check_norms(mesh, route)
       for mesh in MESHES for route in ROUTES},
    **{f"{mesh}-grads-{name}": _check_algo(mesh, name)
       for mesh in MESHES for name in ALGOS},
    **{f"{mesh}-scales-alike": _check_scales(mesh) for mesh in MESHES},
    **{f"{mesh}-init-exact": _check_init(mesh) for mesh in MESHES},
    **{f"{mesh}-param-bytes": _check_param_bytes(mesh) for mesh in MESHES},
    "2x2-adamw-zero1": _check_adamw,
    "2x2-noise-by-model-index": _check_noise,
    "2x2-ckpt-to-whole-port": _check_ckpt_port,
    "2x2-ckpt-to-whole-jax": _check_ckpt_jax,
    "2x2-ckpt-whole-to-slices": _check_ckpt_into_slices,
    "fingerprint-rule": _check_fingerprint,
    "1x2-grads-embed-inputs": _check_embed_inputs,
    **{f"{mesh}-serve-prefill-decode": _check_serve(mesh) for mesh in MESHES},
    **{f"{mesh}-dryrun-records": _check_dryrun_records(mesh) for mesh in MESHES},
}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_tensor_parallel_world(worlds, check):
    CHECKS[check](worlds)


# ---------------------------------------------------------------------------
# refusals: on a model axis above 1, each raises NotImplementedError naming
# ROADMAP
# ---------------------------------------------------------------------------

def _mesh(data=1, model=2):
    return types.SimpleNamespace(axis_names=("data", "model"), shape=(data, model),
                                 get_local_rank=lambda axis: 0)


def _model(arch, **kw):
    return Model(arch, dtype=torch.float32, device="cpu", mesh=_mesh(), **kw)


def _reduced(name, **kw):
    return dataclasses.replace(treduced(TARCHS[name]), **kw)


def _engine(model):
    from repro_torch.serve import Engine
    return Engine(model)


REFUSALS = {
    "moe": (lambda: _model(_reduced("grok-1-314b")), "MoE layers"),
    "mamba": (lambda: _model(_reduced("mamba2-1.3b")), "Mamba layers"),
    "qk-norm": (lambda: _model(_reduced("chameleon-34b")), "qk_norm"),
    "fsdp": (lambda: _model(_reduced(PHI3, use_fsdp=True)), "FSDP with tensor"),
    "kv-heads": (lambda: _model(_reduced("chatglm3-6b")), "replicating KV heads"),
    "pp-stages": (lambda: _model(_tarch(), pp_stages=2), "pp_stages=2"),
    "dpsgd": (lambda: _dpsgd_step(), "dp.algo='dpsgd'"),
    "adam8bit": (lambda: Trainer(_model(_tarch()), TrainConfig(
        param_dtype="float32", compute_dtype="float32",
        optim=OptimConfig(name="adam8bit")), ShapeConfig("t", T, B, "train")
        ).init_state(), "adam8bit"),
    "serving": (lambda: _engine(_model(_tarch())), "tensor-parallel model slices"),
    "host-loop": (lambda: _host_loop(_model(_tarch())), "tensor-parallel model slices"),
    "decode": (lambda: (lambda m: m.decode_step_paged(
        m.init_paged_cache(2, 4), torch.zeros((1, 1), dtype=torch.long),
        torch.zeros((1,), dtype=torch.long), torch.zeros((1, 1), dtype=torch.long)))(
        _model(_tarch())), "paged decode of tensor-parallel model slices"),
    "paged-attention": (lambda: _paged_layer(_model(_tarch())),
                        "paged decode of tensor-parallel model slices"),
}


def _host_loop(model):
    from repro_torch.serve import HostLoopEngine
    return HostLoopEngine(model)


def _paged_layer(model):
    """``layers.attn_decode_paged`` on a rank's slices of one layer."""
    from repro_torch.models import layers as L
    p = {k: v[0] for k, v in model.params["blocks"][0]["attn"].items()}
    pool = torch.zeros((2, 4, model.arch.n_kv_heads, model.arch.hd))
    L.attn_decode_paged(p, torch.zeros((1, 1, model.arch.d_model)), (pool, pool.clone()),
                        torch.zeros((1, 1), dtype=torch.long),
                        torch.zeros((1,), dtype=torch.long), model.arch)


def _dpsgd_step():
    from repro_torch.core import algo
    m = _model(_tarch()).requires_grad_(True)
    fn = algo.make_noisy_grad_fn(m.loss_fn, DPConfig(algo="dpsgd"))
    fn(m.params, {"tokens": torch.zeros((2, 5), dtype=torch.long)}, torch.Generator())


LAUNCHER_REFUSALS = {
    "launcher-image": (dict(arch=TARCHS["vit-cifar10"], sizes={"model": 2}),
                       "image family"),
    "launcher-autotune": (dict(arch=_tarch(), sizes={"model": 2}, autotune=True),
                          "--autotune"),
    "launcher-dpsgd": (dict(arch=_tarch(), sizes={"model": 2}, cfg=TrainConfig(
        dp=DPConfig(algo="dpsgd"))), "dp.algo='dpsgd'"),
    "launcher-compress": (dict(arch=_tarch(), sizes={"model": 2, "data": 2},
                               cfg=TrainConfig(compress_pod_grads=True)),
                          "compress_pod_grads"),
    "launcher-stage": (dict(arch=_tarch(), sizes={"stage": 2, "model": 2},
                            cfg=TrainConfig(pp_stages=2)), "'model' axis beside it"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS) + sorted(LAUNCHER_REFUSALS))
def test_tensor_parallel_refusal(case):
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
    assert unported_mesh_reason(_tarch(), {"model": 2, "data": 2},
                                TrainConfig(zero1=True)) == ""
