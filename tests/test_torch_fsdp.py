"""FSDP for the ``use_fsdp`` archs against the JAX package's single-device
run, in one 2-rank gloo world on the CPU (``torch.distributed.run
--standalone``; the child script is ``CHILD`` below), each of its checks a
case of ``test_fsdp_world``.

The world trains reduced chameleon-34b (qk-norm, embedding inputs) with
``use_fsdp`` on, in float32 at σ = 0, from JAX-initialised weights cut into
each rank's slices; each rank holds half of the batch under
``dist.runtime.layout``:

* the gradients and metrics of ``sgd``, ``dpsgd``, ``dpsgd_r`` and
  ``dpsgd_r1f`` at ``remat`` ``none`` and ``block`` and at ``grad_accum``
  2, the slices gathered whole, against the reference on the whole batch;
  one ``dpsgd_r`` step of reduced grok-1 (MoE leaves) and of jamba's
  two-layer hybrid cut at reduced width (attention with its dense FFN,
  Mamba with the MoE FFN), from the slices of the port's seeded init,
  against the reference on the whole of that init and the whole batch;
* two AdamW steps' slices and optimizer state, and ``update_norm``,
  against a world of one on the whole batch;
* at σ > 0 the ranks' slice noise differs, with std σC/denom; the adaptive
  clip's next norm is one on both ranks;
* the gather's backward runs once a gathered leaf per pass 2 and never in
  pass 1, counted from the collective records;
* each rank holds half of every sharded leaf; seeded init draws the
  slices of the whole init bit for bit (row blocks too); the fingerprint
  follows the reference's rule for a leaf that is not fully addressable;
* the FSDP checkpoint restores whole in one process with the port and with
  ``repro.train.checkpoint``, and a whole one restores into the slices;
* a fake-tensor trace of one rank's step (``TracedGroup``,
  ``launch/costs.py`` ``traced_rank_collectives``) records the gathers and
  reductions of the count formula, and the autotuner prices such a plan
  by them;
* the planner's estimate of the sharded step is the whole one's; serving
  sharded params raises by name.

Pins: rtol 1e-5 / atol 2e-6 (the reference's) wherever a sum over the
ranks reorders; exact equality where the arithmetic is the same.
"""
import collections
import concurrent.futures
import dataclasses
import os
import subprocess
import sys
import textwrap
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import ATTN as JATTN, MAMBA as JMAMBA
from repro.configs.base import DPConfig as JDPConfig
from repro.configs.base import OptimConfig as JOptimConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import make_noisy_grad_fn as j_make_noisy_grad_fn
from repro.models.transformer import build_model
from repro.optim import make_optimizer as j_make_optimizer
from repro.train import checkpoint as jcheckpoint
from repro.train.state import TrainState as JTrainState
from repro.train.trainer import make_opt_init
from repro_torch import interop, tree
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import (ATTN, MAMBA, DPConfig, OptimConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.core import algo as talgo
from repro_torch.dist import sharding
from repro_torch.launch.costs import traced_rank_collectives
from repro_torch.launch.memory import abstract_batch
from repro_torch.models.transformer import Model, group_layers
from repro_torch.train import Trainer

ROOT = os.path.join(os.path.dirname(__file__), "..")
PINS = dict(rtol=1e-5, atol=2e-6)
B, T = 8, 16
ALGOS = ("sgd", "dpsgd", "dpsgd_r", "dpsgd_r1f")
RUNS = ("none", "block", "accum2")
METRICS = ("loss", "grad_norm_mean", "grad_norm_max", "clipped_frac")
SIGMA = 1.0
FAMILY_SEED = 5
CHAMELEON, GROK, JAMBA = "chameleon-34b", "grok-1-314b", "jamba-1.5-large-398b"


def _tarch(name):
    """The port's reduced config with ``use_fsdp`` on (the reduced config
    turns it off, as the reference's does); jamba's is its two-layer
    hybrid cut."""
    arch = treduced(TARCHS[name])
    if name == JAMBA:
        arch = dataclasses.replace(arch, n_layers=2, layer_pattern=(ATTN, MAMBA))
    return dataclasses.replace(arch, use_fsdp=True)


def _jarch(name):
    """The JAX package's reduced config; jamba's two-layer hybrid cut."""
    arch = jreduced(JARCHS[name])
    if name == JAMBA:
        arch = dataclasses.replace(arch, n_layers=2, layer_pattern=(JATTN, JMAMBA))
    return arch


CHILD = textwrap.dedent('''
    import collections, dataclasses, datetime, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import (ATTN, MAMBA, DPConfig, OptimConfig,
                                          ShapeConfig, TrainConfig)
    from repro_torch.core import algo
    from repro_torch.dist import runtime
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.models.transformer import Model, gathered
    from repro_torch.serve import Engine, HostLoopEngine
    from repro_torch.train import Trainer

    out, FAMILY_SEED = sys.argv[1], int(sys.argv[2])
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60))
    rank = dist.get_rank()
    inp = np.load(out + "/inputs.npz")
    C, res = float(inp["C"]), {}
    mesh = make_host_mesh()

    def fsdp_arch(name):
        arch = dataclasses.replace(reduced(ARCHS[name]), use_fsdp=True)
        if name.startswith("jamba"):
            arch = dataclasses.replace(arch, n_layers=2,
                                       layer_pattern=(ATTN, MAMBA))
        return arch

    def build(arch, prefix, remat="none", sharded=True):
        m = Model(arch, dtype=torch.float32, device="cpu", remat=remat,
                  mesh=mesh if sharded else None)
        with torch.no_grad():
            for i, p in enumerate(tree.leaves(m.params)):
                w = torch.from_numpy(inp[f"{prefix}p{i}"])
                sh = runtime.fsdp_shard_of(p)
                p.copy_(w if sh is None else sh.of(w))
        return m.requires_grad_(True)

    def local(batch):
        index, count = runtime.batch_shard()
        rows = len(next(iter(batch.values()))) // count
        return {k: torch.from_numpy(v[index * rows:(index + 1) * rows])
                for k, v in batch.items()}

    def whole(x, p):
        sh = runtime.fsdp_shard_of(p)
        return x if sh is None else runtime.all_gather(x, dist.group.WORLD, sh.dim)

    def grads(tag, m, dp, batch, accum=1):
        fn = algo.make_noisy_grad_fn(m.loss_fn, dp, grad_accum=accum)
        g, met = fn(m.params, local(batch), torch.Generator().manual_seed(0))
        for i, (x, p) in enumerate(zip(g, tree.leaves(m.params))):
            res[f"{tag}/g{i}"] = whole(x, p).numpy()
        for k, v in met.items():
            res[f"{tag}/{k}"] = float(v)
        return g, met

    def kinds(fn):
        with runtime.metered() as rec:
            fn()
        return collections.Counter(r["kind"] for r in rec)

    def dp(name="dpsgd_r", **kw):
        return DPConfig(**dict(dict(enabled=name != "sgd", algo=name,
                                    clip_norm=C, noise_multiplier=0.0), **kw))

    cham = fsdp_arch("chameleon-34b")
    cbatch = {"embeds": inp["embeds"], "labels": inp["labels"]}
    with runtime.layout(mesh, ("data",)):
        m = build(cham, "c")
        # the gathered params are the whole ones, bit for bit
        res["gathered_exact"] = all(
            np.array_equal(x.detach().numpy(), inp[f"cp{i}"]) for i, x in
            enumerate(tree.leaves(gathered(m.params, m.fsdp))))
        for run in ("none", "block", "accum2"):
            m.remat = "none" if run == "none" else "block"
            for name in ("sgd", "dpsgd", "dpsgd_r", "dpsgd_r1f"):
                grads(f"{name}/{run}", m, dp(name), cbatch,
                      accum=2 if run == "accum2" else 1)

        # the gather's backward (a reduce-scatter): never in pass 1, once a
        # gathered leaf in pass 2, at each remat policy
        data, _ = algo.split_mask(local(cbatch))
        for remat in ("none", "block"):
            m.remat = remat
            nsq = []
            n1 = kinds(lambda: nsq.append(algo.norm_pass(
                m.loss_fn, m.params, data, dp())[0]))
            w = algo.clipping.clip_factors(nsq[0], C)
            n2 = kinds(lambda: algo.reweighted_grads(m.loss_fn, m.params, data, w))
            n3 = kinds(lambda: grads("r1f-count", m, dp("dpsgd_r1f"), cbatch))
            for tag, n in (("pass1", n1), ("pass2", n2), ("r1f", n3)):
                for kind in ("reduce-scatter", "all-reduce"):
                    res[f"count/{remat}/{tag}/{kind}"] = n[kind]

        # the MoE and Mamba leaves: a dpsgd_r step of the seeded slices
        # (the parent holds it to the reference on the whole init)
        for name, prefix in (("grok-1-314b", "g"), ("jamba-1.5-large-398b", "j")):
            grads(prefix, Model(fsdp_arch(name), dtype=torch.float32, device="cpu",
                                remat="none", mesh=mesh, seed=FAMILY_SEED
                                ).requires_grad_(True),
                  dp(clip_norm=float(inp[f"{prefix}C"])),
                  {"tokens": inp[f"{prefix}toks"]})

        # serving sharded params is refused by name
        refused = []
        grok = Model(fsdp_arch("grok-1-314b"), dtype=torch.float32, device="cpu",
                     mesh=mesh)
        for fn in (lambda: Engine(grok), lambda: HostLoopEngine(grok),
                   lambda: m.decode_step(m.init_cache(1, 4), torch.zeros(
                       (1, 1, cham.d_model)), torch.zeros((1,), dtype=torch.long))):
            try:
                fn()
                refused.append("")
            except NotImplementedError as e:
                refused.append(str(e))
        res["serving_refused"] = np.array(refused)

        # σ > 0: each rank draws its slices' noise; the clip rider is shared
        m.remat = "none"
        noisy = dp(noise_multiplier=float(inp["sigma"]))
        g0, _ = grads("quiet", m, dp(), cbatch)
        g1, _ = grads("noisy", m, noisy, cbatch)
        sharded = [runtime.fsdp_shard_of(p) is not None for p in tree.leaves(m.params)]
        noise = torch.cat([(a - b).reshape(-1) for a, b, s in zip(g1, g0, sharded) if s])
        shared = torch.cat([(a - b).reshape(-1) for a, b, s in zip(g1, g0, sharded)
                            if not s])
        fn = algo.make_noisy_grad_fn(m.loss_fn, dataclasses.replace(
            noisy, adaptive_clip=True))
        _, met = fn(m.params, local(cbatch), torch.Generator().manual_seed(0),
                    clip_norm=torch.tensor(C))
        mine = dict(noise=noise.numpy(), shared=shared.numpy(),
                    clip_next=float(met["clip_norm_next"]))

        # two AdamW steps against a world of one on the whole batch
        shape = ShapeConfig("t", inp["embeds"].shape[1], 8, "train")
        cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                          remat="block", steps=2, zero1=True, ckpt_dir=out + "/ck2",
                          dp=DPConfig(clip_norm=C, noise_multiplier=0.0),
                          optim=OptimConfig(name="adamw", lr=1e-2,
                                            schedule="constant"))
        tr = Trainer(build(cham, "c"), cfg, shape, mesh=mesh)
        state = tr.init_state()

        with runtime.suspended():
            tr1 = Trainer(build(cham, "c", sharded=False),
                          dataclasses.replace(cfg, ckpt_dir=out + "/ck1"), shape)
            state1 = tr1.init_state()
        for step in range(2):
            met = tr.train_step(state, tr.make_batch(step))
            res[f"adamw/update_norm{step}"] = float(met["update_norm"])
            with runtime.suspended():
                met1 = tr1.train_step(state1, tr1.make_batch(step))
            res[f"w1/update_norm{step}"] = float(met1["update_norm"])
        params = tree.leaves(state.params)
        for i, (p, p1) in enumerate(zip(params, tree.leaves(state1.params))):
            sh = runtime.fsdp_shard_of(p)
            res[f"adamw/p{i}"] = p.detach().numpy()
            res[f"w1/p{i}"] = p1.detach().numpy()
            res[f"w1slice/p{i}"] = (p1 if sh is None else sh.of(p1)).detach().numpy()
            for key in ("m", "v"):
                res[f"adamw/{key}{i}"] = state.opt_state[key][i].numpy()
                ref = state1.opt_state[key][i]
                res[f"w1slice/{key}{i}"] = (ref if sh is None else sh.of(ref)).numpy()
        held = sum(p.numel() * p.element_size() for p in params)
        opt = sum(t.numel() * t.element_size() for t in tree.leaves(state.opt_state))
        mine.update(held=held, opt=opt)
        tr.ckpt.save(state, 2, shards=tr.step_fn.ckpt_shards(state))
        # a whole checkpoint (one process's layout) into the slices
        tr1.ckpt.save(state1, 2)
        back = Trainer(build(cham, "c"), dataclasses.replace(cfg, ckpt_dir=out + "/ck1"),
                       shape, mesh=mesh).restore_or_init()
        def cut(x, p):
            sh = runtime.fsdp_shard_of(p)
            return x if sh is None else sh.of(x)
        want = [cut(x, p) for x, p in zip(tree.leaves(state1.params), params)]
        want += [cut(x, p) for key in sorted(state1.opt_state)
                 for x, p in zip(state1.opt_state[key], params)]
        res["restored_slices_exact"] = back.step == 2 and all(
            torch.equal(a, b) for a, b in zip(
                tree.leaves(back.params) + tree.leaves(back.opt_state), want))
        mine["whole_opt"] = sum(t.numel() * t.element_size()
                                for t in tree.leaves(state1.opt_state))

        # the fingerprint of the slices, both ranks agreeing
        res["fp"] = runtime.verify_init_consistency(build(cham, "c").params)

    # seeded init: the slices of the whole init, row blocks too
    exact = True
    for draw in (transformer.DRAW_ELEMS, 100):
        transformer.DRAW_ELEMS = draw
        for name in ("chameleon-34b", "grok-1-314b"):
            a = fsdp_arch(name)
            sl = Model(a, dtype=torch.float32, device="cpu", seed=3, mesh=mesh)
            wh = Model(a, dtype=torch.float32, device="cpu", seed=3)
            for p, w in zip(tree.leaves(sl.params), tree.leaves(wh.params)):
                sh = runtime.fsdp_shard_of(p)
                exact &= torch.equal(p, w if sh is None else sh.of(w))
    mine["init_exact"] = bool(exact)

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank == 0:
        for r, d in enumerate(every):
            for k, v in d.items():
                res[f"rank{r}/{k}"] = v
        np.savez(out + "/results.npz", **res)
    dist.barrier()
    dist.destroy_process_group()
''')


def _jax_model(name=CHAMELEON):
    """The JAX package's reduced ``name`` (remat none: the same numbers, a
    quicker compile)."""
    return build_model(_jarch(name), param_dtype="float32",
                       compute_dtype="float32", remat="none")


def _median_clip(model, batch) -> float:
    """A clip norm that clips some examples: the median of the port's
    norms of ``batch`` on ``model``."""
    nsq, _ = talgo.norm_pass(model.loss_fn, model.params, {
        k: torch.from_numpy(v) for k, v in batch.items()}, DPConfig())
    return float(np.sqrt(np.median(nsq.numpy())))


def _jax_grads(jm, params, dp, batch):
    fn = jax.jit(j_make_noisy_grad_fn(jm.loss_fn, dp))
    return fn(params, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))


def _count_gathers(arch) -> dict:
    """The gathers of one forward of a sharded ``arch`` at ``data`` 2: one
    per layer of a stacked sharded leaf, one per other sharded leaf, and
    how many of them the repeated blocks make (what a ``block`` recompute
    gathers again); the whole leaves (the algorithm's all-reduce)."""
    model = Model(arch, dtype=torch.float32, device="cpu")
    reps = group_layers(arch)[2]
    out = dict(forward=0, blocks=0, whole=0)
    spec = sharding._paired(model.abstract_params(), model.logical_axes())
    for (path, _, _), sh in zip(spec, _entries(model)):
        if sh is None:
            out["whole"] += 1
        elif path[0] == "blocks":
            out["forward"] += reps
            out["blocks"] += reps
        else:
            out["forward"] += 1
    return out


def _entries(model):
    """The model's FSDP layout at ``data`` 2, rank 0's, in leaf order."""
    mesh = type("M", (), {"axis_names": ("data",), "shape": (2,)})()
    return _shard_entries(sharding.fsdp_shards(mesh, model, index=0))


def _shard_entries(shards):
    """A layout tree's entries (``Shard`` or None) in leaf order."""
    if isinstance(shards, dict):
        return [x for k in sorted(shards) for x in _shard_entries(shards[k])]
    if isinstance(shards, (list, tuple)):
        return [x for v in shards for x in _shard_entries(v)]
    return [shards]


def _reference_fingerprint(params, sharded) -> int:
    """The reference's ``init_fingerprint`` rule with the bytes of the
    leaves in ``sharded`` (their key strings) left out, as for a leaf that
    is not fully addressable."""
    total = 0
    for path, leaf in sorted(jax.tree_util.tree_flatten_with_path(params)[0],
                             key=lambda kv: str(kv[0])):
        key = jax.tree_util.keystr(path)
        c = zlib.crc32(f"{key}:{tuple(leaf.shape)}:{leaf.dtype}".encode())
        if key not in sharded:
            c = zlib.crc32(np.ascontiguousarray(np.asarray(leaf)).tobytes(), c)
        total = zlib.crc32(c.to_bytes(4, "little"), total)
    return total & 0xFFFFFFFF


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the world, compute the JAX references while it runs, and
    return (results, references)."""
    out = tmp_path_factory.mktemp("fsdp")
    rng = np.random.default_rng(7)
    jm = _jax_model()
    cparams = jm.init(jax.random.PRNGKey(0))
    d = jm.arch.d_model
    embeds = rng.standard_normal((B, T, d)).astype(np.float32)
    labels = rng.integers(0, jm.arch.vocab, (B, T)).astype(np.int32)
    cbatch = {"embeds": embeds, "labels": labels}
    tm = Model(_tarch(CHAMELEON), interop.params_from_numpy(
        jax.tree.map(np.asarray, cparams), "cpu"), dtype=torch.float32,
        device="cpu", remat="none")
    C = _median_clip(tm, cbatch)
    inp = dict(embeds=embeds, labels=labels, C=C, sigma=SIGMA)
    for i, p in enumerate(jax.tree.leaves(cparams)):
        inp[f"cp{i}"] = np.asarray(p)
    # grok and jamba: the port's seeded whole init, which the child's
    # slices are cut from bit for bit, in the reference's layout
    family = {}
    for prefix, name in (("g", GROK), ("j", JAMBA)):
        toks = {"tokens": rng.integers(0, _tarch(name).vocab,
                                       (B, T + 1)).astype(np.int32)}
        whole = Model(_tarch(name), dtype=torch.float32, device="cpu",
                      remat="none", seed=FAMILY_SEED)
        inp[f"{prefix}toks"], inp[f"{prefix}C"] = toks["tokens"], _median_clip(whole, toks)
        family[prefix] = (name, interop.params_to_numpy(whole.params), toks,
                          inp[f"{prefix}C"])
    np.savez(out / "inputs.npz", **inp)
    (out / "child.py").write_text(CHILD)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", str(out / "child.py"), str(out),
         str(FAMILY_SEED)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        # the references' compiles overlap (XLA compiles without the GIL)
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            jobs = {name: pool.submit(_jax_grads, jm, cparams, JDPConfig(
                enabled=name != "sgd", algo=name, clip_norm=C, noise_multiplier=0.0),
                cbatch) for name in ALGOS}
            for prefix, (name, params, toks, clip) in family.items():
                jobs[prefix] = pool.submit(_jax_grads, _jax_model(name), params,
                                           JDPConfig(algo="dpsgd_r", clip_norm=clip,
                                                     noise_multiplier=0.0), toks)
            want = {k: job.result() for k, job in jobs.items()}
        log, _ = proc.communicate(timeout=150)
    finally:
        proc.kill()
    assert proc.returncode == 0, log[-4000:]
    res = dict(np.load(out / "results.npz", allow_pickle=True))
    return dict(res=res, want=want, out=out, cparams=cparams, C=C)


def _grads_match(world, tag, want):
    jg, jmet = want
    res = world["res"]
    for i, w in enumerate(jax.tree.leaves(jg)):
        np.testing.assert_allclose(res[f"{tag}/g{i}"], np.asarray(w), **PINS,
                                   err_msg=f"{tag} leaf {i}")
    for k in METRICS:
        if k in jmet:
            np.testing.assert_allclose(res[f"{tag}/{k}"], float(jmet[k]),
                                       rtol=1e-5, err_msg=f"{tag} {k}")


def _check_algo(name):
    def check(world):
        for run in RUNS:
            _grads_match(world, f"{name}/{run}", world["want"][name])
        if name == "dpsgd_r":
            assert 0 < world["res"]["dpsgd_r/none/clipped_frac"] < 1
    return check


def _check_family(prefix):
    """One FSDP ``dpsgd_r`` step of grok's MoE or jamba's Mamba + MoE
    leaves against the reference's single-device step on the whole batch;
    some examples clip."""
    def check(world):
        _grads_match(world, prefix, world["want"][prefix])
        assert 0 < world["res"][f"{prefix}/clipped_frac"] < 1
    return check


def _check_adamw(world):
    """Two AdamW steps (ZeRO-1 on): every rank's param and moment slices
    are the slices of a world of one's, at the pins."""
    res = world["res"]
    n = len(jax.tree.leaves(world["cparams"]))
    for i in range(n):
        for key in ("p", "m", "v"):
            np.testing.assert_allclose(res[f"adamw/{key}{i}"],
                                       res[f"w1slice/{key}{i}"], **PINS,
                                       err_msg=f"{key} leaf {i}")


def _check_update_norm(world):
    res = world["res"]
    for step in range(2):
        np.testing.assert_allclose(res[f"adamw/update_norm{step}"],
                                   res[f"w1/update_norm{step}"], rtol=1e-5)


def _check_noise(world):
    """Each rank's slices get their own draws of N(0, σ²C²)/denom; the
    noise of the whole leaves is one on both ranks."""
    res = world["res"]
    a, b = res["rank0/noise"], res["rank1/noise"]
    assert a.size >= 10_000 and a.shape == b.shape
    assert not np.allclose(a, b)
    want = SIGMA * world["C"] / B
    for x in (a, b):
        assert abs(x.std() / want - 1) < 0.05, (x.std(), want)
    np.testing.assert_array_equal(res["rank0/shared"], res["rank1/shared"])
    assert np.abs(res["rank0/shared"]).max() > 0


def _check_adaptive_clip(world):
    res = world["res"]
    assert res["rank0/clip_next"] == res["rank1/clip_next"]
    assert res["rank0/clip_next"] != world["C"]


def _check_gather_counts(world):
    """The gather's backward (a reduce-scatter) in pass 1: never.  In pass
    2: once a gathered leaf (a stacked leaf once a layer), at either remat
    policy, and no all-reduce.  ``dpsgd_r1f``'s whole step: those, and one
    all-reduce a whole leaf (the algorithm's sum)."""
    res = world["res"]
    n = _count_gathers(_tarch(CHAMELEON))
    for remat in ("none", "block"):
        c = {k[len(f"count/{remat}/"):]: v for k, v in res.items()
             if k.startswith(f"count/{remat}/")}
        assert c["pass1/reduce-scatter"] == c["pass1/all-reduce"] == 0
        assert c["pass2/reduce-scatter"] == n["forward"]
        assert c["pass2/all-reduce"] == 0
        assert c["r1f/reduce-scatter"] == n["forward"]
        assert c["r1f/all-reduce"] == n["whole"]


def _check_param_bytes(world):
    """Each rank holds half of every sharded leaf and the whole of the
    rest, exactly; so does its optimizer state."""
    res = world["res"]
    tm = Model(_tarch(CHAMELEON), dtype=torch.float32, device="cpu")
    entries = _entries(tm)
    leaves = tree.leaves(tm.abstract_params())
    whole = sum(p.numel() * 4 for p in leaves)
    split = sum(p.numel() * 4 for p, sh in zip(leaves, entries) if sh is not None)
    assert split > whole // 2
    for r in (0, 1):
        assert res[f"rank{r}/held"] == whole - split // 2
        # AdamW: float32 m, v and master copy of each held slice
        assert res[f"rank{r}/opt"] == 3 * (whole - split // 2)
        assert res[f"rank{r}/whole_opt"] == 3 * whole


def _check_init(world):
    res = world["res"]
    assert res["gathered_exact"]
    assert res["rank0/init_exact"] and res["rank1/init_exact"]


def _check_fingerprint(world):
    """The slices' fingerprint, agreed by both ranks, is the reference's
    rule with the sharded leaves' bytes left out."""
    entries = _entries(Model(_tarch(CHAMELEON), dtype=torch.float32,
                             device="cpu"))
    paths = jax.tree_util.tree_flatten_with_path(world["cparams"])[0]
    sharded = {jax.tree_util.keystr(path) for (path, _), sh in zip(paths, entries)
               if sh is not None}
    assert sharded
    assert int(world["res"]["fp"]) == _reference_fingerprint(world["cparams"],
                                                             sharded)


def _restore_port(world):
    tm = Model(_tarch(CHAMELEON), dtype=torch.float32, device="cpu",
               remat="none")
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      ckpt_dir=str(world["out"] / "ck2"),
                      optim=OptimConfig(name="adamw"))
    return Trainer(tm, cfg, ShapeConfig("t", T, B, "train")).restore_or_init()


def _check_ckpt_port(world):
    """The 2-rank FSDP checkpoint, restored whole in one process by the
    port: the params of a world of one at the pins."""
    state = _restore_port(world)
    assert state.step == 2
    for i, p in enumerate(tree.leaves(state.params)):
        np.testing.assert_allclose(p.detach().numpy(), world["res"][f"w1/p{i}"],
                                   **PINS, err_msg=f"leaf {i}")


def _check_ckpt_jax(world):
    """The same checkpoint restored by ``repro.train.checkpoint``: bit for
    bit the port's restore."""
    jcfg = JTrainConfig(optim=JOptimConfig(name="adamw"))
    params = world["cparams"]
    jstate = jcheckpoint.CheckpointManager(str(world["out"] / "ck2")).restore(
        JTrainState.create(params, make_opt_init(jcfg, j_make_optimizer(
            jcfg.optim))(params)))
    state = _restore_port(world)
    assert int(jstate.step) == 2
    for a, b in zip(tree.leaves(state.params) + tree.leaves(state.opt_state),
                    jax.tree.leaves(jstate.params) + jax.tree.leaves(jstate.opt_state)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def _check_ckpt_into_slices(world):
    assert world["res"]["restored_slices_exact"]


def _check_cost_trace(world):
    """One rank's ``dpsgd_r`` step traced on fake tensors with no process
    group: all-gathers = pass 1 and pass 2 each gather every sharded leaf
    a layer at a time (again in a ``block`` recompute) + the losses, norms²
    and mask; reduce-scatters = the slices' reductions in pass 2;
    all-reduces = the whole leaves' sum + ``update_norm``'s."""
    arch = _tarch(CHAMELEON)
    tm = Model(arch, dtype=torch.float32, device="cpu")
    n = _count_gathers(arch)
    for remat in ("none", "block"):
        cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                          remat=remat, dp=DPConfig(clip_norm=1.0))
        got = collections.Counter(r["kind"] for r in traced_rank_collectives(
            tm, cfg, abstract_batch(arch, B, T), 2))
        recompute = n["blocks"] if remat == "block" else 0
        assert got["all-gather"] == 2 * (n["forward"] + recompute) + 3
        assert got["reduce-scatter"] == n["forward"]
        assert got["all-reduce"] == n["whole"] + 1


def _check_planner(world):
    """The planner's estimate of a sharded model's step, outside any
    layout, is the whole model's (its trace takes whole params: the
    reference's conservative estimate)."""
    mesh = type("M", (), {"axis_names": ("data",), "shape": (2,),
                          "get_local_rank": lambda self, axis: 1})()
    arch = _tarch(CHAMELEON)
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32", remat="block",
                      ckpt_dir=str(world["out"] / "ck_planner"))
    shape = ShapeConfig("t", T, B, "train")
    models = (Model(arch, dtype=torch.float32, device="cpu", mesh=mesh),
              Model(arch, dtype=torch.float32, device="cpu"))
    assert models[0].fsdp is not None and models[1].fsdp is None
    peaks = []
    for m in models:
        tr = Trainer(m, cfg, shape)
        batch = {k: torch.from_numpy(v) for k, v in tr.global_batch(0).items()}
        peaks.append(tr.memory_report(None, batch)["peak_bytes"])
    assert peaks[0] == peaks[1] > 0


def _check_serving_refused(world):
    """The engine, the host loop and ``decode_step`` raise by name on
    FSDP-sharded params."""
    for msg in world["res"]["serving_refused"]:
        assert "FSDP-sharded params is not ported" in str(msg), msg


def _check_autotune_plan(world):
    """A ``use_fsdp`` arch's plan on a 2-wide batch axis is feasible, and
    its collective term is the ring bytes of one rank's traced FSDP
    collectives over the H100's link."""
    from repro_torch.launch import autotune as ta
    from repro_torch.launch.roofline import LINK_BW, collective_bytes
    arch = _tarch(CHAMELEON)
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      remat="none", dp=DPConfig(clip_norm=1.0))
    scorer = ta.PlanScorer(arch, cfg, ShapeConfig("t", T, B, "train"), device="cpu")
    plan = ta.LaunchPlan(remat="none", mesh_shape=(2, 1))
    score = scorer.score(plan)
    assert score.feasible, score.reason
    records = scorer.fsdp_records(plan)
    kinds = collections.Counter(r["kind"] for r in records)
    assert kinds["all-gather"] and kinds["reduce-scatter"]
    want = collective_bytes(records, 2)["total"] / LINK_BW
    assert score.breakdown["collective_seconds"] == pytest.approx(want, rel=1e-12)
    compressed = scorer.score(ta.LaunchPlan(remat="none", mesh_shape=(2, 1),
                                            compress_grads=True))
    assert not compressed.feasible and "compress_pod_grads" in compressed.reason


CHECKS = {
    **{f"grads-{name}": _check_algo(name) for name in ALGOS},
    "grads-grok-moe": _check_family("g"),
    "grads-jamba-mamba-moe": _check_family("j"),
    "adamw-slices": _check_adamw,
    "update-norm": _check_update_norm,
    "noise-per-shard": _check_noise,
    "adaptive-clip-shared": _check_adaptive_clip,
    "gather-backward-counts": _check_gather_counts,
    "param-bytes-half": _check_param_bytes,
    "init-and-gather-exact": _check_init,
    "fingerprint-rule": _check_fingerprint,
    "ckpt-2rank-to-whole-port": _check_ckpt_port,
    "ckpt-2rank-to-whole-jax": _check_ckpt_jax,
    "ckpt-whole-to-slices": _check_ckpt_into_slices,
    "cost-trace-counts": _check_cost_trace,
    "planner-whole-params": _check_planner,
    "serving-refused": _check_serving_refused,
    "autotune-fsdp-plan": _check_autotune_plan,
}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_fsdp_world(world, check):
    CHECKS[check](world)
