"""The port's distribution runtime against the JAX package.

* ``compress_grads`` bit for bit against ``repro.dist.compress``, and its
  error feedback converging (the cumulative signal sent tracks the
  cumulative true one within one quantization bucket).
* ``init_fingerprint`` equal to ``repro.dist.runtime.init_fingerprint`` on
  the same params (float32 and bf16 leaves).
* One 2-rank gloo world on the CPU (``torch.distributed.run
  --standalone``; the child script is ``CHILD`` below).  On the reduced
  stablelm in float32, σ = 0, with JAX-initialised weights, each rank
  holding its half of the batch under ``dist.runtime.layout``: the
  gradients and metrics of ``sgd``, ``dpsgd``, ``dpsgd_r`` and
  ``dpsgd_r1f`` against the JAX package's single-device run on the whole
  batch (its 8-device test is red under jax 0.9, so one device is the
  oracle); a Poisson-masked batch at the capacity rounded to the batch
  width; ``dp.augmult`` = 2 with example-aligned shards; the ZeRO-1 AdamW
  step with the compression rider equal, bit for bit, to the unsharded
  update of the compressed gradient; a rank of another seed making
  ``verify_init_consistency`` raise.  The world writes a 2-rank ZeRO-1
  checkpoint and restores a whole-leaf one into its slices; this process
  restores the 2-rank one with the port and with ``repro.train.checkpoint``.

Pins: rtol 1e-5 / atol 2e-6 (the reference's) for everything a sum over
other shards reorders; exact equality where the arithmetic is the same.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import (DPConfig as JDPConfig, OptimConfig as JOptimConfig,
                                ShapeConfig as JShapeConfig,
                                TrainConfig as JTrainConfig)
from repro.core import make_noisy_grad_fn as j_make_noisy_grad_fn
from repro.core.algo import make_clipped_sum_fn
from repro.dist import compress as jcompress
from repro.dist import runtime as jruntime
from repro.models.transformer import build_model
from repro.optim import make_optimizer as j_make_optimizer
from repro.train import checkpoint as jcheckpoint
from repro.train.state import TrainState as JTrainState
from repro.train.trainer import make_opt_init, physical_batch_size
from repro_torch import interop, tree
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import DPConfig, OptimConfig, ShapeConfig, TrainConfig
from repro_torch.dist import compress, runtime
from repro_torch.models.transformer import Model
from repro_torch.train import Trainer

ROOT = os.path.join(os.path.dirname(__file__), "..")
PINS = dict(rtol=1e-5, atol=2e-6)
ARCH, B, T, N = "stablelm-3b", 8, 16, 1_000_000
ALGOS = ("sgd", "dpsgd", "dpsgd_r", "dpsgd_r1f")
METRICS = ("loss", "grad_norm_mean", "grad_norm_max", "clipped_frac",
           "realized_batch")


def test_compress_grads_matches_jax_bit_for_bit():
    """Leaves of sizes that 256 divides and does not, a carried residual,
    and a zero leaf: the dequantized gradients and the new residuals."""
    rng = np.random.default_rng(0)
    shapes = [(3, 256), (7, 33), (1000,), (4, 5, 6)]
    grads = [rng.standard_normal(s).astype(np.float32) * 3 for s in shapes]
    grads.append(np.zeros((300,), np.float32))
    errs = [rng.standard_normal(g.shape).astype(np.float32) * 0.01 for g in grads]
    got, got_err = compress.compress_grads([torch.from_numpy(g) for g in grads],
                                           [torch.from_numpy(e) for e in errs])
    want, want_err = jcompress.compress_grads([jnp.asarray(g) for g in grads],
                                              [jnp.asarray(e) for e in errs])
    for a, b in zip(got + got_err, list(want) + list(want_err)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    zero = compress.init_error_state({"a": torch.ones(3, dtype=torch.bfloat16)})
    assert zero["a"].dtype == torch.float32 and not zero["a"].any()


def test_error_feedback_converges():
    """The cumulative dequantized signal stays within one bucket of the
    cumulative true gradient, step after step."""
    rng = np.random.default_rng(1)
    err = compress.init_error_state([torch.zeros(1000)])
    sent = torch.zeros(1000, dtype=torch.float64)
    true = torch.zeros(1000, dtype=torch.float64)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
        deq, err = compress.compress_grads([g], err)
        sent += deq[0].double()
        true += g.double()
        bucket = float((g.abs().max() + err[0].abs().max()) / 127.0)
        assert float((true - sent).abs().max()) <= bucket * 2


def test_init_fingerprint_matches_jax():
    jm = build_model(jreduced(JARCHS[ARCH]), param_dtype="bfloat16",
                     compute_dtype="float32")
    for seed in (0, 1):
        params = jm.init(jax.random.PRNGKey(seed))
        tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
        assert any(p.dtype == torch.bfloat16 for p in tree.leaves(tp))
        assert runtime.init_fingerprint(tp) == jruntime.init_fingerprint(params)
    assert runtime.verify_init_consistency(tp) == runtime.init_fingerprint(tp)


CHILD = textwrap.dedent('''
    import dataclasses, datetime, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import (DPConfig, OptimConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.core import algo
    from repro_torch.dist import compress, runtime
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import Trainer, TrainState

    out = sys.argv[1]
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60))
    rank = dist.get_rank()
    inp = np.load(out + "/inputs.npz")
    arch = reduced(ARCHS["stablelm-3b"])
    model = Model(arch, dtype=torch.float32, device="cpu", remat="none")
    with torch.no_grad():
        for i, p in enumerate(tree.leaves(model.params)):
            p.copy_(torch.from_numpy(inp[f"p{i}"]))
    model.requires_grad_(True)
    C, res = float(inp["C"]), {}
    mesh = make_host_mesh()
    res["fp"] = runtime.verify_init_consistency(model.params)

    def local(batch):
        index, count = runtime.batch_shard()
        rows = len(next(iter(batch.values()))) // count
        return {k: torch.from_numpy(v[index * rows:(index + 1) * rows])
                for k, v in batch.items()}

    def grads(tag, dp, batch, denom=None):
        fn = algo.make_noisy_grad_fn(model.loss_fn, dp, expected_batch_size=denom)
        g, met = fn(model.params, local(batch), torch.Generator().manual_seed(0))
        for i, x in enumerate(g):
            res[f"{tag}/g{i}"] = x.numpy()
        for k, v in met.items():
            res[f"{tag}/{k}"] = float(v)

    with runtime.layout(mesh, ("data",)):
        toks = inp["toks"]
        for name in ("sgd", "dpsgd", "dpsgd_r", "dpsgd_r1f"):
            grads(name, DPConfig(enabled=name != "sgd", algo=name, clip_norm=C,
                                 noise_multiplier=0.0), {"tokens": toks})
        grads("poisson", DPConfig(clip_norm=C, noise_multiplier=0.0),
              {"tokens": inp["ptoks"], "mask": inp["pmask"]}, denom=8.0)
        grads("augmult", DPConfig(clip_norm=C, noise_multiplier=0.0, augmult=2),
              {"tokens": np.repeat(toks[:4], 2, axis=0)})

        shape = ShapeConfig("t", toks.shape[1] - 1, 8, "train")
        def config(**kw):
            return TrainConfig(param_dtype="float32", compute_dtype="float32",
                               remat="none", steps=1, **kw)
        poisson = Trainer(model, config(ckpt_dir=out + "/ck_poisson", dp=DPConfig(
            sampling="poisson")), shape, mesh=mesh)
        res["capacity"] = poisson.capacity

        cfg = config(ckpt_dir=out + "/ck2", zero1=True, compress_pod_grads=True,
                     dp=DPConfig(clip_norm=C, noise_multiplier=0.0),
                     optim=OptimConfig(name="adamw", lr=1e-2, schedule="constant"))
        tr = Trainer(model, cfg, shape, mesh=mesh)
        state = tr.init_state()
        leaves = tree.leaves(state.params)
        m = state.opt_state["opt"]["m"]
        sharded = [i for i, sh in enumerate(tr.step_fn.shards) if sh is not None]
        res["sharded"] = np.array(sharded)
        for i in sharded:
            d = tr.step_fn.shards[i][0]
            assert m[i].shape[d] * 2 == leaves[i].shape[d], (i, m[i].shape)
        ref_p = [p.detach().clone() for p in leaves]
        g, met = tr.gradients(state, tr.make_batch(0))
        deq, new_err = compress.compress_grads(
            [x.clone() for x in g], compress.init_error_state(ref_p))
        opt = make_optimizer(cfg.optim)
        ref_opt = opt.init(ref_p)
        opt.apply(deq, ref_opt, ref_p, 0)
        tr.update(state, g, met)
        for i, (p, r) in enumerate(zip(leaves, ref_p)):
            assert torch.equal(p, r), i
            assert torch.equal(state.opt_state["grad_err"][i], new_err[i]), i
            for key in ("m", "v", "master"):
                want = tr.step_fn._slice(ref_opt[key][i], tr.step_fn.shards[i])
                assert torch.equal(state.opt_state["opt"][key][i], want), (key, i)
        for i, x in enumerate(tree.leaves({"grad_err": new_err, "opt": ref_opt})):
            res[f"ref/opt{i}"] = x.numpy()
        for i, p in enumerate(ref_p):
            res[f"ref/p{i}"] = p.numpy()
        tr.ckpt.save(state, 1, shards=tr.step_fn.ckpt_shards(state))
        # a whole-leaf checkpoint (one process's layout) into ZeRO-1 slices
        whole = TrainState(1, model.params, {"grad_err": new_err, "opt": ref_opt})
        tr1 = Trainer(model, dataclasses.replace(cfg, ckpt_dir=out + "/ck1"),
                      shape, mesh=mesh)
        tr1.ckpt.save(whole, 1)
        back = tr1.restore_or_init()
        for a, b in zip(tree.leaves(back.opt_state), tree.leaves(state.opt_state)):
            assert torch.equal(a, b)
        assert back.step == 1

        bad = Model(arch, dtype=torch.float32, device="cpu", seed=rank)
        try:
            runtime.verify_init_consistency(bad.params)
            res["mismatch"] = ""
        except RuntimeError as e:
            res["mismatch"] = str(e)
    if rank == 0:
        np.savez(out + "/results.npz", **res)
    dist.barrier()
    dist.destroy_process_group()
''')


def _jax_setup():
    jm = build_model(jreduced(JARCHS[ARCH]), param_dtype="float32",
                     compute_dtype="float32", remat="none")
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jm.arch.vocab, (B, T + 1)).astype(np.int32)
    ptoks = rng.integers(0, jm.arch.vocab, (B, T + 1)).astype(np.int32)
    pmask = np.array([1, 0, 1, 1, 1, 0, 0, 1], bool)
    _, (_, nsq) = jax.jit(make_clipped_sum_fn(jm.loss_fn, JDPConfig()))(
        params, {"tokens": jnp.asarray(toks)})
    C = float(np.sqrt(np.median(np.asarray(nsq))))
    return jm, params, dict(toks=toks, ptoks=ptoks, pmask=pmask, C=C)


def _jax_grads(jm, params, dp, batch, denom=None):
    fn = jax.jit(j_make_noisy_grad_fn(jm.loss_fn, dp, expected_batch_size=denom))
    return fn(params, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))


def test_two_rank_world_matches_jax_single_device(tmp_path):
    jm, params, inp = _jax_setup()
    leaves = [np.asarray(p) for p in jax.tree.leaves(params)]
    np.savez(tmp_path / "inputs.npz", **inp, **{f"p{i}": p for i, p in enumerate(leaves)})
    (tmp_path / "child.py").write_text(CHILD)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    world = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", str(tmp_path / "child.py"), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # the JAX oracle while the world runs
    C = inp["C"]
    want = {name: _jax_grads(jm, params, JDPConfig(
        enabled=name != "sgd", algo=name, clip_norm=C, noise_multiplier=0.0),
        {"tokens": inp["toks"]}) for name in ALGOS}
    want["poisson"] = _jax_grads(jm, params, JDPConfig(clip_norm=C, noise_multiplier=0.0),
                                 {"tokens": inp["ptoks"], "mask": inp["pmask"]}, 8.0)
    want["augmult"] = _jax_grads(jm, params, JDPConfig(clip_norm=C, noise_multiplier=0.0,
                                                       augmult=2),
                                 {"tokens": np.repeat(inp["toks"][:4], 2, axis=0)})
    try:
        log, _ = world.communicate(timeout=120)
    finally:
        world.kill()
    assert world.returncode == 0, log[-4000:]
    res = np.load(tmp_path / "results.npz")

    for tag, (jg, jmet) in want.items():
        for i, w in enumerate(jax.tree.leaves(jg)):
            np.testing.assert_allclose(res[f"{tag}/g{i}"], np.asarray(w), **PINS,
                                       err_msg=f"{tag} leaf {i}")
        for k in METRICS:
            if k in jmet:
                np.testing.assert_allclose(res[f"{tag}/{k}"], float(jmet[k]),
                                           rtol=1e-5, err_msg=f"{tag} {k}")
    assert 0 < res["dpsgd_r/clipped_frac"] < 1 and res["poisson/realized_batch"] == 5
    jshape = JShapeConfig("t", T, B, "train")
    assert int(res["capacity"]) == physical_batch_size(
        JTrainConfig(dp=JDPConfig(sampling="poisson")), jshape, N, shards=2)
    assert int(res["capacity"]) % 2 == 0
    assert "ranks [1] disagree with rank 0" in str(res["mismatch"])
    assert len(res["sharded"]) > 0

    # the 2-rank ZeRO-1 checkpoint, restored whole in one process by both
    tarch = treduced(TARCHS[ARCH])
    model = Model(tarch, dtype=torch.float32, device="cpu", remat="none")
    cfg = TrainConfig(param_dtype="float32", compute_dtype="float32",
                      ckpt_dir=str(tmp_path / "ck2"), compress_pod_grads=True,
                      optim=OptimConfig(name="adamw"))
    state = Trainer(model, cfg, ShapeConfig("t", T, B, "train")).restore_or_init()
    jcfg = JTrainConfig(compress_pod_grads=True, optim=JOptimConfig(name="adamw"))
    jstate = jcheckpoint.CheckpointManager(str(tmp_path / "ck2")).restore(
        JTrainState.create(params, make_opt_init(jcfg, j_make_optimizer(jcfg.optim))(params)))
    assert state.step == int(jstate.step) == 1
    got_p, got_o = tree.leaves(state.params), tree.leaves(state.opt_state)
    for i, (a, b) in enumerate(zip(got_p, jax.tree.leaves(jstate.params))):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.detach().numpy(), res[f"ref/p{i}"])
    for i, (a, b) in enumerate(zip(got_o, jax.tree.leaves(jstate.opt_state))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), res[f"ref/opt{i}"])
    assert len(got_o) == len(jax.tree.leaves(jstate.opt_state))
    assert int(res["fp"]) == jruntime.init_fingerprint(params)
