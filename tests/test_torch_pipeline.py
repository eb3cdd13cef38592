"""The port's pipeline schedule against the JAX package's.

``Model(pp_stages=S)`` runs the repeated blocks stage-major on the
shifted-buffer microbatch schedule (models/transformer.py
``_blocks_pipelined``).  Ports of ``tests/test_pipeline.py``'s cases: the
microbatch count and the shift primitive with its transpose; the
validation errors; the pipelined per-example losses and norms² (the fused
route) at S 2 with M 2 and 4 against the JAX pipelined forward on the
reduced stablelm, deepseek-moe (every layer MoE, so its blocks stack 2
deep) and jamba (two periods of a Mamba layer and an attention layer with
MoE, from its pattern), JAX-initialised
weights carried across with ``interop``; and the pipelined updates of
every algorithm equal to the sequential ones under a Poisson mask and
with ``grad_accum``.  Pins: rtol 1e-5 / atol 2e-6, the reference's.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.core.algo import stage_microbatches as j_stage_microbatches
from repro.core.context import DPContext as JDPContext
from repro.models import build_model_for as j_build_model_for
from repro.models.layers import pipeline_shift as j_pipeline_shift
from repro_torch import interop, tree
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import DPConfig
from repro_torch.core import algo
from repro_torch.core.context import DPContext
from repro_torch.models import build_model_for
from repro_torch.models.layers import pipeline_shift
from repro_torch.models.transformer import Model


PINS = dict(rtol=1e-5, atol=2e-6)
B, T = 8, 16


def _cut(arch, name):
    """The reduced arch with two stacked blocks: deepseek with every layer
    MoE; jamba on the two layers of its pattern round its attention layer
    (a Mamba layer with a dense FFN, an attention layer with an MoE one),
    repeated twice."""
    if name == "deepseek-moe-16b":
        return dataclasses.replace(arch, moe=dataclasses.replace(
            arch.moe, moe_skip_first=0))
    if name == "jamba-1.5-large-398b":
        return dataclasses.replace(arch, n_layers=4,
                                   layer_pattern=arch.layer_pattern[3:5])
    return arch


def _jax_losses_and_norms(model):
    """Jitted per-example losses and the fused route's norms² (the pass-1
    pullback of ``(Σ L, acc)`` with cotangents (1, 0))."""
    def fn(params, batch):
        def pass1(p, acc0):
            ctx = JDPContext(acc=acc0, mode="norm", strategy="fused")
            losses, ctx = model.loss_fn(p, batch, ctx)
            return (jnp.sum(losses), ctx.acc), losses
        acc0 = jnp.zeros((B,), jnp.float32)
        _, pull, losses = jax.vjp(pass1, params, acc0, has_aux=True)
        return losses, pull((jnp.ones(()), jnp.zeros((B,), jnp.float32)))[1]
    return jax.jit(fn)


def _archs(name):
    return (_cut(jreduced(JARCHS[name]), name), _cut(treduced(TARCHS[name]), name))


def test_stage_microbatches_clamps_to_divisor():
    assert algo.stage_microbatches(8, 2) == 2
    assert algo.stage_microbatches(8, 2, requested=4) == 4
    assert algo.stage_microbatches(8, 2, requested=3) == 2
    assert algo.stage_microbatches(8, 2, requested=100) == 8
    assert algo.stage_microbatches(1, 4) == 1
    assert algo.stage_microbatches(6, 4) == 3
    assert algo.stage_microbatches(5, 2) == 1
    for n in range(1, 13):
        for s in (1, 2, 3, 4):
            for req in (0, 1, 2, 3, 5, 8):
                assert algo.stage_microbatches(n, s, req) == \
                    j_stage_microbatches(n, s, req)


def test_pipeline_shift_semantics():
    """Tensors, dicts of tensors and the schedule's list of stage slots
    shift alike; the tensor forms equal the reference's."""
    buf = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    inject = np.full((4,), -1.0, np.float32)
    got = pipeline_shift(torch.from_numpy(buf), torch.from_numpy(inject))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_pipeline_shift(jnp.asarray(buf), jnp.asarray(inject))))
    got2 = pipeline_shift({"a": torch.from_numpy(buf), "b": 2 * torch.from_numpy(buf)},
                          {"a": torch.from_numpy(inject), "b": torch.from_numpy(inject)})
    np.testing.assert_array_equal(got2["b"][1:].numpy(), 2 * buf[:-1])
    assert pipeline_shift(["s0", "s1", "s2"], "in") == ["in", "s0", "s1"]
    assert pipeline_shift((torch.zeros(2, 1),), (torch.ones(1),))[0][0, 0] == 1


def test_pipeline_shift_transpose_is_reduction():
    """The backward of S shifts sums a cotangent over every position it
    visited, as the reference's transpose does."""
    def roll(inject):
        buf = torch.zeros((3, 2))
        for _ in range(3):
            buf = pipeline_shift(buf, inject)
        return (buf[-1] * torch.arange(1.0, 3.0)).sum()

    def jroll(inject):
        buf = jnp.zeros((3, 2))
        for _ in range(3):
            buf = j_pipeline_shift(buf, inject)
        return jnp.sum(buf[-1] * jnp.arange(1.0, 3.0))

    x = torch.ones(2, requires_grad=True)
    (g,) = torch.autograd.grad(roll(x), x)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jax.grad(jroll)(jnp.ones(2))))
    np.testing.assert_array_equal(g.numpy(), [1.0, 2.0])


def test_pp_stages_validation():
    arch = treduced(TARCHS["stablelm-3b"])
    with pytest.raises(ValueError, match="pick a divisor of 2"):
        build_model_for(arch, pp_stages=3, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="pp_microbatches must be >= 0"):
        build_model_for(arch, pp_stages=2, pp_microbatches=-1,
                        dtype=torch.float32, device="cpu")
    cnn = treduced(TARCHS["cnn-cifar10"])
    with pytest.raises(ValueError, match="only supported for transformer"):
        build_model_for(cnn, pp_stages=2)
    build_model_for(cnn, pp_stages=1, pp_microbatches=0, dtype=torch.float32,
                    device="cpu")
    assert build_model_for(arch, pp_stages=2, dtype=torch.float32,
                           device="cpu").pp_stages == 2


PIPELINED = ("stablelm-3b", "deepseek-moe-16b", "jamba-1.5-large-398b")


@pytest.fixture(scope="module")
def pipelined_refs():
    """For each of ``PIPELINED``: its JAX-initialised params, tokens, and
    the reference's pipelined losses and norms² at M 2 and 4, all six
    compiles started at once on a thread pool (XLA compiles without the
    GIL) and awaited by the test that reads them."""
    pool = concurrent.futures.ThreadPoolExecutor(2 * len(PIPELINED))
    out = {}
    for name in PIPELINED:
        jarch, _ = _archs(name)
        jseq = j_build_model_for(jarch, param_dtype="float32", compute_dtype="float32")
        params = jseq.init(jax.random.PRNGKey(0))
        toks = np.random.default_rng(1).integers(0, jarch.vocab, (B, T + 1)).astype(np.int32)
        refs = {mb: pool.submit(_jax_losses_and_norms(j_build_model_for(
            jarch, param_dtype="float32", compute_dtype="float32", remat="none",
            pp_stages=2, pp_microbatches=mb)), params, {"tokens": jnp.asarray(toks)})
            for mb in (2, 4)}
        out[name] = (params, toks, refs)
    yield out
    pool.shutdown(wait=True)


@pytest.mark.parametrize("name", PIPELINED)
def test_pipelined_losses_and_norms_match_jax(name, pipelined_refs):
    """S 2, M 2 and 4: per-example losses and the fused route's norms² of
    the port's pipelined forward against the JAX pipelined forward."""
    _, tarch = _archs(name)
    params, toks, refs = pipelined_refs[name]
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    for mb, ref in refs.items():
        tm = Model(tarch, tp, dtype=torch.float32, device="cpu", pp_stages=2,
                   pp_microbatches=mb)
        got, _ = tm.loss_fn(tm.params, {"tokens": torch.from_numpy(toks)},
                            DPContext.off())
        nsq, losses = algo.norm_pass(tm.loss_fn, tm.params,
                                     {"tokens": torch.from_numpy(toks)},
                                     DPConfig(norm_strategy="fused"))
        want, want_nsq = ref.result()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **PINS)
        np.testing.assert_allclose(losses.numpy(), np.asarray(want), **PINS)
        np.testing.assert_allclose(nsq.numpy(), np.asarray(want_nsq), **PINS)


def _models(**kw):
    arch = treduced(TARCHS["stablelm-3b"])
    seq = Model(arch, dtype=torch.float32, device="cpu", **kw)
    pipe = Model(arch, seq.params, dtype=torch.float32, device="cpu",
                 pp_stages=2, **kw)
    for m in (seq, pipe):
        m.requires_grad_(True)
    return arch, seq, pipe


def _grads(model, dp, batch, grad_accum=1):
    fn = algo.make_noisy_grad_fn(model.loss_fn, dp, grad_accum=grad_accum)
    g = torch.Generator().manual_seed(11)
    return fn(model.params, batch, g)


@pytest.mark.parametrize("algo_name", ["sgd", "dpsgd", "dpsgd_r", "dpsgd_r1f"])
def test_pipelined_updates_match_sequential_under_mask(algo_name):
    """Every algorithm on a Poisson-masked batch: the pipelined update
    (noise from one seed) equals the sequential one."""
    arch, seq, pipe = _models()
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, arch.vocab, (B, T + 1)).astype(np.int32))
    mask = torch.from_numpy(rng.random(B) < 0.7)
    batch = {"tokens": toks, "mask": mask}
    dp = DPConfig(enabled=algo_name != "sgd", algo=algo_name, clip_norm=0.05,
                  noise_multiplier=0.4, norm_strategy="fused")
    ga, ma = _grads(seq, dp, batch)
    gb, mb = _grads(pipe, dp, batch)
    assert float(ma["realized_batch"]) == float(mb["realized_batch"])
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **PINS)


def test_pipelined_with_grad_accum():
    arch, seq, pipe = _models()
    toks = np.random.default_rng(4).integers(0, arch.vocab, (B, T + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks)}
    dp = DPConfig(algo="dpsgd_r", clip_norm=0.05, noise_multiplier=0.3,
                  norm_strategy="fused")
    ga, _ = _grads(seq, dp, batch, grad_accum=2)
    gb, _ = _grads(pipe, dp, batch, grad_accum=2)
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **PINS)
    assert len(ga) == len(tree.leaves(seq.params))
