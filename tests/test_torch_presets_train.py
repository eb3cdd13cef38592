"""One ``dpsgd_r`` step of the other three dense presets through the port's
fused route against the JAX package: reduced chatglm3-6b (rotary on half
the head; GQA, 4 query heads on 1 kv head at the reduced width),
stablelm-3b (rotary on a quarter) and starcoder2-7b (GQA, GELU), float32,
JAX-initialised weights carried across with ``interop``, seeded numpy
tokens, a clip norm among the per-example norms so some examples clip.
The per-row losses, the per-example norms² and the clipped sum (the
update at σ = 0, before its division by B) at the reference's f32 pins,
rtol 1e-5 / atol 2e-6 (``tests/test_memory.py``), the absolute one scaled
by a leaf's largest entry where that exceeds 1: the embedding's gradient
sums the rows of repeated tokens (entries up to ~5 here) in another order
than JAX's scatter, so an entry that cancels to near zero can be ~1e-6 of
the leaf's largest entry away.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.configs.base import DPConfig as JDPConfig
from repro.core import make_clipped_sum_fn as j_make_clipped_sum_fn
from repro.models.transformer import build_model
from repro_torch import interop
from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.configs.base import DPConfig
from repro_torch.core import algo as talgo
from repro_torch.models.transformer import Model

PINS = dict(rtol=1e-5, atol=2e-6)
B, T = 4, 16


@pytest.mark.parametrize("name", ["chatglm3-6b", "stablelm-3b", "starcoder2-7b"])
def test_dpsgd_r_fused_step_matches_jax(name):
    jarch, tarch = jreduced(JARCHS[name]), treduced(TARCHS[name])
    assert (tarch.n_heads, tarch.n_kv_heads, tarch.rotary_pct, tarch.mlp_act) == \
        (jarch.n_heads, jarch.n_kv_heads, jarch.rotary_pct, jarch.mlp_act)
    jm = build_model(jarch, param_dtype="float32", compute_dtype="float32",
                     remat="none")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(2).integers(0, jarch.vocab, (B, T + 1)).astype(np.int32)
    tm = Model(tarch, interop.params_from_numpy(params, "cpu"), dtype=torch.float32,
               device="cpu", remat="block")
    tm.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(toks)}
    dp = dict(algo="dpsgd_r", norm_strategy="fused", noise_multiplier=0.0)
    nsq, _ = talgo.norm_pass(tm.loss_fn, tm.params, batch, DPConfig(**dp))
    C = float(np.sqrt(np.median(nsq.numpy())))
    grads, (losses, nsq) = talgo.make_clipped_sum_fn(
        tm.loss_fn, DPConfig(use_kernels=True, clip_norm=C, **dp))(tm.params, batch)
    jgrads, (jlosses, jnsq) = jax.jit(j_make_clipped_sum_fn(
        jm.loss_fn, JDPConfig(clip_norm=C, **dp)))(
        jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), **PINS)
    np.testing.assert_allclose(nsq.numpy(), np.asarray(jnsq), **PINS)
    assert 0 < int((nsq > C * C).sum()) < B          # some examples clip
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=PINS["rtol"],
                                   atol=PINS["atol"] * max(1.0, np.abs(w).max()))
