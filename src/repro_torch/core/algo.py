"""Algorithm 1 of the paper as gradient transformations.  Counterpart of
``repro/core/algo.py``.

``make_noisy_grad_fn(loss_fn, dp, grad_accum)`` returns

    fn(params, batch, generator) -> (grads, metrics)

where ``grads`` is a list of float32 tensors aligned with
``tree.leaves(params)`` and ``metrics`` a dict of 0-d tensors, for
``dp.algo`` in:

* ``"sgd"``     — non-private baseline: the mean-loss gradient.
* ``"dpsgd_r"`` — reweighted DP-SGD(R) (lines 27–42): pass 1
                  (``norm_pass``) gives the per-example norms² through the
                  ``DPContext`` side-channel on detached parameters, so no
                  weight gradient is formed; pass 2 (``reweighted_grads``)
                  backpropagates the clip-reweighted loss; then noise.

``grad_accum > 1`` sums the clipped sums of equal chunks of the batch
before the noise, as in the JAX package.  Not ported (ROADMAP queue 1):
``"dpsgd"`` and ``"dpsgd_r1f"``, Poisson masks (a ``"mask"`` batch leaf),
``augmult > 1`` and adaptive clipping; each raises ``NotImplementedError``.

loss_fn contract: ``loss_fn(params, batch, ctx) -> (per_example_losses,
ctx)`` with ``per_example_losses: (B,) float32``.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import DPConfig
from repro_torch.core import clipping, noise
from repro_torch.core.context import DPContext

F32 = torch.float32
MASK_KEY = "mask"


def _batch_size(batch) -> int:
    return tree.leaves(batch)[0].shape[0]


def _unported(dp: DPConfig) -> None:
    """Raise on what the port has not taken over yet."""
    if dp.sampling != "fixed":
        raise NotImplementedError(
            f"dp.sampling={dp.sampling!r} is not ported yet (ROADMAP queue 1)")
    if dp.augmult != 1:
        raise NotImplementedError(
            "dp.augmult > 1 is not ported yet (ROADMAP queue 1)")
    if dp.adaptive_clip:
        raise NotImplementedError(
            "dp.adaptive_clip is not ported yet (ROADMAP queue 1)")


def _metrics(losses, nsq, clip_norm):
    n = torch.sqrt(torch.clamp(nsq, min=0.0))
    return {"loss": losses.mean(),
            "grad_norm_mean": n.mean(),
            "grad_norm_max": n.max(),
            "clipped_frac": (n > clip_norm).float().mean(),
            "realized_batch": torch.tensor(float(nsq.shape[0]))}


def _require_grad_leaves(params) -> List[torch.Tensor]:
    leaves = tree.leaves(params)
    if not all(p.requires_grad for p in leaves):
        raise ValueError("the second pass differentiates the params: they "
                         "must require grad (model.requires_grad_(True))")
    return leaves


def _f32_grads(loss, leaves) -> List[torch.Tensor]:
    grads = list(torch.autograd.grad(loss, leaves))
    for i, g in enumerate(grads):      # one leaf at a time: the param-type
        grads[i] = g.float()           # grad is freed as its copy is made
    return grads


# ---------------------------------------------------------------------------
# the two passes of DP-SGD(R)
# ---------------------------------------------------------------------------

def norm_pass(loss_fn: Callable, params, data, dp: DPConfig):
    """Pass 1: (per-example norms² (B,), per-example losses (B,)).

    The accumulator starts as zeros that require grad; every site adds its
    norm² to its gradient.  The params are detached, so the sites compute
    activation gradients and norms² and no weight gradient."""
    device = tree.leaves(params)[0].device
    ctx = DPContext.norm_mode(_batch_size(data), dp.norm_strategy,
                              dp.use_kernels, dp.augmult, device)
    acc0 = ctx.acc
    with torch.enable_grad():
        losses, ctx = loss_fn(tree.tree_map(torch.Tensor.detach, params),
                              data, ctx)
        (nsq,) = torch.autograd.grad(
            (losses.sum(), ctx.acc), (acc0,),
            (torch.ones((), dtype=losses.dtype, device=device),
             torch.zeros_like(ctx.acc)))
    return nsq, losses.detach()


def reweighted_grads(loss_fn: Callable, params, data, weights) -> List[torch.Tensor]:
    """Pass 2: float32 gradients of ``Σ_b weights_b · L_b`` (plain ops),
    aligned with ``tree.leaves(params)``."""
    leaves = _require_grad_leaves(params)
    with torch.enable_grad():
        losses, _ = loss_fn(params, data, DPContext.off())
        return _f32_grads((weights.detach() * losses).sum(), leaves)


# ---------------------------------------------------------------------------
# per-algorithm clipped sums: (params, batch) -> (Σ_i c_i g_i, (losses, nsq))
# ---------------------------------------------------------------------------

def _sgd_sum(loss_fn, dp):
    def fn(params, batch):
        leaves = _require_grad_leaves(params)
        with torch.enable_grad():
            losses, _ = loss_fn(params, batch, DPContext.off())
            grads = _f32_grads(losses.sum(), leaves)
        return grads, (losses.detach(),
                       torch.zeros_like(losses, dtype=F32).detach())
    return fn


def _dpsgd_r_sum(loss_fn, dp: DPConfig):
    def fn(params, batch):
        nsq, losses = norm_pass(loss_fn, params, batch, dp)       # lines 31-33
        c = clipping.clip_factors(nsq, dp.clip_norm)              # line 35
        grads = reweighted_grads(loss_fn, params, batch, c)       # lines 36-39
        return grads, (losses, nsq)
    return fn


def _unported_algo(name):
    def factory(loss_fn, dp):
        raise NotImplementedError(
            f"dp.algo={name!r} is not ported yet (ROADMAP queue 1); the port "
            f"runs 'sgd' and 'dpsgd_r'")
    return factory


_ALGOS: dict = {}


def register_algo(name: str, factory: Callable, *, private: bool = True) -> None:
    """Register a clipped-sum algorithm: ``factory(loss_fn, dp) ->
    fn(params, batch) -> (grads, (losses, nsq))``.  ``private=False`` adds
    no noise and mean-normalises instead."""
    if name in _ALGOS:
        raise ValueError(f"dp.algo {name!r} already registered (registered "
                         f"algos: {sorted(_ALGOS)})")
    _ALGOS[name] = (factory, bool(private))


def algo_is_private(name: str, enabled: bool = True) -> bool:
    if not enabled:
        return False
    return _lookup(name)[1]


def _lookup(name: str):
    try:
        return _ALGOS[name]
    except KeyError:
        raise ValueError(f"unknown dp.algo {name!r}; registered algos: "
                         f"{sorted(_ALGOS)}") from None


register_algo("sgd", _sgd_sum, private=False)
register_algo("dpsgd", _unported_algo("dpsgd"))
register_algo("dpsgd_r", _dpsgd_r_sum)
register_algo("dpsgd_r1f", _unported_algo("dpsgd_r1f"))


def make_clipped_sum_fn(loss_fn: Callable, dp: DPConfig) -> Callable:
    if not dp.enabled:
        return _sgd_sum(loss_fn, dp)
    return _lookup(dp.algo)[0](loss_fn, dp)


# ---------------------------------------------------------------------------
# top level: accumulate -> noise -> scale
# ---------------------------------------------------------------------------

def _chunks(batch, n: int):
    return [tree.tree_map(lambda a, i=i: a.chunk(n, dim=0)[i], batch)
            for i in range(n)]


def make_noisy_grad_fn(loss_fn: Callable, dp: DPConfig, grad_accum: int = 1,
                       expected_batch_size: Optional[float] = None) -> Callable:
    """Build fn(params, batch, generator) -> (grads, metrics).

    ``expected_batch_size``: the private update's normaliser; None uses the
    physical batch size (fixed-size batches).  ``generator`` draws the
    noise on the gradients' device."""
    _unported(dp)
    csum = make_clipped_sum_fn(loss_fn, dp)
    private = algo_is_private(dp.algo, dp.enabled)

    def fn(params, batch, generator: torch.Generator):
        if MASK_KEY in batch:
            raise NotImplementedError(
                "Poisson-masked batches are not ported yet (ROADMAP queue 1)")
        R = _batch_size(batch)
        if grad_accum == 1:
            summed, (losses, nsq) = csum(params, batch)
        else:
            if R % grad_accum:
                raise ValueError(f"batch {R} does not split into "
                                 f"{grad_accum} chunks")
            summed, parts = None, []
            for chunk in _chunks(batch, grad_accum):
                s, ln = csum(params, chunk)
                if summed is None:
                    summed = s
                else:
                    for a, b in zip(summed, s):
                        a.add_(b)
                parts.append(ln)
            losses = torch.cat([p[0] for p in parts])
            nsq = torch.cat([p[1] for p in parts])
        if private:
            denom = (float(expected_batch_size)
                     if expected_batch_size is not None else R)
            noise.add_noise_(summed, generator, dp.noise_multiplier,
                             dp.clip_norm, denom)                  # lines 24/41
            metrics = _metrics(losses, nsq, dp.clip_norm)
        else:
            for g in summed:
                g.div_(R)
            metrics = {"loss": losses.mean(),
                       "realized_batch": torch.tensor(float(R))}
        return summed, metrics

    return fn
