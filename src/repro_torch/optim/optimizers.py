"""Optimizers.  Counterpart of ``repro/optim/optimizers.py``.

* ``sgd``   — SGD with momentum.
* ``adamw`` — AdamW with a float32 master copy and float32 moments.

Both share ``init(params) -> state`` and ``apply(grads, state, params,
step)``, where ``params`` and ``grads`` are lists aligned leaf by leaf
(``tree.leaves``) and the gradients arrive noised and averaged (float32).
Unlike the JAX package's functional version, ``apply`` updates the state
and the params in place: at full width the AdamW state is 12 bytes a
parameter, and a second copy of it would not fit beside the first.  It
also updates one slice of a leaf's leading (stacked-layer) dimension at a
time (``tree.leaf_slices``), so its float32 temporaries take a slice's
size and not a stacked leaf's; the arithmetic is elementwise, so the bits
are those of the whole-leaf update.  ``adam8bit`` is not ported (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List

import torch

from repro_torch import tree
from repro_torch.configs.base import OptimConfig

F32 = torch.float32


def lr_at(cfg: OptimConfig, step: int) -> float:
    if cfg.schedule == "constant":
        return cfg.lr
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    cfg: OptimConfig
    init: Callable
    apply: Callable            # (grads, state, params, step) -> None, in place


def _make_sgd(cfg: OptimConfig) -> Optimizer:
    def init(params: List[torch.Tensor]):
        return {"mom": [torch.zeros(p.shape, dtype=F32, device=p.device)
                        for p in params]}

    @torch.no_grad()
    def apply(grads, state, params, step):
        lr = lr_at(cfg, step)
        for leaf in zip(params, state["mom"], grads):
            for p, m, g in zip(*map(tree.leaf_slices, leaf)):
                m.mul_(cfg.momentum).add_(g)
                p.copy_(p.float() - lr * m)

    return Optimizer(cfg, init, apply)


def _make_adamw(cfg: OptimConfig) -> Optimizer:
    def init(params: List[torch.Tensor]):
        return {"m": [torch.zeros(p.shape, dtype=F32, device=p.device)
                      for p in params],
                "v": [torch.zeros(p.shape, dtype=F32, device=p.device)
                      for p in params],
                "master": [p.detach().to(F32, copy=True) for p in params]}

    @torch.no_grad()
    def apply(grads, state, params, step):
        lr = lr_at(cfg, step)
        bc1 = 1 - cfg.b1 ** (step + 1)
        bc2 = 1 - cfg.b2 ** (step + 1)
        for leaf in zip(params, grads, state["m"], state["v"], state["master"]):
            for p, g, m, v, w in zip(*map(tree.leaf_slices, leaf)):
                m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
                v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
                u = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
                if cfg.weight_decay:
                    u.add_(w, alpha=cfg.weight_decay)
                w.sub_(lr * u)
                p.copy_(w)

    return Optimizer(cfg, init, apply)


def make_optimizer(cfg: OptimConfig) -> Optimizer:
    if cfg.name == "sgd":
        return _make_sgd(cfg)
    if cfg.name == "adamw":
        return _make_adamw(cfg)
    if cfg.name == "adam8bit":
        raise NotImplementedError("optimizer 'adam8bit' is not ported yet "
                                  "(ROADMAP)")
    raise ValueError(f"unknown optimizer {cfg.name!r}")
