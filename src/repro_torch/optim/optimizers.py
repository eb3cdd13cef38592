"""Optimizers.  Counterpart of ``repro/optim/optimizers.py``.

* ``sgd``      — SGD with momentum.
* ``adamw``    — AdamW with a float32 master copy and float32 moments.
* ``adam8bit`` — AdamW with blockwise absmax int8 moments (float32 scale a
  block of ``block_size`` elements of the flattened leaf) and no master
  copy: about 2 bytes a parameter of state where AdamW takes 12.  The JAX
  package runs it as plain XLA, so plain PyTorch is its counterpart.

All share ``init(params) -> state`` and ``apply(grads, state, params,
step)``, where ``params`` and ``grads`` are lists aligned leaf by leaf
(``tree.leaves``) and the gradients arrive noised and averaged (float32).
Unlike the JAX package's functional version, ``apply`` updates the state
and the params in place: at full width the AdamW state is 12 bytes a
parameter, and a second copy of it would not fit beside the first.  It
also updates one slice of a leaf's leading (stacked-layer) dimension at a
time (``tree.leaf_slices``), so its float32 temporaries take a slice's
size and not a stacked leaf's; the arithmetic is elementwise, so the bits
are those of the whole-leaf update.  ``adam8bit``'s slices hold whole
quantization blocks (``block_slices``), so its scales are the whole-leaf
update's too.
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


def n_blocks(numel: int, bs: int) -> int:
    return -(-numel // bs)


def block_slices(t: torch.Tensor, bs: int, max_elems: int = tree.SLICE_ELEMS):
    """``(start, stop)`` element ranges of ``t`` flattened, cut along its
    leading dim as ``tree.leaf_slices`` cuts it, but only where a range
    starts on a multiple of ``bs``: every range but the last holds whole
    quantization blocks, and the last ends at the leaf's end.  Where no
    row count is a multiple of the block (a width that ``bs`` does not
    divide) it takes as few rows as keep the cut on a block edge, or the
    whole leaf."""
    n = t.numel()
    if t.dim() < 2 or n == 0:
        return [(0, n)]
    row = t[0].numel()
    step = bs // math.gcd(row, bs)          # rows whose elements fill blocks
    rows = max(step, (max(1, max_elems // max(1, row)) // step) * step)
    if rows >= t.shape[0]:
        return [(0, n)]
    return [(r * row, min(t.shape[0], r + rows) * row)
            for r in range(0, t.shape[0], rows)]


def _dequantize(q: torch.Tensor, s: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` elements of blocks ``q`` (nb, bs) int8 scaled by
    ``s`` (nb,), flattened, in float32."""
    return (q.to(F32) * s[:, None]).reshape(-1)[:n]


def _quantize_into(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    """Blockwise absmax int8 of flat ``x`` into blocks ``q`` and scales
    ``s`` in place; the last block's tail past ``x`` is zero."""
    nb, bs = q.shape
    flat = x if x.numel() == nb * bs else torch.nn.functional.pad(
        x, (0, nb * bs - x.numel()))
    flat = flat.reshape(nb, bs)
    scale = flat.abs().amax(dim=1) / 127.0
    q.copy_(torch.round(flat / torch.clamp(scale, min=1e-30)[:, None]))
    s.copy_(scale)


def _make_adam8bit(cfg: OptimConfig) -> Optimizer:
    bs = cfg.block_size

    def init(params: List[torch.Tensor]):
        def zq(p):
            nb = n_blocks(p.numel(), bs)
            return {"q": torch.zeros((nb, bs), dtype=torch.int8, device=p.device),
                    "s": torch.zeros((nb,), dtype=F32, device=p.device)}
        return {"m": [zq(p) for p in params], "v": [zq(p) for p in params]}

    @torch.no_grad()
    def apply(grads, state, params, step):
        lr = lr_at(cfg, step)
        bc1 = 1 - cfg.b1 ** (step + 1)
        bc2 = 1 - cfg.b2 ** (step + 1)
        for p, g, mq, vq in zip(params, grads, state["m"], state["v"]):
            pf, gf = p.view(-1), g.view(-1)
            for a, b in block_slices(p, bs):
                blk = slice(a // bs, n_blocks(b, bs))
                gs = gf[a:b]
                m = _dequantize(mq["q"][blk], mq["s"][blk], b - a)
                m = m.mul_(cfg.b1).add_(gs, alpha=1 - cfg.b1)
                v = _dequantize(vq["q"][blk], vq["s"][blk], b - a)
                v = v.mul_(cfg.b2).addcmul_(gs, gs, value=1 - cfg.b2)
                u = (m / bc1).div_(torch.sqrt(torch.clamp(v, min=0.0) / bc2)
                                   .add_(cfg.eps))
                w = pf[a:b].to(F32)
                if cfg.weight_decay:
                    u.add_(w, alpha=cfg.weight_decay)
                pf[a:b] = w.sub_(lr * u)
                _quantize_into(m, mq["q"][blk], mq["s"][blk])
                _quantize_into(v, vq["q"][blk], vq["s"][blk])

    return Optimizer(cfg, init, apply)


def make_optimizer(cfg: OptimConfig) -> Optimizer:
    if cfg.name == "sgd":
        return _make_sgd(cfg)
    if cfg.name == "adamw":
        return _make_adamw(cfg)
    if cfg.name == "adam8bit":
        return _make_adam8bit(cfg)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
