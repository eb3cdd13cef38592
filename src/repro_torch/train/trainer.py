"""Training loop of the port.  Counterpart of ``repro/train/trainer.py``.

A single-process ``Trainer``: each step's batch is the (seed, step)-keyed
synthetic batch, the noise generator is seeded from (seed, step), the
privacy accountant prices q = B/N, and every ``log_every`` steps (and the
last) a record goes to ``history``.  Under ``dp.sampling="poisson"`` the
batch is a Poisson sample padded to a step-invariant ``capacity`` with its
``"mask"``, and the noisy sum is normalised by the expected batch q·N.

The model trains under the config's ``remat`` policy, which the Trainer
sets on it.

Not ported (ROADMAP queue 1): checkpoints (a run always starts from its
init), the memory planner, the launch autotuner, gradient compression,
pipeline stages, retries, the straggler watchdog and separate parameter
and compute types.  ``TrainConfig`` has no fields for these, or raises on
them (``configs/base.py``).
"""
from __future__ import annotations

import math
import time
import zlib
from typing import Dict, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core.accountant import PrivacyAccountant
from repro_torch.core.algo import make_noisy_grad_fn
from repro_torch.data.pipeline import (batch_for, make_source,
                                       poisson_batch_for, poisson_capacity)
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.state import TrainState


def physical_batch_size(train_cfg: TrainConfig, shape: ShapeConfig,
                        dataset_size: int, shards: int = 1) -> int:
    """Physical (padded) examples per step.  Fixed sampling: the configured
    batch.  Poisson: a step-invariant capacity >= the expected size q·N
    (+6 binomial sigmas), rounded so that ``grad_accum`` chunks of
    ``dp.microbatch`` examples and ``shards`` keep dividing it."""
    if train_cfg.dp.sampling != "poisson":
        return shape.global_batch
    mult = math.lcm(max(1, train_cfg.grad_accum)
                    * max(1, train_cfg.dp.microbatch), max(1, shards))
    return poisson_capacity(shape.global_batch,
                            shape.global_batch / dataset_size, multiple=mult)


class Trainer:
    """``Trainer(model, train_cfg, shape)``; ``model`` is a
    ``repro_torch.models.transformer.Model`` whose params the Trainer makes
    trainable and updates in place, and whose ``remat`` it sets to the
    config's."""

    def __init__(self, model, train_cfg: TrainConfig, shape: ShapeConfig):
        self.model = model
        self.cfg = train_cfg
        self.shape = shape
        self.device = model.device
        if train_cfg.param_dtype != train_cfg.compute_dtype:
            raise NotImplementedError(
                f"param_dtype={train_cfg.param_dtype!r} with compute_dtype="
                f"{train_cfg.compute_dtype!r}: separate parameter and "
                f"compute types are not ported yet (ROADMAP queue 1)")
        if model.dtype != getattr(torch, train_cfg.param_dtype, None):
            raise ValueError(f"the model is {model.dtype}, the config asks "
                             f"for param_dtype={train_cfg.param_dtype!r}")
        self.sampling = train_cfg.dp.sampling
        if self.sampling not in ("fixed", "poisson"):
            raise ValueError(f"unknown dp.sampling {self.sampling!r}; the "
                             f"port takes 'fixed' and 'poisson'")
        model.requires_grad_(True)
        model.remat = train_cfg.remat
        self.source = make_source(train_cfg.data_source, model.arch.vocab,
                                  train_cfg.seed)
        self.sample_rate = shape.global_batch / self.source.dataset_size
        self.capacity = physical_batch_size(train_cfg, shape,
                                            self.source.dataset_size)
        # Poisson: the lot size q·N, never the capacity or the realized draw
        expected = (float(shape.global_batch) if self.sampling == "poisson"
                    else None)
        self.grad_fn = make_noisy_grad_fn(model.loss_fn, train_cfg.dp,
                                          grad_accum=train_cfg.grad_accum,
                                          expected_batch_size=expected)
        self.opt = make_optimizer(train_cfg.optim)
        self.accountant = PrivacyAccountant(
            batch_size=shape.global_batch,
            dataset_size=self.source.dataset_size,
            noise_multiplier=train_cfg.dp.noise_multiplier,
            delta=train_cfg.dp.delta, sample_rate=self.sample_rate)
        self.history: list = []

    def init_state(self) -> TrainState:
        params = self.model.params
        return TrainState(step=0, params=params,
                          opt_state=self.opt.init(tree.leaves(params)))

    def make_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The step's (seed, step)-keyed batch, on the model's device; under
        Poisson sampling ``self.capacity`` rows with a ``"mask"`` leaf."""
        if self.sampling == "poisson":
            batch = poisson_batch_for(self.source, self.model.arch, self.shape,
                                      step, capacity=self.capacity,
                                      sample_rate=self.sample_rate)
        else:
            batch = batch_for(self.source, self.model.arch, self.shape, step)
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def noise_generator(self, step: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        # 32 bits: the CPU generator keeps only the low 32 bits of a seed
        g.manual_seed(zlib.crc32(f"{self.cfg.seed}:{step}:noise".encode()))
        return g

    def train_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """One step in place on ``state``; returns the metrics (0-d tensors,
        not yet synchronised)."""
        grads, metrics = self.grad_fn(state.params, batch,
                                      self.noise_generator(state.step))
        metrics["update_norm"] = torch.sqrt(sum((g * g).sum() for g in grads))
        self.opt.apply(grads, state.opt_state, tree.leaves(state.params),
                       state.step)
        state.step += 1
        return metrics

    def run(self, state: TrainState, steps: Optional[int] = None) -> TrainState:
        """Steps ``state.step .. steps - 1`` (default ``cfg.steps``)."""
        cfg = self.cfg
        steps = cfg.steps if steps is None else steps
        for step in range(state.step, steps):
            batch = self.make_batch(step)
            t0 = time.perf_counter()
            metrics = self.train_step(state, batch)
            rec = {k: float(v) for k, v in metrics.items()}   # waits for the step
            dt = time.perf_counter() - t0
            if (step + 1) % cfg.log_every == 0 or step == steps - 1:
                eps = self.accountant.epsilon_at(step + 1)
                rec.update(step=step, sec=dt, epsilon=eps,
                           expected_batch=self.shape.global_batch)
                self.history.append(rec)
                realized = ""
                if self.sampling == "poisson":
                    realized = (f"B {rec['realized_batch']:.0f} of capacity "
                                f"{self.capacity} ")
                print(f"[trainer] step {step:5d} loss {rec['loss']:.4f} "
                      f"eps {eps:.3f} {realized}({dt * 1e3:.0f} ms)", flush=True)
        return state
