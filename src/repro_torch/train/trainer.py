"""Training loop of the port.  Counterpart of ``repro/train/trainer.py``.

A single-process ``Trainer``: each step's batch is the (seed, step)-keyed
batch of the config's data source (synthetic or ``memmap:<path>``), the
noise generator is seeded from (seed, step), the privacy accountant prices
q = B/N, and every ``log_every`` steps (and the last) a record goes to
``history``.  Under ``dp.sampling="poisson"`` the batch is a Poisson sample
padded to a step-invariant ``capacity`` with its ``"mask"``, and the noisy
sum is normalised by the expected batch q·N.  Under ``dp.augmult = K``
the sampled batch is expanded to K views of each example after sampling
(``augment_expand``): the physical rows are K times the examples, and the
privacy unit stays the example.  Under ``dp.adaptive_clip`` the clip norm
is state: the optimizer state is ``{"opt": ..., "clip": {"clip_norm":
C}}``, as in the JAX package, so a checkpoint carries it, each step's
gradient function reads C and makes the next, and the accountant composes
the noisy below-C count beside the gradient mechanism (each logged step
gives the total ε and the two mechanisms' own).  The model trains under
the config's ``remat`` policy, which the Trainer sets on it.

Fault tolerance, as in the JAX package:

* **Checkpoints** (``train/checkpoint.py``, the JAX package's layout):
  ``run`` saves every ``ckpt_every`` steps and at the last, and waits for
  the write at its end; ``restore_or_init`` resumes from the latest one.
  The data and the noise are (seed, step)-keyed, so a resumed run takes
  the steps the uninterrupted one would have taken, bit for bit.
* **Preemption**: SIGTERM or SIGINT lets the step in flight finish, saves,
  and leaves ``run``.
* **Retries**: a step that raises is tried again, three attempts in all.
  The JAX package keeps the last good state because its step is a pure
  function; the port's optimizer updates params and state in place, so a
  retry is only sound while the update has not begun.  The gradient
  function (both passes and the noise) only reads the state, so a failure
  there is retried and the retry is bit-identical; a failure raised from
  the update itself is raised at once, since the state is no longer the
  last good one.  ``inject_failure_at`` raises once at that step, before
  the step (``inject_inside_step=False``) or inside the gradient function
  (the first forward after pass 1; see ``_injected_loss_fn``).
* **Straggler watchdog**: a step slower than ``watchdog_factor`` times the
  median of the last 50 is logged.

Not ported (ROADMAP queue 1): the memory planner, the launch autotuner,
gradient compression and pipeline stages (``configs/base.py`` raises on
their keys).
"""
from __future__ import annotations

import math
import signal
import time
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import adaptive_clip as aclip
from repro_torch.core.accountant import PrivacyAccountant
from repro_torch.core.algo import algo_is_private, make_noisy_grad_fn
from repro_torch.data.pipeline import (augment_expand, batch_for, make_source,
                                       poisson_batch_for, poisson_capacity)
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.state import TrainState


def adaptive_clip_on(dp) -> bool:
    """Adaptive clipping is live when configured and the algorithm is
    private (plain SGD has no clip norm to adapt)."""
    return bool(dp.adaptive_clip) and algo_is_private(dp.algo, dp.enabled)


def physical_batch_size(train_cfg: TrainConfig, shape: ShapeConfig,
                        dataset_size: int, shards: int = 1) -> int:
    """Physical (padded) examples per step.  Fixed sampling: the configured
    batch.  Poisson: a step-invariant capacity >= the expected size q·N
    (+6 binomial sigmas), rounded so that ``grad_accum`` chunks of
    ``dp.microbatch`` examples and ``shards`` keep dividing it.  Under
    ``dp.augmult = K`` the physical rows are K times this."""
    if train_cfg.dp.sampling != "poisson":
        return shape.global_batch
    mult = math.lcm(max(1, train_cfg.grad_accum)
                    * max(1, train_cfg.dp.microbatch), max(1, shards))
    return poisson_capacity(shape.global_batch,
                            shape.global_batch / dataset_size, multiple=mult)


class Trainer:
    """``Trainer(model, train_cfg, shape)``; ``model`` is a model of the
    port (``models.build_model_for``) whose params the Trainer makes
    trainable and updates in place, and whose ``remat`` it sets to the
    config's.  Its parameter and compute types must be the config's.
    ``source`` replaces the data source ``cfg.data_source`` names."""

    def __init__(self, model, train_cfg: TrainConfig, shape: ShapeConfig,
                 inject_failure_at: Optional[int] = None,
                 inject_inside_step: bool = False, source=None):
        self.model = model
        self.cfg = train_cfg
        self.shape = shape
        self.device = model.device
        for name, got in (("param_dtype", model.param_dtype),
                          ("compute_dtype", model.dtype)):
            want = getattr(train_cfg, name)
            if got != getattr(torch, want, None):
                raise ValueError(f"the model's {name} is {got}, the config "
                                 f"asks for {name}={want!r}")
        self.sampling = train_cfg.dp.sampling
        if self.sampling not in ("fixed", "poisson"):
            raise ValueError(f"unknown dp.sampling {self.sampling!r}; the "
                             f"port takes 'fixed' and 'poisson'")
        model.requires_grad_(True)
        model.remat = train_cfg.remat
        # ``source``: a data source in place of ``cfg.data_source``'s (a
        # synthetic one of another dataset size N prices another q = B/N)
        self.source = source or make_source(train_cfg.data_source,
                                            model.arch.vocab, train_cfg.seed)
        self.sample_rate = shape.global_batch / self.source.dataset_size
        self.capacity = physical_batch_size(train_cfg, shape,
                                            self.source.dataset_size)
        self.inject_failure_at = inject_failure_at
        self.inject_inside_step = inject_inside_step
        self._injected = False
        self._step_in_flight: Optional[int] = None
        loss_fn = model.loss_fn
        if inject_failure_at is not None and inject_inside_step:
            loss_fn = self._injected_loss_fn(loss_fn)
        # Poisson: the lot size q·N, never the capacity or the realized draw
        expected = (float(shape.global_batch) if self.sampling == "poisson"
                    else None)
        self.grad_fn = make_noisy_grad_fn(loss_fn, train_cfg.dp,
                                          grad_accum=train_cfg.grad_accum,
                                          expected_batch_size=expected)
        self.opt = make_optimizer(train_cfg.optim)
        self.ckpt = CheckpointManager(train_cfg.ckpt_dir,
                                      keep=train_cfg.ckpt_keep,
                                      use_async=train_cfg.ckpt_async)
        self.accountant = PrivacyAccountant(
            batch_size=shape.global_batch,
            dataset_size=self.source.dataset_size,
            noise_multiplier=train_cfg.dp.noise_multiplier,
            delta=train_cfg.dp.delta, sample_rate=self.sample_rate)
        # the noisy below-C count is a second mechanism at the same rate
        self.adaptive_clip = adaptive_clip_on(train_cfg.dp)
        if self.adaptive_clip:
            self.accountant.compose(aclip.mechanism(train_cfg.dp,
                                                    self.sample_rate))
        self._preempted = False
        self._step_times: list = []
        self.history: list = []

    def _injected_loss_fn(self, loss_fn):
        """``loss_fn`` that raises once, in step ``inject_failure_at``, on
        the first forward after pass 1: pass 2 of ``dpsgd_r`` (a plain-mode
        forward); ``sgd`` and ``dpsgd``, which have no norm pass, at their
        first forward, and ``dpsgd_r1f``, whose one forward is pass 1's, at
        it.  Either way inside the gradient function, before the update."""
        mode = "norm" if self.cfg.dp.algo == "dpsgd_r1f" else "off"

        def wrapped(params, batch, ctx):
            if (self._step_in_flight == self.inject_failure_at
                    and not self._injected and ctx.mode == mode):
                self._injected = True
                raise RuntimeError("injected transient failure inside the step")
            return loss_fn(params, batch, ctx)
        return wrapped

    # -- lifecycle ---------------------------------------------------------
    def init_state(self) -> TrainState:
        params = self.model.params
        opt_state = self.opt.init(tree.leaves(params))
        if self.adaptive_clip:
            opt_state = {"opt": opt_state, aclip.CLIP_STATE_KEY:
                         aclip.init_state(self.cfg.dp, self.device)}
        return TrainState(step=0, params=params, opt_state=opt_state)

    def optimizer_state(self, state: TrainState):
        """The optimizer's own part of ``state.opt_state`` (without the
        adaptive clip rider)."""
        return state.opt_state["opt"] if self.adaptive_clip else state.opt_state

    def clip_norm(self, state: TrainState):
        """The step's clip norm: the adaptive state's 0-d tensor, else None
        (``dp.clip_norm``)."""
        if not self.adaptive_clip:
            return None
        return state.opt_state[aclip.CLIP_STATE_KEY]["clip_norm"]

    def restore_or_init(self) -> TrainState:
        """The latest checkpoint in ``ckpt_dir``, restored into the model's
        params and a fresh optimizer state in place, or the init."""
        state = self.init_state()
        if self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(state)
            print(f"[trainer] restored step {state.step} from "
                  f"{self.cfg.ckpt_dir}", flush=True)
        return state

    def _handle_preempt(self, signum, frame):
        self._preempted = True

    def make_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The step's (seed, step)-keyed batch, on the model's device; under
        Poisson sampling ``self.capacity`` examples with a ``"mask"`` leaf;
        under ``dp.augmult = K`` each example's K views (rows b-major /
        k-minor), made after sampling."""
        if self.sampling == "poisson":
            batch = poisson_batch_for(self.source, self.model.arch, self.shape,
                                      step, capacity=self.capacity,
                                      sample_rate=self.sample_rate)
        else:
            batch = batch_for(self.source, self.model.arch, self.shape, step)
        batch = augment_expand(batch, self.cfg.dp.augmult, self.cfg.seed, step)
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    def noise_generator(self, step: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        # 32 bits: the CPU generator keeps only the low 32 bits of a seed
        g.manual_seed(zlib.crc32(f"{self.cfg.seed}:{step}:noise".encode()))
        return g

    def gradients(self, state: TrainState, batch):
        """The step's noised gradients and metrics; reads ``state`` only."""
        self._step_in_flight = state.step
        grads, metrics = self.grad_fn(state.params, batch,
                                      self.noise_generator(state.step),
                                      clip_norm=self.clip_norm(state))
        metrics["update_norm"] = torch.sqrt(sum((g * g).sum() for g in grads))
        return grads, metrics

    def update(self, state: TrainState, grads, metrics) -> None:
        """The optimizer step and the next clip norm, in place on
        ``state``."""
        self.opt.apply(grads, self.optimizer_state(state),
                       tree.leaves(state.params), state.step)
        if self.adaptive_clip:
            self.clip_norm(state).copy_(metrics["clip_norm_next"])
        state.step += 1

    def train_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """One step in place on ``state``; returns the metrics (0-d tensors,
        not yet synchronised)."""
        grads, metrics = self.gradients(state, batch)
        self.update(state, grads, metrics)
        return metrics

    def _step_with_retries(self, state: TrainState, batch):
        """``train_step`` with up to two retries of a failure in the
        gradient function, which leaves ``state`` as it was; a failure in
        the update is raised at once.  Returns the metrics as floats."""
        for attempt in range(3):
            try:
                if (self.inject_failure_at == state.step
                        and not self.inject_inside_step and not self._injected):
                    self._injected = True
                    raise RuntimeError("injected transient failure")
                grads, metrics = self.gradients(state, batch)
                break
            except RuntimeError as e:
                if attempt == 2:
                    raise
                print(f"[trainer] step {state.step} attempt {attempt} failed: "
                      f"{e}; retrying", flush=True)
        self.update(state, grads, metrics)
        return {k: float(v) for k, v in metrics.items()}   # waits for the step

    # -- loop ---------------------------------------------------------------
    def run(self, state: TrainState, steps: Optional[int] = None,
            install_signals: bool = True) -> TrainState:
        """Steps ``state.step .. steps - 1`` (default ``cfg.steps``),
        checkpointing every ``ckpt_every`` steps, at the last, and on
        preemption."""
        cfg = self.cfg
        steps = cfg.steps if steps is None else steps
        old_handlers = {}
        if install_signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                old_handlers[sig] = signal.signal(sig, self._handle_preempt)
        try:
            for step in range(state.step, steps):
                batch = self.make_batch(step)
                t0 = time.perf_counter()
                rec = self._step_with_retries(state, batch)
                dt = time.perf_counter() - t0
                self._watchdog(step, dt)
                if (step + 1) % cfg.log_every == 0 or step == steps - 1:
                    eps = self.accountant.epsilon_at(step + 1)
                    rec.update(step=step, sec=dt, epsilon=eps,
                               expected_batch=self.shape.global_batch)
                    eps_str = f"eps {eps:.3f}"
                    if len(self.accountant.mechanisms) > 1:
                        # each mechanism's own epsilon beside the total
                        bd = self.accountant.epsilon_breakdown(step + 1)
                        rec.update(bd)
                        parts = " ".join(f"{k[4:]} {v:.3f}" for k, v in
                                         bd.items() if k != "eps_total")
                        eps_str = f"eps {bd['eps_total']:.3f} ({parts})"
                    self.history.append(rec)
                    realized = ""
                    if self.sampling == "poisson":
                        realized = (f"B {rec['realized_batch']:.0f} of capacity "
                                    f"{self.capacity} ")
                    clip = ""
                    if self.adaptive_clip:
                        clip = (f"clip_norm {rec['clip_norm']:.4f} -> "
                                f"{rec['clip_norm_next']:.4f} ")
                    print(f"[trainer] step {step:5d} loss {rec['loss']:.4f} "
                          f"{eps_str} {realized}{clip}({dt * 1e3:.0f} ms)",
                          flush=True)
                if ((step + 1) % cfg.ckpt_every == 0 or step == steps - 1
                        or self._preempted):
                    self.ckpt.save(state, step + 1)
                if self._preempted:
                    print(f"[trainer] preempted at step {step}; checkpoint "
                          f"saved, exiting", flush=True)
                    break
            self.ckpt.wait()
            return state
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)

    def _watchdog(self, step: int, dt: float) -> None:
        self._step_times.append(dt)
        hist = self._step_times[-50:]
        med = float(np.median(hist))
        if len(hist) >= 5 and dt > self.cfg.watchdog_factor * med:
            print(f"[trainer] WATCHDOG straggler: step {step} took "
                  f"{dt:.2f}s (median {med:.2f}s)", flush=True)
