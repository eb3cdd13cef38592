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

Memory plan (``MemConfig``, ``launch/memory.py``): under
``mem.auto_microbatch`` with a budget the Trainer picks the largest
microbatch (smallest ``grad_accum``) whose estimated peak fits
``mem.hbm_budget_bytes`` before it sizes the Poisson capacity, as the JAX
Trainer does; ``memory_report`` gives the estimate and, on the card, the
measured peak beside it.  The step itself is ``TrainStep``, the one
function the Trainer runs and the estimator traces.

Distribution (``mesh``, dist/): the launcher activates the data-parallel
layout (``dist.runtime.layout``) and gives the Trainer its mesh.  Each rank
makes the global (seed, step)-keyed batch and takes its contiguous,
example-aligned slice of rows (the K views of an example stay on one
rank); a Poisson capacity is rounded to a multiple of the batch-axis width
(``physical_batch_size``).  The gradient function all-reduces the clipped
sum (core/algo.py), so every rank holds the same noised gradient.  Under
``zero1`` the optimizer-state leaves that ``dist.sharding.state_shardings``
places on the ``data`` axis are held as this rank's slice: the optimizer
updates the matching slice of each param, and the slices are all-gathered
into the whole param.  ``adam8bit``'s int8 blocks and scales stay whole,
as the reference leaves them replicated.  ``compress_pod_grads`` sends the
noised gradient through the int8 error-feedback codec
(``dist.compress``) before the optimizer, its residual riding in the
optimizer state as ``{"opt": ..., "grad_err": [...]}``, whole on every
rank (the codec's blocks span the flattened leaf).  Checkpoints are
written by every rank, each its own shards (train/checkpoint.py).

FSDP (a ``use_fsdp`` model built on the mesh, ``Model(mesh=...)``): each
sharded param is this rank's slice (``fsdp_shard``), which is also its
ZeRO-1 slice (``spec_for_param(fsdp=True)`` places both), so the
optimizer state of such a leaf is the slice's, the gradient function gives
the slice's summed gradient, the optimizer updates the slice in place and
nothing is gathered back.  ``update_norm`` sums the slices' squares over
the ranks.  ``compress_pod_grads`` and ``adam8bit`` are refused with FSDP
(``fsdp_refusal``): their int8 blocks span the flattened whole leaf.

Tensor parallel (a model built on a mesh with a ``model`` axis above 1):
each model slice (``model_shard``) is a param of its own here, with its
own optimizer state; ZeRO-1 places that state by the whole leaf's axes
and cuts the rank's model-local leaf along its ``data`` dim.
``update_norm`` sums the slices' squares over the ``model`` group.  In a
checkpoint each model rank writes its slices (and their state) from its
first data replica; the int8 riders are refused here too.

Pipeline stages across processes (a model built on a mesh with a
``stage`` axis above 1): each rank's blocks slice (``stage_shard``) is a
param of its own, with its own optimizer state, placed under ZeRO-1 by the
whole leaf's axes as a model slice's is; the leaves every stage rank holds
whole get the same noised gradient on every one of them, so they stay
alike.  ``update_norm`` sums the slices' squares over the ``stage`` group
and counts the whole leaves once.  In a checkpoint each stage rank writes
its blocks' region of the ``layers`` dim (and its state) from its first
data replica, and rank 0 the whole leaves; the int8 riders are refused
here too.

Launch plans (``plan``, launch/autotune.py): a solved ``LaunchPlan`` is
applied onto the config up front and takes the place of the
auto-microbatch search (the one-dimensional case of the plan space), as in
the JAX Trainer.  The Trainer sets the remat policy on the model, so the
model must only have been built for the plan's ``pp_stages``.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.dist import compress, runtime, sharding
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


def fsdp_refusal(cfg: TrainConfig) -> str:
    """Why ``cfg`` cannot train FSDP-sharded params, tensor-parallel model
    slices or pipeline stage slices, naming ROADMAP; "" when it can.  Both int8 codecs
    quantize in blocks of the flattened whole leaf, so on a slice they
    would compute something other than the reference."""
    parts = [what for what, on in (
        ("compress_pod_grads", cfg.compress_pod_grads),
        ("optim.name='adam8bit'", cfg.optim.name == "adam8bit")) if on]
    if not parts:
        return ""
    return (f"{' and '.join(parts)} with FSDP-sharded params, "
            f"tensor-parallel model slices or pipeline stage slices is not "
            f"ported: the int8 blocks "
            f"span the flattened whole leaf, and a rank holds a slice of it "
            f"(ROADMAP queue 1)")


# the process group over which the other slices of a param cut along each
# axis lie (``runtime.cut_of``)
_GROUPS = {"data": runtime.fsdp_group, sharding.MODEL_AXIS: runtime.model_group,
           sharding.STAGE_AXIS: runtime.stage_group}


def _sliced(p) -> bool:
    return runtime.cut_of(p) is not None


def _whole_shape(p):
    """A param's whole leaf's shape (a model or stage slice's, its
    leaf's)."""
    sh = runtime.model_shard_of(p) or runtime.stage_shard_of(p)
    shape = list(p.shape)
    if sh is not None:
        shape[sh.dim] = sh.size
    return shape


class TrainStep:
    """One optimizer step of ``train_cfg`` on ``model``: the function
    ``Trainer.train_step`` runs and ``launch/memory.py`` traces (the
    counterpart of the JAX package's ``make_train_step``).  ``gradients``
    makes the noised gradients and metrics and only reads the state;
    ``update`` compresses them (``compress_pod_grads``), takes the
    optimizer step and the next clip norm in place.  ``loss_fn`` replaces
    ``model.loss_fn`` (the Trainer's fault injection).
    ``expected_batch_size``: the private update's normaliser under Poisson
    sampling (q·N), None for fixed batches.  ``mesh``: the device mesh,
    whose ``data`` axis ZeRO-1 (``zero1``) shards the optimizer state over
    (None: one process, nothing sharded).  The params' own FSDP slices
    (``fsdp_shard``) are the model's."""

    def __init__(self, model, train_cfg: TrainConfig,
                 expected_batch_size: Optional[float] = None, loss_fn=None,
                 mesh=None):
        self.model = model
        self.dp = train_cfg.dp
        self.adaptive_clip = adaptive_clip_on(train_cfg.dp)
        self.compress = train_cfg.compress_pod_grads
        self.grad_fn = make_noisy_grad_fn(loss_fn or model.loss_fn,
                                          train_cfg.dp,
                                          grad_accum=train_cfg.grad_accum,
                                          expected_batch_size=expected_batch_size)
        self.opt = make_optimizer(train_cfg.optim)
        self.cfg = train_cfg
        self.mesh = mesh
        self.zero1 = train_cfg.zero1
        # ZeRO-1: per param leaf, (dim, index, count) of this rank's slice
        # of its optimizer state, or None (whole, or an FSDP slice already);
        # set by init_state
        self.shards: Optional[list] = None
        self.data_group = None

    def _leaf_shards(self, n: int) -> list:
        return self.shards or [None] * n

    def _zero1_shards(self, leaves):
        """The ZeRO-1 slice of each param leaf's optimizer state: where
        ``state_shardings`` places the optimizer's state of a leaf on the
        ``data`` axis (every param-shaped state leaf of it alike), this
        rank's slice of that dim, else None.  The placements are of the
        whole leaves (a model or stage slice's is its leaf's), and such a
        slice's state is cut along the same dim of the slice."""
        none = [None] * len(leaves)
        if self.mesh is None or not self.zero1:
            return none
        index, count, self.data_group = runtime.axis_shard(self.mesh, "data")
        if count == 1:
            return none
        meta = [torch.empty(_whole_shape(p), dtype=p.dtype, device="meta")
                for p in leaves]
        specs = sharding.state_shardings(
            self.mesh, self.model,
            TrainState(step=0, params=None, opt_state=self.opt.init(meta)))
        dims = list(none)
        for part in specs.opt_state.values():
            if isinstance(part, list) and len(part) == len(leaves):
                for i, spec in enumerate(part):
                    if isinstance(spec, sharding.PartitionSpec) and "data" in spec:
                        dims[i] = spec.index("data")
        return [None if d is None or runtime.fsdp_shard_of(p) is not None
                else (d, index, count) for d, p in zip(dims, leaves)]

    @staticmethod
    def _slice(t, shard):
        """The view of ``t`` a ZeRO-1 ``shard`` owns (``t`` when None)."""
        if shard is None:
            return t
        d, index, count = shard
        n = t.shape[d] // count
        return t.narrow(d, index * n, n)

    def init_state(self, params, device) -> TrainState:
        """Step 0: ``params`` and a fresh optimizer state beside them (this
        rank's ZeRO-1 slices, an FSDP slice's own; the compression and
        adaptive clip riders under their options).  Raises for a config
        FSDP-sharded params cannot train (``fsdp_refusal``)."""
        leaves = tree.leaves(params)
        reason = fsdp_refusal(self.cfg)
        if reason and any(_sliced(p) for p in leaves):
            raise NotImplementedError(reason)
        self.shards = self._zero1_shards(leaves)
        opt_state = self.opt.init([self._slice(p, sh)
                                   for p, sh in zip(leaves, self.shards)])
        riders = {}
        if self.compress:
            riders["grad_err"] = compress.init_error_state(leaves)
        if self.adaptive_clip:
            riders[aclip.CLIP_STATE_KEY] = aclip.init_state(self.dp, device)
        if riders:
            opt_state = {"opt": opt_state, **riders}
        return TrainState(step=0, params=params, opt_state=opt_state)

    def optimizer_state(self, state: TrainState):
        if self.adaptive_clip or self.compress:
            return state.opt_state["opt"]
        return state.opt_state

    def clip_norm(self, state: TrainState):
        if not self.adaptive_clip:
            return None
        return state.opt_state[aclip.CLIP_STATE_KEY]["clip_norm"]

    def ckpt_shards(self, state: TrainState) -> list:
        """Each leaf's layout for ``CheckpointManager``, aligned with
        ``checkpoint.flatten(state)``: ``(cuts, writes)`` for a leaf this
        rank holds a region of, ``cuts`` its ``(dim, index, count)`` cut
        along each sharded dim (an FSDP slice's; a model or stage slice's; a
        ZeRO-1 slice's of the state, beside its param's own cut) and ``writes``
        whether the rank is the region's first replica, the one that
        writes it (coordinate 0 on every axis above 1 that does not cut
        it); None for a whole leaf."""
        params = tree.leaves(state.params)

        def cut(sh):
            return () if sh is None else ((sh.dim, sh.index, sh.count),)
        own = [() if c is None else cut(c[0]) for c in map(runtime.cut_of, params)]
        zero1 = [() if z is None else (z,) for z in self._leaf_shards(len(params))]

        def layout(cuts, axes):
            """(cuts, writes) of a region cut over the mesh ``axes``."""
            if not cuts:
                return None
            writes = all(self.mesh.get_local_rank(a) == 0
                         for a in sharding._axis_names(self.mesh)
                         if a not in axes and sharding._axis_size(self.mesh, a) > 1)
            return cuts, writes

        def axes_of(p):
            c = runtime.cut_of(p)
            return set() if c is None else {c[1]}
        param_part = [layout(c, axes_of(p)) for c, p in zip(own, params)]
        state_part = [layout(c + z, axes_of(p) | ({"data"} if z else set()))
                      for c, z, p in zip(own, zero1, params)]

        def walk(t, shard=None):
            if isinstance(t, dict):
                return [x for k in sorted(t) for x in walk(t[k])]
            if isinstance(t, list) and len(t) == len(params):
                return [x for v, sh in zip(t, state_part) for x in walk(v, sh)]
            if isinstance(t, (list, tuple)):
                return [x for v in t for x in walk(v)]
            return [] if t is None else [shard]

        opt = state.opt_state
        if self.adaptive_clip or self.compress:     # the riders are whole
            opt_part = [x for k in sorted(opt) for x in (
                walk(opt[k]) if k == "opt" else [None] * len(tree.leaves(opt[k])))]
        else:
            opt_part = walk(opt)
        return [None] + param_part + opt_part

    def gradients(self, state: TrainState, batch, generator: torch.Generator):
        grads, metrics = self.grad_fn(state.params, batch, generator,
                                      clip_norm=self.clip_norm(state))
        metrics["update_norm"] = self._update_norm(grads, state)
        return grads, metrics

    @staticmethod
    def _update_norm(grads, state: TrainState):
        """‖update‖ of the whole gradient: an FSDP slice's squares are
        summed over the ranks that hold the other slices (the ``data``
        group), a model slice's over the ``model`` group, a stage slice's
        over the ``stage`` group; a whole leaf counts once."""
        params = tree.leaves(state.params)
        sq = [(g * g).sum() for g in grads]
        total = sum(q for q, p in zip(sq, params) if not _sliced(p))
        cuts = [runtime.cut_of(p) for p in params]
        for axis, group in _GROUPS.items():
            part = [q for q, c in zip(sq, cuts) if c is not None and c[1] == axis]
            if part:
                part = torch.stack(part).sum()
                runtime.all_reduce_([part], group())
                total = total + part
        return torch.sqrt(total)

    def update(self, state: TrainState, grads, metrics) -> None:
        if self.compress:
            err = state.opt_state["grad_err"]
            grads, new_err = compress.compress_grads(grads, err)
            for e, n in zip(err, new_err):
                e.copy_(n)
            metrics["update_norm"] = self._update_norm(grads, state)
        leaves = tree.leaves(state.params)
        shards = self._leaf_shards(len(leaves))
        self.opt.apply([self._slice(g, sh) for g, sh in zip(grads, shards)],
                       self.optimizer_state(state),
                       [self._slice(p, sh) for p, sh in zip(leaves, shards)],
                       state.step)
        with torch.no_grad():
            for p, sh in zip(leaves, shards):
                if sh is not None:          # the updated slices, whole again
                    d = sh[0]
                    part = self._slice(p, sh).movedim(d, 0)
                    p.copy_(runtime.all_gather(part, self.data_group).movedim(0, d))
        if self.adaptive_clip:
            self.clip_norm(state).copy_(metrics["clip_norm_next"])
        state.step += 1

    def __call__(self, state: TrainState, batch, generator: torch.Generator):
        grads, metrics = self.gradients(state, batch, generator)
        self.update(state, grads, metrics)
        return metrics


class Trainer:
    """``Trainer(model, train_cfg, shape)``; ``model`` is a model of the
    port (``models.build_model_for``) whose params the Trainer makes
    trainable and updates in place, and whose ``remat`` it sets to the
    config's.  Its parameter and compute types must be the config's.
    ``source`` replaces the data source ``cfg.data_source`` names.
    ``mesh``: the device mesh of a data-parallel run (the launcher's), whose
    batch-axis width the Poisson capacity is rounded to and whose ``data``
    axis ZeRO-1 shards over; the batch is sliced under the active
    ``dist.runtime.layout``.  ``plan``: a solved launch plan
    (launch/autotune.py ``LaunchPlan``), applied onto the config; it skips
    the auto-microbatch search."""

    def __init__(self, model, train_cfg: TrainConfig, shape: ShapeConfig,
                 inject_failure_at: Optional[int] = None,
                 inject_inside_step: bool = False, source=None, mesh=None,
                 plan=None):
        self.plan = plan
        if plan is not None:
            stages = getattr(model, "pp_stages", 1)
            if stages != plan.pp_stages:
                raise ValueError(
                    f"model was built with pp_stages={stages} but the launch "
                    f"plan says pp_stages={plan.pp_stages}; rebuild the model "
                    f"with the plan's stages")
            train_cfg = plan.apply(train_cfg)
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
        # the mesh's batch-axis width: a Poisson capacity stays divisible
        self.batch_multiple = 1 if mesh is None else sharding.batch_axis_width(mesh)
        # the memory plan: the largest microbatch whose estimated peak fits
        # the budget, picked before the capacity below so that Poisson's
        # lcm rounding sees the chosen grad_accum
        self.mem_estimate = None
        if plan is None and train_cfg.mem.auto_microbatch and \
                train_cfg.mem.hbm_budget_bytes > 0:
            from repro_torch.launch.memory import pick_grad_accum
            accum, est = pick_grad_accum(model, train_cfg, shape,
                                         dataset_size=self.source.dataset_size,
                                         shards=self.batch_multiple)
            if accum != train_cfg.grad_accum:
                print(f"[trainer] auto_microbatch: grad_accum "
                      f"{train_cfg.grad_accum} -> {accum} (estimated "
                      f"per-device peak "
                      f"{est['per_device_peak_bytes'] / 1e9:.3f} GB <= budget "
                      f"{train_cfg.mem.hbm_budget_bytes / 1e9:.3f} GB)",
                      flush=True)
            train_cfg = dataclasses.replace(train_cfg, grad_accum=accum)
            self.cfg = train_cfg
            self.mem_estimate = est
        self.sample_rate = shape.global_batch / self.source.dataset_size
        self.capacity = physical_batch_size(train_cfg, shape,
                                            self.source.dataset_size,
                                            shards=self.batch_multiple)
        self.inject_failure_at = inject_failure_at
        self.inject_inside_step = inject_inside_step
        self._injected = False
        self._step_in_flight: Optional[int] = None
        loss_fn = model.loss_fn
        if inject_failure_at is not None and inject_inside_step:
            loss_fn = self._injected_loss_fn(loss_fn)
        # Poisson: the lot size q·N, never the capacity or the realized draw
        self.expected_batch = (float(shape.global_batch)
                               if self.sampling == "poisson" else None)
        self.step_fn = TrainStep(model, train_cfg, self.expected_batch, loss_fn,
                                 mesh=mesh)
        self.ckpt = CheckpointManager(train_cfg.ckpt_dir,
                                      keep=train_cfg.ckpt_keep,
                                      use_async=train_cfg.ckpt_async)
        self.accountant = PrivacyAccountant(
            batch_size=shape.global_batch,
            dataset_size=self.source.dataset_size,
            noise_multiplier=train_cfg.dp.noise_multiplier,
            delta=train_cfg.dp.delta, sample_rate=self.sample_rate)
        # the noisy below-C count is a second mechanism at the same rate
        self.adaptive_clip = self.step_fn.adaptive_clip
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

    @property
    def opt(self):
        """The step's optimizer."""
        return self.step_fn.opt

    @opt.setter
    def opt(self, opt) -> None:
        self.step_fn.opt = opt

    # -- memory --------------------------------------------------------------
    def memory_report(self, state: TrainState, batch,
                      measure: bool = False) -> dict:
        """The estimated peak of one step of this Trainer's config at
        ``batch``'s shapes (``launch/memory.estimate_train_memory``, traced
        on fake tensors: nothing here changes).  With ``measure`` on a CUDA
        device, also one real ``train_step`` on ``state`` with the
        allocator's peak reset before it: ``measured_peak_bytes`` (its
        ``torch.cuda.max_memory_allocated``), ``estimate_vs_measured`` and
        the step's ``metrics``, the counterpart of the JAX Trainer's
        ``xla_*`` keys.  That step advances ``state`` as ``train_step``
        does."""
        from repro_torch.launch.memory import abstract_like, estimate_train_memory
        est = estimate_train_memory(self.model, self.cfg, abstract_like(batch),
                                    expected_batch_size=self.expected_batch)
        if measure and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            metrics = self.train_step(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}   # syncs
            peak = torch.cuda.max_memory_allocated(self.device)
            est.update(measured_peak_bytes=int(peak), metrics=metrics,
                       estimate_vs_measured=est["peak_bytes"] / max(peak, 1))
        return est

    # -- lifecycle ---------------------------------------------------------
    def init_state(self) -> TrainState:
        return self.step_fn.init_state(self.model.params, self.device)

    def optimizer_state(self, state: TrainState):
        """The optimizer's own part of ``state.opt_state`` (without the
        adaptive clip rider)."""
        return self.step_fn.optimizer_state(state)

    def clip_norm(self, state: TrainState):
        """The step's clip norm: the adaptive state's 0-d tensor, else None
        (``dp.clip_norm``)."""
        return self.step_fn.clip_norm(state)

    def restore_or_init(self) -> TrainState:
        """The latest checkpoint in ``ckpt_dir``, restored into the model's
        params and a fresh optimizer state in place, or the init."""
        state = self.init_state()
        if self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(state, shards=self.step_fn.ckpt_shards(state))
            print(f"[trainer] restored step {state.step} from "
                  f"{self.cfg.ckpt_dir}", flush=True)
        return state

    def _handle_preempt(self, signum, frame):
        self._preempted = True

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        """The step's (seed, step)-keyed batch of every rank, on the host;
        under Poisson sampling ``self.capacity`` examples with a ``"mask"``
        leaf; under ``dp.augmult = K`` each example's K views (rows b-major
        / k-minor), made after sampling."""
        if self.sampling == "poisson":
            batch = poisson_batch_for(self.source, self.model.arch, self.shape,
                                      step, capacity=self.capacity,
                                      sample_rate=self.sample_rate)
        else:
            batch = batch_for(self.source, self.model.arch, self.shape, step)
        return augment_expand(batch, self.cfg.dp.augmult, self.cfg.seed, step)

    def make_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """This rank's slice of ``global_batch`` on the model's device:
        under an active layout the rank's contiguous run of examples (with
        their K views), else the whole batch."""
        batch = self.global_batch(step)
        index, count = runtime.batch_shard()
        rows = len(next(iter(batch.values()))) // count
        return {k: torch.from_numpy(v[index * rows:(index + 1) * rows]).to(
            self.device) for k, v in batch.items()}

    def noise_generator(self, step: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        # 32 bits: the CPU generator keeps only the low 32 bits of a seed
        g.manual_seed(zlib.crc32(f"{self.cfg.seed}:{step}:noise".encode()))
        return g

    def gradients(self, state: TrainState, batch):
        """The step's noised gradients and metrics; reads ``state`` only."""
        self._step_in_flight = state.step
        return self.step_fn.gradients(state, batch,
                                      self.noise_generator(state.step))

    def update(self, state: TrainState, grads, metrics) -> None:
        """The optimizer step and the next clip norm, in place on
        ``state``."""
        self.step_fn.update(state, grads, metrics)

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
                    gnorm = (f"grad_norm_mean {rec['grad_norm_mean']:.6g} "
                             if "grad_norm_mean" in rec else "")
                    print(f"[trainer] step {step:5d} loss {rec['loss']:.6g} "
                          f"{gnorm}{eps_str} {realized}{clip}({dt * 1e3:.0f} ms)",
                          flush=True)
                if ((step + 1) % cfg.ckpt_every == 0 or step == steps - 1
                        or self._preempted):
                    self.ckpt.save(state, step + 1,
                                   shards=self.step_fn.ckpt_shards(state))
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
