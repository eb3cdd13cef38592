"""Search-based launch autotuner: solve for the fastest feasible plan.
Counterpart of ``repro/launch/autotune.py``.

The port can price any launch choice: ``launch/costs.py`` records the
traced step's GEMMs, ``sim/dataflow.py`` turns them into cycle-model
seconds and ``launch/memory.py`` estimates the resident peak.  This module
defines the ``LaunchPlan`` space, a feasibility predicate (the estimated
per-device peak must fit ``MemConfig.hbm_budget_bytes``; the grad-accum,
microbatch and batch-axis divisibility rules must hold; the mesh must be
one the launcher runs), the fitness (predicted step seconds from
``traced_step_time`` over the plan's traced GEMMs, and the predicted
peak), and searches the space with a seeded GA (tournament select, uniform
crossover, mutation), a beam or an exhaustive sweep.  The top-k predicted
plans and the hand-picked default are then measured on the model's device,
with the predicted-against-measured rank correlation; the winner is the
fastest measured plan whose measured peak does not exceed the default's
(or the budget), so a solved plan is never slower than the default.

Both fitness modes come from one trace: ``estimate_train_memory(...,
costs=True)`` runs the Trainer's own ``TrainStep`` once on fake tensors
and counts its peak and its work together.  ``PlanScorer`` caches the
score of each plan and the trace of each trace-relevant knob combination
(the mesh shape is not one: the trace is of the global batch); the
``evals``, ``traces`` and ``cache_hits`` counters land in the report.

Determinism: every random draw comes from one ``random.Random(seed)``,
candidate orderings are sorted and the estimators are pure functions of
the plan, so one seed on one config gives one winning plan.  The wall
clock enters only the measurement.

The collective term is the gradient tree's ring all-reduce over the batch
axis, 2(w-1)/w of the float32 gradient bytes (a quarter of it under int8
compression), over the H100's NVLink bandwidth (``roofline.LINK_BW``).
Meshes: the measurement runs in one process, so a plan whose ``model``
axis (the last) is above 1, or a ``use_fsdp`` arch's plan with
``compress_grads`` on a wider batch axis, is infeasible with the
launcher's own reason (``launch/train.py`` ``unported_mesh_reason`` under
``--autotune``); for the same reason the launcher refuses a ``stage``
axis above 1 under ``--autotune`` (the plan space has no such axis).  A
``use_fsdp`` arch's plan on a wider batch axis trains FSDP-sharded: its
collective term is that of the FSDP collectives one rank's step records
(``launch/costs.py`` ``traced_rank_collectives``: the gathers a layer at
a time, the slices' gradient reductions and the rest of the step's),
traced once per trace key.  On a CUDA model a measured plan runs its
kernels on the card; a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import math
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import (FAMILY_REMAT_POLICIES, REMAT_POLICIES,
                                      TrainConfig, TuneConfig)
from repro_torch.launch.roofline import LINK_BW

COMPRESS_FACTOR = 4.0               # int8 + error feedback vs f32 wire bytes


# ---------------------------------------------------------------------------
# The candidate space
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, order=True)
class LaunchPlan:
    """One point of the launch-plan space: everything the launcher may vary
    without changing the training semantics (the update stays the
    configured algorithm at the configured batch size; only the execution
    strategy moves)."""
    grad_accum: int = 1
    microbatch: int = 0             # vanilla-dpsgd chunk (0 = whole)
    remat: str = "block"
    norm_strategy: str = "auto"
    use_kernels: bool = False
    mesh_shape: Tuple[int, ...] = (1, 1)     # (data, model) device grid
    compress_grads: bool = False
    pp_stages: int = 1              # pipeline stages over the block axis

    @property
    def width(self) -> int:
        """Batch-axis device width.  Mesh convention: the *last* axis is
        "model", everything before it shards the batch (("data", "model")
        or ("pod", "data", "model")); a one-axis mesh is all batch."""
        if not self.mesh_shape:
            return 1
        if len(self.mesh_shape) == 1:
            return int(self.mesh_shape[0])
        return self.n_devices // int(self.mesh_shape[-1])

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.mesh_shape:
            n *= int(s)
        return n

    def apply(self, cfg: TrainConfig) -> TrainConfig:
        """The TrainConfig this plan launches ``cfg`` as."""
        return dataclasses.replace(
            cfg,
            grad_accum=self.grad_accum,
            remat=self.remat,
            pp_stages=self.pp_stages,
            compress_pod_grads=self.compress_grads,
            mesh=dataclasses.replace(cfg.mesh, shape=tuple(self.mesh_shape)),
            dp=dataclasses.replace(cfg.dp,
                                   microbatch=self.microbatch,
                                   norm_strategy=self.norm_strategy,
                                   use_kernels=self.use_kernels))

    @classmethod
    def from_config(cls, cfg: TrainConfig,
                    mesh_shape: Optional[Sequence[int]] = None
                    ) -> "LaunchPlan":
        """The hand-picked default as a plan (the search's incumbent)."""
        return cls(grad_accum=cfg.grad_accum,
                   microbatch=cfg.dp.microbatch,
                   remat=cfg.remat,
                   norm_strategy=cfg.dp.norm_strategy,
                   use_kernels=cfg.dp.use_kernels,
                   mesh_shape=tuple(mesh_shape if mesh_shape is not None
                                    else cfg.mesh.shape),
                   compress_grads=cfg.compress_pod_grads,
                   pp_stages=cfg.pp_stages)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mesh_shape"] = list(self.mesh_shape)
        return d


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


class PlanSpace:
    """The per-dimension candidate values, as an indexable genome space.
    A genome is a tuple of per-dimension indices; ``plan_of`` decodes it.
    Dimensions with a single candidate cost the search nothing."""

    DIM_NAMES = ("grad_accum", "microbatch", "remat", "norm_strategy",
                 "use_kernels", "mesh_shape", "compress_grads", "pp_stages")

    def __init__(self, dims: Sequence[Tuple], default: LaunchPlan):
        self.dims = [tuple(d) for d in dims]
        self.default = default

    @classmethod
    def build(cls, arch, cfg: TrainConfig, shape,
              mesh_shapes: Optional[Sequence[Tuple[int, ...]]] = None,
              include_kernels: bool = False) -> "PlanSpace":
        B = shape.global_batch
        accums = _divisors(B)
        # vanilla dpsgd's chunks per accum step; for every other algorithm
        # the knob is inert, so the dimension collapses to the configured one
        if cfg.dp.enabled and cfg.dp.algo == "dpsgd":
            micro = [0] + [m for m in _divisors(B) if m > 1 and m < B]
        else:
            micro = [cfg.dp.microbatch]
        remats = list(FAMILY_REMAT_POLICIES.get(arch.family, REMAT_POLICIES))
        if cfg.dp.enabled and cfg.dp.algo in ("dpsgd_r", "dpsgd_r1f"):
            strategies = ["auto", "materialize", "gram", "fused"]
        else:
            strategies = [cfg.dp.norm_strategy]
        kernels = [False, True] if include_kernels else [False]
        meshes = [tuple(m) for m in (mesh_shapes or [cfg.mesh.shape])]
        compress = [False, True] if any(
            _prod(m) > 1 for m in meshes) else [False]
        # pipeline stages: divisors of the repeated-block count (capped);
        # the image families have no block axis to slice
        if arch.family not in ("cnn", "vit"):
            from repro_torch.models.transformer import group_layers
            _, _, reps = group_layers(arch)
            stages = [s for s in _divisors(max(reps, 1)) if s <= 8]
        else:
            stages = [1]
        if cfg.pp_stages not in stages:
            stages = sorted(set(stages) | {cfg.pp_stages})
        default = LaunchPlan.from_config(cfg, mesh_shape=meshes[0])
        return cls([accums, micro, remats, strategies, kernels, meshes,
                    compress, stages], default)

    @property
    def size(self) -> int:
        return _prod(len(d) for d in self.dims)

    def plan_of(self, genome: Tuple[int, ...]) -> LaunchPlan:
        vals = dict(zip(self.DIM_NAMES,
                        (d[i] for d, i in zip(self.dims, genome))))
        return LaunchPlan(**vals)

    def genome_of(self, plan: LaunchPlan) -> Optional[Tuple[int, ...]]:
        """Encode ``plan``; None if any value is outside the space."""
        genome = []
        for name, dim in zip(self.DIM_NAMES, self.dims):
            v = getattr(plan, name)
            if v not in dim:
                return None
            genome.append(dim.index(v))
        return tuple(genome)

    def genomes(self):
        return itertools.product(*(range(len(d)) for d in self.dims))


# ---------------------------------------------------------------------------
# Fitness: predicted seconds + predicted peak, memoized
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanScore:
    plan: LaunchPlan
    feasible: bool
    reason: str = ""                   # why infeasible ("" when feasible)
    pred_seconds: float = math.inf     # cycle-model step time
    peak_bytes: int = 0                # estimated per-device peak
    capacity: int = 0                  # physical examples per step
    breakdown: Optional[dict] = None   # gemm/elementwise/collective split

    def as_dict(self) -> dict:
        d = {"plan": self.plan.as_dict(), "feasible": self.feasible,
             "reason": self.reason, "pred_seconds": self.pred_seconds,
             "peak_bytes": int(self.peak_bytes),
             "capacity": int(self.capacity)}
        if self.breakdown:
            d["breakdown"] = dict(self.breakdown)
        return d


class PlanScorer:
    """Feasibility and fitness with two-level memoization.

    Level 1: the score of each plan (the GA revisits genomes).  Level 2:
    the (estimate, costs) trace keyed by the trace-relevant knobs only:
    plans that differ in mesh shape share one trace; only the per-device
    normalization and the collective term change.  Models are built on
    ``device`` in the config's types, one per ``pp_stages`` (the Trainer
    sets the remat policy, so one model serves every policy).
    ``link_bw``: the collective term's link bandwidth (bytes/s)."""

    def __init__(self, arch, base_cfg: TrainConfig, shape,
                 dataset_size: int = 1_000_000, device="cuda",
                 link_bw: float = LINK_BW):
        self.arch = arch
        self.base_cfg = base_cfg
        self.shape = shape
        self.dataset_size = dataset_size
        self.device = torch.device(device)
        self.link_bw = link_bw
        self.evals = 0                 # score() calls
        self.traces = 0                # fake-tensor traces actually run
        self.cache_hits = 0            # served from either cache
        self._scores: Dict[LaunchPlan, PlanScore] = {}
        self._traces: Dict[tuple, tuple] = {}
        self._rank_records: Dict[tuple, list] = {}
        self._models: Dict[int, object] = {}

    # -- model / trace machinery ------------------------------------------
    def model_for(self, pp_stages: int = 1):
        if pp_stages not in self._models:
            from repro_torch.models import build_model_for
            cfg = self.base_cfg
            self._models[pp_stages] = build_model_for(
                self.arch, dtype=getattr(torch, cfg.compute_dtype),
                param_dtype=getattr(torch, cfg.param_dtype),
                device=self.device, seed=cfg.seed, remat=cfg.remat,
                pp_stages=pp_stages, pp_microbatches=cfg.pp_microbatches)
        return self._models[pp_stages]

    def _expected(self) -> Optional[float]:
        return (float(self.shape.global_batch)
                if self.base_cfg.dp.sampling == "poisson" else None)

    def _capacity(self, plan: LaunchPlan) -> int:
        from repro_torch.train.trainer import physical_batch_size
        cfg_p = plan.apply(self.base_cfg)
        return physical_batch_size(cfg_p, self.shape, self.dataset_size,
                                   shards=plan.width)

    def _trace(self, plan: LaunchPlan, capacity: int) -> tuple:
        """(estimate dict, costs dict) of the plan's traced step; the mesh
        shape is not in the key: the trace is of the global batch."""
        key = (plan.grad_accum, plan.microbatch, plan.remat,
               plan.norm_strategy, plan.use_kernels, plan.compress_grads,
               plan.pp_stages, capacity)
        if key in self._traces:
            self.cache_hits += 1
            return self._traces[key]
        from repro_torch.launch.memory import (abstract_batch,
                                               estimate_train_memory)
        self.traces += 1
        cfg_p = plan.apply(self.base_cfg)
        model = self.model_for(plan.pp_stages)
        batch_abs = abstract_batch(self.arch, capacity, self.shape.seq_len,
                                   augmult=cfg_p.dp.augmult)
        est = estimate_train_memory(model, cfg_p, batch_abs,
                                    expected_batch_size=self._expected(),
                                    costs=True)
        costs = est.pop("costs")
        self._traces[key] = (est, costs)
        return est, costs

    # -- feasibility (cheap checks first, trace only when they pass) ------
    def _static_infeasible(self, plan: LaunchPlan) -> str:
        family = self.arch.family
        if plan.remat not in FAMILY_REMAT_POLICIES.get(family,
                                                       REMAT_POLICIES):
            return (f"remat={plan.remat!r} unsupported for family "
                    f"{family!r}")
        B = self.shape.global_batch
        if plan.grad_accum < 1 or B % plan.grad_accum:
            return f"grad_accum={plan.grad_accum} does not divide B={B}"
        chunk = B // plan.grad_accum
        mb = max(1, plan.microbatch)
        if chunk % mb:
            return (f"chunk={chunk} not divisible by "
                    f"microbatch={plan.microbatch}")
        if self.base_cfg.dp.sampling != "poisson" and chunk % plan.width:
            # poisson re-rounds its padded capacity to the lcm instead
            return (f"chunk={chunk} not divisible by batch-axis "
                    f"width={plan.width}")
        if plan.pp_stages > 1:
            if family in ("cnn", "vit"):
                return (f"pp_stages={plan.pp_stages} unsupported for "
                        f"image family {family!r}")
            from repro_torch.models.transformer import group_layers
            _, _, reps = group_layers(self.arch)
            if reps == 0 or reps % plan.pp_stages:
                return (f"pp_stages={plan.pp_stages} does not divide the "
                        f"stacked block count reps={reps}")
        from repro_torch.launch.train import unported_mesh_reason
        model = int(plan.mesh_shape[-1]) if len(plan.mesh_shape) > 1 else 1
        return unported_mesh_reason(self.arch, {"model": model,
                                                "data": plan.width},
                                    plan.apply(self.base_cfg), autotune=True)

    # -- the fitness function ---------------------------------------------
    def score(self, plan: LaunchPlan) -> PlanScore:
        self.evals += 1
        if plan in self._scores:
            self.cache_hits += 1
            return self._scores[plan]
        reason = self._static_infeasible(plan)
        if reason:
            s = PlanScore(plan, feasible=False, reason=reason)
            self._scores[plan] = s
            return s
        capacity = self._capacity(plan)
        try:
            est, costs = self._trace(plan, capacity)
        except (ValueError, NotImplementedError) as e:
            # a refused combination (e.g. a site without the requested norm
            # rule) is infeasible, not fatal: the search routes around it.
            # On the card a kernel plan's refusal raises: routing around it
            # would quietly pick a plain plan instead.  Any other error is
            # a fault and propagates.
            if plan.use_kernels and self.device.type == "cuda":
                raise
            s = PlanScore(plan, feasible=False,
                          reason=f"trace failed: {type(e).__name__}: {e}")
            self._scores[plan] = s
            return s
        from repro_torch.launch.memory import per_device_peak_bytes
        peak = per_device_peak_bytes(est, plan.width,
                                     stages=plan.pp_stages)
        seconds, breakdown = self._predict_seconds(plan, est, costs)
        budget = self.base_cfg.mem.hbm_budget_bytes
        if budget > 0 and peak > budget:
            s = PlanScore(plan, feasible=False,
                          reason=(f"estimated per-device peak {peak} B "
                                  f"exceeds budget {budget} B by "
                                  f"{peak - budget} B"),
                          pred_seconds=seconds, peak_bytes=peak,
                          capacity=capacity, breakdown=breakdown)
        else:
            s = PlanScore(plan, feasible=True, pred_seconds=seconds,
                          peak_bytes=peak, capacity=capacity,
                          breakdown=breakdown)
        self._scores[plan] = s
        return s

    def fsdp_records(self, plan: LaunchPlan) -> list:
        """The collective records of one rank's step of a ``use_fsdp``
        arch's plan on its batch axis (``costs.traced_rank_collectives``),
        traced once per trace key and width."""
        capacity = self._capacity(plan)
        key = (plan.grad_accum, plan.microbatch, plan.remat,
               plan.norm_strategy, plan.use_kernels, plan.pp_stages,
               capacity, plan.width)
        if key not in self._rank_records:
            from repro_torch.launch.costs import traced_rank_collectives
            from repro_torch.launch.memory import abstract_batch
            cfg_p = plan.apply(self.base_cfg)
            self._rank_records[key] = traced_rank_collectives(
                self.model_for(plan.pp_stages), cfg_p,
                abstract_batch(self.arch, capacity, self.shape.seq_len,
                               augmult=cfg_p.dp.augmult),
                plan.width, expected_batch_size=self._expected())
        return self._rank_records[key]

    def costs_of(self, plan: LaunchPlan) -> dict:
        """The traced costs of a scored feasible plan's step."""
        return self._trace(plan, self._capacity(plan))[1]

    def _predict_seconds(self, plan: LaunchPlan, est: dict,
                         costs: dict) -> Tuple[float, dict]:
        """Cycle-model seconds for the traced step on the plan's engine.

        The engine mirrors the route the plan buys: the fused kernel route
        is the DiVa dataflow (outer-product + PPU); kernels without the
        fused strategy still avoid the per-example spill (OS+PPU); the
        plain route prices as the conventional weight-stationary array.
        The collective term is the gradient tree's ring all-reduce over the
        batch axis, /4 under int8 compression; for a ``use_fsdp`` arch on a
        wider batch axis, the ring bytes of one rank's traced FSDP
        collectives (``fsdp_records``)."""
        from repro_torch.sim.dataflow import DIVA, OS_PPU, WS, traced_step_time
        if plan.use_kernels and plan.norm_strategy == "fused":
            acc = DIVA
        elif plan.use_kernels:
            acc = OS_PPU
        else:
            acc = WS
        w = plan.width
        coll = 0.0
        if w > 1 and self.arch.use_fsdp:
            from repro_torch.launch.roofline import collective_bytes
            coll = collective_bytes(self.fsdp_records(plan), w)["total"]
        elif w > 1:
            coll = est.get("grad_bytes", 0) * 2.0 * (w - 1) / w
            if plan.compress_grads:
                coll /= COMPRESS_FACTOR
        ts = traced_step_time(acc, costs.get("gemms", ()),
                              ew_flops=costs.get("elementwise_flops", 0.0),
                              move_bytes=costs.get("move_bytes", 0.0),
                              n_devices=plan.n_devices, coll_bytes=coll,
                              ici_bw=self.link_bw)
        return ts.total, {"gemm_seconds": ts.gemm,
                          "elementwise_seconds": ts.elementwise,
                          "collective_seconds": ts.collective,
                          "dram_bytes": ts.dram_bytes,
                          "engine": acc.name}


# ---------------------------------------------------------------------------
# Search backends (all deterministic; the GA is seeded)
# ---------------------------------------------------------------------------

def _fitness_key(score: PlanScore) -> tuple:
    """Sort key: feasible first, then predicted seconds, then the plan
    itself: the total order that makes every backend deterministic."""
    return (not score.feasible,
            score.pred_seconds if score.feasible else math.inf,
            score.plan)


def _search_exhaustive(space: PlanSpace, scorer: PlanScorer) -> None:
    for g in space.genomes():
        scorer.score(space.plan_of(g))


def _search_beam(space: PlanSpace, scorer: PlanScorer,
                 tune: TuneConfig) -> None:
    """Deterministic beam over single-dimension moves: start from the
    incumbent, expand every one-knob neighbor of every beam entry, keep
    the ``beam_width`` best, stop when a round improves nothing."""
    start = space.genome_of(space.default)
    if start is None:
        start = tuple(0 for _ in space.dims)
    beam = [start]
    seen = {start}
    best = _fitness_key(scorer.score(space.plan_of(start)))
    for _ in range(len(space.dims) * max(2, tune.beam_width)):
        frontier = []
        for g in beam:
            for i, dim in enumerate(space.dims):
                for v in range(len(dim)):
                    if v == g[i]:
                        continue
                    n = g[:i] + (v,) + g[i + 1:]
                    if n not in seen:
                        seen.add(n)
                        frontier.append(n)
        if not frontier:
            break
        ranked = sorted(
            frontier, key=lambda g: _fitness_key(scorer.score(
                space.plan_of(g))))
        beam = ranked[:tune.beam_width]
        new_best = min(best, _fitness_key(scorer.score(
            space.plan_of(beam[0]))))
        if new_best == best:
            break
        best = new_best


def _search_ga(space: PlanSpace, scorer: PlanScorer,
               tune: TuneConfig) -> None:
    """Seeded GA: tournament select (k=3) + uniform crossover + per-gene
    mutation, 2-elite carryover.  All stochastic choices come from one
    ``random.Random(tune.seed)`` stream; scored plans accumulate in the
    scorer's cache, so the final ranking sees every genome ever visited."""
    rng = random.Random(tune.seed)
    dims = space.dims
    mut_p = max(0.1, 1.0 / len(dims))

    def rand_genome() -> Tuple[int, ...]:
        return tuple(rng.randrange(len(d)) for d in dims)

    def key_of(g: Tuple[int, ...]) -> tuple:
        return _fitness_key(scorer.score(space.plan_of(g)))

    incumbent = space.genome_of(space.default)
    pop = ([incumbent] if incumbent is not None else [])
    while len(pop) < max(4, tune.population):
        pop.append(rand_genome())

    def tournament(scored: List[Tuple[tuple, Tuple[int, ...]]]
                   ) -> Tuple[int, ...]:
        picks = [scored[rng.randrange(len(scored))] for _ in range(3)]
        return min(picks)[1]

    for _ in range(max(1, tune.generations)):
        scored = sorted((key_of(g), g) for g in pop)
        nxt = [g for _, g in scored[:2]]               # elites
        while len(nxt) < len(pop):
            p1, p2 = tournament(scored), tournament(scored)
            child = tuple(a if rng.random() < 0.5 else b
                          for a, b in zip(p1, p2))
            child = tuple(rng.randrange(len(dims[i]))
                          if rng.random() < mut_p else v
                          for i, v in enumerate(child))
            nxt.append(child)
        pop = nxt
    for g in pop:                                      # score final gen
        scorer.score(space.plan_of(g))


# ---------------------------------------------------------------------------
# Measurement (the sim-vs-real loop)
# ---------------------------------------------------------------------------

def _concrete_batch(arch, capacity: int, seq_len: int, augmult: int, device,
                   seed: int = 0) -> dict:
    """A seeded numpy batch of ``abstract_batch``'s shapes and dtypes on
    ``device``: token ids below the vocab, labels below the classes,
    standard-normal images and embeddings."""
    import numpy as np
    from repro_torch.launch.memory import abstract_batch
    abs_b = abstract_batch(arch, capacity, seq_len, augmult=augmult)
    rng = np.random.default_rng(seed)
    out = {}
    for name, leaf in abs_b.items():
        if leaf.dtype.is_floating_point:
            val = rng.standard_normal(tuple(leaf.shape)).astype(np.float32)
        else:
            hi = arch.n_classes if arch.family in ("cnn", "vit") else arch.vocab
            val = rng.integers(0, max(2, hi), size=tuple(leaf.shape))
        out[name] = torch.from_numpy(val).to(device=device, dtype=leaf.dtype)
    return out


def measure_plan(scorer: PlanScorer, plan: LaunchPlan,
                 iters: int = 5) -> dict:
    """Run the plan's train step on its model's device: the best of
    ``iters`` wall-clock steps after one warm-up, each ending in a
    ``torch.cuda.synchronize()`` on the card.  ``measured_peak_bytes`` (on
    the card; None on the CPU) is the step's own peak, the counterpart of
    XLA's arguments + temporaries: the params, optimizer state and batch
    it holds, plus the most ``torch.cuda.max_memory_allocated`` rose above
    what was allocated when the steps began (the scorer's other models do
    not count).  The plan's optimizer state and the allocator's cache are
    freed before returning."""
    from repro_torch.launch.memory import _tree_bytes
    from repro_torch.train.trainer import TrainStep
    cfg_p = plan.apply(scorer.base_cfg)
    model = scorer.model_for(plan.pp_stages)
    device = model.device
    cuda = device.type == "cuda"
    capacity = scorer._capacity(plan)
    batch = _concrete_batch(scorer.arch, capacity, scorer.shape.seq_len,
                           cfg_p.dp.augmult, device, seed=cfg_p.seed)
    remat = model.remat
    model.requires_grad_(True)
    model.remat = plan.remat
    try:
        step = TrainStep(model, cfg_p, scorer._expected())
        state = step.init_state(model.params, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(cfg_p.seed)
        peak = None
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        best = math.inf
        for _ in range(max(1, iters) + 1):     # +1 warm-up step
            t0 = time.perf_counter()
            metrics = step(state, batch, gen)
            float(metrics["loss"])              # reads back: syncs
            if cuda:
                torch.cuda.synchronize(device)
            best = min(best, time.perf_counter() - t0)
        if cuda:
            peak = (torch.cuda.max_memory_allocated(device) - base
                    + _tree_bytes([state.params, state.opt_state, batch]))
    finally:
        model.remat = remat
    del state, step, batch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"plan": plan.as_dict(), "seconds": best,
            "measured_peak_bytes": peak, "capacity": int(capacity)}


def spearman(xs: Sequence[float], ys: Sequence[float]) -> Optional[float]:
    """Spearman rank correlation (average ranks for ties): Pearson on the
    rank vectors.  None when undefined (n < 2 or a constant vector)."""
    n = len(xs)
    if n != len(ys) or n < 2:
        return None

    def ranks(vals):
        order = sorted(range(n), key=lambda i: vals[i])
        r = [0.0] * n
        i = 0
        while i < n:
            j = i
            while j + 1 < n and vals[order[j + 1]] == vals[order[i]]:
                j += 1
            avg = (i + j) / 2.0 + 1.0
            for k in range(i, j + 1):
                r[order[k]] = avg
            i = j + 1
        return r

    rx, ry = ranks(list(xs)), ranks(list(ys))
    mx, my = sum(rx) / n, sum(ry) / n
    num = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    dx = math.sqrt(sum((a - mx) ** 2 for a in rx))
    dy = math.sqrt(sum((b - my) ** 2 for b in ry))
    if dx == 0 or dy == 0:
        return None
    return num / (dx * dy)


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AutotuneReport:
    plan: LaunchPlan                   # the winner
    default_plan: LaunchPlan
    predicted: List[PlanScore]         # feasible plans, best first
    measured: List[dict]               # measure_plan records (may be empty)
    rank_correlation: Optional[float]  # predicted-vs-measured Spearman
    space_size: int
    method: str
    seed: int
    evals: int
    traces: int
    cache_hits: int
    search_s: float = 0.0              # the search's wall seconds
    measure_s: float = 0.0             # the measurement's wall seconds

    def as_dict(self) -> dict:
        return {
            "plan": self.plan.as_dict(),
            "default_plan": self.default_plan.as_dict(),
            "predicted": [s.as_dict() for s in self.predicted],
            "measured": list(self.measured),
            "rank_correlation": self.rank_correlation,
            "space_size": self.space_size,
            "method": self.method,
            "seed": self.seed,
            "evals": self.evals,
            "traces": self.traces,
            "cache_hits": self.cache_hits,
            "search_s": self.search_s,
            "measure_s": self.measure_s,
        }


def solve(arch, cfg: TrainConfig, shape,
          mesh_shapes: Optional[Sequence[Tuple[int, ...]]] = None,
          measure: bool = True, dataset_size: int = 1_000_000,
          device="cuda", link_bw: float = LINK_BW,
          scorer: Optional[PlanScorer] = None) -> AutotuneReport:
    """Search the launch-plan space of ``(arch, cfg, shape)`` and return
    the winning plan and the report.  ``cfg.tune`` carries the search
    knobs; ``cfg`` itself is the hand-picked incumbent the winner must
    beat.  Models are built and plans measured on ``device``; ``scorer``
    (one of these arguments') reuses its models and traces.  Raises
    ``ValueError`` when no candidate is feasible, naming the best
    infeasible candidate's budget gap in bytes."""
    tune = cfg.tune
    space = PlanSpace.build(arch, cfg, shape, mesh_shapes=mesh_shapes,
                            include_kernels=tune.include_kernels)
    if scorer is None:
        scorer = PlanScorer(arch, cfg, shape, dataset_size=dataset_size,
                            device=device, link_bw=link_bw)

    method = tune.method
    if method == "auto":
        method = "exhaustive" if space.size <= tune.exhaustive_limit \
            else "ga"
    t0 = time.perf_counter()
    if method == "exhaustive":
        _search_exhaustive(space, scorer)
    elif method == "beam":
        _search_beam(space, scorer, tune)
    elif method == "ga":
        _search_ga(space, scorer, tune)
    else:
        raise ValueError(f"unknown tune.method {method!r}; "
                         f"expected auto | ga | beam | exhaustive")
    search_s = time.perf_counter() - t0

    scored = sorted(scorer._scores.values(), key=_fitness_key)
    feasible = [s for s in scored if s.feasible]
    if not feasible:
        budget = cfg.mem.hbm_budget_bytes
        over = [s for s in scored if s.peak_bytes > 0]
        if budget > 0 and over:
            best = min(over, key=lambda s: s.peak_bytes)
            gap = best.peak_bytes - budget
            raise ValueError(
                f"autotune: no feasible launch plan for arch={arch.name} "
                f"under hbm_budget_bytes={budget} "
                f"({budget / 1e9:.3f} GB/device); best infeasible "
                f"candidate {best.plan} has estimated per-device peak "
                f"{best.peak_bytes} B ({best.peak_bytes / 1e9:.3f} GB), "
                f"{gap} B over budget. Raise the budget by at least "
                f"that gap, shrink the batch, or widen the mesh.")
        reasons = sorted({s.reason for s in scored if s.reason})
        raise ValueError(
            f"autotune: no feasible launch plan for arch={arch.name}: "
            + "; ".join(reasons[:4]))

    topk = feasible[:max(1, tune.topk)]
    winner = topk[0].plan
    measured: List[dict] = []
    correlation = None
    t1 = time.perf_counter()
    if measure:
        to_measure = list(dict.fromkeys(
            [s.plan for s in topk] + [space.default]))
        for p in to_measure:
            rec = measure_plan(scorer, p, iters=tune.measure_iters)
            sc = scorer.score(p)
            rec["pred_seconds"] = sc.pred_seconds
            rec["pred_peak_bytes"] = int(sc.peak_bytes)
            rec["feasible"] = sc.feasible
            measured.append(rec)

        def plan_key(d: dict) -> tuple:
            return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                                for k, v in d.items()))

        by_plan = {plan_key(r["plan"]): r for r in measured}

        def rec_of(p: LaunchPlan) -> dict:
            return by_plan[plan_key(p.as_dict())]

        default_rec = rec_of(space.default)
        default_peak = default_rec["measured_peak_bytes"]
        budget = cfg.mem.hbm_budget_bytes

        # a measured candidate is eligible iff its measured peak is no
        # worse than the default's (or it fits the explicit budget): the
        # "never slower at equal-or-lower memory" gate holds by
        # construction because the default itself is always eligible
        def eligible(rec: dict) -> bool:
            mp = rec["measured_peak_bytes"]
            if mp is None or default_peak is None:
                return True
            return mp <= default_peak or (budget > 0 and mp <= budget)

        pool = [r for r in measured if eligible(r)]
        if default_rec not in pool:
            pool.append(default_rec)
        win_rec = min(pool, key=lambda r: (r["seconds"],
                                           sorted(r["plan"].items())))
        winner = LaunchPlan(**{**win_rec["plan"],
                               "mesh_shape": tuple(
                                   win_rec["plan"]["mesh_shape"])})
        pred = [r["pred_seconds"] for r in measured]
        meas = [r["seconds"] for r in measured]
        correlation = spearman(pred, meas)

    return AutotuneReport(
        plan=winner, default_plan=space.default, predicted=topk,
        measured=measured, rank_correlation=correlation,
        space_size=space.size, method=method, seed=tune.seed,
        evals=scorer.evals, traces=scorer.traces,
        cache_hits=scorer.cache_hits, search_s=search_s,
        measure_s=time.perf_counter() - t1)
