"""Peak-live memory estimation: bytes *resident*, not bytes moved.
Counterpart of ``repro/launch/memory.py``.

The paper's workload characterization (§III) root-causes DP-SGD's
bottleneck as a *memory-capacity* blowup: per-example gradients and held
activations inflate the resident footprint against non-private training.
This module returns the peak number of simultaneously resident bytes of
one training step, plus a per-phase breakdown (params / optimizer state /
batch / gradient accumulators / the per-example-grad side channel) that
mirrors the paper's Fig. 4 taxonomy, and sizes the microbatch split to a
memory budget (``MemConfig``).

Estimator model (``traced_peak_bytes``).  The JAX package walks the
step's jaxpr; the port's step is eager autograd, so the estimator runs the
step itself, the Trainer's own ``TrainStep``, on fake tensors
(``FakeTensorMode``): shapes, dtypes and the model's device, no data and
no memory.  A dispatch mode below autograd sees every op the step runs,
forward and backward, with the saved tensors autograd keeps, and counts
storages:

* **Allocation** — each output storage not yet live adds its ``nbytes``
  when it appears.  Views share their base's storage, so a storage counts
  once however many tensors look into it.
* **Free** — a storage leaves the live sum when it dies, that is when its
  last tensor (a view, a saved tensor, a closure) is gone: a weak
  reference to the storage says so.
* **Peak** = resident arguments (params, optimizer state, batch) + the
  highest live sum of everything the step allocates.

Because fake tensors sit on the model's device, the trace takes the card's
routes: the kernel wrappers (``use_kernels``) make the allocations of their
launches and launch nothing (``kernels/build.is_fake``), and ``dpsgd``'s
flat buffers, the remat regions and the noise draw allocate as they do on
the card.  A fake CUDA tensor needs a CUDA build of PyTorch for the model
code to index it; on a CPU build the estimate of a CPU model traces fake
CPU tensors and the kernels' plain versions.

Accuracy contract: an approximation of what the device allocator holds at
its peak (the CUDA caching allocator also rounds blocks and keeps cuBLAS
and cuDNN workspaces).  The documented tolerance is the JAX package's
``TOLERANCE_FACTOR``: the estimate stays within that factor of the JAX
package's estimate of the same step (``tests/test_torch_memory.py``) and
of the peak measured on the card (``chip_smoke.py`` phase 12).  Consumers
(the Trainer's auto-microbatch search, the launcher's memory line) treat
it as a sizing signal with that tolerance, never as an exact byte count.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import tree

# Documented estimator tolerance (see the module docstring): estimate /
# reference in [1/4, 4].  The allocator's rounding and workspaces and the
# other package's scheduling freedom are why this is a factor, not a percent.
TOLERANCE_FACTOR = 4.0


def _tree_bytes(xs) -> int:
    """Bytes of the distinct storages under ``xs`` (a tree of tensors)."""
    seen = {}
    for t in tree.leaves(xs):
        if isinstance(t, torch.Tensor):
            storage = t.untyped_storage()
            seen[storage._cdata] = int(storage.nbytes())
    return int(sum(seen.values()))


class _LiveBytes(TorchDispatchMode):
    """Counts the live bytes of every storage the ops below autograd make,
    past the ``resident`` ones.  ``peak`` is exact up to the moment a
    storage is seen to die: the live sum is an upper bound between sweeps,
    and a sweep (dropping the dead storages) runs whenever that bound
    would raise the peak."""

    def __init__(self, resident):
        super().__init__()
        self.resident = {t.untyped_storage()._cdata for t in resident}
        self.live = {}          # storage handle -> (weak ref, bytes)
        self.bytes = 0
        self.peak = 0
        self.peak_op = None

    def _sweep(self) -> None:
        for key, (ref, n) in list(self.live.items()):
            if ref.expired():
                del self.live[key]
                self.bytes -= n

    def _add(self, t: torch.Tensor, op) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self.resident:
            return
        old = self.live.get(key)
        if old is not None:
            if not old[0].expired():
                return              # a view, or the same storage again
            self.bytes -= old[1]    # a dead storage's handle, reused
        n = int(storage.nbytes())
        self.live[key] = (StorageWeakRef(storage), n)
        self.bytes += n
        if self.bytes > self.peak:
            self._sweep()
            if self.bytes > self.peak:
                self.peak, self.peak_op = self.bytes, str(op)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t, func)
        return out


@dataclasses.dataclass(frozen=True)
class PeakEstimate:
    """Estimator output (byte counts of one device)."""
    arg_bytes: int              # resident inputs: params, opt state, batch
    donated_bytes: int          # donated inputs (none: eager steps donate nothing)
    out_bytes: int              # outputs (the step's metrics)
    transient_bytes: int        # peak of everything allocated mid-step
    peak_bytes: int             # arg_bytes + transient peak (the headline)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def traced_peak_bytes(fn: Callable, resident) -> Tuple[PeakEstimate, object]:
    """Run ``fn()`` under the live-bytes count and return (its
    ``PeakEstimate``, the op at the peak).  ``resident``: a tree of the
    tensors live for the whole call (the arguments).  Call it inside a
    ``FakeTensorMode`` on fake tensors for an estimate that allocates
    nothing."""
    resident = [t for t in tree.leaves(resident) if isinstance(t, torch.Tensor)]
    counter = _LiveBytes(resident)
    with counter:
        out = fn()
    arg_bytes = _tree_bytes(resident)
    out_bytes = _tree_bytes([t for t in tree_leaves(out)
                             if isinstance(t, torch.Tensor)])
    est = PeakEstimate(arg_bytes=arg_bytes, donated_bytes=0,
                       out_bytes=out_bytes, transient_bytes=int(counter.peak),
                       peak_bytes=arg_bytes + int(counter.peak))
    return est, counter.peak_op


# ---------------------------------------------------------------------------
# Train-step estimation with the Fig.-4-style phase breakdown
# ---------------------------------------------------------------------------

def abstract_like(xs):
    """A meta-tensor twin (shapes and dtypes, no data) of a tree of
    tensors: the port's ``ShapeDtypeStruct``."""
    return tree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                               device="meta"), xs)


def per_device_peak_bytes(est: dict, shards: int, stages: int = 1) -> int:
    """Per-device peak from a global ``estimate_train_memory`` dict on a
    ``shards``-wide batch axis: parameters and optimizer state are assumed
    replicated, everything else (batch, activations, per-example channel)
    shards with the batch.  ``shards == 1`` returns the global peak
    unchanged.  ``stages``: the pipeline stage axis's width, over which
    the block-attributable fraction of the resident state
    (``est["block_params_fraction"]``) divides."""
    if shards <= 1 and stages <= 1:
        return int(est["peak_bytes"])
    resident = est.get("params_bytes", 0) + est.get("opt_state_bytes", 0)
    sharded = max(est["peak_bytes"] - resident, 0)
    if stages > 1:
        bf = float(est.get("block_params_fraction", 0.0))
        resident = resident * (1.0 - bf + bf / stages)
    return int(resident + -(-sharded // max(1, shards)))


def abstract_batch(arch, batch_size: int, seq_len: int,
                   augmult: int = 1) -> dict:
    """Meta-tensor batch for a train cell of ``arch`` (images for the image
    families, next-token text otherwise), float32 inputs.

    ``batch_size`` counts *examples*; ``augmult = K > 1`` multiplies the
    physical row count by K (K views per example, the trainer's
    ``augment_expand`` layout)."""
    from repro_torch.configs.base import IMAGE_FAMILIES
    rows = batch_size * max(1, augmult)
    meta = dict(device="meta")
    if arch.family in IMAGE_FAMILIES:
        size, _, channels = arch.image_shape()
        return {"images": torch.empty((rows, size, size, channels),
                                      dtype=torch.float32, **meta),
                "labels": torch.empty((rows,), dtype=torch.int32, **meta)}
    if arch.embed_stub:
        return {"embeds": torch.empty((rows, seq_len, arch.d_model),
                                      dtype=torch.float32, **meta),
                "labels": torch.empty((rows, seq_len), dtype=torch.int32,
                                      **meta)}
    return {"tokens": torch.empty((rows, seq_len + 1), dtype=torch.int32,
                                  **meta)}


def per_example_grad_bytes(dp, batch_size: int, grad_accum: int,
                           param_elems: int) -> int:
    """Size of the per-example-grad side channel, shared with the
    analytical accelerator model (sim/dataflow.py ``pegrad_spill_bytes``):
    vanilla DP-SGD materializes one f32 gradient per example of its chunk;
    the reweighted algorithms carry only the (B,) f32 norm accumulator.
    ``batch_size`` counts physical rows; under ``dp.augmult = K`` the
    privacy unit is the example (rows/K)."""
    from repro_torch.sim.dataflow import pegrad_spill_bytes
    if not dp.enabled or dp.algo == "sgd":
        return 0
    examples = batch_size // max(1, getattr(dp, "augmult", 1))
    if dp.algo == "dpsgd":
        chunk = examples // max(1, grad_accum)
        if dp.microbatch:
            chunk = min(chunk, dp.microbatch)
        return int(pegrad_spill_bytes(chunk, param_elems))
    return 4 * examples             # the (B,) f32 norm side channel


def estimate_train_memory(model, train_cfg, batch_abs,
                          expected_batch_size: Optional[float] = None,
                          device=None, costs: bool = False) -> dict:
    """Estimate the resident-memory footprint of one optimizer step.

    Returns the ``PeakEstimate`` fields plus the phase breakdown::

        params_bytes / opt_state_bytes / batch_bytes   resident state
        grad_bytes                                     f32 gradient tree
        per_example_grad_bytes                         the DP side channel
        transient_bytes / peak_bytes                   from the trace
        peak_op                                        the op at the peak

    ``batch_abs`` is a tree of meta tensors (``abstract_batch``,
    ``abstract_like``); the step traced is the Trainer's own
    (``train/trainer.py`` ``TrainStep``) under the config's remat policy,
    so remat, algorithm, grad_accum, microbatch and the pipeline schedule
    all shape the estimate.  The trace is of one process on the whole batch
    with whole params (no collective; ``per_device_peak_bytes`` divides it
    over a mesh, taking params and optimizer state as replicated, so an
    FSDP model's estimate is the reference's conservative one).
    ``device`` (default the model's) is the fake tensors' device.  With
    ``costs``, the same trace also counts the step's work
    (``launch/costs.py`` ``CostCounter``) into ``"costs"`` (``Costs.as_dict``
    and ``io_bytes``).  The model, its params, its remat policy, every
    generator and the kernels' launch counts are as they were afterwards."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.dist import runtime
    from repro_torch.train.trainer import TrainStep
    device = model.device if device is None else torch.device(device)
    step = TrainStep(model, train_cfg, expected_batch_size)
    remat = model.remat
    model.remat = train_cfg.remat
    try:
        # whole params: an FSDP model's slices are the whole leaves' shapes
        # here, which its gathers pass through as they are
        whole = (model.params if getattr(model, "fsdp", None) is None
                 else model.abstract_params())
        with runtime.suspended(), FakeTensorMode():
            params = tree.tree_map(
                lambda p: torch.empty(p.shape, dtype=p.dtype,
                                      device=device).requires_grad_(True),
                whole)
            state = step.init_state(params, device)
            batch = tree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                        device=device),
                                  batch_abs)
            counter = None
            if costs:
                from repro_torch.launch.costs import CostCounter
                counter = CostCounter()
            # the noise draw's bytes from a generator of the trace's own:
            # no real generator is read or advanced
            with counter or contextlib.nullcontext():
                est, peak_op = traced_peak_bytes(
                    lambda: step(state, batch, torch.Generator()),
                    [state.params, state.opt_state, batch])
            params_bytes = _tree_bytes(params)
            block_bytes = _tree_bytes(params["blocks"]) if (
                isinstance(params, dict) and params.get("blocks") is not None) else 0
            opt_bytes = _tree_bytes(state.opt_state)
            batch_bytes = _tree_bytes(batch)
            leaves = tree.leaves(params)
    finally:
        model.remat = remat
    param_elems = sum(p.numel() for p in leaves)
    B = tree.leaves(batch_abs)[0].shape[0]
    out = est.as_dict()
    out.update({
        "params_bytes": params_bytes,
        "opt_state_bytes": opt_bytes,
        "batch_bytes": batch_bytes,
        "grad_bytes": 4 * param_elems,          # f32 gradient tree
        "per_example_grad_bytes": per_example_grad_bytes(
            train_cfg.dp, B, train_cfg.grad_accum, param_elems),
        "block_params_fraction": block_bytes / max(params_bytes, 1),
        "remat": train_cfg.remat,
        "algo": train_cfg.dp.algo if train_cfg.dp.enabled else "sgd",
        "grad_accum": int(train_cfg.grad_accum),
        "batch_size": int(B),
        "pp_stages": int(getattr(model, "pp_stages", 1)),
        "pp_microbatches": int(getattr(model, "pp_microbatches", 0)),
        "peak_op": str(peak_op),
    })
    if counter is not None:
        out["costs"] = dict(counter.costs.as_dict(),
                            io_bytes=float(est.arg_bytes + est.out_bytes))
    return out


# ---------------------------------------------------------------------------
# Serving programs: the prefill and the decode step
# ---------------------------------------------------------------------------

SERVE_KINDS = ("prefill", "decode")


def abstract_cache(model, batch_size: int, cache_len: int):
    """Meta tensors of ``model.init_cache(batch_size, cache_len)`` (a
    tensor-parallel model's: its KV heads), nothing allocated."""
    device = model.device
    model.device = torch.device("meta")
    try:
        return model.init_cache(batch_size, cache_len)
    finally:
        model.device = device


def serve_program(model, kind: str, batch, cache_len: int, cache=None):
    """``(fn, resident inputs)`` of a serving program of ``model`` on the
    tensors ``batch`` (``{"tokens": (B, T)}``, or ``{"embeds": (B, T,
    d)}`` for an embedding-input arch): ``"prefill"``, the prompt's forward
    into a cache of ``cache_len`` positions (``model.prefill``), or
    ``"decode"``, one token against the cache ``cache`` of ``cache_len``
    positions (``abstract_cache``'s shapes, on the batch's device), written
    at its last position (``model.decode_step``).  The counterparts of the
    reference dry-run's jitted ``prefill`` and ``decode_step``."""
    if kind not in SERVE_KINDS:
        raise ValueError(f"serving program {kind!r}: one of {SERVE_KINDS}")
    inputs = batch["embeds"] if "embeds" in batch else batch["tokens"]
    if kind == "prefill":
        return (lambda: model.prefill(inputs, cache_len)), [batch]
    B = inputs.shape[0]
    pos = torch.full((B,), cache_len - 1, dtype=torch.long, device=inputs.device)
    return (lambda: model.decode_step(cache, inputs, pos)), [batch, cache, pos]


def estimate_serve_memory(model, kind: str, batch_abs, cache_len: int,
                          device=None, costs: bool = False) -> dict:
    """The ``PeakEstimate`` of one serving program (``serve_program``) of
    the whole model on ``batch_abs``'s meta tensors, traced on fake tensors
    as ``estimate_train_memory`` traces a step (whole params; no
    collective), with ``params_bytes``, ``batch_bytes``, ``cache_bytes``
    (decode: the cache it reads; prefill: none resident) and the op at
    the peak; with ``costs``, the same trace's ``CostCounter`` record under
    ``"costs"``.  The model and its params are as they were afterwards."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.dist import runtime
    device = model.device if device is None else torch.device(device)
    B = tree.leaves(batch_abs)[0].shape[0]
    cache_abs = abstract_cache(model, B, cache_len) if kind == "decode" else None
    whole = (model.params if getattr(model, "fsdp", None) is None
             else model.abstract_params())
    saved = model.params
    try:
        with runtime.suspended(), FakeTensorMode():
            def fake(t):
                return torch.empty(t.shape, dtype=t.dtype, device=device)
            model.params = params = tree.tree_map(fake, whole)
            batch = tree.tree_map(fake, batch_abs)
            cache = None if cache_abs is None else tree.tree_map(fake, cache_abs)
            fn, resident = serve_program(model, kind, batch, cache_len, cache)
            counter = None
            if costs:
                from repro_torch.launch.costs import CostCounter
                counter = CostCounter()
            with counter or contextlib.nullcontext():
                est, peak_op = traced_peak_bytes(fn, [params] + resident)
            sizes = dict(params_bytes=_tree_bytes(params), batch_bytes=_tree_bytes(batch),
                         cache_bytes=_tree_bytes(cache))
    finally:
        model.params = saved
    out = est.as_dict()
    out.update(sizes, kind=kind, batch_size=int(B), cache_len=int(cache_len),
               peak_op=str(peak_op))
    if counter is not None:
        out["costs"] = dict(counter.costs.as_dict(),
                            io_bytes=float(est.arg_bytes + est.out_bytes))
    return out


# ---------------------------------------------------------------------------
# Budget-driven auto-microbatching (MemConfig)
# ---------------------------------------------------------------------------

def _accum_candidates(train_cfg, shape, shards: int) -> list:
    """Feasible grad_accum values, ascending (largest microbatch first).

    Fixed sampling: divisors of the global batch whose chunk also divides
    over the batch-axis width and the vanilla-DP-SGD microbatch.  Poisson:
    every accum is feasible (the padded capacity re-rounds to
    lcm(grad_accum·microbatch, shards) per candidate), but the same
    divisor ladder keeps the search space deterministic."""
    B = shape.global_batch
    mb = max(1, train_cfg.dp.microbatch)
    cands = []
    for g in range(1, B + 1):
        if B % g:
            continue
        chunk = B // g
        if chunk % mb:
            continue
        if train_cfg.dp.sampling != "poisson" and chunk % shards:
            continue
        cands.append(g)
    return cands


def pick_grad_accum(model, train_cfg, shape, dataset_size: int = 1_000_000,
                    shards: int = 1) -> Tuple[int, dict]:
    """Pick the smallest grad_accum (= largest microbatch) whose estimated
    peak fits ``train_cfg.mem.hbm_budget_bytes``.

    Returns ``(grad_accum, estimate_dict)``.  Raises ``ValueError`` when
    even the smallest feasible split exceeds the budget: that is a
    capacity planning error the launcher must surface, not paper over.
    The physical batch each candidate is estimated at is the Trainer's own
    ``physical_batch_size`` (Poisson capacity lcm-rounding included).  The
    budget is per device; each candidate's estimate is normalized by the
    ``shards``-wide batch axis (``per_device_peak_bytes``) before the
    comparison and returned as ``per_device_peak_bytes``."""
    from repro_torch.train.trainer import physical_batch_size

    budget = train_cfg.mem.hbm_budget_bytes
    if budget <= 0:
        raise ValueError("pick_grad_accum needs mem.hbm_budget_bytes > 0")
    expected = (float(shape.global_batch)
                if train_cfg.dp.sampling == "poisson" else None)
    candidates = _accum_candidates(train_cfg, shape, shards)
    if not candidates:
        # a divisibility misconfiguration, not a budget problem: say so
        raise ValueError(
            f"no feasible grad_accum split at all: global_batch="
            f"{shape.global_batch} has no divisor whose chunk also divides "
            f"microbatch={max(1, train_cfg.dp.microbatch)} and "
            f"batch-axis width={shards} (sampling="
            f"{train_cfg.dp.sampling!r}); fix the batch/mesh/microbatch "
            f"divisibility — no budget can")
    tried = []
    for g in candidates:
        cfg_g = dataclasses.replace(train_cfg, grad_accum=g)
        cap = physical_batch_size(cfg_g, shape, dataset_size, shards=shards)
        batch_abs = abstract_batch(model.arch, cap, shape.seq_len,
                                   augmult=train_cfg.dp.augmult)
        est = estimate_train_memory(model, cfg_g, batch_abs,
                                    expected_batch_size=expected)
        est["capacity"] = int(cap)
        est["per_device_peak_bytes"] = per_device_peak_bytes(est, shards)
        tried.append((g, est["per_device_peak_bytes"]))
        if est["per_device_peak_bytes"] <= budget:
            return g, est
    lines = ", ".join(f"grad_accum={g}: {p / 1e9:.3f} GB" for g, p in tried)
    best_g, best_peak = min(tried, key=lambda t: t[1])
    gap = best_peak - budget
    raise ValueError(
        f"no microbatch split fits hbm_budget_bytes={budget} "
        f"({budget / 1e9:.3f} GB/device); estimated per-device peaks "
        f"({shards}-wide batch axis): {lines}. "
        f"Closest: grad_accum={best_g} at {best_peak} B "
        f"({best_peak / 1e9:.3f} GB), {gap} B over budget — raise the "
        f"budget by at least that gap, shrink the batch, or use remat.")


def within_tolerance(ratio: float) -> bool:
    """Whether an estimate / reference ratio is inside the documented
    ``TOLERANCE_FACTOR``."""
    return math.isfinite(ratio) and \
        1 / TOLERANCE_FACTOR <= ratio <= TOLERANCE_FACTOR
