"""Algorithm 1 of the paper as gradient transformations.  Counterpart of
``repro/core/algo.py``.

``make_noisy_grad_fn(loss_fn, dp, grad_accum)`` returns

    fn(params, batch, generator) -> (grads, metrics)

where ``grads`` is a list of float32 tensors aligned with
``tree.leaves(params)`` and ``metrics`` a dict of 0-d tensors, for
``dp.algo`` in:

* ``"sgd"``     — non-private baseline: the mean-loss gradient.
* ``"dpsgd"``   — vanilla DP-SGD (lines 15–25): per-example gradients of
                  ``m_i · L_i`` in the parameter dtype, ``dp.microbatch``
                  examples at a time (0 = the whole batch), into one flat
                  ``(mbe, N)`` buffer per parameter dtype
                  (``clipping.flat_stacks``), then ``clipping.clip_and_sum``
                  (one ``clip_reduce`` launch a buffer with kernels) into
                  the flat float32 sums, returned as leaf views.  One
                  ``autograd.grad`` per example on its own rows, where the
                  JAX package vmaps over the microbatch: the flash kernels'
                  ``autograd.Function``s have no vmap rule.
* ``"dpsgd_r"`` — reweighted DP-SGD(R) (lines 27–42): pass 1
                  (``norm_pass``) gives the per-example norms² through the
                  ``DPContext`` side-channel on detached parameters, so no
                  weight gradient is formed; pass 2 (``reweighted_grads``)
                  backpropagates the clip-reweighted loss; then noise.
* ``"dpsgd_r1f"`` — DP-SGD(R) with one forward: the parameters are not
                  detached, and two pullbacks run through its retained
                  graph, the first seeded with the mask (the norms²), the
                  second with the clip weights (the clipped sum).  A
                  ``sites.Pull`` switch keeps the first from forming weight
                  gradients and the second from computing norms², which
                  the JAX package leaves to XLA's dead-code elimination.

Masked variable batches (Poisson subsampling, lines 15–17): a batch may
carry a ``"mask"`` leaf, ``(B,)`` bool example-validity flags of a
right-padded fixed-capacity batch (data/pipeline.py ``poisson_batch_for``).
Every backward pass is seeded with the masked per-example loss cotangents,
so a padded row's activation gradients, its norm² at every site (plain rules
and kernels alike: an all-zero gy row reduces to an exact zero), its clip
factor and its term of the clipped sum are exact zeros, and a masked batch
gives the update of the compacted batch.  Metrics are taken over the real
rows only.  Without a ``"mask"`` leaf every row is real.

``grad_accum > 1`` sums the clipped sums of equal chunks of the batch (the
mask chunked alongside, each chunk whole examples) before the noise, as in
the JAX package.

Augmentation multiplicity (``dp.augmult = K > 1``): every batch leaf
carries B·K rows, K views of each example, b-major / k-minor
(data/pipeline.py ``augment_expand``), and the mask is repeated over K.
The per-example gradient is the mean over the K views, clipped once: every
backward is seeded with ``m/K``-scaled loss cotangents, so the pulled-back
gradient of example b is its K-averaged gradient, and the site rules fold
the K views into their contraction axis (``norms.fold_views4``), so the
accumulator holds ‖mean-over-K gradient‖² per example, (B,).  Losses stay
per row (B·K,), norms² per example (B,).  K = 1 is the single-view
dataflow bit for bit.

Adaptive clipping: a batch may carry a ``"clip_norm"`` leaf, a 0-d tensor
that overrides ``dp.clip_norm`` in every algorithm (``split_clip``, the one
place it is resolved); ``make_noisy_grad_fn``'s ``clip_norm`` argument puts
it there.  Under ``dp.adaptive_clip`` the step also makes the next clip
norm (core/adaptive_clip.py) from the per-example norms², and its metrics
carry ``clip_norm``, ``clip_frac_below`` and ``clip_norm_next``.

``expected_batch_size``: the private update's normaliser, in examples.
Under Poisson sampling the trainer passes the expected sample size q·N
(Algorithm 1 line 24's lot size), never the capacity or the realized
size, which would leak the sample size.

Data parallel (an active ``dist.runtime.layout``): each rank's batch is
its shard of the global one.  Its clipped sum is all-reduced over the
batch axes once a step, after ``grad_accum``'s chunks and before the
noise; the per-example losses, norms² and mask are all-gathered, so the
metrics, ``clipped_frac``, the normaliser (the global example count) and
the adaptive clip's below-C count are those of one process on the global
batch.  Every rank draws the noise from a generator seeded alike, so
every rank adds the same noise and holds the same update.

FSDP (params carrying ``fsdp_shard``, dist/runtime.py): the gather's
backward has already summed a slice's pass-2 gradient over the ranks, so
the all-reduce skips those leaves (a second sum would double them);
``dpsgd`` differentiates whole leaves gathered once a step, clips and sums
them locally, and its whole sums are reduced here once and cut to the
slice.  A slice's noise is drawn for the slice alone
(``noise.shard_generator``); the adaptive clip's count noise stays on the
step's generator, so every rank gets the same next clip norm.  In
``dpsgd_r1f`` the first pullback reaches only the accumulator, so the
gather's backward runs in the second alone.

Tensor parallel (params carrying ``model_shard``, a ``model`` axis above
1): every model rank takes the same examples, and each norm site on a
slice gives that slice's partial norm² (the norm scales' taps count on the
first model rank alone, core/context.py), so the (B,) norms² are summed
over the ``model`` group right after their pullback and before the clip
factors (``norm_pass``, ``dpsgd_r1f``): every model rank then clips alike,
and the losses and norms² are the same on each.  A slice's clipped sum is
its own gradient, reduced over the batch group alone; its noise comes from
a generator keyed by the step's and the slice's ``model`` index
(``noise.shard_generator``), alike on every data rank that holds the
slice.  ``dpsgd`` raises: its flat per-example buffers would need their
norms² summed over the group (ROADMAP queue 1).

Pipeline stages across processes (params carrying ``stage_shard``, a
``stage`` axis above 1): every stage rank of a ``data`` coordinate takes the
same examples and returns the last stage rank's losses
(models/transformer.py), and the accumulator's cotangent crosses the
stages back, so the first stage rank's pullback holds the norms² and the
others' zeros: they are summed over the ``stage`` group right after each
pullback, beside the ``model`` group's sum, and every stage rank clips
alike.  A stage slice's clipped sum is its own, reduced over the batch
group; a leaf every stage rank holds whole (``stage_owner``) has its real
clipped sum on its owner alone, which broadcasts it over the stage group
before the noise, and every stage rank then adds the same noise to it from
the step's generator.  A stage slice's noise comes from a generator keyed
by its stage index.  ``dpsgd`` raises: its per-example backward would
cross the pipeline once an example.  The step's sends are waited once its
clipped sums are made (``runtime.stage_flush``).

loss_fn contract: ``loss_fn(params, batch, ctx) -> (per_example_losses,
ctx)`` with ``per_example_losses: (B,) float32``.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import DPConfig
from repro_torch.core import adaptive_clip, clipping, noise, sites
from repro_torch.core.context import DPContext
from repro_torch.dist import runtime
from repro_torch.kernels.build import is_fake

F32 = torch.float32
MASK_KEY = "mask"
CLIP_KEY = "clip_norm"


def _batch_size(batch) -> int:
    return tree.leaves(batch)[0].shape[0]


def split_mask(batch):
    """Split the optional ``"mask"`` (and ``"clip_norm"``) leaves off a
    batch: (model inputs, float32 (B·K,) 0/1 mask or None)."""
    data, mask, _ = split_clip(batch)
    return data, mask


def split_clip(batch):
    """(model inputs, float32 mask or None, clip-norm override or None):
    both auxiliary leaves stripped, so model code never sees them."""
    if not isinstance(batch, dict) or not ({MASK_KEY, CLIP_KEY} & set(batch)):
        return batch, None, None
    data = {k: v for k, v in batch.items() if k not in (MASK_KEY, CLIP_KEY)}
    mask = batch.get(MASK_KEY)
    return data, None if mask is None else mask.to(F32), batch.get(CLIP_KEY)


def _ones_if_none(mask, R: int, device) -> torch.Tensor:
    return torch.ones((R,), dtype=F32, device=device) if mask is None else mask


def _views(dp: DPConfig) -> int:
    return max(1, int(dp.augmult))


def _example_mask(m_rows: torch.Tensor, k: int) -> torch.Tensor:
    """(B·K,) row mask -> (B,) per-example mask (an example is present with
    all K views or with none)."""
    return m_rows if k == 1 else m_rows.reshape(-1, k)[:, 0]


def _view_seed(m_rows: torch.Tensor, k: int) -> torch.Tensor:
    """Loss-cotangent seed: the row mask scaled 1/K, so pulled-back grads
    and norms² are means over the K views; K = 1 keeps the mask as it is."""
    return m_rows if k == 1 else m_rows / k


def _expand_rows(c_ex: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) per-example weights -> (B·K,) row weights carrying the 1/K view
    averaging (pass-2 seeds)."""
    return c_ex if k == 1 else torch.repeat_interleave(c_ex, k) / k


def stage_microbatches(n_examples: int, n_stages: int,
                       requested: int = 0) -> int:
    """The microbatches a call of the pipelined block stack
    (models/transformer.py ``_blocks_pipelined``) cuts its batch into.  A
    microbatch is a contiguous run of examples, never of rows, so the K
    views of an example travel together and the (B,) accumulator's chunks
    stay aligned with the activations'.  The request (0: one a stage) is
    clamped to the largest divisor of ``n_examples`` not above it;
    ``dpsgd``'s one-example calls get 1."""
    want = max(1, requested or n_stages)
    m = max(1, min(want, n_examples))
    while n_examples % m:
        m -= 1
    return m


def _metrics(losses, nsq, clip_norm, mask_rows, mask_ex):
    """Metrics over the real entries only: padded rows carry exact-zero
    norms² but arbitrary losses.  ``losses``/``mask_rows`` are per row,
    ``nsq``/``mask_ex`` per example."""
    n = torch.sqrt(torch.clamp(nsq, min=0.0))
    count_rows = torch.clamp(mask_rows.sum(), min=1.0)
    count_ex = torch.clamp(mask_ex.sum(), min=1.0)
    return {"loss": (losses * mask_rows).sum() / count_rows,
            "grad_norm_mean": (n * mask_ex).sum() / count_ex,
            "grad_norm_max": (n * mask_ex).max(),
            "clipped_frac": ((n > clip_norm).float() * mask_ex).sum() / count_ex,
            "realized_batch": mask_ex.sum()}


def _noise_clip(C, dp: DPConfig) -> float:
    """The clip norm as a number, for the noise's scale.  A fake tensor
    (``launch/memory.py``'s trace of the step) holds no value to read:
    ``dp.clip_norm`` stands in, which sets no size."""
    if isinstance(C, torch.Tensor) and is_fake(C):
        return float(dp.clip_norm)
    return float(C)


def _require_grad_leaves(params) -> List[torch.Tensor]:
    leaves = tree.leaves(params)
    if not all(p.requires_grad for p in leaves):
        raise ValueError("the second pass differentiates the params: they "
                         "must require grad (model.requires_grad_(True))")
    return leaves


def _f32_grads(outputs, leaves, grad_outputs=None) -> List[torch.Tensor]:
    grads = list(torch.autograd.grad(outputs, leaves, grad_outputs))
    for i, g in enumerate(grads):      # one leaf at a time: the param-type
        grads[i] = g.float()           # grad is freed as its copy is made
    return grads


# ---------------------------------------------------------------------------
# the two passes of DP-SGD(R)
# ---------------------------------------------------------------------------

def _sum_partials(nsq: torch.Tensor) -> None:
    """The ranks' partial norms² made whole in place: summed over the
    ``model`` group (a slice's partial) and the ``stage`` group (the first
    stage rank's pullback holds them all)."""
    runtime.all_reduce_([nsq], runtime.model_group())
    runtime.all_reduce_([nsq], runtime.stage_group())


def norm_pass(loss_fn: Callable, params, data, dp: DPConfig, mask=None):
    """Pass 1: (per-example norms² (B,), per-row losses (B·K,)).

    The accumulator starts as zeros that require grad; every site adds its
    norm² to its gradient.  The params are detached, so the sites compute
    activation gradients and norms² and no weight gradient.  The loss
    cotangents are seeded with ``mask`` (float (B·K,) 0/1, default all
    ones): the pass backpropagates Σ mᵢ·Lᵢ, so every padded row's gy is an
    exact zero at every site, and so is its norm².  Tensor parallel, the
    ranks' partial norms² are summed over the ``model`` group, and across
    pipeline stages over the ``stage`` group."""
    device = tree.leaves(params)[0].device
    K = _views(dp)
    R = _batch_size(data)
    ctx = DPContext.norm_mode(R // K, dp.norm_strategy, dp.use_kernels, K,
                              device)
    acc0 = ctx.acc
    seed = _view_seed(_ones_if_none(mask, R, device), K)
    with torch.enable_grad():
        losses, ctx = loss_fn(tree.tree_map(torch.Tensor.detach, params),
                              data, ctx)
        (nsq,) = torch.autograd.grad((losses, ctx.acc), (acc0,),
                                     (seed.to(losses.dtype),
                                      torch.zeros_like(ctx.acc)))
    _sum_partials(nsq)
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
        data, mask = split_mask(batch)
        leaves = _require_grad_leaves(params)
        with torch.enable_grad():
            losses, _ = loss_fn(params, data, DPContext.off())
            m = _ones_if_none(mask, losses.shape[0], losses.device)
            grads = _f32_grads((m * losses).sum(), leaves)
        return grads, (losses.detach(),
                       torch.zeros_like(losses, dtype=F32).detach())
    return fn


def _dpsgd_r_sum(loss_fn, dp: DPConfig):
    K = _views(dp)

    def fn(params, batch):
        data, mask, clip = split_clip(batch)
        C = dp.clip_norm if clip is None else clip
        m = _ones_if_none(mask, _batch_size(data), tree.leaves(params)[0].device)
        nsq, losses = norm_pass(loss_fn, params, data, dp, m)     # lines 31-33
        c = clipping.clip_factors(nsq, C) * _example_mask(m, K)   # line 35
        grads = reweighted_grads(loss_fn, params, data,
                                 _expand_rows(c, K))              # lines 36-39
        return grads, (losses, nsq)
    return fn


def _dpsgd_sum(loss_fn, dp: DPConfig):
    K = _views(dp)

    def fn(params, batch):
        data, mask, clip = split_clip(batch)
        C = dp.clip_norm if clip is None else clip
        leaves = _require_grad_leaves(params)
        if any(runtime.model_shard_of(p) is not None for p in leaves):
            raise NotImplementedError(
                "dp.algo='dpsgd' on tensor-parallel model slices is not "
                "ported: its flat per-example buffers would need their "
                "norms² summed over the model group (ROADMAP queue 1)")
        if any(runtime.stage_shard_of(p) is not None for p in leaves):
            raise NotImplementedError(
                "dp.algo='dpsgd' on pipeline stage slices is not ported: its "
                "per-example backward would cross the pipeline once an "
                "example (ROADMAP queue 1)")
        # FSDP: each example's gradient must be whole before its clip, so
        # the slices are gathered once, outside autograd, and the whole
        # leaves differentiated (no collective in their backward)
        whole = {id(p): runtime.fsdp_whole(p).requires_grad_() for p in leaves
                 if runtime.fsdp_shard_of(p) is not None}
        if whole:
            params = tree.tree_map(lambda p: whole.get(id(p), p), params)
            leaves = tree.leaves(params)
        device = leaves[0].device
        R = _batch_size(data)
        B = R // K                         # examples (privacy units)
        me = _example_mask(_ones_if_none(mask, R, device), K)
        mbe = dp.microbatch or B
        if B % mbe:
            raise ValueError(f"dp.microbatch={dp.microbatch} does not divide "
                             f"the {B} examples of the batch")
        # one microbatch of per-example gradients, filled in place (a stack
        # of a list would hold two copies at once), one flat buffer per
        # dtype with a view per leaf; the running sums flat alike
        bufs, sums, stack, summed = clipping.flat_stacks(leaves, mbe)
        # float32 temporaries of the norms no larger than a leaf's slice,
        # as when each leaf was taken on its own
        max_elems = min(tree.SLICE_ELEMS, max(p.numel() for p in leaves))
        losses, nsqs = [], []
        for start in range(0, B, mbe):
            for i in range(mbe):
                b = start + i
                ex = tree.tree_map(lambda a: a[b * K:(b + 1) * K], data)
                with torch.enable_grad():
                    raw, _ = loss_fn(params, ex, DPContext.off())
                    # masked at the loss: a padded example's gradient and
                    # norm are exact zeros; the mean over its K views
                    grads = torch.autograd.grad(me[b] * raw.mean(), leaves)
                for s_, g in zip(stack, grads):
                    s_[i].copy_(g)
                del grads
                losses.append(raw.detach())
            nsqs.append(clipping.clip_and_sum(bufs, C, sums,
                                              me[start:start + mbe],
                                              dp.use_kernels, max_elems))
        return summed, (torch.cat(losses), torch.cat(nsqs))
    return fn


def _dpsgd_r1f_sum(loss_fn, dp: DPConfig):
    K = _views(dp)

    def fn(params, batch):
        data, mask, clip = split_clip(batch)
        C = dp.clip_norm if clip is None else clip
        leaves = _require_grad_leaves(params)
        device = leaves[0].device
        R = _batch_size(data)
        m = _ones_if_none(mask, R, device)
        pull = sites.Pull()
        ctx = DPContext.norm_mode(R // K, dp.norm_strategy, dp.use_kernels, K,
                                  device, pull=pull)
        acc0 = ctx.acc
        with torch.enable_grad():
            losses, ctx = loss_fn(params, data, ctx)
            pull.stage = "norms"            # no weight gradient
            (nsq,) = torch.autograd.grad(
                (losses, ctx.acc), (acc0,),
                (_view_seed(m, K).to(losses.dtype), torch.zeros_like(ctx.acc)),
                retain_graph=True)
            _sum_partials(nsq)
            c = clipping.clip_factors(nsq, C) * _example_mask(m, K)
            pull.stage = "grads"            # no norm²
            grads = _f32_grads(losses, leaves,
                               _expand_rows(c, K).to(losses.dtype))
        return grads, (losses.detach(), nsq)
    return fn


_ALGOS: dict = {}


def register_algo(name: str, factory: Callable, *, private: bool = True) -> None:
    """Register a clipped-sum algorithm: ``factory(loss_fn, dp) ->
    fn(params, batch) -> (grads, (losses, nsq))``.  ``private=False`` adds
    no noise and mean-normalises instead."""
    if name in _ALGOS:
        raise ValueError(f"dp.algo {name!r} already registered (registered "
                         f"algos: {sorted(_ALGOS)})")
    _ALGOS[name] = (factory, bool(private))


def unregister_algo(name: str) -> None:
    _ALGOS.pop(name, None)


def list_algos() -> list:
    return sorted(_ALGOS)


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
register_algo("dpsgd", _dpsgd_sum)
register_algo("dpsgd_r", _dpsgd_r_sum)
register_algo("dpsgd_r1f", _dpsgd_r1f_sum)


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
    """Build fn(params, batch, generator, clip_norm=None) -> (grads,
    metrics).

    ``expected_batch_size``: the private update's normaliser, in examples;
    None uses the physical example count (fixed-size batches); under
    Poisson sampling q·N.  ``generator`` draws the noise on the gradients'
    device: the gradients' first, then, under ``dp.adaptive_clip``, the
    below-C count's.  ``clip_norm``: a 0-d float32 tensor overriding
    ``dp.clip_norm`` (the trainer's adaptive clip state), put into every
    chunk as the ``"clip_norm"`` leaf."""
    csum = make_clipped_sum_fn(loss_fn, dp)
    private = algo_is_private(dp.algo, dp.enabled)
    K = _views(dp)

    def fn(params, batch, generator: torch.Generator, clip_norm=None):
        _, mask = split_mask(batch)
        R = _batch_size(batch)
        leaves = tree.leaves(params)
        fsdp = [runtime.fsdp_shard_of(p) for p in leaves]
        if R % K:
            raise ValueError(f"{R} rows do not hold {K} views each")
        full_mask = _ones_if_none(mask, R, leaves[0].device)
        mask_ex = _example_mask(full_mask, K)

        def with_clip(b):
            return b if clip_norm is None else dict(b, **{CLIP_KEY: clip_norm})

        if grad_accum == 1:
            summed, (losses, nsq) = csum(params, with_clip(batch))
        else:
            if R % grad_accum or (R // grad_accum) % K:
                raise ValueError(f"batch {R} ({K} views an example) does not "
                                 f"split into {grad_accum} chunks of whole "
                                 f"examples")
            summed, parts = None, []
            for chunk in _chunks(batch, grad_accum):
                s, ln = csum(params, with_clip(chunk))
                if summed is None:
                    summed = s
                else:
                    for a, b in zip(summed, s):
                        a.add_(b)
                parts.append(ln)
            losses = torch.cat([p[0] for p in parts])
            nsq = torch.cat([p[1] for p in parts])
        runtime.stage_flush()
        if runtime.active() is not None:
            # data parallel: this rank's clipped sum joins the others'
            # before the noise, and the metrics, the normaliser and the
            # adaptive clip read the global per-example vectors
            group = runtime.batch_group()
            # an FSDP slice's gradient is summed already (the gather's
            # backward); dpsgd's whole leaves are summed here and cut
            reduced = [sh is not None and g.shape == p.shape
                       for g, p, sh in zip(summed, leaves, fsdp)]
            # a whole leaf another stage rank runs has zeros here, which its
            # owner's broadcast below replaces
            owner = [runtime.stage_owner_of(p) for p in leaves]
            me = runtime.stage_shard()[0]
            runtime.all_reduce_([g for g, r, o in zip(summed, reduced, owner)
                                 if not r and o in (None, me)], group)
            summed = [g if sh is None or r else sh.of(g)
                      for g, sh, r in zip(summed, fsdp, reduced)]
            for src in sorted({o for o in owner if o is not None}):
                runtime.broadcast_([g for g, o in zip(summed, owner) if o == src],
                                   src, runtime.stage_group())
            losses, nsq, full_mask = (runtime.all_gather(t, group)
                                      for t in (losses, nsq, full_mask))
            mask_ex = _example_mask(full_mask, K)
            R = full_mask.shape[0]
        if private:
            C = dp.clip_norm if clip_norm is None else clip_norm
            denom = (float(expected_batch_size)
                     if expected_batch_size is not None else R // K)
            # a rank's FSDP slices draw on their data index, its model
            # slices on their model index, its stage slices on their stage
            # index (no two of them mix in one model)
            cuts = [runtime.cut_of(p) for p in leaves]
            local = [i for i, c in enumerate(cuts) if c is not None]
            shard_gen = None
            if local:
                sh, axis = cuts[local[0]]
                shard_gen = noise.shard_generator(generator, sh.index, axis)
            noise.add_noise_(summed, generator, dp.noise_multiplier,
                             _noise_clip(C, dp), denom, shard_gen,
                             local)                                 # lines 24/41
            metrics = _metrics(losses, nsq, C, full_mask, mask_ex)
            if dp.adaptive_clip and clip_norm is not None:
                state, frac = adaptive_clip.update(
                    {"clip_norm": clip_norm}, nsq, mask_ex, dp, denom,
                    generator)
                metrics["clip_norm"] = clip_norm.detach().clone()
                metrics["clip_frac_below"] = frac
                metrics["clip_norm_next"] = state["clip_norm"]
        else:
            count = torch.clamp(full_mask.sum(), min=1.0)
            for g in summed:
                g.div_(count)
            metrics = {"loss": (losses * full_mask).sum() / count,
                       "realized_batch": full_mask.sum()}
        return summed, metrics

    return fn
