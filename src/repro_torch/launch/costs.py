"""Cost accounting for the roofline and the launch autotuner: the traced
step's GEMM stream, its elementwise work and the bytes it moves.
Counterpart of ``repro/launch/costs.py``.

The JAX package walks the step's jaxpr (scan bodies times their trip
counts, Pallas kernel bodies times their grids) after a dead-code pass.
The port's step is eager autograd, so ``traced_costs`` runs it on fake
tensors under ``CostCounter``, a ``TorchDispatchMode`` below autograd, the
machinery of the memory planner's ``_LiveBytes`` (launch/memory.py): it
sees every op the step runs, forward, backward and remat recompute, once
each time it runs.  Python loops over layers and ``grad_accum`` chunks take
the place of scan trip counts.  There is no dead-code pass: the eager step
runs only what the card runs, so whatever it computes is counted.

* **Products.**  Every ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
  ``dot``, convolution and convolution backward is one ``(m, k, n)`` GEMM
  record, folded as the reference folds a ``dot_general`` (batch dims into
  M, N the rhs free dims) and a convolution (K every weight dim but the
  output feature), its FLOPs bucketed by the input dtype.
* **Moves.**  Gathers, scatters, ``index`` and ``index_put`` count their
  output bytes as ``move_bytes``; pure view and copy ops count nothing
  (the reference's ``_MOVE_PRIMS``).
* **Everything else** counts one FLOP per output element.
* **Kernels.**  A kernel wrapper (``kernels/*.py``) records the work of
  the function it computes, whichever of its branches runs: the GEMMs and
  elementwise FLOPs of its plain version (counted once per shape on meta
  tensors, the FLOPs in the wrapper's input dtype), and ``move_bytes``
  equal to the operands it reads and the results it writes, as the
  reference's ``pallas_call`` branch counts kernel operands and results.
  Nothing the wrapper runs inside (its plain version on the CPU, its fake
  branch's allocations) is counted again, so a kernel route costs the same
  on the card and on the CPU.
* **Collectives.**  ``dist/runtime.py``'s ``all_reduce_``,
  ``all_gather`` and FSDP's gathers and slice reductions append ``{"kind",
  "bytes", "group"}`` while a counter is active, under a layout with a
  process group or a group-less one of the mesh's shape (a trace of one
  rank's program, ``traced_rank``: its costs, collectives and peak from one
  trace); ``roofline.collective_bytes`` turns them into wire bytes.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.dist import runtime
from repro_torch.kernels import build as kbuild

_DOTS = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot", "vdot"}
_CONVS = {"convolution", "convolution_backward"}
_GATHERS = {
    "gather", "scatter", "scatter_add", "scatter_add_", "scatter_", "scatter_reduce",
    "scatter_reduce_", "index", "index_select", "index_put", "index_put_",
    "_index_put_impl_", "index_add", "index_add_", "embedding",
    "embedding_dense_backward", "take", "masked_select",
}
# views, copies, fills, comparisons, selects and sorts: no work counted
_MOVES = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "permute",
    "transpose", "t", "squeeze", "unsqueeze", "slice", "select", "narrow",
    "split", "split_with_sizes", "unsafe_split", "unbind", "chunk", "cat",
    "stack", "clone", "copy_", "copy", "_to_copy", "to", "contiguous",
    "detach", "alias", "as_strided", "unfold", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "zeros", "zeros_like",
    "new_zeros", "ones", "ones_like", "new_ones", "full", "full_like",
    "new_full", "fill_", "fill", "zero_", "arange", "scalar_tensor",
    "lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "eq", "ne", "lt",
    "gt", "le", "ge", "logical_and", "logical_or", "logical_not",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor",
    "where", "masked_fill", "masked_fill_", "constant_pad_nd", "pad", "flip",
    "sort", "argsort", "topk", "repeat", "view_as_real", "view_as_complex",
    "_conj", "resolve_conj", "resolve_neg", "set_", "resize_", "_pin_memory",
}


def _name(func) -> str:
    return func.overloadpacket.__name__


def _numel(t) -> int:
    return int(t.numel())


def _bytes(t) -> int:
    return int(t.numel()) * t.element_size()


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


class Costs:
    """The reference's ``Costs``: dot FLOPs by input dtype, elementwise
    FLOPs, product and move bytes and the GEMM multiset, plus the kernel
    records by wrapper (``kernels``) and the collective records
    (``collectives``)."""

    def __init__(self):
        self.dot_flops: Dict[str, float] = {}
        self.ew_flops = 0.0
        self.dot_bytes = 0.0
        self.move_bytes = 0.0
        # (m, k, n) -> how many times the step runs it: what the
        # sim/dataflow.py cycle model prices (launch/autotune.py fitness)
        self.gemms: Dict[tuple, float] = {}
        # wrapper name -> {"calls", "dot_flops", "ew_flops", "bytes"}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.collectives: List[dict] = []

    @property
    def total_flops(self) -> float:
        return sum(self.dot_flops.values()) + self.ew_flops

    @property
    def total_bytes(self) -> float:
        return self.dot_bytes + self.move_bytes

    def gemm_list(self):
        """Deterministically-ordered [(m, k, n, mult), ...]."""
        return [(m, k, n, mult)
                for (m, k, n), mult in sorted(self.gemms.items())]

    def as_dict(self) -> dict:
        return {"dot_flops_by_dtype": dict(self.dot_flops),
                "elementwise_flops": self.ew_flops,
                "dot_bytes": self.dot_bytes,
                "move_bytes": self.move_bytes,
                "total_flops": self.total_flops,
                "total_bytes": self.total_bytes,
                "gemms": [list(g) for g in self.gemm_list()],
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "collectives": [dict(r) for r in self.collectives]}

    def _gemm(self, m, k, n, dtype, nbytes) -> None:
        flops = 2.0 * m * k * n
        dt = _dtype_name(dtype)
        self.dot_flops[dt] = self.dot_flops.get(dt, 0.0) + flops
        self.dot_bytes += nbytes
        key = (int(m), int(k), int(n))
        self.gemms[key] = self.gemms.get(key, 0.0) + 1.0


def _dot_cost(name, args, out, acc: Costs) -> None:
    if name in ("addmm", "baddbmm", "addmv"):
        bias, a, b = args[0], args[1], args[2]
        acc.ew_flops += _numel(out)          # the added term
    else:
        bias, a, b = None, args[0], args[1]
    dtype = torch.promote_types(a.dtype, b.dtype)
    nbytes = _bytes(a) + _bytes(b) + _bytes(out)
    if name in ("mm", "addmm"):
        m, k = a.shape
        n = b.shape[1]
    elif name in ("bmm", "baddbmm"):
        bs, m, k = a.shape
        m, n = bs * m, b.shape[2]
    elif name in ("mv", "addmv"):
        (m, k), n = a.shape, 1
    else:                                    # dot, vdot
        m, k, n = 1, a.shape[0], 1
    acc._gemm(m, k, n, dtype, nbytes)


def _conv_cost(name, args, out, acc: Costs) -> None:
    """The reference's ``_conv_cost``: 2 · output elements · K, K every
    weight dim but the output feature's.  The backward's input gradient is
    the convolution of gy with the weight (output feature C_in), its
    weight gradient that of x with gy (output feature C_out, K the rows of
    gy), as the reference's transposed convolutions count them."""
    if name == "convolution":
        x, w = args[0], args[1]
        transposed, groups = bool(args[6]), int(args[8])
        n = w.shape[1] * groups if transposed else w.shape[0]
        k = w.numel() // n
        acc._gemm(out.numel() // max(n, 1), k, n, torch.promote_types(x.dtype, w.dtype),
                  _bytes(x) + _bytes(w) + _bytes(out))
        return
    gy, x, w = args[0], args[1], args[2]
    groups, mask = int(args[9]), args[10]
    gx, gw, gb = out
    dtype = torch.promote_types(gy.dtype, w.dtype)
    if mask[0] and gx is not None:
        n = x.shape[1]
        k = gy.shape[1] // groups * math.prod(w.shape[2:])
        acc._gemm(gx.numel() // n, k, n, dtype, _bytes(gy) + _bytes(w) + _bytes(gx))
    if mask[1] and gw is not None:
        n = w.shape[0]
        k = gy.numel() // gy.shape[1]
        acc._gemm(gw.numel() // n, k, n, dtype, _bytes(x) + _bytes(gy) + _bytes(gw))
    if len(mask) > 2 and mask[2] and gb is not None:
        acc.ew_flops += gb.numel()


def _count(func, args, out, acc: Costs) -> None:
    name = _name(func)
    if name in _DOTS:
        _dot_cost(name, args, out, acc)
    elif name in _CONVS:
        _conv_cost(name, args, out, acc)
    elif name in _GATHERS:
        acc.move_bytes += sum(_bytes(t) for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor))
    elif name not in _MOVES:
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs and name.endswith("_") and isinstance(args[0], torch.Tensor):
            outs = [args[0]]                  # an in-place op: its self
        acc.ew_flops += sum(_numel(t) for t in outs)


def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


def _shape_key(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    return repr(x)


# (wrapper, argument shapes) -> the work of its plain version
_KERNEL_WORK: Dict[tuple, dict] = {}


def _plain_work(name: str, plain, args, kwargs) -> dict:
    """The work of ``plain(*args, **kwargs)``, run once per shape on meta
    tensors outside every active mode: its GEMMs and FLOPs, the bytes of
    the inputs its ops read and of its results."""
    key = (name, tuple(_shape_key(a) for a in args),
           tuple(sorted((k, _shape_key(v)) for k, v in kwargs.items())))
    work = _KERNEL_WORK.get(key)
    if work is not None:
        return work
    counter = CostCounter(kernels=False)
    with _disable_current_modes(), torch.no_grad():
        margs, mkw = tree_map(_meta, args), tree_map(_meta, kwargs)
        inputs = [t for t in tree_leaves((margs, mkw)) if isinstance(t, torch.Tensor)]
        with counter:
            out = plain(*margs, **mkw)
    read = {id(t) for t in counter.read}
    nbytes = sum(_bytes(t) for t in inputs if id(t) in read)
    nbytes += sum(_bytes(t) for t in tree_leaves(out) if isinstance(t, torch.Tensor))
    c = counter.costs
    work = {"dot_flops": sum(c.dot_flops.values()), "gemms": dict(c.gemms),
            "ew_flops": c.ew_flops, "bytes": float(nbytes)}
    _KERNEL_WORK[key] = work
    return work


class CostCounter(TorchDispatchMode):
    """Counts the work of every op below autograd into ``costs`` (a
    ``Costs``), the kernel wrappers' records and, while active, the
    collectives of ``dist/runtime.py``.  Run the function under a
    ``FakeTensorMode`` on fake tensors to count without computing."""

    def __init__(self, kernels: bool = True):
        super().__init__()
        self.costs = Costs()
        self.quiet = 0
        self.kernels = kernels
        self.read = []              # tensors the ops took (a kernel's plain run)

    def __enter__(self):
        if self.kernels:
            kbuild.COST_SINKS.append(self)
            self._trace = contextlib.ExitStack()
            self._trace.enter_context(runtime.traced())
            self._trace.enter_context(runtime.metered(self.costs.collectives))
        return super().__enter__()

    def __exit__(self, *exc):
        if self.kernels:
            kbuild.COST_SINKS.remove(self)
            self._trace.close()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.quiet:
            if not self.kernels:
                self.read.extend(t for t in tree_leaves((args, kwargs))
                                 if isinstance(t, torch.Tensor))
            _count(func, args, out, self.costs)
        return out

    @contextlib.contextmanager
    def kernel(self, name: str, plain, args, kwargs):
        """A kernel wrapper's call: its plain version's work recorded once,
        nothing inside counted."""
        if self.quiet:
            yield
            return
        work = _plain_work(name, plain, args, kwargs)
        acc = self.costs
        first = next(a for a in tree_leaves(args) if isinstance(a, torch.Tensor)
                     and a.is_floating_point())
        dt = _dtype_name(first.dtype)
        acc.dot_flops[dt] = acc.dot_flops.get(dt, 0.0) + work["dot_flops"]
        for g, v in work["gemms"].items():
            acc.gemms[g] = acc.gemms.get(g, 0.0) + v
        acc.ew_flops += work["ew_flops"]
        acc.move_bytes += work["bytes"]
        rec = acc.kernels.setdefault(name, dict(calls=0, dot_flops=0.0,
                                                ew_flops=0.0, bytes=0.0))
        rec["calls"] += 1
        rec["dot_flops"] += work["dot_flops"]
        rec["ew_flops"] += work["ew_flops"]
        rec["bytes"] += work["bytes"]
        self.quiet += 1
        try:
            yield
        finally:
            self.quiet -= 1


def _io_bytes(*trees) -> int:
    seen = {}
    for t in tree_leaves(trees):
        if isinstance(t, torch.Tensor):
            seen[id(t)] = _bytes(t)
    return int(sum(seen.values()))


def traced_costs(fn, *args, device=None) -> dict:
    """Run ``fn(*args)`` on fake tensors under a ``CostCounter`` and return
    its costs (``Costs.as_dict`` and ``io_bytes``, the arguments' and
    results' bytes).  ``args``: trees of tensors (real or meta), each made
    a fake tensor of its shape, dtype and gradient flag on ``device``
    (default its own; the CPU for a meta tensor).  The counterpart of the
    reference's ``jaxpr_costs(fn, *abstract_args)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def fake(t):
        if not isinstance(t, torch.Tensor):
            return t
        dev = device or ("cpu" if t.device.type == "meta" else t.device)
        return torch.empty(t.shape, dtype=t.dtype, device=dev).requires_grad_(
            t.requires_grad)

    with runtime.suspended(), FakeTensorMode():
        fargs = tree_map(fake, args)
        counter = CostCounter()
        with counter:
            out = fn(*fargs)
        io = _io_bytes(fargs, out)
    d = counter.costs.as_dict()
    d["io_bytes"] = float(io)
    return d


# the model attribute and param attribute of each layout of a rank's slices,
# in the order ``Model`` registers them (one a param)
_RANK_LAYOUTS = (("stage", "stage_shard", "stage_shards"),
                 ("tp", "model_shard", "model_shards"),
                 ("fsdp", "fsdp_shard", "fsdp_shards"))


def traced_rank(model, mesh, batch_abs, *, train_cfg=None, kind: str = "train",
                cache_len: int = 0, expected_batch_size=None, device=None,
                zero1: bool = True, costs: bool = True, peak: bool = True) -> dict:
    """One trace of rank 0's program on ``mesh``, a mesh of axis names and
    sizes with no process group (``launch/mesh.py`` ``traced_mesh``), on
    fake tensors under its layout (``dist.runtime.layout`` inside
    ``runtime.traced()``: every group a ``TracedGroup``, its collectives
    recorded and not run).

    The rank holds the first slice of each of ``model``'s params that the
    mesh cuts (``dist.sharding``'s ``stage_shards``, ``model_shards`` and
    ``fsdp_shards``; ``model`` is built whole, on any device, and its
    refusals, ``tp_refusal`` and the like, are the caller's to check) and
    its share of ``batch_abs``'s rows over the batch axes
    (``sharding.batch_pspec``; every row where the batch does not divide).
    ``kind``: ``"train"``, the Trainer's ``TrainStep`` of ``train_cfg``
    (its ZeRO-1 over the mesh's ``data`` axis with ``zero1``); or
    ``"prefill"`` or ``"decode"`` (``launch/memory.py`` ``serve_program``)
    into or against a cache of ``cache_len`` positions, the rank's KV heads
    of it.  ``device`` (default the model's) is the fake tensors' device,
    so it picks the kernel routes.

    Returns ``{"collectives": [...]}`` (``{"kind", "bytes", "group"}``)
    and, with ``costs``, ``"costs"`` (a ``CostCounter``'s ``Costs.as_dict``
    and ``io_bytes``) and, with ``peak``, ``"memory"`` (the
    ``PeakEstimate`` of the rank's program and ``peak_op``): the three from
    the same trace.  The model, its params and remat policy and every
    generator are as they were afterwards."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import tree
    from repro_torch.dist import sharding
    from repro_torch.launch import memory
    from repro_torch.train.trainer import TrainStep
    device = model.device if device is None else torch.device(device)
    layouts = {}
    for attr, _, fn in _RANK_LAYOUTS:
        cut = getattr(sharding, fn)(mesh, model, index=0)
        layouts[attr] = cut if tree.leaves(cut) else None
    attr, shards = next(((a, layouts[m]) for m, a, _ in _RANK_LAYOUTS
                         if layouts[m] is not None), (None, None))
    width = sharding.stage_axis_width(mesh)

    def walk(p, sh, key=None):
        """A fake param of ``p``'s type: the slice ``sh`` names, or whole
        (on a stage axis, owned by the stage rank that runs it)."""
        if isinstance(p, dict):
            return {k: walk(v, None if sh is None else sh[k], k if key is None else key)
                    for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            out = [walk(v, None if sh is None else s, key)
                   for v, s in zip(p, sh if sh is not None else [None] * len(p))]
            return tuple(out) if isinstance(p, tuple) else out
        shape = list(p.shape)
        if sh is not None:
            shape[sh.dim] = sh.part
        t = torch.empty(shape, dtype=p.dtype, device=device).requires_grad_(kind == "train")
        if sh is not None:
            setattr(t, attr, sh)
        elif width > 1:
            t.stage_owner = sharding.stage_owner(key, width)
        return t

    rows = tree.leaves(batch_abs)[0].shape[0]
    bax = sharding.batch_pspec(mesh, rows)
    n = 1 if bax is None else math.prod(sharding._axis_size(mesh, a) for a in bax)
    saved = (model.fsdp, model.tp, model.stage, model.remat, model.params)
    for a in layouts:
        setattr(model, a, layouts[a])
    cache_abs = (memory.abstract_cache(model, rows // n, cache_len)
                 if kind == "decode" else None)
    try:
        with runtime.traced(), FakeTensorMode():
            def fake(t):
                return torch.empty(t.shape, dtype=t.dtype, device=device)
            params = walk(model.abstract_params(), shards)
            batch = tree.tree_map(lambda t: torch.empty(
                (t.shape[0] // n,) + tuple(t.shape[1:]), dtype=t.dtype,
                device=device), batch_abs)
            if kind == "train":
                model.remat = train_cfg.remat
                step = TrainStep(model, train_cfg, expected_batch_size,
                                 mesh=mesh if zero1 else None)
                state = step.init_state(params, device)
                fn = lambda: step(state, batch, torch.Generator())    # noqa: E731
                resident = [state.params, state.opt_state, batch]
            else:
                model.params = params
                cache = None if cache_abs is None else tree.tree_map(fake, cache_abs)
                fn, resident = memory.serve_program(model, kind, batch, cache_len, cache)
                resident = [params] + resident
            counter = CostCounter() if costs else None
            with counter or contextlib.nullcontext(), \
                    runtime.metered() as records, runtime.layout(mesh, bax):
                if peak:
                    est, peak_op = memory.traced_peak_bytes(fn, resident)
                else:
                    fn()
    finally:
        model.fsdp, model.tp, model.stage, model.remat, model.params = saved
    out = {"collectives": records}
    if peak:
        out["memory"] = dict(est.as_dict(), peak_op=str(peak_op))
    if counter is not None:
        io = (est.arg_bytes + est.out_bytes) if peak else _io_bytes(resident)
        out["costs"] = dict(counter.costs.as_dict(), io_bytes=float(io),
                            collectives=[dict(r) for r in records])
    return out


def traced_rank_collectives(model, train_cfg, batch_abs, width: int,
                            expected_batch_size=None, device=None,
                            stages: int = 1) -> List[dict]:
    """The collective records (``{"kind", "bytes", "group"}``) of one
    rank's ``TrainStep`` on a ``width``-wide ``data`` axis beside a
    ``stages``-wide ``stage`` axis (``traced_rank`` on that mesh, no ZeRO-1,
    nothing counted but the collectives): the first rank's FSDP slices of
    ``model``'s params (whole leaves for an arch without ``use_fsdp``), its
    ``1/width`` of ``batch_abs``'s rows, and every gather, gradient
    reduction and all-gather that step makes.  ``stages`` above 1: the
    first stage rank, holding the blocks of its stages (``model`` built
    whole, with the run's ``pp_stages``), its records the sends of its
    microbatches' activations (the received cotangents and losses are the
    sends of the other stage ranks), the norms²'s sum over the stage group
    and the broadcast of the clipped sums of the leaves it runs alone."""
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import traced_mesh
    mesh = traced_mesh((width, stages), ("data", sharding.STAGE_AXIS))
    return traced_rank(model, mesh, batch_abs, train_cfg=train_cfg,
                       expected_batch_size=expected_batch_size, device=device,
                       zero1=False, costs=False, peak=False)["collectives"]


# ---------------------------------------------------------------------------
# registry-backed norm-rule accounting (core/sites.py FLOP formulas)
# ---------------------------------------------------------------------------

def norm_rule_summary(site_shapes) -> list:
    """Per-site-kind norm-rule cost table, straight from the registry.

    ``site_shapes``: iterable of ``(label, kind, operand_shapes, gy_shape)``.
    For each entry, every rule the site registered is costed with the
    site's own FLOP formulas and the ``"auto"`` winner is resolved."""
    from repro_torch.core import sites
    rows = []
    for label, kind, op_shapes, gy_shape in site_shapes:
        site = sites.get_site(kind)
        per = {name: float(fn(op_shapes, gy_shape))
               for name, fn in site.flops.items()}
        rows.append({"label": label, "kind": kind,
                     "gy_shape": [int(s) for s in gy_shape],
                     "rule_flops": per,
                     "auto": sites.resolve_strategy(kind, "auto", op_shapes,
                                                    gy_shape)})
    return rows
