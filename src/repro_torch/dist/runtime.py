"""Batch-local execution and the collectives of data-parallel DP-SGD.
Counterpart of ``repro/dist/runtime.py``.

The JAX package runs one program over a mesh and wraps its per-example
ops in ``shard_map`` over the batch axes.  The port runs one process a
device: each rank already holds only its shard of the batch (the Trainer
takes its contiguous, example-aligned slice of the global batch), so every
per-example op is local by construction, and what crosses ranks is
explicit: the clipped-gradient sum is all-reduced over the batch axes
before the noise, and the per-example losses, norms² and mask are
all-gathered for the metrics (core/algo.py).

The layout is ambient, as in the reference: the launcher activates
``layout(mesh, batch_axes)`` around training, and outside one every
function here is the single-process op, so the same model and algorithm
code runs in one process (tests, the chip smoke run) and data-parallel.

Collectives take CUDA tensors on NCCL and on gloo; gloo gets a host copy
(which is what it would stage itself), and gathers move raw bytes, so any
dtype crosses any backend bit for bit.  Only ``all_reduce``,
``all_gather`` (over gloo: ``broadcast``), ``broadcast``,
``all_gather_object`` and point-to-point sends are used: gloo has no
reduce-scatter.

FSDP (a ``use_fsdp`` arch on a ``data`` axis above 1): each rank holds one
slice of every param that ``sharding.fsdp_shards`` places on ``data``,
the param carrying its ``sharding.Shard`` as ``fsdp_shard``.
``fsdp_gather`` makes the whole leaf from the slices just before a layer
uses it, through ``_Gather``, a ``torch.autograd.Function`` whose
backward sums the whole-leaf gradient over the batch group into this
rank's slice (``reduce_slice``, a reduce-scatter made of point-to-point
sends, since gloo has none): pass 2's gradient of a slice is the sum over
every rank's examples.  Over gloo a gather is one broadcast from each
rank (gloo's ``all_gather`` moves a few times fewer bytes a second), and
CUDA tensors cross the host in pinned memory.  ``dpsgd`` needs each
example's whole gradient before its clip, so it gathers whole leaves once
a step outside autograd (``fsdp_whole``): their local gradient is the
whole one, with no collective, and the clipped sum is reduced once
(core/algo.py).

Tensor parallelism (a ``model`` axis above 1, Megatron's layout, which
``sharding.spec_for_param``'s placements give): each rank holds the
contiguous slice at its ``model`` coordinate of every param placed on
``model`` (``sharding.model_shards``; the param carries its ``Shard`` as
``model_shard``) and the whole of the rest (the norm scales).  The layout
activates for the ``model`` axis alone as well, so a (1, 2) mesh, whose
batch is not sharded, runs its model collectives.  ``to_model`` is the
identity forward and sums the gradient over the ``model`` group backward
(before a column-parallel product); ``from_model`` sums over the group
forward and is the identity backward (after a row-parallel product).
Both go through ``all_reduce_``.  Every model rank holds the whole
residual stream and its gradient, alike bit for bit.

Pipeline stages across processes (a ``stage`` axis above 1, the
reference's placement, ``sharding.stage_shards``): each rank holds the
contiguous blocks of its stages (the param carries its ``Shard`` as
``stage_shard``) and the whole of the embedding, prelude, final norm and
head (``stage_owner``: the stage rank whose gradient of it is the real one,
the first for the embedding and prelude, the last for the final norm and
head).  Every stage rank of a ``data`` coordinate takes the same examples;
the model (models/transformer.py) moves each microbatch's (x, acc, aux)
between stage ranks through ``StagePipe``: ``send_next`` forward sends to
rank w+1 and backward receives the cotangents, ``recv_prev`` forward
receives and backward sends them to w-1, and the last rank's per-example
losses reach every stage rank through ``share_losses``, with graph edges
to that rank's sends and to the params it does not use (``_Anchor``, whose
gradient is zero), so that ``torch.autograd.grad`` over the losses, the
norm accumulator or the params runs every send's and receive's backward on
every rank.  Every message is tagged by (loss call, microbatch, direction,
pullback) and every send is posted with ``isend`` and waited at the end of
the step (``stage_flush``), so no order the autograd engines of two ranks
walk the microbatches in can deadlock; a receive waits the group's timeout
and raises when a peer is lost.  Tags need gloo: on NCCL, which ignores
them, a stage axis raises.

Metering: inside ``metered()`` (the launcher's byte count, a
``CostCounter``), ``all_reduce_``, ``all_gather``, ``broadcast_``,
``reduce_slice`` and the stage sends append ``{"kind", "bytes", "group"}``
to its records (``bytes``: the result's size on one rank; a
reduce-scatter's, the summed leaf's; a send's, the tensors it carries).  A
meter changes nothing else.  Cost traces (launch/costs.py): inside
``traced()``, and only there, a layout over a mesh with no process group
(an object of the mesh's axis names and shape) is a trace of one rank's
step: its batch group is a ``TracedGroup`` of the batch axes' size, whose
collectives record and return what a real group's would in shape, moving
nothing (a stage message records its send and is received as zeros).
Anywhere else such a layout raises, as a step that would skip its
collectives must not run.  In a trace the rank is coordinate 0 of every
axis, and any batch axes take a ``TracedGroup`` (the production meshes'
``pod`` and ``data`` together, beside a ``model`` axis: launch/dryrun.py),
where a real world takes only the whole world or one axis.
"""
from __future__ import annotations

import contextlib
import math
import zlib
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.dist import sharding as _sh


class _Layout:
    """The ambient layout, process-wide: the autograd engine runs a CUDA
    backward, and the remat recompute inside it, on a thread of its own,
    which must see the layout its forward ran under (FSDP's gathers, the
    stage messages)."""

    def __init__(self):
        self.mesh = None
        self.batch_axes: Optional[Tuple[str, ...]] = None
        self.traces = 0           # cost traces in progress (``traced``)
        self.suspended = 0        # ``suspended`` contexts in progress
        # the loss calls on a stage layout so far, which number their
        # messages alike on every stage rank, and the sends posted and not
        # yet waited (``stage_flush``), each with its buffer
        self.stage_calls = 0
        self.pending: list = []


_ACTIVE = _Layout()
# the active meters' collective record lists, innermost last (``metered``)
COLLECTIVE_SINKS: list = []


class TracedGroup:
    """The batch group of a layout with no process group: ``size`` ranks,
    collectives recorded and not run (a cost trace of one rank's step)."""

    def __init__(self, size: int):
        self.size = size


# a group of one rank: every collective over it is the identity and records
# nothing (the batch group of a layout whose batch is not sharded, the
# model group outside a tensor-parallel layout)
SOLO = TracedGroup(1)


@contextlib.contextmanager
def layout(mesh, batch_axes):
    """Activate data-parallel, tensor-parallel and pipeline execution:
    inside this context the batch dim is sharded over ``batch_axes`` of
    ``mesh``, one contiguous slice a rank, the model collectives run over
    its ``model`` axis and the stage messages over its ``stage`` axis.  A
    falsy ``batch_axes`` (batch not shardable) on a mesh with no ``model``
    or ``stage`` axis above 1 is a no-op, so ``layout(mesh,
    batch_pspec(mesh, B))`` is always safe; with one, every rank takes the
    whole batch.  The batch axes must span the whole world or be one axis
    of the mesh; a mesh with no process group is taken only inside a cost
    trace."""
    if not batch_axes and (mesh is None or all(
            _sh._axis_size(mesh, a) == 1
            for a in (_sh.MODEL_AXIS, _sh.STAGE_AXIS))):
        yield
        return
    prev = (_ACTIVE.mesh, _ACTIVE.batch_axes)
    _ACTIVE.mesh, _ACTIVE.batch_axes = mesh, tuple(batch_axes or ())
    try:
        batch_group()             # refuse an unsupported layout up front
        model_group()
        group = stage_group()
        if not isinstance(group, TracedGroup) and \
                dist.get_backend(group) != "gloo":
            raise NotImplementedError(
                f"a 'stage' axis on {dist.get_backend(group)}: pipeline "
                f"stages across processes match their messages by tag, which "
                f"only gloo keeps (ROADMAP queue 1)")
        yield
    finally:
        _ACTIVE.mesh, _ACTIVE.batch_axes = prev


@contextlib.contextmanager
def metered(records: Optional[list] = None):
    """Record every collective run inside into ``records`` (a new list if
    None), which it yields.  Nothing else changes: a layout with no process
    group still raises."""
    records = [] if records is None else records
    COLLECTIVE_SINKS.append(records)
    try:
        yield records
    finally:
        del COLLECTIVE_SINKS[[r is records for r in COLLECTIVE_SINKS].index(True)]


@contextlib.contextmanager
def traced():
    """A cost trace of one rank's step on fake tensors (launch/costs.py):
    inside it a layout over a mesh with no process group runs on
    ``TracedGroup``s, its collectives recorded and not run."""
    _ACTIVE.traces += 1
    try:
        yield
    finally:
        _ACTIVE.traces -= 1


@contextlib.contextmanager
def suspended():
    """No layout inside: the code runs as one process (the memory
    planner's trace of a step, which launches no collective; a
    tensor-parallel model then runs on its slices alone, with every model
    collective the identity)."""
    prev = (_ACTIVE.mesh, _ACTIVE.batch_axes)
    _ACTIVE.mesh, _ACTIVE.batch_axes = None, None
    _ACTIVE.suspended += 1
    try:
        yield
    finally:
        _ACTIVE.mesh, _ACTIVE.batch_axes = prev
        _ACTIVE.suspended -= 1


def is_suspended() -> bool:
    """Whether a ``suspended`` context is in progress."""
    return _ACTIVE.suspended > 0


def active() -> Optional[Tuple]:
    """The ambient (mesh, batch_axes), or None outside any ``layout``."""
    if _ACTIVE.mesh is None:
        return None
    return _ACTIVE.mesh, _ACTIVE.batch_axes


def _n_shards(mesh, bax) -> int:
    return math.prod(_sh._axis_size(mesh, a) for a in bax)


def _group_of(mesh, axes):
    """The process group of ``axes`` of ``mesh``: the world when they span
    it, else the one axis's group; a ``TracedGroup`` for a mesh with no
    process group inside a cost trace."""
    if not dist.is_initialized() or not hasattr(mesh, "get_group"):
        if _ACTIVE.traces:
            return TracedGroup(_n_shards(mesh, axes))
        raise RuntimeError(
            f"a layout over {_sh._axis_names(mesh)} with no process group: "
            f"join one (torch.distributed.init_process_group) before the "
            f"step; only a cost trace (launch/costs.py) runs without one")
    if _n_shards(mesh, axes) == dist.get_world_size():
        return dist.group.WORLD
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    raise NotImplementedError(
        f"batch axes {axes} span part of the mesh {_sh._axis_names(mesh)}: "
        f"only a batch over the whole world or one axis is ported "
        f"(ROADMAP queue 1)")


def batch_group():
    """The process group of the active layout's batch axes (None outside
    a layout): the world when they span it, else the one axis's group;
    ``SOLO`` when the batch is not sharded (a tensor-parallel layout on a
    ``data`` axis of 1)."""
    state = active()
    if state is None:
        return None
    if not state[1]:
        return SOLO
    return _group_of(*state)


def model_group():
    """The process group of the active layout's ``model`` axis; ``SOLO``
    outside a layout or on a ``model`` axis of 1."""
    state = active()
    if state is None or _sh._axis_size(state[0], _sh.MODEL_AXIS) == 1:
        return SOLO
    return _group_of(state[0], (_sh.MODEL_AXIS,))


def model_shard() -> Tuple[int, int]:
    """(this rank's coordinate, the size) of the active layout's ``model``
    axis; (0, 1) outside a layout or on an axis of 1 (and coordinate 0 in
    a cost trace, whose mesh has no ranks)."""
    state = active()
    if state is None:
        return 0, 1
    size = _sh._axis_size(state[0], _sh.MODEL_AXIS)
    if size == 1 or not hasattr(state[0], "get_local_rank"):
        return 0, size
    return state[0].get_local_rank(_sh.MODEL_AXIS), size


def stage_group():
    """The process group of the active layout's ``stage`` axis; ``SOLO``
    outside a layout or on a ``stage`` axis of 1."""
    state = active()
    if state is None or _sh._axis_size(state[0], _sh.STAGE_AXIS) == 1:
        return SOLO
    return _group_of(state[0], (_sh.STAGE_AXIS,))


def stage_shard() -> Tuple[int, int]:
    """(this rank's coordinate, the size) of the active layout's ``stage``
    axis; (0, 1) outside a layout or on an axis of 1 (and coordinate 0 in
    a cost trace, whose mesh has no ranks)."""
    state = active()
    if state is None:
        return 0, 1
    size = _sh._axis_size(state[0], _sh.STAGE_AXIS)
    if size == 1 or not hasattr(state[0], "get_local_rank"):
        return 0, size
    return state[0].get_local_rank(_sh.STAGE_AXIS), size


def fsdp_group():
    """The process group of the active layout's ``data`` axis, which FSDP
    shards params over.  Raises outside a layout: a sliced param cannot be
    gathered there."""
    state = active()
    if state is None:
        raise RuntimeError(
            "an FSDP-sharded param outside a data-parallel layout: its slices "
            "can only be gathered inside dist.runtime.layout(mesh, ...)")
    return _group_of(state[0], ("data",))


def batch_shard() -> Tuple[int, int]:
    """(this rank's index, the number of shards) of the batch under the
    active layout: the index over the batch axes in mesh order, outermost
    first; (0, 1) outside a layout."""
    state = active()
    if state is None:
        return 0, 1
    mesh, bax = state
    idx = 0
    for a in bax:
        idx = idx * _sh._axis_size(mesh, a) + _local_rank(mesh, a)
    return idx, _n_shards(mesh, bax)


def _local_rank(mesh, name: str) -> int:
    """This rank's coordinate on axis ``name``: 0 on a mesh with no process
    group (a trace of rank 0's program)."""
    return mesh.get_local_rank(name) if hasattr(mesh, "get_local_rank") else 0


def axis_shard(mesh, name: str) -> Tuple[int, int, object]:
    """(this rank's coordinate, the size, the process group) of one mesh
    axis; (0, 1, None) when the mesh lacks it; (0, the size, a
    ``TracedGroup``) on a mesh with no process group inside a cost trace."""
    size = _sh._axis_size(mesh, name)
    if size == 1:
        return 0, 1, None
    if hasattr(mesh, "get_group"):
        return mesh.get_local_rank(name), size, mesh.get_group(name)
    return 0, size, _group_of(mesh, (name,))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _group_size(group) -> int:
    if isinstance(group, TracedGroup):
        return group.size
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _record(kind: str, nbytes: int, n: int) -> None:
    if COLLECTIVE_SINKS:
        COLLECTIVE_SINKS[-1].append({"kind": kind, "bytes": int(nbytes),
                                     "group": int(n)})


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's backend takes it: a contiguous tensor, on the
    host for gloo (in pinned memory, which crosses the link several times
    faster, from blocks the caching host allocator reuses)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return t.contiguous()


def _like(h: torch.Tensor, shape=None) -> torch.Tensor:
    """An empty buffer beside a staged tensor: on its device, pinned when
    it is."""
    return torch.empty(h.shape if shape is None else shape, dtype=h.dtype,
                       device=h.device, pin_memory=h.is_pinned())


def all_reduce_(tensors: List[torch.Tensor], group=None,
                op: str = "sum") -> None:
    """Sum (``op="max"``: take the largest of) each tensor over ``group``'s
    ranks, in place."""
    n = _group_size(group)
    if n == 1:
        return
    for t in tensors:
        _record("all-reduce", t.numel() * t.element_size(), n)
    if isinstance(group, TracedGroup):
        return
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for t in tensors:
        h = _staged(t, group)
        dist.all_reduce(h, op=rop, group=group)
        if h is not t:
            t.copy_(h)


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank) concatenated along
    ``dim`` in rank order, on ``t``'s device; the bytes cross unchanged."""
    n = _group_size(group)
    if n == 1:
        return t
    _record("all-gather", n * t.numel() * t.element_size(), n)
    if isinstance(group, TracedGroup):
        return torch.cat([t] * n, dim=dim)
    h = _staged(t, group)
    flat = h.reshape(-1).view(torch.uint8)
    out = _like(flat, (n, flat.numel()))
    if dist.get_backend(group) == "gloo":
        # one broadcast from each rank into its row: gloo's all_gather
        # moves a few times fewer bytes a second between processes
        me = dist.get_rank(group)
        out[me].copy_(flat)
        for k in range(n):
            dist.broadcast(out[k], group=group,
                           src=dist.get_global_rank(group, k))
    else:
        dist.all_gather(list(out.unbind(0)), flat, group=group)
    whole = out.to(t.device).view(t.dtype).reshape((n,) + tuple(t.shape))
    return torch.cat(whole.unbind(0), dim=dim)


def broadcast_(tensors: List[torch.Tensor], src: int, group) -> None:
    """Each tensor of the rank at coordinate ``src`` of ``group`` given to
    every rank of it, in place."""
    n = _group_size(group)
    if n == 1:
        return
    for t in tensors:
        _record("broadcast", t.numel() * t.element_size(), n)
    if isinstance(group, TracedGroup):
        return
    root = dist.get_global_rank(group, src)
    for t in tensors:
        h = _staged(t, group)
        dist.broadcast(h, src=root, group=group)
        if h is not t:
            t.copy_(h)


def reduce_slice(g: torch.Tensor, shard, group, lead: int = 0) -> torch.Tensor:
    """This rank's ``shard`` (``sharding.Shard``) of the sum of the whole
    leaf ``g`` over ``group``'s ranks, as a new tensor on ``g``'s device;
    ``g`` is left as it was.  ``lead``: leading dims of the stacked leaf
    indexed away.  A reduce-scatter: each rank sends every other rank that
    rank's slice of its ``g`` and adds the slices it receives to its own,
    in rank order, on ``g``'s device (gloo has no reduce-scatter; point to
    point, each rank moves (n-1)/n of the leaf each way, where an
    all-reduce moves twice that and sums on the host).  Recorded as a
    ``reduce-scatter`` of ``g``'s bytes."""
    n = _group_size(group)
    if n > 1:
        _record("reduce-scatter", g.numel() * g.element_size(), n)
    if n == 1 or isinstance(group, TracedGroup):
        return shard.of(g, lead).clone()
    d, me = shard.dim - lead, dist.get_rank(group)
    parts = [g.narrow(d, k * shard.part, shard.part) for k in range(n)]
    ops, got = [], {}
    for k in range(n):
        if k != me:
            peer = dist.get_global_rank(group, k)
            send = _staged(parts[k], group)
            got[k] = _like(send)
            ops += [dist.P2POp(dist.isend, send, peer, group),
                    dist.P2POp(dist.irecv, got[k], peer, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = parts[me].clone(memory_format=torch.contiguous_format)
    for k in sorted(got):
        out += got[k].to(g.device)
    return out


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------

def fsdp_shard_of(t) -> Optional["_sh.Shard"]:
    """The ``sharding.Shard`` an FSDP-sharded param carries, else None."""
    return getattr(t, "fsdp_shard", None)


class _Gather(torch.autograd.Function):
    """This rank's slice -> the whole leaf (``all_gather`` along the
    shard's dim over the ``data`` group).  Backward: the whole-leaf
    gradient summed over the batch group into this rank's slice
    (``reduce_slice``), so a slice's gradient sums every rank's examples."""

    @staticmethod
    def forward(ctx, part, shard, lead, group):
        ctx.shard, ctx.lead, ctx.reduce_group = shard, lead, batch_group()
        return all_gather(part, group, shard.dim - lead)

    @staticmethod
    def backward(ctx, g):
        return (reduce_slice(g, ctx.shard, ctx.reduce_group, ctx.lead),
                None, None, None)


def fsdp_gather(part: torch.Tensor, shard, lead: int = 0) -> torch.Tensor:
    """The whole leaf of an FSDP slice, differentiable (``_Gather``):
    ``part`` is this rank's ``shard`` of a leaf, ``lead`` leading dims of
    the stacked leaf indexed away.  A leaf that is already whole (a trace
    of the whole-param step, ``dpsgd``'s gathered leaves) is returned as
    it is; a slice outside a layout raises (``fsdp_group``)."""
    d = shard.dim - lead
    if part.shape[d] == shard.size:
        return part
    if part.shape[d] != shard.part:
        raise ValueError(f"FSDP slice of {part.shape[d]} along dim {d}; the "
                         f"shard is {shard.part} of {shard.size}")
    group = fsdp_group()
    if _group_size(group) != shard.count:
        raise RuntimeError(f"FSDP slices of {shard.count} ranks gathered over "
                           f"a group of {_group_size(group)}")
    return _Gather.apply(part, shard, lead, group)


def fsdp_whole(p: torch.Tensor) -> torch.Tensor:
    """An FSDP-sharded param's whole leaf, outside autograd (``dpsgd``'s
    per-example mode: the caller differentiates the whole leaf, so each
    example's gradient is whole and local); any other param as it is."""
    shard = fsdp_shard_of(p)
    if shard is None:
        return p
    with torch.no_grad():
        return fsdp_gather(p.detach(), shard)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def model_shard_of(t) -> Optional["_sh.Shard"]:
    """The ``sharding.Shard`` a tensor-parallel model slice carries, else
    None."""
    return getattr(t, "model_shard", None)


class _ToModel(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over the ``model``
    group (each rank's column-parallel products give a partial one)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        all_reduce_([g], ctx.group)
        return g, None


class _FromModel(torch.autograd.Function):
    """Forward, the partial sums of a row-parallel product summed over the
    ``model`` group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        all_reduce_([y], group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` entering the column-parallel products of a layer: itself, with
    its gradient summed over the ``model`` group (``_ToModel``); ``x`` as
    it is outside a tensor-parallel layout."""
    group = model_group()
    return x if group is SOLO else _ToModel.apply(x, group)


def from_model(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sum made whole over the ``model``
    group (``_FromModel``); ``x`` as it is outside a tensor-parallel
    layout."""
    group = model_group()
    return x if group is SOLO else _FromModel.apply(x, group)


def counts_replicated() -> bool:
    """Whether this rank adds the norm² of a param replicated over the
    ``model`` axis: its per-example gradient is whole and alike on every
    model rank, so only the first of them counts it in the norm² that is
    summed over the group (``core.algo.norm_pass``)."""
    return model_shard()[0] == 0


# ---------------------------------------------------------------------------
# pipeline stages across processes
# ---------------------------------------------------------------------------

def stage_shard_of(t) -> Optional["_sh.Shard"]:
    """The ``sharding.Shard`` a stage rank's blocks slice carries, else
    None."""
    return getattr(t, "stage_shard", None)


def cut_of(t) -> Optional[Tuple["_sh.Shard", str]]:
    """(the ``sharding.Shard``, its mesh axis) of a param this rank holds a
    slice of: an FSDP slice (``data``), a model slice or a stage slice;
    None for a whole param."""
    for sh, axis in ((fsdp_shard_of(t), "data"), (model_shard_of(t), _sh.MODEL_AXIS),
                     (stage_shard_of(t), _sh.STAGE_AXIS)):
        if sh is not None:
            return sh, axis
    return None


def stage_owner_of(t) -> Optional[int]:
    """The stage coordinate whose gradient of a param every stage rank
    holds whole is the real one (the rank that runs it), else None."""
    return getattr(t, "stage_owner", None)


_FWD, _LOSS, _BWD = 0, 1, 2


def _tag(call: int, mb: int, kind: int) -> int:
    """A message's gloo tag: (loss call, microbatch, kind), kind
    ``_FWD``, ``_LOSS`` or ``_BWD`` + the pullback's index."""
    return ((call % 4096) * 1024 + mb % 1024) * 64 + kind % 64


def _align(n: int) -> int:
    return -(-n // 8) * 8


def _packed(tensors) -> torch.Tensor:
    """The tensors (None skipped) as one byte buffer, as gloo takes it (on
    the host, pinned, for CUDA tensors)."""
    parts = [t for t in tensors if t is not None]
    sizes = [t.numel() * t.element_size() for t in parts]
    cuda = parts[0].is_cuda
    buf = torch.empty(sum(map(_align, sizes)), dtype=torch.uint8,
                      pin_memory=cuda, device="cpu" if cuda else parts[0].device)
    off = 0
    for t, n in zip(parts, sizes):
        buf[off:off + n].copy_(t.detach().reshape(-1).view(torch.uint8))
        off += _align(n)
    return buf


def _unpacked(buf: torch.Tensor, specs, device) -> list:
    """``_packed``'s tensors back on ``device`` from its buffer: ``specs``
    their (shape, dtype), None for a skipped one."""
    buf = buf.to(device)
    out, off = [], 0
    for spec in specs:
        if spec is None:
            out.append(None)
            continue
        shape, dtype = spec
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        out.append(buf[off:off + n].view(dtype).reshape(shape))
        off += _align(n)
    return out


class StagePipe:
    """One loss call's messages between the stage ranks of one ``data``
    coordinate, each microbatch's (x, acc, aux) tagged by the call's
    number: ``specs`` their (shape, dtype), None for an absent one (the
    accumulator outside a norm pass), ``rows`` the per-example losses'
    length, ``device`` where received tensors land."""

    def __init__(self, specs, rows: int, device):
        self.group = stage_group()
        self.index, self.size = stage_shard()
        self.call = _ACTIVE.stage_calls
        _ACTIVE.stage_calls += 1
        self.specs, self.rows, self.device = specs, rows, device

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    def _send(self, tensors, to: int, tag: int) -> None:
        nbytes = sum(t.numel() * t.element_size() for t in tensors
                     if t is not None)
        _record("send", nbytes, self.size)
        if isinstance(self.group, TracedGroup):
            return
        buf = _packed(tensors)
        _ACTIVE.pending.append((dist.isend(buf, dist.get_global_rank(self.group, to),
                                           group=self.group, tag=tag), buf))

    def _recv(self, specs, frm: int, tag: int) -> list:
        if isinstance(self.group, TracedGroup):
            return [None if sp is None else
                    torch.zeros(sp[0], dtype=sp[1], device=self.device)
                    for sp in specs]
        n = sum(_align(math.prod(shape) * torch.empty((), dtype=dt).element_size())
                for shape, dt in (sp for sp in specs if sp is not None))
        cuda = torch.device(self.device).type == "cuda"
        buf = torch.empty(n, dtype=torch.uint8, pin_memory=cuda,
                          device="cpu" if cuda else self.device)
        # the group's timeout: a lost peer raises here
        dist.irecv(buf, dist.get_global_rank(self.group, frm), group=self.group,
                   tag=tag).wait()
        return _unpacked(buf, specs, self.device)

    def send_next(self, mb: int, x, acc, aux) -> torch.Tensor:
        """Microbatch ``mb``'s (x, acc, aux) to stage rank w+1; returns a
        token whose backward receives their cotangents (``_SendNext``)."""
        return _SendNext.apply(self, mb, x, acc, aux)

    def recv_prev(self, mb: int, anchor) -> Tuple:
        """Microbatch ``mb``'s (x, acc, aux) from stage rank w-1, acc None
        when its spec is; their backward sends the cotangents back
        (``_RecvPrev``).  ``anchor``: ``anchor(...)`` of the tensors the
        backward must reach on this rank (None: nothing differentiable)."""
        got = iter(_RecvPrev.apply(self, mb, anchor))
        return tuple(None if sp is None else next(got) for sp in self.specs)

    def share_losses(self, losses=None, tokens=(), anchor=None):
        """The last stage rank's (rows,) float32 per-example losses on
        every stage rank: the last gives ``losses`` and returns them; the
        others return them received, through ``_Share``, whose backward
        reaches this rank's send ``tokens`` and ``anchor``."""
        if self.last:
            for k in range(self.size - 1):
                self._send([losses], k, _tag(self.call, 0, _LOSS))
            return losses
        return _Share.apply(self, anchor, *tokens)


def anchor(*tensors) -> Optional[torch.Tensor]:
    """A 0-d tensor that depends on ``tensors`` (those that require grad)
    with zero gradient, or None when none does: a stage rank's graph edge
    to what it does not run (``StagePipe``)."""
    live = [t for t in tensors if t is not None and t.requires_grad]
    return _Anchor.apply(*live) if live else None


class _Anchor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *tensors):
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return tensors[0].new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        return tuple(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.like)


class _SendNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pipe, mb, x, acc, aux):
        ctx.pipe, ctx.mb, ctx.pulls = pipe, mb, 0
        pipe._send([x, acc, aux], pipe.index + 1, _tag(pipe.call, mb, _FWD))
        return x.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        pipe = ctx.pipe
        grads = pipe._recv(pipe.specs, pipe.index + 1,
                           _tag(pipe.call, ctx.mb, _BWD + ctx.pulls))
        ctx.pulls += 1
        return (None, None) + tuple(
            g if need else None for g, need in zip(grads, ctx.needs_input_grad[2:]))


class _RecvPrev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pipe, mb, anchor):
        ctx.pipe, ctx.mb, ctx.pulls = pipe, mb, 0
        got = pipe._recv(pipe.specs, pipe.index - 1, _tag(pipe.call, mb, _FWD))
        return tuple(t for t in got if t is not None)

    @staticmethod
    def backward(ctx, *grads):
        pipe = ctx.pipe
        it = iter(grads)
        pipe._send([None if sp is None else next(it) for sp in pipe.specs],
                   pipe.index - 1, _tag(pipe.call, ctx.mb, _BWD + ctx.pulls))
        ctx.pulls += 1
        return None, None, (torch.zeros((), device=grads[0].device)
                            if ctx.needs_input_grad[2] else None)


class _Share(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pipe, anchor, *tokens):
        ctx.n = len(tokens)
        (losses,) = pipe._recv([((pipe.rows,), torch.float32)], pipe.size - 1,
                               _tag(pipe.call, 0, _LOSS))
        return losses

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros((), device=g.device)
        return (None, zero if ctx.needs_input_grad[1] else None) + (zero,) * ctx.n


def stage_flush() -> None:
    """Wait for every stage send posted so far (each rank's step ends
    here, once its own receives are done; a lost peer raises)."""
    while _ACTIVE.pending:
        work, _ = _ACTIVE.pending.pop(0)
        work.wait()


def batch_local(fn: Callable, n_batch_args: int,
                reduce_out: bool = False) -> Callable:
    """``fn`` under the ambient layout.  Each rank holds only its batch
    shard, so ``fn`` runs as it is on its arguments; with ``reduce_out``
    its tensor outputs are then summed over the batch axes in place (the
    cross-device sums, such as the clipped-gradient reduction).  Outside a
    layout this is ``fn`` itself.  ``n_batch_args`` is the reference's
    signature: the first arguments carry the batch dim."""
    if active() is None or not reduce_out:
        return fn

    def wrapped(*args):
        out = fn(*args)
        all_reduce_([t for t in tree.leaves(out) if isinstance(t, torch.Tensor)],
                    batch_group())
        return out

    return wrapped


def attn_local(fn: Callable, n_kv: int) -> Callable:
    """A flash-attention call ``fn(q, k, v)`` under the ambient layout:
    each rank holds its batch shard and, on a ``model`` axis above 1, its
    contiguous run of the heads (the column-parallel ``wq``, ``wk``, ``wv``
    slices give q, k and v of those heads alone), so ``fn`` runs as it is on
    the local heads.  The reference shards the heads only when the axis
    divides the ``n_kv`` KV heads; other counts raise (replicating KV heads
    is not ported, ROADMAP queue 1)."""
    msz = model_shard()[1]
    if n_kv % msz:
        raise NotImplementedError(
            f"{n_kv} KV heads over a {msz}-wide model axis: replicating KV "
            f"heads is not ported (ROADMAP queue 1)")
    return fn


# ---------------------------------------------------------------------------
# init verification
# ---------------------------------------------------------------------------

def _key_paths(t, path=()):
    """(path, leaf) of every leaf; a path entry is ("dict", key) or
    ("seq", index), as JAX's key paths."""
    if isinstance(t, dict):
        for k in t:
            yield from _key_paths(t[k], path + (("dict", k),))
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from _key_paths(v, path + (("seq", i),))
    elif t is not None:
        yield path, t


def _path_str(path) -> str:
    """``str`` of the reference's key-path tuple (its sort key)."""
    parts = [f"DictKey(key={k!r})" if kind == "dict" else f"SequenceKey(idx={k})"
             for kind, k in path]
    return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"


def _keystr(path) -> str:
    """``jax.tree_util.keystr`` of a key path."""
    return "".join(f"[{k!r}]" if kind == "dict" else f"[{k}]" for kind, k in path)


def init_fingerprint(params) -> int:
    """crc32 fingerprint of a param tree, bit-identical to the reference's
    on the same params: leaves in the order of their key paths' ``str``,
    each the crc32 of its ``keystr``, shape and dtype record chained with
    its raw bytes (bf16 as its 2-byte words), and each leaf's crc chained
    into the total.  An FSDP slice (a leaf with ``fsdp_shard``), a model
    slice (``model_shard``) or a stage slice (``stage_shard``) records its
    whole leaf's shape and no bytes, the reference's rule for a leaf that
    is not fully addressable: the bytes live on other ranks, and the
    structure this check exists to catch is visible without them."""
    total = 0
    for path, leaf in sorted(_key_paths(params), key=lambda kv: _path_str(kv[0])):
        dtype = str(leaf.dtype).removeprefix("torch.")
        cut = cut_of(leaf)
        shard = None if cut is None else cut[0]
        shape = list(leaf.shape)
        if shard is not None:
            shape[shard.dim] = shard.size
        rec = f"{_keystr(path)}:{tuple(shape)}:{dtype}"
        c = zlib.crc32(rec.encode())
        if shard is None:
            h = leaf.detach().to("cpu").contiguous()
            if h.dtype == torch.bfloat16:
                h = h.view(torch.int16)
            c = zlib.crc32(h.numpy().tobytes(), c)
        total = zlib.crc32(c.to_bytes(4, "little"), total)
    return total & 0xFFFFFFFF


def verify_init_consistency(params, tag: str = "init") -> int:
    """Every process fingerprints its ``params`` and the fingerprints are
    all-gathered and compared, catching a rank that initialised from
    another seed or config.  One process: the fingerprint, no collective.
    Raises ``RuntimeError`` naming the ranks that disagree with rank 0."""
    fp = init_fingerprint(params)
    if dist.is_initialized() and dist.get_world_size() > 1:
        vals = [None] * dist.get_world_size()
        dist.all_gather_object(vals, fp)
        if any(v != vals[0] for v in vals):
            bad = [i for i, v in enumerate(vals) if v != vals[0]]
            raise RuntimeError(
                f"{tag} fingerprint mismatch across processes: "
                f"{ {i: hex(v) for i, v in enumerate(vals)} }; ranks {bad} "
                f"disagree with rank 0 (seed or config drift); refusing to "
                f"train on mixed params")
    return fp
