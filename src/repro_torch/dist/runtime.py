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
``all_gather`` (over gloo: ``broadcast``), ``all_gather_object`` and
point-to-point sends are used: gloo has no reduce-scatter.

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

Metering: inside ``metered()`` (the launcher's byte count, a
``CostCounter``), ``all_reduce_``, ``all_gather`` and ``reduce_slice``
append ``{"kind", "bytes", "group"}`` to its records (``bytes``: the
result's size on one rank; a reduce-scatter's, the summed leaf's).  A
meter changes nothing else.  Cost traces (launch/costs.py): inside
``traced()``, and only there, a layout over a mesh with no process group
(an object of the mesh's axis names and shape) is a trace of one rank's
step: its batch group is a ``TracedGroup`` of the batch axes' size, whose
collectives record and return what a real group's would in shape, moving
nothing.  Anywhere else such a layout raises, as a step that would skip
its collectives must not run.
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
    which must see the layout its forward ran under (FSDP's gathers)."""

    def __init__(self):
        self.mesh = None
        self.batch_axes: Optional[Tuple[str, ...]] = None
        self.traces = 0           # cost traces in progress (``traced``)
        self.suspended = 0        # ``suspended`` contexts in progress


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
    """Activate data-parallel and tensor-parallel execution: inside this
    context the batch dim is sharded over ``batch_axes`` of ``mesh``, one
    contiguous slice a rank, and the model collectives run over its
    ``model`` axis.  A falsy ``batch_axes`` (batch not shardable) on a mesh
    with no ``model`` axis above 1 is a no-op, so ``layout(mesh,
    batch_pspec(mesh, B))`` is always safe; with one, every rank takes the
    whole batch.  The batch axes must span the whole world or be one axis
    of the mesh; a mesh with no process group is taken only inside a cost
    trace."""
    if not batch_axes and (mesh is None
                           or _sh._axis_size(mesh, _sh.MODEL_AXIS) == 1):
        yield
        return
    prev = (_ACTIVE.mesh, _ACTIVE.batch_axes)
    _ACTIVE.mesh, _ACTIVE.batch_axes = mesh, tuple(batch_axes or ())
    try:
        batch_group()             # refuse an unsupported layout up front
        model_group()
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
        idx = idx * _sh._axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx, _n_shards(mesh, bax)


def axis_shard(mesh, name: str) -> Tuple[int, int, object]:
    """(this rank's coordinate, the size, the process group) of one mesh
    axis; (0, 1, None) when the mesh lacks it."""
    size = _sh._axis_size(mesh, name)
    if size == 1:
        return 0, 1, None
    return mesh.get_local_rank(name), size, mesh.get_group(name)


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
    into the total.  An FSDP slice (a leaf with ``fsdp_shard``) or a model
    slice (``model_shard``) records its whole leaf's shape and no bytes,
    the reference's rule for a leaf that is not fully addressable: the
    bytes live on other ranks, and the structure this check exists to
    catch is visible without them."""
    total = 0
    for path, leaf in sorted(_key_paths(params), key=lambda kv: _path_str(kv[0])):
        dtype = str(leaf.dtype).removeprefix("torch.")
        shard = fsdp_shard_of(leaf) or model_shard_of(leaf)
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
