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
``all_gather`` and ``all_gather_object`` are used: gloo has no
reduce-scatter.

Cost traces (launch/costs.py): while a ``CostCounter`` is active,
``all_reduce_`` and ``all_gather`` append ``{"kind", "bytes", "group"}``
to its collective records (``bytes``: the result's size on one rank).
While a counter is active, a layout over a mesh with no process group (an
object of the mesh's axis names and shape) is a trace of one rank's step:
its batch group is a ``TracedGroup`` of the batch axes' size, whose
collectives record and return what a real group's would in shape, moving
nothing.  Outside a trace such a layout raises, as a step that would
skip its collectives must not run.
"""
from __future__ import annotations

import contextlib
import math
import threading
import zlib
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.dist import sharding as _sh


class _Layout(threading.local):
    def __init__(self):
        self.mesh = None
        self.batch_axes: Optional[Tuple[str, ...]] = None


_ACTIVE = _Layout()
# the active cost counters' collective record lists (launch/costs.py)
COLLECTIVE_SINKS: list = []


class TracedGroup:
    """The batch group of a layout with no process group: ``size`` ranks,
    collectives recorded and not run (a cost trace of one rank's step)."""

    def __init__(self, size: int):
        self.size = size


@contextlib.contextmanager
def layout(mesh, batch_axes):
    """Activate data-parallel execution: inside this context the batch dim
    is sharded over ``batch_axes`` of ``mesh``, one contiguous slice a
    rank.  A falsy ``batch_axes`` (batch not shardable) is a no-op, so
    ``layout(mesh, batch_pspec(mesh, B))`` is always safe.  The batch axes
    must span the whole world or be one axis of the mesh; a mesh with no
    process group is taken only inside a cost trace."""
    if not batch_axes:
        yield
        return
    prev = (_ACTIVE.mesh, _ACTIVE.batch_axes)
    _ACTIVE.mesh, _ACTIVE.batch_axes = mesh, tuple(batch_axes)
    try:
        batch_group()             # refuse an unsupported layout up front
        yield
    finally:
        _ACTIVE.mesh, _ACTIVE.batch_axes = prev


@contextlib.contextmanager
def suspended():
    """No layout inside: the code runs as one process (the memory
    planner's trace of a step, which launches no collective)."""
    prev = (_ACTIVE.mesh, _ACTIVE.batch_axes)
    _ACTIVE.mesh, _ACTIVE.batch_axes = None, None
    try:
        yield
    finally:
        _ACTIVE.mesh, _ACTIVE.batch_axes = prev


def active() -> Optional[Tuple]:
    """The ambient (mesh, batch_axes), or None outside any ``layout``."""
    if _ACTIVE.mesh is None:
        return None
    return _ACTIVE.mesh, _ACTIVE.batch_axes


def _n_shards(mesh, bax) -> int:
    return math.prod(_sh._axis_size(mesh, a) for a in bax)


def batch_group():
    """The process group of the active layout's batch axes (None outside
    a layout): the world when they span it, else the one axis's group."""
    state = active()
    if state is None:
        return None
    mesh, bax = state
    if not dist.is_initialized():
        if COLLECTIVE_SINKS:
            return TracedGroup(_n_shards(mesh, bax))
        raise RuntimeError(
            f"a layout over {_sh._axis_names(mesh)} with no process group: "
            f"join one (torch.distributed.init_process_group) before the "
            f"step; only a cost trace (launch/costs.py) runs without one")
    if _n_shards(mesh, bax) == dist.get_world_size():
        return dist.group.WORLD
    if len(bax) == 1:
        return mesh.get_group(bax[0])
    raise NotImplementedError(
        f"batch axes {bax} span part of the mesh {_sh._axis_names(mesh)}: "
        f"only a batch over the whole world or one axis is ported "
        f"(ROADMAP queue 1)")


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
    host for gloo."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.to("cpu").contiguous()
    return t.contiguous()


def all_reduce_(tensors: List[torch.Tensor], group=None) -> None:
    """Sum each tensor over ``group``'s ranks, in place."""
    n = _group_size(group)
    if n == 1:
        return
    for t in tensors:
        _record("all-reduce", t.numel() * t.element_size(), n)
    if isinstance(group, TracedGroup):
        return
    for t in tensors:
        h = _staged(t, group)
        dist.all_reduce(h, group=group)
        if h is not t:
            t.copy_(h)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank) concatenated along dim
    0 in rank order, on ``t``'s device; the bytes cross unchanged."""
    n = _group_size(group)
    if n == 1:
        return t
    _record("all-gather", n * t.numel() * t.element_size(), n)
    if isinstance(group, TracedGroup):
        return torch.cat([t] * n)
    h = _staged(t, group)
    flat = h.reshape(-1).view(torch.uint8)
    outs = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, flat, group=group)
    return torch.cat([o.view(t.dtype).reshape(t.shape) for o in outs]).to(t.device)


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
    each rank holds its batch shard, so on a ``model`` axis of size 1 this
    is ``fn``.  Splitting the heads over a wider ``model`` axis is not
    ported (ROADMAP queue 1) and raises."""
    state = active()
    if state is None:
        return fn
    msz = _sh._axis_size(state[0], _sh.MODEL_AXIS)
    if msz > 1:
        raise NotImplementedError(
            f"attention heads over a {msz}-wide model axis are not ported "
            f"(ROADMAP queue 1)")
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
    into the total.  Every rank holds whole params (ZeRO-1 shards only the
    optimizer state), so every leaf contributes its bytes."""
    total = 0
    for path, leaf in sorted(_key_paths(params), key=lambda kv: _path_str(kv[0])):
        dtype = str(leaf.dtype).removeprefix("torch.")
        rec = f"{_keystr(path)}:{tuple(leaf.shape)}:{dtype}"
        h = leaf.detach().to("cpu").contiguous()
        if h.dtype == torch.bfloat16:
            h = h.view(torch.int16)
        c = zlib.crc32(h.numpy().tobytes(), zlib.crc32(rec.encode()))
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
