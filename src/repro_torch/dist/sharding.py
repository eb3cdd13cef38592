"""Sharding rules: logical param axes -> mesh placements.  Counterpart of
``repro/dist/sharding.py``; the rules are the same shape arithmetic.

The mesh axis vocabulary is fixed (launch/mesh.py):

* ``data`` (and ``pod`` when multi-pod) carry the **batch** dimension:
  DP-SGD is data-parallel up to the clipped-gradient sum, which the port
  all-reduces over these axes (dist/runtime.py, core/algo.py).
* ``model`` carries one weight dimension a param, picked from the logical
  axis names of the model spec (models/layers.py ``P``): ``expert`` first,
  then ``heads``/``kv``, then ``mlp``, then ``vocab``.  A dim is sharded
  only where the axis size divides it, else the rule falls through to the
  next candidate (grok's 8 experts on a 16-way model axis fall through to
  its 32768-wide ``mlp`` dim).
* ``stage`` carries the stacked ``layers`` dim of the repeated blocks, so
  each stage's device group holds its contiguous slice of them.

``fsdp=True`` (the arch's ``use_fsdp``) also shards the first remaining
named weight dim over ``data``; ``state_shardings(zero1=True)`` does the
same for param-shaped optimizer-state leaves only (ZeRO-1).

A placement is a ``PartitionSpec``: a tuple of one entry a dim, each a
mesh-axis name, a tuple of names (the batch axes) or None (replicated), as
a JAX ``PartitionSpec``'s entries are.  The rules read only the mesh's axis
names and sizes: they run on a ``DeviceMesh`` (``mesh_dim_names``,
``shape``) or on any object with ``axis_names`` and ``devices.shape`` or
``shape`` (a fake mesh in tests), and never touch a device.

The port places only what its runtime runs: the batch axes, ZeRO-1's
``data`` sharding of the optimizer state (train/trainer.py), FSDP's
``data`` sharding of a ``use_fsdp`` arch's params (``fsdp_shards``: each
rank holds one slice of such a leaf, gathered a layer at a time in the
forward; models/transformer.py, dist/runtime.py) and the ``model`` axis's
sharding of the dense decoders' params (``model_shards``: tensor
parallelism, each rank holding its slice for good; the placements give
Megatron's layout: ``wq``, ``wk``, ``wv``, ``w1``, ``w3`` and the head
column-parallel, ``wo`` and ``w2`` row-parallel, the embedding over the
vocabulary, the norm scales replicated) and the ``stage`` axis's sharding
of the repeated blocks (``stage_shards``: pipeline stages across
processes, each rank holding the contiguous blocks of its stages for good
and the whole of the embedding, prelude, final norm and head).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch import tree

# mesh axes that carry the batch dimension, outermost first
BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"
# the pipeline axis: carries the stacked "layers" dim
STAGE_AXIS = "stage"
# logical-axis priority for the model axis (first divisible match wins)
MODEL_PRIORITY = ("expert", "heads", "kv", "mlp", "vocab")
# logical axes never sharded over data/model (only the stage axis may own
# the stacked layer dim)
_NEVER_SHARD = ("layers",)


class PartitionSpec(tuple):
    """A leaf's placement: one entry a dim (a mesh-axis name, a tuple of
    names, or None for replicated); ``PartitionSpec()`` replicates the
    whole leaf.  A tuple of one name is that name, as JAX normalises it.
    A tuple, and a leaf of a spec tree (``spec_leaves``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1
                                     else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def spec_leaves(specs):
    """The ``PartitionSpec`` leaves of a spec tree in the order
    ``train.checkpoint.flatten`` orders a state's leaves (a ``TrainState``:
    its step, then its params, then its optimizer state)."""
    from repro_torch.train.state import TrainState
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, TrainState):
        return ([specs.step] + spec_leaves(specs.params)
                + spec_leaves(specs.opt_state))
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [x for v in specs for x in spec_leaves(v)]
    return []


def mesh_from_config(cfg):
    """A ``DeviceMesh`` from a ``MeshConfig`` (configs/base.py) over the
    process group's world."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(cfg.shape, cfg.axes)


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    return tuple(mesh.mesh_dim_names if names is None else names)


def _mesh_shape(mesh) -> Tuple[int, ...]:
    devices = getattr(mesh, "devices", None)
    return tuple(int(s) for s in (mesh.shape if devices is None
                                  else devices.shape))


def _axis_size(mesh, name: str) -> int:
    """Size of a named mesh axis (1 if absent)."""
    names = _axis_names(mesh)
    if name not in names:
        return 1
    return _mesh_shape(mesh)[names.index(name)]


def batch_axis_width(mesh) -> int:
    """The product of the mesh's batch-axis sizes: the divisor a physical
    batch must satisfy for ``batch_pspec`` to use full data parallelism
    (the Trainer rounds a Poisson capacity to a multiple of it)."""
    w = 1
    for a in BATCH_AXES:
        w *= _axis_size(mesh, a)
    return w


def stage_axis_width(mesh) -> int:
    """Size of the pipeline ``stage`` axis (1 when absent)."""
    return _axis_size(mesh, STAGE_AXIS)


def batch_pspec(mesh, global_batch: int) -> Optional[Tuple[str, ...]]:
    """Mesh axes the batch dim shards over: the ``BATCH_AXES`` subset (in
    order) with the largest size product that divides the batch (a 16-wide
    data axis beats pod+data when only one divides).  None when nothing
    divides (batch 1 long-context decode)."""
    present = [a for a in BATCH_AXES if a in _axis_names(mesh)]
    best: Tuple[str, ...] = ()
    best_prod = 1
    for mask in range(1, 2 ** len(present)):
        combo = tuple(a for i, a in enumerate(present) if mask >> i & 1)
        prod = 1
        for a in combo:
            prod *= _axis_size(mesh, a)
        if global_batch % prod == 0 and prod > best_prod:
            best, best_prod = combo, prod
    return best or None


def spec_for_param(axes: Sequence[Optional[str]], shape: Sequence[int],
                   mesh, fsdp: bool = False) -> PartitionSpec:
    """The placement of one param from its logical axes and shape: a
    ``layers`` dim on the ``stage`` axis where present and divisible; one
    dim on ``model`` by ``MODEL_PRIORITY`` with divisibility fall-through;
    with ``fsdp``, the first remaining named dim (never ``layers``) that
    the ``data`` axis divides on ``data``.  Other dims are replicated."""
    names = _axis_names(mesh)
    entries: list = [None] * len(shape)
    if STAGE_AXIS in names:
        ssz = _axis_size(mesh, STAGE_AXIS)
        for i, (ax, dim) in enumerate(zip(axes, shape)):
            if ax == "layers" and dim % ssz == 0:
                entries[i] = STAGE_AXIS
                break
    if MODEL_AXIS in names:
        msz = _axis_size(mesh, MODEL_AXIS)
        for logical in MODEL_PRIORITY:
            placed = False
            for i, (ax, dim) in enumerate(zip(axes, shape)):
                if ax == logical and dim % msz == 0:
                    entries[i] = MODEL_AXIS
                    placed = True
                    break
            if placed:
                break
    if fsdp and "data" in names:
        dsz = _axis_size(mesh, "data")
        for i, (ax, dim) in enumerate(zip(axes, shape)):
            if (entries[i] is None and ax is not None
                    and ax not in _NEVER_SHARD and dim % dsz == 0):
                entries[i] = "data"
                break
    return PartitionSpec(*entries)


def _zip_spec_tree(shapes, axes, fn):
    """Map fn(shaped leaf, logical-axes tuple) over the parallel trees of
    ``model.abstract_params()`` and ``model.logical_axes()``, recursing on
    the shapes' side so the axes tuples stay leaves."""
    if isinstance(shapes, dict):
        return {k: _zip_spec_tree(shapes[k], axes[k], fn) for k in shapes}
    if isinstance(shapes, (list, tuple)):
        out = [_zip_spec_tree(s, a, fn) for s, a in zip(shapes, axes)]
        return tuple(out) if isinstance(shapes, tuple) else out
    return fn(shapes, axes)


def param_shardings(mesh, model, fsdp: Optional[bool] = None):
    """The placement tree of ``model``'s params; ``fsdp=None`` takes the
    arch's ``use_fsdp``."""
    if fsdp is None:
        fsdp = bool(getattr(model.arch, "use_fsdp", False))
    return _zip_spec_tree(
        model.abstract_params(), model.logical_axes(),
        lambda leaf, ax: spec_for_param(ax, leaf.shape, mesh, fsdp=fsdp))


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's slice of an FSDP-sharded param, of a tensor-parallel
    model slice or of a pipeline stage's blocks: slice ``index`` of
    ``count`` equal slices along ``dim`` of the whole leaf, whose extent
    along ``dim`` is ``size``.  Not a tuple, so a tree of them keeps its
    tuples as containers (``tree.tree_map``)."""
    dim: int
    index: int
    count: int
    size: int

    @property
    def part(self) -> int:
        """The slice's extent along ``dim``."""
        return self.size // self.count

    def of(self, whole, lead: int = 0):
        """This rank's view of a whole leaf; ``lead`` leading dims (a
        stacked leaf's layer dim) already indexed away."""
        return whole.narrow(self.dim - lead, self.index * self.part, self.part)


def _axis_shards(mesh, model, axis: str, index: Optional[int], fsdp: bool):
    """The tree parallel to ``model.abstract_params()`` whose leaf is this
    rank's ``Shard`` of a param that ``spec_for_param`` places on ``axis``
    (the contiguous slice at the rank's coordinate ``index``, default this
    process's from a ``DeviceMesh``, as GSPMD lays it out), or None for a
    leaf every rank of the axis holds whole; every leaf None on an axis of
    1."""
    count = _axis_size(mesh, axis)
    if count > 1 and index is None:
        index = mesh.get_local_rank(axis)

    def leaf(shaped, axes):
        if count == 1:
            return None
        spec = spec_for_param(axes, shaped.shape, mesh, fsdp=fsdp)
        if axis not in spec:
            return None
        d = spec.index(axis)
        return Shard(d, int(index), count, int(shaped.shape[d]))

    return _zip_spec_tree(model.abstract_params(), model.logical_axes(), leaf)


def fsdp_shards(mesh, model, index: Optional[int] = None):
    """The FSDP layout of ``model``'s params on ``mesh``: this rank's
    ``Shard`` of each param that ``param_shardings`` places on the ``data``
    axis (the arch's ``use_fsdp``: the first named non-``layers`` dim the
    axis divides), None for a leaf that stays whole.  ``index``: the rank's
    coordinate on the ``data`` axis (a trace of one rank's step on a mesh of
    names and sizes passes it).  Every leaf is None on a ``data`` axis of 1
    or for an arch without ``use_fsdp``."""
    return _axis_shards(mesh, model, "data", index,
                        bool(getattr(model.arch, "use_fsdp", False)))


def model_shards(mesh, model, index: Optional[int] = None):
    """The tensor-parallel layout of ``model``'s params on ``mesh``: this
    rank's ``Shard`` of each param that ``param_shardings`` places on the
    ``model`` axis, None for a leaf every model rank holds whole."""
    return _axis_shards(mesh, model, MODEL_AXIS, index, False)


def stage_shards(mesh, model, index: Optional[int] = None):
    """The pipeline layout of ``model``'s params on ``mesh``: this rank's
    ``Shard`` of each ``blocks`` leaf's leading ``layers`` dim (the blocks
    of its contiguous run of stages), None for a leaf every stage rank
    holds whole (the embedding, prelude, final norm and head)."""
    return _axis_shards(mesh, model, STAGE_AXIS, index, False)


def stage_owner(key: str, width: int) -> int:
    """The stage coordinate that runs the whole (not stage-cut) top-level
    param ``key`` on a ``stage`` axis of ``width``, so whose gradient of it
    is the real one: the last stage rank for the final norm and the head,
    the first for the rest (the embedding and the prelude)."""
    return width - 1 if key in ("final_norm", "head") else 0


def batch_shardings(mesh, abs_tree, global_batch: int):
    """The placement tree of a batch: dim 0 over the batch axes, the rest
    replicated."""
    bax = batch_pspec(mesh, global_batch)

    def mk(leaf):
        if bax is None or leaf.dim() == 0:
            return PartitionSpec()
        return PartitionSpec(bax, *(None,) * (leaf.dim() - 1))

    return tree.tree_map(mk, abs_tree)


def _paired(shapes, axes, path=()):
    """(path, shaped leaf, logical axes) of every param in ``tree.leaves``
    order, from the parallel trees of ``abstract_params`` and
    ``logical_axes``; a dict key enters a path as a str, a list or tuple
    index as an int, as the reference normalises its key paths."""
    if isinstance(shapes, dict):
        for k in sorted(shapes):
            yield from _paired(shapes[k], axes[k], path + (str(k),))
    elif isinstance(shapes, (list, tuple)):
        for i, (s, a) in enumerate(zip(shapes, axes)):
            yield from _paired(s, a, path + (i,))
    else:
        yield path, shapes, tuple(axes)


def state_shardings(mesh, model, state, zero1: bool = True):
    """The placement tree of a ``TrainState`` (its tensors, real or meta):
    the step replicated, the params by ``param_shardings``, every
    optimizer-state leaf shaped like a param by that param's logical axes,
    with ``zero1`` also over ``data`` (ZeRO-1); other leaves (int8 moment
    blocks, scalars) replicated.  The port's optimizers hold their state
    in lists aligned leaf by leaf with the params (``tree.leaves``): an
    entry of a list as long as the params' leaves takes the path of its
    param, so the leaves are matched by path suffix and shape as in the
    reference, and same-shape params of other axes (wq against wo when
    d_model = H·hd) keep their own placements."""
    from repro_torch.train.state import TrainState
    p_sh = param_shardings(mesh, model)
    pairs = list(_paired(model.abstract_params(), model.logical_axes()))
    param_paths = [p for p, _, _ in pairs]
    param_at = {p: tuple(leaf.shape) for p, leaf, _ in pairs}
    axes_at = {p: ax for p, _, ax in pairs}

    def opt_spec(key, leaf):
        for n in range(len(key) - 1, 0, -1):       # longest param-path suffix
            suffix = key[-n:]
            if param_at.get(suffix) == tuple(leaf.shape):
                return spec_for_param(axes_at[suffix], leaf.shape, mesh,
                                      fsdp=zero1)
        return PartitionSpec()

    def walk(t, key):
        if isinstance(t, dict):
            return {k: walk(v, key + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            aligned = isinstance(t, list) and len(t) == len(param_paths)
            out = [walk(v, key + (param_paths[i] if aligned else (i,)))
                   for i, v in enumerate(t)]
            return tuple(out) if isinstance(t, tuple) else out
        return None if t is None else opt_spec(key, t)

    return TrainState(step=PartitionSpec(), params=p_sh,
                      opt_state=walk(state.opt_state, ()))


def cache_shardings(mesh, cache, global_batch: int, model=None):
    """The placement tree of a cache (``model.init_cache``, real or meta
    tensors): the batch dim (dim 0 for prelude layers, dim 1 for the
    stacked blocks, which lead with their layer dim) over the batch axes,
    the rest replicated.  With ``model`` (whose arch names each layer's
    kind), an attention layer's (k, v) also put their KV-heads dim (the
    second to last) on the ``model`` axis where it divides the KV heads:
    a model rank holds the KV heads of its query heads alone.  The
    reference keeps the cache replicated over ``model`` and lets GSPMD
    reshard it; the port's tensor-parallel decode reads only its heads'."""
    bax = batch_pspec(mesh, global_batch)
    kinds = {}
    if model is not None:
        from repro_torch.models.transformer import group_layers
        pattern = model.arch.pattern()
        pre = group_layers(model.arch)[0]
        msz = _axis_size(mesh, MODEL_AXIS)
        if msz > 1 and model.arch.n_kv_heads % msz == 0:
            kinds = {("prelude", i): pattern[i] for i in range(pre)}
            kinds.update({("blocks", j): pattern[pre + j]
                          for j in range(len(pattern) - pre)})

    def walk(t, top, layer=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            out = [walk(v, top, i if layer is None else layer)
                   for i, v in enumerate(t)]
            return tuple(out) if isinstance(t, tuple) else out
        if t is None:
            return None
        entries = [None] * t.dim()
        if bax is not None and t.dim() > 0:
            entries[1 if top == "blocks" and t.dim() > 1 else 0] = bax
        if kinds.get((top, layer)) == "attn":
            entries[-2] = MODEL_AXIS
        return PartitionSpec(*entries) if any(entries) else PartitionSpec()

    return walk(cache, None)
