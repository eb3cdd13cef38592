"""Model assembly: layer grouping (prelude + repeated block), param spec,
seeded init on the device, the training loss, prefill and decode.
Counterpart of ``repro/models/transformer.py``.

Params keep the JAX package's nesting and layouts: ``{"embed",
"prelude": [layer, ...], "blocks": (layer, ...), "final_norm", "head"}``,
where every ``blocks`` leaf carries a leading ``(reps,)`` axis.  The JAX
package scans that axis with ``lax.scan``; here a Python loop indexes it.
An embedding-input arch (``embed_stub``: audio, VLM backbones whose
frontend is a stub) has no ``"embed"``: training, prefill and decode take
its precomputed (B, T, d) embeddings where a token arch takes ids.
Caches are ``{"prelude": [c, ...], "blocks": (c, ...)}`` with the same
leading ``(reps,)`` axis on block leaves, ``c`` an attention layer's (k, v)
or a Mamba layer's (conv window, SSM state).

A layer is attention or Mamba2 (models/mamba2.py) with a dense or MoE FFN
(models/moe.py), as the layer pattern says, so the dense, MoE, SSM and
hybrid decoders are one ``Model``.  An MoE layer also gives a per-example
load-balance aux loss, which the training loss adds at
``AUX_LOSS_WEIGHT``.  Mamba layers keep an O(1) recurrent state a slot:
there is nothing to page, so the paged cache and paged decode raise for
them.  Training puts each block (one period of the repeated layers) under
the model's ``remat`` policy
(``layers.remat_wrap``), as the JAX package wraps its scanned block, with
the running aux total carried through it beside the activations and the
norm accumulator; the prelude is not wrapped.

Tensor parallelism (``Model(mesh=...)`` on a ``model`` axis above 1, the
dense decoders; ``tp_refusal`` names what is not ported): each rank holds
its slices (``dist.sharding.model_shards``) and trains on the whole batch
of its ``data`` coordinate.  Attention and the FFN are Megatron's column
and row pairs (models/layers.py); the embedding is vocabulary-parallel
(an id outside the rank's rows gives a zero row, then a sum over the
group); the head gives the rank's columns of the logits, and the
cross-entropy is vocabulary-parallel (``vocab_parallel_xent``); prefill
and the contiguous decode run on the same slices, each rank's cache
holding its KV heads and the logits gathered whole.  Each norm
site on a slice yields that slice's partial norm², and the norm scales'
taps count once over the group (core/context.py), so the sum over the
``model`` group (core/algo.py ``norm_pass``) is the exact norm².

Pipeline stages across processes (``Model(mesh=...)`` on a ``stage`` axis
of width W above 1, ``pp_stages`` a multiple of W; ``stage_refusal`` names
what is not ported): stage rank w holds the blocks of stages [w·S/W,
(w+1)·S/W) (``dist.sharding.stage_shards``) and the whole of the rest.
The embedding and prelude run on the first stage rank, each rank runs its
local stages on the shifted-buffer schedule with each microbatch's (x,
acc, aux) received from rank w-1 at its first local stage and sent to w+1
after its last (``dist.runtime.StagePipe``), and the final norm, head and
cross-entropy run on the last, whose per-example losses every stage rank
returns.  The accumulator's cotangent crosses the stages back with its
microbatch, so the first stage rank's pullback holds every site's norm²
and the others' zeros (core/algo.py sums them over the stage group).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch import resolve_device, tree
from repro_torch.configs.base import ATTN, MAMBA, ArchConfig, validate_remat
from repro_torch.core.algo import stage_microbatches
from repro_torch.core.context import DPContext
from repro_torch.dist import runtime
from repro_torch.dist import sharding as dist_sharding
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import P

AUX_LOSS_WEIGHT = 0.01
VOCAB_PAD = 256
# init_spec: the most entries drawn at once (a 1 GiB float32 temporary)
DRAW_ELEMS = 1 << 28


def padded_vocab(v: int) -> int:
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


# ---------------------------------------------------------------------------
# Layer signatures & grouping
# ---------------------------------------------------------------------------

def layer_sig(arch: ArchConfig, i: int) -> Tuple[str, bool]:
    return (arch.pattern()[i], arch.is_moe_layer(i))


def group_layers(arch: ArchConfig) -> Tuple[int, int, int]:
    """Return (n_prelude, period, n_reps): layers [n_prelude:] are a
    ``period``-layer signature repeated ``n_reps`` times."""
    sigs = [layer_sig(arch, i) for i in range(arch.n_layers)]
    for pre in range(0, 3):
        rest = sigs[pre:]
        if not rest:
            continue
        for p in range(1, min(len(rest), 16) + 1):
            if len(rest) % p == 0 and rest == rest[:p] * (len(rest) // p):
                return pre, p, len(rest) // p
    return arch.n_layers, 1, 0


def layer_spec(arch: ArchConfig, sig: Tuple[str, bool]) -> Dict[str, Any]:
    kind, is_moe = sig
    d = arch.d_model
    spec: Dict[str, Any] = {"ln1": P((d,), "ones")}
    if kind == ATTN:
        spec["attn"] = L.attn_spec(arch)
    else:
        spec["mamba"] = mamba2.mamba_spec(arch)
    if arch.d_ff > 0:
        spec["ln2"] = P((d,), "ones")
        if is_moe:
            spec["moe"] = moe_lib.moe_spec(arch)
        else:
            spec["mlp"] = L.mlp_spec(arch, arch.ff_dense())
    return spec


def model_spec(arch: ArchConfig) -> Dict[str, Any]:
    """The decoder's param spec; an embedding-input arch (``embed_stub``)
    has no ``"embed"`` table: its inputs are precomputed embeddings."""
    pre, period, reps = group_layers(arch)
    spec: Dict[str, Any] = {}
    if not arch.embed_stub:
        spec["embed"] = P((padded_vocab(arch.vocab), arch.d_model), "embed",
                          ("vocab", "embed"))
    spec["prelude"] = [layer_spec(arch, layer_sig(arch, i)) for i in range(pre)]
    if reps > 0:
        spec["blocks"] = tuple(layer_spec(arch, layer_sig(arch, pre + j))
                               for j in range(period))
    spec["final_norm"] = P((arch.d_model,), "ones")
    spec["head"] = P((arch.d_model, padded_vocab(arch.vocab)),
                     axes=("embed", "vocab"))
    return spec


def tp_refusal(arch: ArchConfig, width: int, pp_stages: int = 1) -> str:
    """What of ``arch`` (and ``pp_stages``) tensor parallelism over a
    ``width``-wide ``model`` axis does not port, naming ROADMAP; "" when it
    runs (the dense and embedding-input decoders whose heads, KV heads, FFN
    and padded vocabulary the axis divides, in one pipeline stage)."""
    if width <= 1:
        return ""
    why = [f"pp_stages={pp_stages}"] if pp_stages > 1 else []
    if arch.family in ("cnn", "vit"):
        why.append(f"the image family {arch.family!r}")
    else:
        if arch.use_fsdp:
            why.append("FSDP with tensor parallelism (use_fsdp)")
        if arch.moe.enabled:
            why.append("MoE layers (the expert axis)")
        if MAMBA in arch.pattern():
            why.append("Mamba layers")
        if arch.qk_norm:
            why.append("qk_norm (a replicated scale seen by the local heads "
                       "alone gives a partial gradient vector)")
        if arch.n_kv_heads % width or arch.n_heads % width:
            why.append(f"{arch.n_heads} heads and {arch.n_kv_heads} KV heads "
                       f"(replicating KV heads)")
        for what, n in (("d_ff", arch.d_ff),
                        ("padded vocab", padded_vocab(arch.vocab))):
            if n % width:
                why.append(f"{what} {n}")
    if not why:
        return ""
    return (f"{arch.name} on a {width}-wide 'model' axis (tensor "
            f"parallelism): {'; '.join(why)} not ported (ROADMAP queue 1)")


def serving_refusal(arch: ArchConfig, what: str, sliced: str) -> str:
    """The refusal, naming ROADMAP, of ``what`` (the prefill, the decode,
    the engines, the host loop) on params ``sliced`` over one mesh axis:
    ``"stage"`` (pipeline stage slices), ``"fsdp"`` (FSDP-sharded params)
    or ``"model"`` (tensor-parallel model slices, on which only prefill and
    the contiguous decode run)."""
    if sliced == "stage":
        return (f"{arch.name}: {what} of pipeline stage slices is not ported "
                f"(the reference serves with no mesh; ROADMAP queue 1 item 9)")
    if sliced == "fsdp":
        return (f"{arch.name}: {what} of FSDP-sharded params is not ported "
                f"(ROADMAP queue 1 item 7)")
    return (f"{arch.name}: {what} of tensor-parallel model slices is not "
            f"ported (prefill and the contiguous decode run on them; ROADMAP "
            f"queue 1 item 8)")


def serve_mesh_refusal(arch: ArchConfig, sizes: dict, fsdp: bool = True) -> str:
    """Why the port cannot prefill or decode ``arch`` on a mesh of these
    axis sizes (``{"model": 16, "data": 16}``; an absent axis is 1), naming
    ROADMAP; "" when it can.  ``fsdp``: a ``use_fsdp`` arch's params are
    sharded over a ``data`` axis above 1 (the reference's ``serve_fsdp``)."""
    if sizes.get(dist_sharding.STAGE_AXIS, 1) > 1:
        return serving_refusal(arch, "serving", "stage")
    width = sizes.get(dist_sharding.MODEL_AXIS, 1)
    if width > 1:
        return tp_refusal(arch, width)
    if fsdp and arch.use_fsdp and sizes.get("data", 1) > 1:
        return serving_refusal(arch, "serving", "fsdp")
    return ""


def stage_refusal(arch: ArchConfig, width: int, pp_stages: int = 1,
                  model_width: int = 1) -> str:
    """What of ``arch`` (and ``pp_stages``, a ``model`` axis of
    ``model_width``) pipeline stages across processes over a
    ``width``-wide ``stage`` axis do not port, naming ROADMAP; "" when they
    run (the dense and MoE decoders, ``pp_stages`` a multiple of the
    width, no ``model`` axis)."""
    if width <= 1:
        return ""
    why = []
    if pp_stages % width:
        why.append(f"pp_stages={pp_stages}, which the axis does not divide")
    if model_width > 1:
        why.append(f"a {model_width}-wide 'model' axis beside it")
    if arch.family in ("cnn", "vit"):
        why.append(f"the image family {arch.family!r}")
    else:
        if arch.use_fsdp:
            why.append("FSDP with pipeline stages (use_fsdp)")
        if MAMBA in arch.pattern():
            why.append("Mamba layers (the SSM and hybrid families)")
    if not why:
        return ""
    return (f"{arch.name} on a {width}-wide 'stage' axis (pipeline stages "
            f"across processes): {'; '.join(why)} not ported (ROADMAP queue 1)")


def _map_spec(spec, fn, path=()):
    """Map fn(P, path) over a spec tree (dicts/lists/tuples of P)."""
    if isinstance(spec, P):
        return fn(spec, path)
    if isinstance(spec, dict):
        return {k: _map_spec(v, fn, path + (k,)) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        out = [_map_spec(v, fn, path + (str(i),)) for i, v in enumerate(spec)]
        return tuple(out) if isinstance(spec, tuple) else out
    raise TypeError(type(spec))


def init_spec(spec, seed: int, dtype: torch.dtype, device: torch.device,
              lead=lambda path: (), fan_in=lambda shape: math.prod(shape[:-1]),
              part=lambda path: None):
    """Seeded init of a spec tree on ``device``, with the distributions of
    the JAX package's initialisers: ones and zeros, Mamba's ``mamba_dt``
    (the inverse softplus of exp U(ln 1e-3, ln 1e-1)) and ``mamba_alog``
    (ln U(1, 16)), all four kept float32 as there; N(0, 0.02²) for an
    embedding, N(0, 1/fan_in) for a weight, ``fan_in(shape)`` of its spec
    shape (by default the product of all dims but the last, the image
    models' rule).  ``lead(path)`` is a leaf's leading stacked dims.  A
    leaf is drawn one slice of its stacked dims at a time, and a slice of
    over ``DRAW_ELEMS`` entries a block along its first dim at a time (an
    expert stack's (E, d_in, d_out): experts), in float32 and cast into its
    place, so the float32 temporary is at most 1 GiB or one row of the
    slice, never the whole stack.  Each draw has its own
    ``torch.Generator`` seeded by a crc32 of (seed, its path, the slice's
    index and first row; an unstacked leaf of at most ``DRAW_ELEMS``: seed
    and path), so its values do not depend on the other leaves or slices.
    ``part(path)``: the ``dist.sharding.Shard`` of a leaf this process
    holds one slice of (None: the whole leaf).  Such a leaf is drawn a
    layer slice (or a row block) at a time as above and only its part is
    kept, skipping the layer slices and row blocks outside it, so the slice
    equals the same slice of the whole leaf bit for bit and no whole
    stacked leaf is ever held.  The bits differ from JAX's threefry: tests
    share weights via ``interop``."""
    def draw(p: P, shape, key: str):
        g = torch.Generator(device=device)
        # 32 bits: the CPU generator keeps only the low 32 bits of a seed
        g.manual_seed(zlib.crc32(key.encode()))
        if p.init in ("mamba_dt", "mamba_alog"):
            u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
            if p.init == "mamba_alog":
                return torch.log(1.0 + 15.0 * u)
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
            return dt + torch.log(-torch.expm1(-dt))        # inverse softplus
        std = 0.02 if p.init == "embed" else 1.0 / fan_in(p.shape) ** 0.5
        w = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
        return w.mul_(std)

    def mk(p: P, path):
        shape = lead(path) + p.shape
        sh = part(path)
        local = list(shape)
        if sh is not None:
            local[sh.dim] = sh.part
        if p.init in ("ones", "zeros"):
            fill = torch.ones if p.init == "ones" else torch.zeros
            return fill(local, dtype=torch.float32, device=device)
        small = p.init in ("mamba_dt", "mamba_alog")        # kept float32
        out = torch.empty(local, dtype=torch.float32 if small else dtype,
                          device=device)
        n = len(lead(path))
        piece = shape[n:]
        rows = max(1, DRAW_ELEMS // max(1, math.prod(piece[1:])))
        # this process's layer slices of the stacked dims, its rows of the
        # piece's first dim, and the dim of the piece its slice cuts when
        # that is another one
        stacked = [range(k) for k in shape[:n]]
        lo, hi, cut, first = 0, piece[0], None, 0
        if sh is not None and sh.dim < n:
            first = sh.index * sh.part
            stacked[sh.dim] = range(first, first + sh.part)
        elif sh is not None and sh.dim == n:
            lo, hi = sh.index * sh.part, (sh.index + 1) * sh.part
        elif sh is not None:
            cut = sh.dim - n

        def keep(w):
            return w if cut is None else w.narrow(cut, sh.index * sh.part, sh.part)
        base = f"{seed}:{'/'.join(path)}"
        for idx in itertools.product(*stacked):
            key = f"{base}:{','.join(map(str, idx))}" if n else base
            at = tuple(i - first if sh is not None and d == sh.dim else i
                       for d, i in enumerate(idx))
            if math.prod(piece) <= DRAW_ELEMS:
                out[at] = keep(draw(p, piece, key)[lo:hi])
                continue
            for r in range(0, piece[0], rows):        # rows at a time
                h = min(rows, piece[0] - r)
                a, b = max(r, lo), min(r + h, hi)
                if a < b:
                    w = draw(p, (h,) + piece[1:], f"{key}:rows{r}")
                    out[at][a - lo:b - lo] = keep(w[a - r:b - r])
        return out

    return _map_spec(spec, mk)


SMALL_INITS = ("ones", "zeros", "mamba_dt", "mamba_alog")    # kept float32


def abstract_spec(spec, dtype: torch.dtype, lead=lambda path: ()):
    """Meta tensors (shapes and types, no storage) of a spec tree's params,
    the small inits float32 as ``init_spec`` makes them; ``lead(path)`` as
    there."""
    return _map_spec(spec, lambda p, path: torch.empty(
        lead(path) + p.shape, device="meta",
        dtype=torch.float32 if p.init in SMALL_INITS else dtype))


def spec_axes(spec, lead=lambda path: ()):
    """The logical axes of a spec tree's params, ``lead(path)`` the names of
    a leaf's leading stacked dims."""
    return _map_spec(spec, lambda p, path: lead(path) + p.axes)


def _blocks_lead(arch: ArchConfig):
    reps = group_layers(arch)[2]
    return lambda path: (reps,) if path and path[0] == "blocks" else ()


def abstract_params(arch: ArchConfig, dtype: torch.dtype = torch.bfloat16):
    """The decoder's params as meta tensors (nothing allocated), the
    ``blocks`` leaves with their leading ``(reps,)`` axis."""
    return abstract_spec(model_spec(arch), dtype, _blocks_lead(arch))


def logical_axes(arch: ArchConfig):
    """Logical-axis tuples parallel to ``abstract_params``; a ``blocks``
    leaf's stacked dim is ``"layers"``."""
    return spec_axes(model_spec(arch), lambda path: ("layers",)
                     if path and path[0] == "blocks" else ())


def init_params(arch: ArchConfig, seed: int, dtype: torch.dtype,
                device: torch.device, shards=None):
    """``init_spec`` of the decoder's spec; every ``blocks`` leaf carries
    the leading ``(reps,)`` axis.  fan_in is a weight's second-to-last dim,
    as in the JAX transformer: d_in of a dense (d_in, d_out) and of an
    expert stack (E, d_in, d_out) alike.  ``shards``: the FSDP layout
    (``dist.sharding.fsdp_shards``), whose sharded leaves are drawn as
    this process's slices only."""
    return init_spec(model_spec(arch), seed, dtype, device,
                     _blocks_lead(arch), lambda shape: shape[-2],
                     lambda path: _at(shards, path))


def _at(tree, path):
    """The entry of ``tree`` at a spec path (dict keys, sequence indices as
    str); None for a None tree."""
    for k in path:
        if tree is None:
            return None
        tree = tree[k] if isinstance(tree, dict) else tree[int(k)]
    return tree


def _index(tree, r: int):
    """Layer r of a (reps, ...) block tree."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def gathered(params, shards, lead: int = 0):
    """``params`` (a subtree of the model's) with every FSDP slice gathered
    whole (``dist.runtime.fsdp_gather``), ``shards`` the parallel subtree
    of the FSDP layout (None: nothing sharded), ``lead`` the stacked dims
    already indexed away."""
    if shards is None:
        return params
    if isinstance(params, dict):
        return {k: gathered(v, shards[k], lead) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        out = [gathered(v, s, lead) for v, s in zip(params, shards)]
        return tuple(out) if isinstance(params, tuple) else out
    return runtime.fsdp_gather(params, shards, lead)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class ParamModel(nn.Module):
    """A model whose params are a tree in the JAX package's layout
    (``interop.params_from_numpy``), or None for a seeded ``init(arch,
    seed, param_dtype, device)`` on the device.  ``dtype`` is the compute
    type (activations and caches), ``param_dtype`` the type the weights are
    held in (default ``dtype``; norm scales and biases stay float32); each
    weight is cast to the compute type where it is used, as the JAX
    package's ``param_dtype`` and ``compute_dtype``.  ``device`` defaults
    to ``cuda`` and raises without one; pass ``"cpu"`` for the plain path.
    ``remat``: the training loss's activation-checkpointing policy
    (``configs.base.REMAT_POLICIES``), ``"block"`` by default as in the JAX
    package.  Every param is registered under its slash-joined tree path,
    frozen; ``model.requires_grad_(True)`` makes them trainable (the
    Trainer does).

    ``mesh``: the device mesh of a data-parallel run.  For an arch with
    ``use_fsdp`` on a ``data`` axis above 1 the params are FSDP-sharded:
    ``fsdp`` is the layout (``dist.sharding.fsdp_shards``), each sharded
    param is this rank's slice (drawn alone by a seeded init, cut from
    whole ``params`` otherwise) carrying its ``Shard`` as ``fsdp_shard``,
    and the model gathers each layer's params just before the layer runs
    (``gathered``).  Otherwise ``fsdp`` is None and every param whole.  On
    a ``model`` axis above 1 the params are tensor-parallel: ``tp`` is the
    layout (``dist.sharding.model_shards``) and each param on ``model`` is
    this rank's slice for good, drawn or cut alike, carrying its ``Shard``
    as ``model_shard``; otherwise ``tp`` is None.  On a ``stage`` axis above
    1 ``stage`` is the layout (``dist.sharding.stage_shards``): each
    ``blocks`` leaf is this rank's run of layers, drawn or cut alike,
    carrying its ``Shard`` as ``stage_shard``; otherwise ``stage`` is
    None."""

    def __init__(self, arch: ArchConfig, params, init, *, dtype: torch.dtype,
                 device, seed: int, remat: str,
                 param_dtype: Optional[torch.dtype], mesh=None):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        self.param_dtype = dtype if param_dtype is None else param_dtype
        self.remat = validate_remat(remat)
        self.device = resolve_device(device)
        self.fsdp = self.tp = self.stage = None
        if mesh is not None and arch.use_fsdp:
            shards = dist_sharding.fsdp_shards(mesh, self)
            if tree.leaves(shards):           # some leaf is sharded
                self.fsdp = shards
        if mesh is not None:
            for name, layout in (("tp", dist_sharding.model_shards),
                                 ("stage", dist_sharding.stage_shards)):
                shards = layout(mesh, self)
                if tree.leaves(shards):
                    setattr(self, name, shards)
        shards, attr = next(((s, a) for s, a in (
            (self.stage, "stage_shard"), (self.tp, "model_shard"),
            (self.fsdp, "fsdp_shard")) if s is not None), (None, None))
        if params is None:
            kw = {} if shards is None else {"shards": shards}
            params = init(arch, seed, self.param_dtype, self.device, **kw)
        self.params = self._register(params, shards, attr)

    def _register(self, tree, shards, attr, path=()):
        if isinstance(tree, dict):
            return {k: self._register(v, _at(shards, (k,)), attr, path + (k,))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [self._register(v, _at(shards, (str(i),)), attr, path + (str(i),))
                   for i, v in enumerate(tree)]
            return tuple(out) if isinstance(tree, tuple) else out
        if shards is not None and tree.shape[shards.dim] == shards.size:
            tree = shards.of(tree).clone()     # whole params given: the slice
        prm = nn.Parameter(tree.to(self.device), requires_grad=False)
        if shards is not None:
            setattr(prm, attr, shards)
        self.register_parameter("/".join(path), prm)
        return prm

    def _shards(self, *path):
        """The FSDP layout's subtree at ``path`` (None when unsharded)."""
        return _at(self.fsdp, path)


class Model(ParamModel):
    """Serving and training model of one decoder ``ArchConfig``: dense,
    MoE, SSM or hybrid (the ``ParamModel`` contract for params, types,
    device and remat).

    ``pp_stages`` > 1 slices the repeated blocks into that many contiguous
    stages, run on a microbatch-interleaved schedule in the training
    forward (``_blocks_pipelined``); it must divide the block count.
    ``pp_microbatches``: the microbatches a call, 0 for one a stage
    (``core.algo.stage_microbatches`` clamps it to a divisor of the
    examples).  Prefill and decode always run the blocks in sequence."""

    def __init__(self, arch: ArchConfig, params=None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: int = 0, remat: str = "block",
                 param_dtype: Optional[torch.dtype] = None,
                 pp_stages: int = 1, pp_microbatches: int = 0, mesh=None):
        pre, period, reps = group_layers(arch)
        if pp_stages > 1 and (reps == 0 or reps % pp_stages):
            raise ValueError(
                f"pp_stages={pp_stages} must divide the scanned block count "
                f"(arch {arch.name!r} groups as {reps} x {period}-layer "
                f"blocks + {pre} prelude); pick a divisor of {reps}")
        if pp_microbatches < 0:
            raise ValueError(
                f"pp_microbatches must be >= 0, got {pp_microbatches}")
        if mesh is not None:
            width = dist_sharding._axis_size(mesh, dist_sharding.MODEL_AXIS)
            reason = (stage_refusal(arch, dist_sharding.stage_axis_width(mesh),
                                    pp_stages, width)
                      or tp_refusal(arch, width, pp_stages))
            if reason:
                raise NotImplementedError(reason)
        self.pp_stages, self.pp_microbatches = pp_stages, pp_microbatches
        super().__init__(arch, params, init_params, dtype=dtype, device=device,
                         seed=seed, remat=remat, param_dtype=param_dtype,
                         mesh=mesh)
        if self.stage is not None:
            # the stage rank whose gradient of a whole leaf is the real one
            width = self.stage_width()
            for key, sub in self.params.items():
                if key != "blocks":
                    for p in tree.leaves(sub):
                        p.stage_owner = dist_sharding.stage_owner(key, width)

    def abstract_params(self):
        return abstract_params(self.arch, self.param_dtype)

    def logical_axes(self):
        return logical_axes(self.arch)

    # -- per-layer ----------------------------------------------------------
    def _ffn(self, p, h, ctx: DPContext):
        """The layer's FFN, dense or MoE: (y, ctx, aux (B,) or None)."""
        if "moe" in p:
            return moe_lib.moe_apply(p["moe"], h, ctx, self.arch)
        return L.mlp_apply(p["mlp"], h, ctx, self.arch) + (None,)

    def _layer(self, p, x, ctx: DPContext, pos):
        """Full-sequence layer (train / prefill): (x, ctx, cache, aux), the
        cache (k, v) or a Mamba layer's (conv window, SSM state), aux None
        for a dense FFN."""
        arch = self.arch
        h, ctx = L.rmsnorm(x, p["ln1"], ctx, arch.norm_eps)
        if "attn" in p:
            y, ctx, kv = L.attn_apply(p["attn"], h, ctx, arch, pos)
        else:
            y, ctx, kv = mamba2.mamba_apply(p["mamba"], h, ctx, arch,
                                            want_cache=True, remat=self.remat)
        x = x + y
        aux = None
        if arch.d_ff > 0:
            h, ctx = L.rmsnorm(x, p["ln2"], ctx, arch.norm_eps)
            y, ctx, aux = self._ffn(p, h, ctx)
            x = x + y
        return x, ctx, kv, aux

    def _layer_decode(self, p, x, kv, pos, tables=None):
        arch = self.arch
        off = DPContext.off()
        h, _ = L.rmsnorm(x, p["ln1"], off, arch.norm_eps)
        if "mamba" in p:                 # the new state written in place
            y, new = mamba2.mamba_decode(p["mamba"], h, kv[0], kv[1], arch)
            for dst, src in zip(kv, new):
                dst.copy_(src)
        elif tables is None:
            y, kv = L.attn_decode(p["attn"], h, kv, pos, arch)
        else:
            y, kv = L.attn_decode_paged(p["attn"], h, kv, tables, pos, arch)
        x = x + y
        if arch.d_ff > 0:
            h, _ = L.rmsnorm(x, p["ln2"], off, arch.norm_eps)
            x = x + self._ffn(p, h, off)[0]     # MoE at T 1: capacity 1
        return x, kv

    def _layers(self, params=None):
        """(params, cache address) of every layer in execution order; the
        address is ("prelude", i) or ("blocks", j, r)."""
        params = self.params if params is None else params
        pre, period, reps = group_layers(self.arch)
        for i in range(pre):
            yield self._prelude(params, i), ("prelude", i)
        for r in range(reps):
            for j in range(period):
                yield (gathered(_index(params["blocks"][j], r),
                                self._shards("blocks", str(j)), lead=1),
                       ("blocks", j, r))

    def _prelude(self, params, i: int):
        """Prelude layer i's params, gathered whole under FSDP."""
        return gathered(params["prelude"][i], self._shards("prelude", str(i)))

    def _whole_params(self, what: str, model_slices: bool = False):
        """Raise, naming ROADMAP, for ``what`` (serving) on sliced params;
        ``model_slices``: ``what`` runs on tensor-parallel model slices
        (prefill and the contiguous decode)."""
        for sliced, layout in (("stage", self.stage), ("fsdp", self.fsdp),
                               ("model", None if model_slices else self.tp)):
            if layout is not None:
                raise NotImplementedError(serving_refusal(self.arch, what, sliced))

    def _check_layout(self):
        """Raise unless the active layout's ``model`` and ``stage`` axes are
        those the params are sliced for (a trace of the whole program, under
        ``runtime.suspended``, takes any)."""
        for axis, (width, built) in (
                ("model", (runtime.model_shard()[1], self.tp_width())),
                ("stage", (runtime.stage_shard()[1], self.stage_width()))):
            if width != built and not runtime.is_suspended():
                raise RuntimeError(
                    f"{self.arch.name}: params sliced for a {built}-wide "
                    f"{axis} axis under a layout of a {width}-wide one; a model "
                    f"runs inside dist.runtime.layout over the mesh it was "
                    f"built on (Model(mesh=...))")

    def _vocab_lo(self, leaf: str) -> Optional[int]:
        """The first vocabulary row (``embed``) or logits column (``head``)
        of this rank's slice of ``leaf``; None when the leaf is whole."""
        sh = _at(self.tp, (leaf,))
        return None if sh is None else sh.index * sh.part

    def _head(self, params, x, ctx: DPContext):
        """Logits: (B, T, Vpad), or a tensor-parallel rank's columns of
        them (the final norm's output enters through ``to_model``)."""
        x, ctx = L.rmsnorm(x, gathered(params["final_norm"],
                                       self._shards("final_norm")),
                           ctx, self.arch.norm_eps)
        head = gathered(params["head"], self._shards("head"))
        x = runtime.to_model(x)
        return ctx.dense(x, L.cast(head, x))

    def _embed_in(self, params, inputs, ctx: DPContext):
        """(B, T, d) activations in the compute type: an embedding-input
        arch's precomputed embeddings cast (no site), else the token ids'
        rows gathered through the embedding site in the parameter type and
        cast, as the JAX package does (its embedding site sees the
        parameter type).  Vocabulary-parallel (a rank's rows of the table):
        an id outside them takes row 0 and a zero row out, so its gradient
        row into the site is zero and the site's norm² is this slice's
        exact partial; the rows are then summed over the ``model`` group
        (one rank holds each id's row, so the sum is exact)."""
        if self.arch.embed_stub:
            return inputs.to(self.dtype), ctx
        table = gathered(params["embed"], self._shards("embed"))
        lo = self._vocab_lo("embed")
        if lo is None:
            x, ctx = ctx.embed(inputs, table)
            return x.to(self.dtype), ctx
        ids = inputs.long() - lo
        inside = (ids >= 0) & (ids < table.shape[0])
        x, ctx = ctx.embed(torch.where(inside, ids, 0), table)
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
        return runtime.from_model(x).to(self.dtype), ctx

    # -- training -------------------------------------------------------------
    def loss_fn(self, params, batch, ctx: DPContext):
        """Per-example losses and the context: ``((B,) float32, ctx)``,
        each loss the cross-entropy plus ``AUX_LOSS_WEIGHT`` times the
        example's MoE aux losses summed over layers.  ``params``: a tree in
        this model's layout (``self.params``, or the same tree detached);
        batch: ``{"tokens": (B, T+1) int}``, or for an embedding-input arch
        ``{"embeds": (B, T, d) float, "labels": (B, T) int}``."""
        self._check_layout()
        if self.arch.embed_stub:
            inputs, labels = batch["embeds"], batch["labels"]
        else:
            toks = batch["tokens"]
            inputs, labels = toks[:, :-1], toks[:, 1:]
        B, T = labels.shape
        dev = labels.device
        pipe = None
        if runtime.stage_shard()[1] > 1:
            pipe = self._pipe(B, T, ctx, dev)
        x = None
        pos = torch.arange(T, device=dev)[None].expand(B, T)
        aux = torch.zeros((B,), dtype=torch.float32, device=dev)
        if pipe is None or pipe.first:
            x, ctx = self._embed_in(params, inputs, ctx)
            for i in range(group_layers(self.arch)[0]):
                x, ctx, _, a = self._layer(self._prelude(params, i), x, ctx, pos)
                if a is not None:
                    aux = aux + a
        if self.pp_stages > 1:
            x, acc, aux = self._blocks_pipelined(params, x, ctx, aux, pos, pipe)
        else:
            x, acc, aux = self._blocks(params, range(self._local_reps(params)),
                                       (x, ctx.acc, aux), ctx, pos)
        ctx = dataclasses.replace(ctx, acc=acc)
        if pipe is not None and not pipe.last:
            # the head runs on the last stage rank: its losses, with edges
            # to this rank's sends and to the leaves it does not run
            tail = runtime.anchor(*tree.leaves(params["final_norm"]),
                                  *tree.leaves(params["head"]))
            return pipe.share_losses(tokens=x, anchor=tail), ctx
        logits, ctx = self._head(params, x, ctx)
        lo = self._vocab_lo("head")
        losses = (per_example_xent(logits, labels, self.arch.vocab) if lo is None
                  else vocab_parallel_xent(logits, labels, self.arch.vocab, lo))
        losses = losses + AUX_LOSS_WEIGHT * aux
        return losses if pipe is None else pipe.share_losses(losses), ctx

    def _pipe(self, B: int, T: int, ctx: DPContext, device):
        """The loss call's ``StagePipe``: each microbatch's (x, acc, aux)
        specs, the microbatches ``_blocks_pipelined`` cuts the batch into."""
        n_ex = B if ctx.acc is None else ctx.acc.shape[0]
        M = stage_microbatches(n_ex, self.pp_stages, self.pp_microbatches)
        specs = (((B // M, T, self.arch.d_model), self.dtype),
                 None if ctx.acc is None else ((n_ex // M,), torch.float32),
                 ((B // M,), torch.float32))
        return runtime.StagePipe(specs, B, device)

    def stage_width(self) -> int:
        """The ``stage`` axis width the blocks are sliced for (1: whole)."""
        if self.stage is None:
            return 1
        return next(sh.count for sh in tree.leaves(self.stage))

    @staticmethod
    def _local_reps(params) -> int:
        """The blocks this rank holds (all of them but on a stage axis)."""
        blocks = params.get("blocks")
        return 0 if blocks is None else tree.leaves(blocks)[0].shape[0]

    def tp_width(self) -> int:
        """The ``model`` axis width the params are sliced for (1: whole)."""
        if self.tp is None:
            return 1
        return next(sh.count for sh in tree.leaves(self.tp))

    def _blocks(self, params, reps, carry, ctx: DPContext, pos):
        """Blocks ``reps`` (indices of the stacked axis) in order on
        ``carry`` = (x, acc, aux), each under the remat policy."""
        for r in reps:
            block = self._block_fn([_index(bp, r) for bp in params["blocks"]],
                                   ctx, pos)
            carry = L.remat_wrap(block, self.remat)(*carry)
        return carry

    def _blocks_pipelined(self, params, x, ctx: DPContext, aux, pos, pipe=None):
        """The repeated blocks on the shifted-buffer pipeline schedule of
        the JAX package's ``_blocks_pipelined``: the (reps, ...) block
        params are viewed stage-major, stage s owning blocks [s·reps/S,
        (s+1)·reps/S), and the batch is cut into M example-aligned
        microbatches (``stage_microbatches``).  The schedule runs M + S − 1
        ticks over a buffer of S stage slots: each tick shifts it by one
        stage (``layers.pipeline_shift``: stage 0 takes the next
        microbatch, the last stage's output is collected), then runs every
        stage on its slot.  The (B,) norm² accumulator and the aux total
        ride the buffer with their microbatch, so the accumulator's
        cotangent, where every site adds its norm², flows back across the
        stages to its examples.

        The stage bodies run one after another in Python (the kernels'
        ``autograd.Function``s have no vmap rule), and a bubble slot, which
        holds no microbatch during the warm-up and drain ticks, is skipped
        rather than run on zeros: its outputs are discarded in the
        reference.  Every batch op of the stack is per example, so each
        microbatch's losses and norms² are those of the sequential loop on
        its rows.

        Across processes (``pipe``, a ``StagePipe``), this rank's params
        hold the blocks of its S/W local stages and the schedule runs those:
        a microbatch enters the first local stage from ``pipe.recv_prev``
        (on the first stage rank, from ``x``) and leaves the last through
        ``pipe.send_next``, whose tokens stand in for x (the last stage
        rank collects its outputs as above).  Returns (x, acc, aux), on a
        rank that sends them (x = the send tokens, acc the accumulators it
        sent, aux None)."""
        S = self.pp_stages // self.stage_width()        # the local stages
        per = self._local_reps(params) // S
        rows = pos.shape[0]
        n_ex = rows if ctx.acc is None else ctx.acc.shape[0]
        M = stage_microbatches(n_ex, self.pp_stages, self.pp_microbatches)
        sends = pipe is not None and not pipe.last

        def chunks(a, n):
            return [None] * M if a is None else list(a.split(n))
        pos_mb = chunks(pos, rows // M)
        if pipe is None or pipe.first:
            mbs = list(zip(chunks(x, rows // M), chunks(ctx.acc, n_ex // M),
                           chunks(aux, rows // M), pos_mb))
        else:
            # the first local stage's input arrives from rank w-1, with an
            # edge to what this rank does not run (the embedding, prelude)
            # or else to its first block, and to the accumulator
            unused = [p for k in ("embed", "prelude")
                      for p in tree.leaves(params.get(k))]
            edge = runtime.anchor(ctx.acc,
                                  *(unused or tree.leaves(params["blocks"])[:1]))
            mbs = [None] * M
        buf, outs = [None] * S, []
        for t in range(M + S - 1):
            if t < M and pipe is not None and not pipe.first:
                mbs[t] = pipe.recv_prev(t, edge) + (pos_mb[t],)
            buf = L.pipeline_shift(buf, mbs[t] if t < M else None)
            buf = [None if slot is None else
                   self._blocks(params, range(s * per, (s + 1) * per),
                                slot[:3], ctx, slot[3]) + (slot[3],)
                   for s, slot in enumerate(buf)]
            if buf[-1] is not None:
                if sends:
                    outs.append((pipe.send_next(len(outs), *buf[-1][:3]),
                                 buf[-1][1]))
                else:
                    outs.append(buf[-1])
        acc = None if ctx.acc is None else torch.cat([o[1] for o in outs])
        if sends:
            return [o[0] for o in outs], acc, None
        return torch.cat([o[0] for o in outs]), acc, torch.cat([o[2] for o in outs])

    def _block_fn(self, layer_params, ctx: DPContext, pos):
        """One period of blocks as ``fn(x, acc, aux, saved=None) -> (x,
        acc, aux)``: tensors in and out, the ``DPContext`` rebuilt inside
        around the accumulator, so a checkpoint boundary sees it; ``aux``
        the running (B,) aux total.  Under FSDP the layers' slices are
        gathered inside, so a remat policy gathers them again in its
        recompute instead of keeping the whole block."""
        def block(x, acc, aux, saved=None):
            c = dataclasses.replace(ctx, acc=acc, saved=saved)
            for j, p in enumerate(layer_params):
                p = gathered(p, self._shards("blocks", str(j)), lead=1)
                x, c, _, a = self._layer(p, x, c, pos)
                if a is not None:
                    aux = aux + a
            return x, c.acc, aux
        return block

    # -- caches -------------------------------------------------------------
    def _cache_tree(self, leaves) -> Dict[str, Any]:
        """Zeros of ``leaves(kind)``, a layer's ((shape, dtype), ...), for
        every layer; block leaves lead with (reps,)."""
        arch = self.arch
        pre, period, reps = group_layers(arch)

        def layer(kind, *lead):
            return tuple(torch.zeros(lead + shape, dtype=dtype, device=self.device)
                         for shape, dtype in leaves(kind))
        return {"prelude": [layer(layer_sig(arch, i)[0]) for i in range(pre)],
                "blocks": (tuple(layer(layer_sig(arch, pre + j)[0], reps)
                                 for j in range(period)) if reps > 0 else None)}

    def init_cache(self, B: int, S: int):
        """Contiguous cache: (k, v) of (B, S, KV, hd) per attention layer,
        KV this rank's KV heads on tensor-parallel model slices
        (``dist.sharding.cache_shardings``); (conv window (B, K-1, C) in the
        compute type, SSM state (B, H, P, N) float32) per Mamba layer."""
        arch = self.arch
        kv = (B, S, arch.n_kv_heads // self.tp_width(), arch.hd)

        def leaves(kind):
            if kind == ATTN:
                return ((kv, self.dtype),) * 2
            d_in, H, G, N, K, Pd = mamba2.mamba_dims(arch)
            return (((B, K - 1, d_in + 2 * G * N), self.dtype),
                    ((B, H, Pd, N), torch.float32))
        return self._cache_tree(leaves)

    def _no_mamba(self, what: str):
        if MAMBA in self.arch.pattern():
            raise ValueError(f"{self.arch.name}: {what}")

    def init_paged_cache(self, num_blocks: int, block_size: int):
        """Block-paged KV pools: (k, v) of (num_blocks, block_size, KV, hd)
        per layer, one table shared across the stack.  Raises for an
        architecture with Mamba layers: their state is O(1) a slot."""
        self._no_mamba("paged KV cache requires an attention-only architecture "
                       "(SSM state is O(1) per slot — nothing to page)")
        shape = (num_blocks, block_size, self.arch.n_kv_heads, self.arch.hd)
        return self._cache_tree(lambda kind: ((shape, self.dtype),) * 2)

    @staticmethod
    def _layer_cache(cache, addr):
        if addr[0] == "prelude":
            return cache["prelude"][addr[1]]
        k, v = cache["blocks"][addr[1]]
        return k[addr[2]], v[addr[2]]

    # -- serving ------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens, cache_len: int, lengths=None):
        """Full-prompt forward.  tokens: (B, T) int, or for an
        embedding-input arch its (B, T, d) embeddings.  Returns (logits at
        the last position (B, 1, Vpad), cache), the attention leaves padded
        to ``cache_len`` positions, the Mamba states as the prompt leaves
        them.  ``lengths``: optional (B,) true lengths of right-padded
        prompts; logits are then taken at ``lengths - 1`` (exact for
        attention: padded positions are causally masked; a Mamba state
        absorbs pad tokens, so SSM and hybrid callers pass equal-length
        prompts).  On tensor-parallel model slices, inside their layout:
        attention on the rank's heads (its cache holds their (k, v)), the
        FFN on its columns, and the logits gathered whole."""
        self._whole_params("prefill", model_slices=True)
        self._check_layout()

        def pad(a):     # (B, T, KV, hd) -> (B, cache_len, KV, hd)
            if cache_len == T:
                return a.contiguous()
            out = a.new_zeros(a.shape[:-3] + (cache_len,) + a.shape[-2:])
            out[..., :T, :, :] = a
            return out

        off = DPContext.off()
        x, _ = self._embed_in(self.params, tokens, off)
        B, T = x.shape[0], x.shape[1]
        pos = torch.arange(T, device=x.device)[None].expand(B, T)
        pre_c: List[Any] = []
        blk_c: Dict[int, List[Any]] = {}
        for p, addr in self._layers():
            x, _, c, _ = self._layer(p, x, off, pos)
            if "attn" in p:
                c = tuple(pad(a) for a in c)
            if addr[0] == "prelude":
                pre_c.append(c)
            else:
                blk_c.setdefault(addr[1], []).append(c)
        if lengths is None:
            x_last = x[:, -1:]
        else:
            idx = (lengths.long() - 1).to(x.device)
            x_last = x[torch.arange(B, device=x.device), idx][:, None]
        logits = self._whole_logits(self._head(self.params, x_last, off)[0])
        cache = {"prelude": pre_c,
                 "blocks": (tuple(tuple(torch.stack(leaf) for leaf in zip(*blk_c[j]))
                                  for j in sorted(blk_c))
                            if blk_c else None)}
        return logits, cache

    def _whole_logits(self, logits):
        """The head's logits whole: a tensor-parallel rank's columns
        gathered over the ``model`` group (``runtime.all_gather``, metered),
        so the caller sees (B, T, Vpad) as from whole params."""
        if self._vocab_lo("head") is None:
            return logits
        return runtime.all_gather(logits, runtime.model_group(), dim=-1)

    def _decode(self, cache, tokens, pos, tables):
        self._whole_params("decode" if tables is None else "the paged decode",
                           model_slices=tables is None)
        self._check_layout()
        off = DPContext.off()
        x, _ = self._embed_in(self.params, tokens, off)
        for p, addr in self._layers():
            x, _ = self._layer_decode(p, x, self._layer_cache(cache, addr),
                                      pos, tables)
        return self._whole_logits(self._head(self.params, x, off)[0]), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """One-token decode. tokens: (B, 1), or for an embedding-input arch
        (B, 1, d) embeddings; pos: (B,) write positions.  Writes the cache
        in place; returns (logits (B,1,Vpad), cache).  On tensor-parallel
        model slices (inside their layout) the cache holds the rank's KV
        heads (``init_cache``) and the logits are whole, as ``prefill``'s."""
        return self._decode(cache, tokens, pos, None)

    @torch.no_grad()
    def decode_step_paged(self, cache, tokens, pos, tables):
        """One-token decode through block tables (B, nb), sentinel =
        num_blocks.  Same contract as ``decode_step``; greedy outputs equal
        the contiguous path's.  Raises for an architecture with Mamba
        layers."""
        self._no_mamba("paged decode supports attention layers only")
        return self._decode(cache, tokens, pos, tables)


def vocab_parallel_xent(logits, labels, vocab: int, lo: int):
    """``per_example_xent`` of logits split over the ``model`` group by
    columns: ``logits`` (B, T, V/m) are this rank's columns ``lo`` onward.
    The padded columns are masked by their global index (so the padding
    falls in the last slices alone); the row max is taken over the group
    (``op="max"``), the sum of exponentials and the target's logit summed
    over it (``runtime.from_model``: each rank's gradient is its own
    columns').  The result is alike on every rank; it equals the whole
    row's but for the order of the exponentials' sum."""
    lf = logits.float()
    V = lf.shape[-1]
    col = lo + torch.arange(V, device=lf.device)
    if lo + V > vocab:
        lf = torch.where(col < vocab, lf, torch.full((), -1e30, device=lf.device))
    m = lf.detach().amax(dim=-1)
    runtime.all_reduce_([m], runtime.model_group(), op="max")
    sumexp = runtime.from_model(torch.exp(lf - m[..., None]).sum(dim=-1))
    ids = labels.long() - lo
    inside = (ids >= 0) & (ids < V)
    picked = torch.gather(lf, -1, torch.where(inside, ids, 0)[..., None])[..., 0]
    target = runtime.from_model(torch.where(inside, picked, 0.0))
    return -(target - m - torch.log(sumexp)).mean(dim=-1)


def per_example_xent(logits, labels, vocab: int):
    """(B,T,Vpad) logits, (B,T) labels -> (B,) mean cross-entropy in
    float32, with the padded vocab columns masked out."""
    lf = logits.float()
    Vpad = lf.shape[-1]
    if Vpad != vocab:
        col = torch.arange(Vpad, device=lf.device)
        lf = torch.where(col < vocab, lf, torch.full((), -1e30, device=lf.device))
    logp = torch.log_softmax(lf, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -ll.mean(dim=-1)
