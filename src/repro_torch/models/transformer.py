"""Model assembly: layer grouping (prelude + repeated block), param spec,
seeded init on the device, the training loss, prefill and decode.
Counterpart of ``repro/models/transformer.py``.

Params keep the JAX package's nesting and layouts: ``{"embed",
"prelude": [layer, ...], "blocks": (layer, ...), "final_norm", "head"}``,
where every ``blocks`` leaf carries a leading ``(reps,)`` axis.  The JAX
package scans that axis with ``lax.scan``; here a Python loop indexes it.
KV caches are ``{"prelude": [(k, v), ...], "blocks": ((k, v), ...)}`` with
the same leading ``(reps,)`` axis on block leaves.

The port covers attention-only dense decoders.  Mamba and MoE layers raise
``NotImplementedError`` (ROADMAP queue 1).  Training puts each block (one
period of the repeated layers) under the model's ``remat`` policy
(``layers.remat_wrap``), as the JAX package wraps its scanned block; the
prelude is not wrapped.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN, ArchConfig, validate_remat
from repro_torch.core.context import DPContext
from repro_torch.models import layers as L
from repro_torch.models.layers import P

VOCAB_PAD = 256


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
    if kind != ATTN:
        raise NotImplementedError(
            f"{arch.name}: {kind} layers are not ported yet (ROADMAP queue 1, "
            f"Mamba serving path)")
    if is_moe:
        raise NotImplementedError(
            f"{arch.name}: MoE layers are not ported yet (ROADMAP queue 1, "
            f"MoE serving path)")
    d = arch.d_model
    spec: Dict[str, Any] = {"ln1": P((d,), "ones"), "attn": L.attn_spec(arch)}
    if arch.d_ff > 0:
        spec["ln2"] = P((d,), "ones")
        spec["mlp"] = L.mlp_spec(arch, arch.ff_dense())
    return spec


def model_spec(arch: ArchConfig) -> Dict[str, Any]:
    if arch.embed_stub:
        raise NotImplementedError(f"{arch.name}: embedding-input models are "
                                  f"not ported")
    pre, period, reps = group_layers(arch)
    spec: Dict[str, Any] = {
        "embed": P((padded_vocab(arch.vocab), arch.d_model), "embed"),
        "prelude": [layer_spec(arch, layer_sig(arch, i)) for i in range(pre)],
    }
    if reps > 0:
        spec["blocks"] = tuple(layer_spec(arch, layer_sig(arch, pre + j))
                               for j in range(period))
    spec["final_norm"] = P((arch.d_model,), "ones")
    spec["head"] = P((arch.d_model, padded_vocab(arch.vocab)))
    return spec


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
              lead=lambda path: ()):
    """Seeded init of a spec tree on ``device``, with the distributions of
    the JAX package's initialisers: ones and zeros (kept float32, as
    there), N(0, 0.02²) for an embedding, N(0, 1/fan_in) for a weight
    (fan_in the product of all dims but the last).  ``lead(path)`` is a
    leaf's leading stacked dims.  Each leaf draws from its own
    ``torch.Generator`` seeded by a crc32 of (seed, its path), so a leaf's
    values do not depend on the others.  The bits differ from JAX's
    threefry: tests share weights via ``interop``."""
    def mk(p: P, path):
        shape = lead(path) + p.shape
        if p.init in ("ones", "zeros"):
            fill = torch.ones if p.init == "ones" else torch.zeros
            return fill(shape, dtype=torch.float32, device=device)
        g = torch.Generator(device=device)
        # 32 bits: the CPU generator keeps only the low 32 bits of a seed
        g.manual_seed(zlib.crc32(f"{seed}:{'/'.join(path)}".encode()))
        std = 0.02 if p.init == "embed" else 1.0 / math.prod(p.shape[:-1]) ** 0.5
        w = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
        return (w.mul_(std)).to(dtype)

    return _map_spec(spec, mk)


def init_params(arch: ArchConfig, seed: int, dtype: torch.dtype,
                device: torch.device):
    """``init_spec`` of the decoder's spec; every ``blocks`` leaf carries
    the leading ``(reps,)`` axis."""
    pre, period, reps = group_layers(arch)
    return init_spec(model_spec(arch), seed, dtype, device,
                     lambda path: (reps,) if path and path[0] == "blocks" else ())


def _index(tree, r: int):
    """Layer r of a (reps, ...) block tree."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


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
    Trainer does)."""

    def __init__(self, arch: ArchConfig, params, init, *, dtype: torch.dtype,
                 device, seed: int, remat: str,
                 param_dtype: Optional[torch.dtype]):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        self.param_dtype = dtype if param_dtype is None else param_dtype
        self.remat = validate_remat(remat)
        self.device = resolve_device(device)
        if params is None:
            params = init(arch, seed, self.param_dtype, self.device)
        self.params = self._register(params)

    def _register(self, tree, path=()):
        if isinstance(tree, dict):
            return {k: self._register(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [self._register(v, path + (str(i),))
                   for i, v in enumerate(tree)]
            return tuple(out) if isinstance(tree, tuple) else out
        prm = nn.Parameter(tree.to(self.device), requires_grad=False)
        self.register_parameter("/".join(path), prm)
        return prm


class Model(ParamModel):
    """Serving and training model of one dense ``ArchConfig`` (the
    ``ParamModel`` contract for params, types, device and remat)."""

    def __init__(self, arch: ArchConfig, params=None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: int = 0, remat: str = "block",
                 param_dtype: Optional[torch.dtype] = None):
        model_spec(arch)          # raises early for unported layer kinds
        super().__init__(arch, params, init_params, dtype=dtype, device=device,
                         seed=seed, remat=remat, param_dtype=param_dtype)

    # -- per-layer ----------------------------------------------------------
    def _layer(self, p, x, ctx: DPContext, pos):
        """Full-sequence layer (train / prefill): (x, ctx, kv)."""
        arch = self.arch
        h, ctx = L.rmsnorm(x, p["ln1"], ctx, arch.norm_eps)
        y, ctx, kv = L.attn_apply(p["attn"], h, ctx, arch, pos)
        x = x + y
        if arch.d_ff > 0:
            h, ctx = L.rmsnorm(x, p["ln2"], ctx, arch.norm_eps)
            y, ctx = L.mlp_apply(p["mlp"], h, ctx, arch)
            x = x + y
        return x, ctx, kv

    def _layer_decode(self, p, x, kv, pos, tables=None):
        arch = self.arch
        off = DPContext.off()
        h, _ = L.rmsnorm(x, p["ln1"], off, arch.norm_eps)
        if tables is None:
            y, kv = L.attn_decode(p["attn"], h, kv, pos, arch)
        else:
            y, kv = L.attn_decode_paged(p["attn"], h, kv, tables, pos, arch)
        x = x + y
        if arch.d_ff > 0:
            h, _ = L.rmsnorm(x, p["ln2"], off, arch.norm_eps)
            x = x + L.mlp_apply(p["mlp"], h, off, arch)[0]
        return x, kv

    def _layers(self, params=None):
        """(params, cache address) of every layer in execution order; the
        address is ("prelude", i) or ("blocks", j, r)."""
        params = self.params if params is None else params
        pre, period, reps = group_layers(self.arch)
        for i in range(pre):
            yield params["prelude"][i], ("prelude", i)
        for r in range(reps):
            for j in range(period):
                yield _index(params["blocks"][j], r), ("blocks", j, r)

    def _head(self, params, x, ctx: DPContext):
        x, ctx = L.rmsnorm(x, params["final_norm"], ctx, self.arch.norm_eps)
        return ctx.dense(x, L.cast(params["head"], x))

    def _embed_in(self, params, tokens, ctx: DPContext):
        # the rows are gathered in the parameter type and cast, as the JAX
        # package does (its embedding site sees the parameter type)
        x, ctx = ctx.embed(tokens, params["embed"])
        return x.to(self.dtype), ctx

    # -- training -------------------------------------------------------------
    def loss_fn(self, params, batch, ctx: DPContext):
        """Per-example losses and the context: ``((B,) float32, ctx)``.
        ``params``: a tree in this model's layout (``self.params``, or the
        same tree detached); batch: ``{"tokens": (B, T+1) int}``."""
        toks = batch["tokens"]
        inputs, labels = toks[:, :-1], toks[:, 1:]
        B, T = labels.shape
        x, ctx = self._embed_in(params, inputs, ctx)
        pos = torch.arange(T, device=x.device)[None].expand(B, T)
        pre, period, reps = group_layers(self.arch)
        for i in range(pre):
            x, ctx, _ = self._layer(params["prelude"][i], x, ctx, pos)
        for r in range(reps):
            block = self._block_fn([_index(params["blocks"][j], r)
                                    for j in range(period)], ctx, pos)
            x, acc = L.remat_wrap(block, self.remat)(x, ctx.acc)
            ctx = dataclasses.replace(ctx, acc=acc)
        logits, ctx = self._head(params, x, ctx)
        return per_example_xent(logits, labels, self.arch.vocab), ctx

    def _block_fn(self, layer_params, ctx: DPContext, pos):
        """One period of blocks as ``fn(x, acc, saved=None) -> (x, acc)``:
        tensors in and out, the ``DPContext`` rebuilt inside around the
        accumulator, so a checkpoint boundary sees it."""
        def block(x, acc, saved=None):
            c = dataclasses.replace(ctx, acc=acc, saved=saved)
            for p in layer_params:
                x, c, _ = self._layer(p, x, c, pos)
            return x, c.acc
        return block

    # -- caches -------------------------------------------------------------
    def _cache_tree(self, shape) -> Dict[str, Any]:
        pre, period, reps = group_layers(self.arch)
        z = lambda *lead: torch.zeros(lead + shape, dtype=self.dtype,
                                      device=self.device)
        return {"prelude": [(z(), z()) for _ in range(pre)],
                "blocks": (tuple((z(reps), z(reps)) for _ in range(period))
                           if reps > 0 else None)}

    def init_cache(self, B: int, S: int):
        """Contiguous KV cache: (k, v) of (B, S, KV, hd) per layer."""
        return self._cache_tree((B, S, self.arch.n_kv_heads, self.arch.hd))

    def init_paged_cache(self, num_blocks: int, block_size: int):
        """Block-paged KV pools: (k, v) of (num_blocks, block_size, KV, hd)
        per layer, one table shared across the stack."""
        return self._cache_tree((num_blocks, block_size, self.arch.n_kv_heads,
                                 self.arch.hd))

    @staticmethod
    def _layer_cache(cache, addr):
        if addr[0] == "prelude":
            return cache["prelude"][addr[1]]
        k, v = cache["blocks"][addr[1]]
        return k[addr[2]], v[addr[2]]

    # -- serving ------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens, cache_len: int, lengths=None):
        """Full-prompt forward.  tokens: (B, T) int.  Returns (logits at
        the last position (B, 1, Vpad), cache padded to ``cache_len``).
        ``lengths``: optional (B,) true lengths of right-padded prompts;
        logits are then taken at ``lengths - 1`` (exact: padded positions
        are causally masked)."""
        off = DPContext.off()
        x, _ = self._embed_in(self.params, tokens, off)
        B, T = x.shape[0], x.shape[1]
        pos = torch.arange(T, device=x.device)[None].expand(B, T)
        pre_c: List[Any] = []
        blk_c: Dict[int, List[Any]] = {}
        for p, addr in self._layers():
            x, _, kv = self._layer(p, x, off, pos)
            if addr[0] == "prelude":
                pre_c.append(kv)
            else:
                blk_c.setdefault(addr[1], []).append(kv)
        if lengths is None:
            x_last = x[:, -1:]
        else:
            idx = (lengths.long() - 1).to(x.device)
            x_last = x[torch.arange(B, device=x.device), idx][:, None]
        logits, _ = self._head(self.params, x_last, off)

        def pad(a):     # (..., T, KV, hd) -> (..., cache_len, KV, hd)
            if cache_len == T:
                return a.contiguous()
            out = a.new_zeros(a.shape[:-3] + (cache_len,) + a.shape[-2:])
            out[..., :T, :, :] = a
            return out

        cache = {"prelude": [(pad(k), pad(v)) for k, v in pre_c],
                 "blocks": (tuple((pad(torch.stack([k for k, _ in blk_c[j]])),
                                   pad(torch.stack([v for _, v in blk_c[j]])))
                                  for j in sorted(blk_c))
                            if blk_c else None)}
        return logits, cache

    def _decode(self, cache, tokens, pos, tables):
        off = DPContext.off()
        x, _ = self._embed_in(self.params, tokens, off)
        for p, addr in self._layers():
            x, _ = self._layer_decode(p, x, self._layer_cache(cache, addr),
                                      pos, tables)
        return self._head(self.params, x, off)[0], cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """One-token decode. tokens: (B, 1); pos: (B,) write positions.
        Writes the cache in place; returns (logits (B,1,Vpad), cache)."""
        return self._decode(cache, tokens, pos, None)

    @torch.no_grad()
    def decode_step_paged(self, cache, tokens, pos, tables):
        """One-token decode through block tables (B, nb), sentinel =
        num_blocks.  Same contract as ``decode_step``; greedy outputs equal
        the contiguous path's."""
        return self._decode(cache, tokens, pos, tables)


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
