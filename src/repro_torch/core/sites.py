"""Pluggable private-site registry.  Counterpart of ``repro/core/sites.py``.

A **site** is a parameterised op whose per-example weight-gradient norm the
DP-SGD(R) side-channel observes, described by one registry entry::

    register_site("dense", fwd=..., bwd=..., nsq_rules={...},
                  kernel_route={...}, fused_bwd={...}, flops={...})

``DPContext.site(kind, *operands)`` (core/context.py) routes through
``SiteCall``, a ``torch.autograd.Function``: its forward is the plain op
and the identity on the ``(B,)`` norm accumulator; its backward adds the
site's per-example squared-grad-norm to the accumulator's gradient and
returns the operand gradients.  An operand that needs no gradient gets
none: pass 1 of DP-SGD(R) runs on detached parameters, so no weight
gradient is computed there (the counterpart of the JAX package's DCE of
the discarded parameter cotangents).  Where one forward serves two
pullbacks (``dpsgd_r1f``), a ``Pull`` switch tells each ``SiteCall``
backward which half to compute.

Contracts every entry satisfies, as in the JAX package: each rule returns
the exact per-example norm² as a (B,) float32 tensor; an all-zero ``gy``
row gives an exactly zero norm²; ``"auto"`` picks the cheapest rule by the
entry's own FLOP formulas and never ``"fused"`` (ties go to the first
registered rule).

Callbacks: ``fwd(spec, *operands) -> y``;
``bwd(spec, operands, gy, needs) -> operand grads``;
``nsq_rules[name](spec, operands, gy) -> (B,)``;
``kernel_route[name]`` the same with kernels (``spec.use_kernels``);
``fused_bwd[name](spec, operands, gy, needs, want_nsq=True) -> (grads,
nsq)`` one joint backward (``nsq`` None when ``want_nsq`` is False);
``flops[name](operand_shapes, gy_shape)``.  ``needs[i]`` says whether
operand i needs a gradient; a grad it does not need may be None.
``save_operands``: the operands the norm rules consume, which
``remat="sites"`` keeps (``name_saved_operands``); ``param_operands``: the
operands that are parameters, whose gradients a ``Pull("norms")`` skips.

Registered here: ``dense``, ``embed``, ``tap``, ``conv2d`` and ``bias``
(the image families, models/cnn.py and models/vit.py) and the
parameter-free ``attention`` site.  ``moe_dense`` is not ported (ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import norms

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """Static per-site-call config.  ``meta`` carries per-call extras
    (``tap``'s ``(nexp, batch)``, ``attention``'s ``(causal,)``,
    ``conv2d``'s ``(stride, padding)``);
    ``augmult`` is the number of views per example (rows B·K, norms (B,))."""
    kind: str
    strategy: str = "auto"
    use_kernels: bool = False
    meta: tuple = ()
    augmult: int = 1


@dataclasses.dataclass(frozen=True)
class SiteDef:
    kind: str
    fwd: Callable
    nsq_rules: Mapping[str, Callable]
    bwd: Callable
    kernel_route: Mapping[str, Callable] = dataclasses.field(default_factory=dict)
    fused_bwd: Mapping[str, Callable] = dataclasses.field(default_factory=dict)
    flops: Mapping[str, Callable] = dataclasses.field(default_factory=dict)
    save_operands: Tuple[int, ...] = ()
    param_operands: Tuple[int, ...] = ()


@dataclasses.dataclass
class Pull:
    """Which half of every ``SiteCall`` backward runs, read when the
    backward runs (``needs_input_grad`` is fixed at the forward).  One
    forward serves two pullbacks in ``dpsgd_r1f``: ``"norms"`` computes the
    norms² and the activation gradients and no parameter gradient;
    ``"grads"`` computes the operand gradients and no norm².  ``"both"``
    (the default, and what no ``Pull`` means) computes both."""
    stage: str = "both"


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def name_saved_operands(site: "SiteDef", operands: tuple, saved) -> None:
    """The counterpart of the JAX package's ``checkpoint_name`` tag: record
    the storage of every operand ``site.save_operands`` names in ``saved``
    (a dict a ``remat="sites"`` region passes down, or None), which keeps
    the saved tensors that live in one of them and recomputes the rest.
    The dict holds the tensors too, so no storage is reused while the
    region runs."""
    if saved is None:
        return
    for i in site.save_operands:
        saved[_storage_key(operands[i])] = operands[i]


def is_saved_operand(t: torch.Tensor, saved) -> bool:
    return saved is not None and _storage_key(t) in saved


_REGISTRY: Dict[str, SiteDef] = {}
_ALIASES = ("auto",)   # strategy names that are never literal rule names


def register_site(kind: str, *, fwd: Callable, bwd: Callable,
                  nsq_rules: Mapping[str, Callable],
                  kernel_route: Optional[Mapping[str, Callable]] = None,
                  fused_bwd: Optional[Mapping[str, Callable]] = None,
                  flops: Optional[Mapping[str, Callable]] = None,
                  save_operands: Tuple[int, ...] = (),
                  param_operands: Tuple[int, ...] = ()) -> SiteDef:
    """Register a site type; returns its ``SiteDef``."""
    if not nsq_rules:
        raise ValueError(f"site {kind!r} needs at least one nsq rule")
    for bad in set(nsq_rules) & set(_ALIASES):
        raise ValueError(f"site {kind!r}: {bad!r} is a reserved strategy name")
    if kind in _REGISTRY:
        raise ValueError(f"site kind {kind!r} already registered (registered "
                         f"kinds: {sorted(_REGISTRY)})")
    site = SiteDef(kind=kind, fwd=fwd, bwd=bwd, nsq_rules=dict(nsq_rules),
                   kernel_route=dict(kernel_route or {}),
                   fused_bwd=dict(fused_bwd or {}), flops=dict(flops or {}),
                   save_operands=tuple(save_operands),
                   param_operands=tuple(param_operands))
    for name, mapping in (("kernel_route", site.kernel_route),
                          ("fused_bwd", site.fused_bwd),
                          ("flops", site.flops)):
        unknown = set(mapping) - set(site.nsq_rules)
        if unknown:
            raise ValueError(f"site {kind!r}: {name} names {sorted(unknown)} "
                             f"have no matching nsq rule "
                             f"{sorted(site.nsq_rules)}")
    _REGISTRY[kind] = site
    return site


def get_site(kind: str) -> SiteDef:
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise KeyError(f"unknown site kind {kind!r}; registered site kinds: "
                       f"{sorted(_REGISTRY)}") from None


def resolve_strategy(kind: str, strategy: str, operand_shapes, gy_shape) -> str:
    """A strategy name resolved to a registered rule of ``kind``: ``"auto"``
    takes the cheapest by the site's ``flops``; a single-rule site ignores
    the name; an unknown name raises."""
    site = get_site(kind)
    rules = site.nsq_rules
    if strategy in rules:
        return strategy
    if len(rules) == 1:
        return next(iter(rules))
    if strategy == "auto":
        best, best_cost = None, None
        for name in rules:             # ties -> first-registered rule
            if name not in site.flops:
                continue
            cost = site.flops[name](operand_shapes, gy_shape)
            if best is None or cost < best_cost:
                best, best_cost = name, cost
        return best if best is not None else next(iter(rules))
    raise ValueError(f"unknown norm strategy {strategy!r} for site {kind!r}; "
                     f"registered strategies: {sorted(rules)} (or 'auto')")


def _shapes(operands):
    return tuple(tuple(getattr(o, "shape", ())) for o in operands)


def site_nsq(spec: SiteSpec, operands, gy) -> torch.Tensor:
    """The site's resolved (kernel-backed when ``use_kernels``) norm rule."""
    site = get_site(spec.kind)
    strat = resolve_strategy(spec.kind, spec.strategy, _shapes(operands),
                             tuple(gy.shape))
    if spec.use_kernels and strat in site.kernel_route:
        return site.kernel_route[strat](spec, operands, gy)
    return site.nsq_rules[strat](spec, operands, gy)


class SiteCall(torch.autograd.Function):
    """``y, acc = SiteCall.apply(spec, pull, acc, *operands)``: the forward
    is the plain op and the identity on ``acc``; the backward returns
    ``gacc + nsq`` for ``acc`` and the operand gradients, or the half of
    them that ``pull`` (a ``Pull`` or None) asks for."""

    @staticmethod
    def forward(ctx, spec, pull, acc, *operands):
        ctx.spec, ctx.pull = spec, pull
        ctx.save_for_backward(*operands)
        return get_site(spec.kind).fwd(spec, *operands), acc.clone()

    @staticmethod
    def backward(ctx, gy, gacc):
        spec = ctx.spec
        stage = ctx.pull.stage if ctx.pull is not None else "both"
        operands = ctx.saved_tensors
        site = get_site(spec.kind)
        needs = list(ctx.needs_input_grad[3:])
        if stage == "norms":
            for i in site.param_operands:
                needs[i] = False
        want_nsq = stage != "grads"
        strat = resolve_strategy(spec.kind, spec.strategy, _shapes(operands),
                                 tuple(gy.shape))
        fused = site.fused_bwd.get(strat)
        if fused is not None:
            grads, nsq = (fused(spec, operands, gy, needs) if want_nsq else
                          fused(spec, operands, gy, needs, want_nsq=False))
        else:
            grads = site.bwd(spec, operands, gy, needs)
            nsq = site_nsq(spec, operands, gy) if want_nsq else None
        if nsq is not None:
            gacc = nsq if gacc is None else gacc + nsq
        grads = tuple(g if n else None for g, n in zip(grads, needs))
        return (None, None, gacc) + grads


def site_call(spec: SiteSpec, pull: Optional[Pull], acc,
              *operands) -> Tuple[torch.Tensor, torch.Tensor]:
    return SiteCall.apply(spec, pull, acc, *operands)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

def _canon4_shape(shape):
    """Shape-level twin of norms.canon4."""
    if len(shape) == 2:
        return (shape[0], 1, 1, shape[1])
    if len(shape) == 3:
        return (shape[0], 1, shape[1], shape[2])
    if len(shape) == 4:
        return tuple(shape)
    raise ValueError(f"dense site operand must be 2/3/4-D, got {shape}")


def _dense_fwd(spec, x, w):
    return torch.matmul(x, w)


def _dense_gx(gy, w, x):
    return torch.matmul(gy, w.t()).to(x.dtype)


def _dense_gw(x, gy, w):
    di, do = w.shape
    return torch.matmul(x.reshape(-1, di).t(), gy.reshape(-1, do)).to(w.dtype)


def _dense_bwd(spec, operands, gy, needs):
    x, w = operands
    return (_dense_gx(gy, w, x) if needs[0] else None,
            _dense_gw(x, gy, w) if needs[1] else None)


def _dense_pair4(spec, operands, gy):
    """Canonical (x4, gy4) with the views folded into the contraction axis."""
    k = spec.augmult
    return (norms.fold_views4(norms.canon4(operands[0]), k),
            norms.fold_views4(norms.canon4(gy), k))


def _dense_rule_materialize(spec, operands, gy):
    return norms.dense_nsq_materialize(*_dense_pair4(spec, operands, gy))


def _dense_rule_gram(spec, operands, gy):
    return norms.dense_nsq_gram(*_dense_pair4(spec, operands, gy))


def _dense_kernel_materialize(spec, operands, gy):
    from repro_torch.kernels import ops as kops
    return kops.pegrad_norm(*_dense_pair4(spec, operands, gy))


def _dense_kernel_gram(spec, operands, gy):
    from repro_torch.kernels import ops as kops
    return kops.gram_norm(*_dense_pair4(spec, operands, gy))


def _dense_fused_bwd(spec, operands, gy, needs, want_nsq=True):
    """The fused strategy: with kernels, ``dense_bwd_norm`` gives the dgrad
    rows and the norm² in one call, and ``dense_dgrad`` the dgrad rows
    alone when no norm² is wanted; without kernels, the plain dgrad and the
    ``materialize`` rule.  The summed weight gradient stays outside the
    kernel, computed only when ``w`` needs it."""
    x, w = operands
    nsq = None
    if spec.use_kernels:
        from repro_torch.kernels import ops as kops
        x4, gy4 = _dense_pair4(spec, operands, gy)
        gx4 = None
        if want_nsq:
            gx4, nsq = kops.dense_bwd_norm(x4, gy4, w)
        elif needs[0]:
            gx4 = kops.dense_dgrad(gy4, w)
        gx = (None if gx4 is None else norms.unfold_views4(
            gx4, spec.augmult).reshape(x.shape).to(x.dtype))
    else:
        gx = _dense_gx(gy, w, x) if needs[0] else None
        if want_nsq:
            nsq = _dense_rule_materialize(spec, operands, gy)
    return (gx, _dense_gw(x, gy, w) if needs[1] else None), nsq


def _dense_flops(rule):
    return lambda shapes, gy_shape: rule(_canon4_shape(shapes[0]),
                                         _canon4_shape(gy_shape))


register_site(
    "dense", fwd=_dense_fwd, bwd=_dense_bwd,
    nsq_rules=dict(materialize=_dense_rule_materialize, gram=_dense_rule_gram,
                   fused=_dense_rule_materialize),
    kernel_route=dict(materialize=_dense_kernel_materialize,
                      gram=_dense_kernel_gram),
    fused_bwd={"fused": _dense_fused_bwd},
    flops=dict(materialize=_dense_flops(norms.flops_materialize),
               gram=_dense_flops(norms.flops_gram),
               fused=_dense_flops(norms.flops_fused)),
    save_operands=(0,), param_operands=(1,))


# ---------------------------------------------------------------------------
# embed
# ---------------------------------------------------------------------------

def _embed_fwd(spec, ids, table):
    return table[ids.long()]


def _embed_bwd(spec, operands, gy, needs):
    ids, table = operands
    if not needs[1]:
        return None, None
    gt = torch.zeros(table.shape, dtype=gy.dtype, device=gy.device)
    gt.index_add_(0, ids.reshape(-1).long(), gy.reshape(-1, table.shape[-1]))
    return None, gt.to(table.dtype)


def _embed_fold(spec, ids, gy):
    """(B·K, T) -> (B, K·T): same-token rows across views combine before
    squaring, which is the K-averaged table gradient."""
    k = spec.augmult
    if k == 1:
        return ids, gy
    B = ids.shape[0] // k
    return ids.reshape(B, -1), gy.reshape(B, -1, gy.shape[-1])


def _embed_rule(spec, operands, gy):
    return norms.embed_nsq(*_embed_fold(spec, operands[0], gy), use_kernels=False)


def _embed_kernel_rule(spec, operands, gy):
    return norms.embed_nsq(*_embed_fold(spec, operands[0], gy), use_kernels=True)


def _embed_flops(operand_shapes, gy_shape):
    b, t, d = gy_shape        # sort + segment sum: O(B·T·d) adds
    return 2 * b * t * d


register_site("embed", fwd=_embed_fwd, bwd=_embed_bwd,
              nsq_rules={"segment_sum": _embed_rule},
              kernel_route={"segment_sum": _embed_kernel_rule},
              flops={"segment_sum": _embed_flops},
              save_operands=(0,), param_operands=(1,))


# ---------------------------------------------------------------------------
# tap: a small parameter broadcast per example, so autograd gives exact
# per-example grads of it
# ---------------------------------------------------------------------------

def _tap_fwd(spec, p):
    nexp, batch = spec.meta
    lead = (1,) * (nexp + 1)
    # repeat, not expand: the output is a tensor of its own, not a view of p
    return p.reshape(lead + tuple(p.shape)).repeat(
        (batch,) + (1,) * (nexp + p.dim()))


def _tap_bwd(spec, operands, gy, needs):
    (p,) = operands
    batch = spec.meta[1]
    return (gy.reshape((batch,) + tuple(p.shape)).sum(dim=0).to(p.dtype)
            if needs[0] else None,)


def _tap_rule(spec, operands, gy):
    (p,) = operands
    batch = spec.meta[1]                 # rows (B·K)
    gpb = gy.reshape((batch,) + tuple(p.shape))
    if spec.augmult > 1:
        gpb = gpb.reshape((batch // spec.augmult, spec.augmult)
                          + tuple(p.shape)).sum(dim=1)
    return norms.tap_nsq(gpb)


def _tap_flops(operand_shapes, gy_shape):
    n = 1
    for s in gy_shape:
        n *= int(s)
    return 2 * n


# tap's only operand is the parameter itself and its rule consumes only gy,
# so the sites remat policy has nothing to save here
register_site("tap", fwd=_tap_fwd, bwd=_tap_bwd,
              nsq_rules={"direct": _tap_rule}, flops={"direct": _tap_flops},
              save_operands=(), param_operands=(0,))


# ---------------------------------------------------------------------------
# conv2d: im2col makes it a dense site over the output positions
# ---------------------------------------------------------------------------
#
# y = conv2d(x, w), x: (B, H, W, Cin), w: (kh, kw, Cin, Cout) (NHWC/HWIO, the
# JAX package's layouts).  The per-example weight gradient is
# patchesᵀ_b · gy_b with patches = im2col(x): (B, P, Cin·kh·kw) over the P
# output positions, so the site is a dense site with T = P,
# d_in = Cin·kh·kw, d_out = Cout, and the dense rules and kernels apply to
# the patch pair.  The patch axis is Cin-major, (Cin, kh, kw), as
# ``jax.lax.conv_general_dilated_patches`` orders it, so the flat weight
# ``_conv_wflat`` gives y = patches · wflat.  Padding follows JAX's
# ``"SAME"`` rule (``_same_pads``), which at stride 2 puts the odd pixel on
# the high side: PyTorch's symmetric ``padding=`` would shift every window.

def _conv_meta(spec):
    stride, padding = spec.meta if spec.meta else (1, "SAME")
    return int(stride), str(padding)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """JAX's SAME padding of one spatial dim: (low, high), out = ceil(in/s)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_pads(spec, x, w):
    """(top, bottom, left, right) padding of ``x`` for the site's meta."""
    s, padding = _conv_meta(spec)
    if padding == "VALID":
        return 0, 0, 0, 0
    if padding != "SAME":
        raise ValueError(f"conv2d padding {padding!r}: want 'SAME' or 'VALID'")
    return _same_pads(x.shape[1], w.shape[0], s) + _same_pads(x.shape[2],
                                                             w.shape[1], s)


def _padded_nchw(spec, x, w):
    """x padded and viewed NCHW (channels-last memory: no copy but the pad)."""
    t, b, l, r = _conv_pads(spec, x, w)
    return F.pad(x.permute(0, 3, 1, 2), (l, r, t, b))


def _conv2d_fwd(spec, x, w):
    s, _ = _conv_meta(spec)
    y = F.conv2d(_padded_nchw(spec, x, w), w.permute(3, 2, 0, 1), stride=s)
    return y.permute(0, 2, 3, 1)


def _conv_patches(spec, x, w):
    """(B, H', W', Cin·kh·kw) im2col patches at ``_conv2d_fwd``'s output
    positions, the feature axis Cin-major: (Cin, kh, kw)."""
    s, _ = _conv_meta(spec)
    kh, kw = w.shape[0], w.shape[1]
    xp = _padded_nchw(spec, x, w).permute(0, 2, 3, 1)      # (B, Hp, Wp, Cin)
    win = xp.unfold(1, kh, s).unfold(2, kw, s)             # (B,H',W',Cin,kh,kw)
    return win.reshape(win.shape[:3] + (-1,))


def _col2im(spec, gpat, x, w):
    """The adjoint of ``_conv_patches``: patch gradients (B, H', W', D) ->
    the input gradient (B, H, W, Cin), overlapping windows summed
    (``F.fold`` is ``F.unfold``'s adjoint, and ``F.unfold`` orders the
    patch axis (Cin, kh, kw) too)."""
    s, _ = _conv_meta(spec)
    t, b, l, r = _conv_pads(spec, x, w)
    B, H, W, _ = x.shape
    cols = gpat.reshape(B, -1, gpat.shape[-1]).transpose(1, 2)
    full = F.fold(cols, (H + t + b, W + l + r), (w.shape[0], w.shape[1]),
                  stride=s)
    return full[:, :, t:t + H, l:l + W].permute(0, 2, 3, 1)


def _conv_wflat(w):
    kh, kw, cin, cout = w.shape
    return w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)


def _conv_gw(pat, gy, w):
    """The summed weight gradient from the patch pair, in w's layout."""
    kh, kw, cin, cout = w.shape
    gwf = torch.matmul(pat.reshape(-1, pat.shape[-1]).t(),
                       gy.reshape(-1, cout))
    return gwf.reshape(cin, kh, kw, cout).permute(1, 2, 0, 3).to(w.dtype)


def _conv_bwd(spec, operands, gy, needs):
    x, w = operands
    s, _ = _conv_meta(spec)
    xp = _padded_nchw(spec, x, w)
    wn = w.permute(3, 2, 0, 1)
    gyn = gy.permute(0, 3, 1, 2)
    gx = gw = None
    if needs[0]:
        t, _, l, _ = _conv_pads(spec, x, w)
        gxp = torch.nn.grad.conv2d_input(xp.shape, wn, gyn, stride=s)
        gx = gxp[:, :, t:t + x.shape[1], l:l + x.shape[2]].permute(
            0, 2, 3, 1).to(x.dtype)
    if needs[1]:
        gw = torch.nn.grad.conv2d_weight(xp, wn.shape, gyn, stride=s).permute(
            2, 3, 1, 0).to(w.dtype)
    return gx, gw


def _conv_pair4(spec, operands, gy):
    """The folded patch pair (B, 1, K·P, d_in), (B, 1, K·P, d_out): rows
    are b-major / k-minor and G == 1, so folding the K views into the
    position axis is a plain reshape."""
    x, w = operands
    pat = _conv_patches(spec, x, w)
    B = x.shape[0] // spec.augmult
    return (pat.reshape(B, 1, -1, pat.shape[-1]),
            gy.reshape(B, 1, -1, gy.shape[-1]))


def _conv_rule_materialize(spec, operands, gy):
    return norms.dense_nsq_materialize(*_conv_pair4(spec, operands, gy))


def _conv_rule_gram(spec, operands, gy):
    return norms.dense_nsq_gram(*_conv_pair4(spec, operands, gy))


def _conv_kernel_materialize(spec, operands, gy):
    from repro_torch.kernels import ops as kops
    return kops.pegrad_norm(*_conv_pair4(spec, operands, gy))


def _conv_kernel_gram(spec, operands, gy):
    from repro_torch.kernels import ops as kops
    return kops.gram_norm(*_conv_pair4(spec, operands, gy))


def _conv_fused_bwd(spec, operands, gy, needs, want_nsq=True):
    """The fused strategy: with kernels, ``dense_bwd_norm`` on the folded
    patch pair gives the patch gradient and the norm² in one call
    (``dense_dgrad`` the patch gradient alone when no norm² is wanted),
    then col2im gives the input gradient; without kernels, the plain
    backward and the ``materialize`` rule."""
    x, w = operands
    if not spec.use_kernels:
        nsq = _conv_rule_materialize(spec, operands, gy) if want_nsq else None
        return _conv_bwd(spec, operands, gy, needs), nsq
    from repro_torch.kernels import ops as kops
    pat4, gy4 = _conv_pair4(spec, operands, gy)
    nsq = gpat4 = None
    if want_nsq:
        gpat4, nsq = kops.dense_bwd_norm(pat4, gy4, _conv_wflat(w))
    elif needs[0]:
        gpat4 = kops.dense_dgrad(gy4, _conv_wflat(w))
    gx = (None if gpat4 is None or not needs[0] else
          _col2im(spec, gpat4.to(pat4.dtype), x, w).to(x.dtype))
    gw = _conv_gw(pat4, gy4, w) if needs[1] else None
    return (gx, gw), nsq


def conv_norm_dims(operand_shapes, gy_shape):
    """(B, P, d_in, d_out) of the conv site's dense problem."""
    x_shape, w_shape = operand_shapes[0], operand_shapes[1]
    p = 1
    for s in gy_shape[1:-1]:
        p *= int(s)
    d_in = int(w_shape[0]) * int(w_shape[1]) * int(w_shape[2])
    return int(x_shape[0]), p, d_in, int(gy_shape[-1])


def _conv_flops(rule):
    def flops(operand_shapes, gy_shape):
        b, p, d_in, d_out = conv_norm_dims(operand_shapes, gy_shape)
        return rule((b, 1, p, d_in), (b, 1, p, d_out))
    return flops


register_site(
    "conv2d", fwd=_conv2d_fwd, bwd=_conv_bwd,
    nsq_rules=dict(materialize=_conv_rule_materialize, gram=_conv_rule_gram,
                   fused=_conv_rule_materialize),
    kernel_route=dict(materialize=_conv_kernel_materialize,
                      gram=_conv_kernel_gram),
    fused_bwd={"fused": _conv_fused_bwd},
    flops=dict(materialize=_conv_flops(norms.flops_materialize),
               gram=_conv_flops(norms.flops_gram),
               fused=_conv_flops(norms.flops_fused)),
    save_operands=(0,), param_operands=(1,))


# ---------------------------------------------------------------------------
# bias: y = x + b, b broadcast over every non-channel dim
# ---------------------------------------------------------------------------

def _bias_fwd(spec, x, b):
    return x + b.to(x.dtype)


def _bias_bwd(spec, operands, gy, needs):
    x, b = operands
    gb = (gy.sum(dim=tuple(range(gy.dim() - 1))).to(b.dtype)
          if needs[1] else None)
    return (gy.to(x.dtype) if needs[0] else None), gb


def _bias_rule(spec, operands, gy):
    if spec.augmult > 1:
        # the K views fold into the summed position axis: the per-example
        # bias gradient is the sum over views and positions of the
        # 1/K-scaled gy
        gy = gy.reshape((gy.shape[0] // spec.augmult, -1, gy.shape[-1]))
    return norms.bias_nsq(gy)


def _bias_flops(operand_shapes, gy_shape):
    n = 1
    for s in gy_shape:
        n *= int(s)
    return 2 * n


# the bias rule consumes only gy: nothing for the sites remat policy to save
register_site("bias", fwd=_bias_fwd, bwd=_bias_bwd,
              nsq_rules={"direct": _bias_rule}, flops={"direct": _bias_flops},
              save_operands=(), param_operands=(1,))


# ---------------------------------------------------------------------------
# attention: parameter-free site carrying the flash backward kernels
# ---------------------------------------------------------------------------
#
# Attention owns no parameters, so its norm² is exactly zero.  What the site
# buys is dataflow: under norm_strategy="fused" the layers route attention
# through it, and with use_kernels its backward is the flash backward pair
# (kernels/flash_attn.py), recomputing the probability tiles from the row
# logsumexp.  Without kernels the backward is autograd of the plain
# attention.  Layouts: q (B, T, KV, rep, hd); k/v (B, S, KV, hd);
# meta = (causal,).

def _attn_causal(spec) -> bool:
    return bool(spec.meta[0]) if spec.meta else True


def _attention_fwd(spec, q, k, v):
    from repro_torch.kernels import ops as kops
    return kops.flash_attention(q, k, v, _attn_causal(spec))


def _attention_bwd(spec, operands, gy, needs):
    from repro_torch.kernels import ref
    with torch.enable_grad():
        leaves = [o.detach().requires_grad_(True) for o in operands]
        out = ref.flash_attn_ref(*leaves, _attn_causal(spec))
        return torch.autograd.grad(out, leaves, gy)


def _attention_rule(spec, operands, gy):
    return torch.zeros((operands[0].shape[0] // spec.augmult,), dtype=F32,
                       device=gy.device)


def _attention_fused_bwd(spec, operands, gy, needs, want_nsq=True):
    q, k, v = operands
    nsq = _attention_rule(spec, operands, gy) if want_nsq else None
    if spec.use_kernels:
        from repro_torch.kernels import ops as kops
        dq, dk, dv = kops.flash_attention_bwd(q, k, v, gy, _attn_causal(spec))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)), nsq
    return _attention_bwd(spec, operands, gy, needs), nsq


# the rule consumes nothing (norm² ≡ 0): nothing for the sites remat policy
# to save, and no parameter
register_site("attention", fwd=_attention_fwd, bwd=_attention_bwd,
              nsq_rules={"fused": _attention_rule},
              fused_bwd={"fused": _attention_fused_bwd},
              flops={"fused": lambda shapes, gy_shape: 0.0},
              save_operands=(), param_operands=())
