"""DPContext: the norm side-channel of DP-SGD(R)'s first pass.  Counterpart
of ``repro/core/context.py``.

A ``(B,)`` float32 accumulator is threaded through every parameterised
site of the model.  In ``norm`` mode each site is a ``sites.SiteCall``
whose forward is the plain op (identity on the accumulator) and whose
backward adds the site's per-example squared-grad-norm to the
accumulator's gradient; backpropagating ``(Σ Lᵢ, acc_out)`` with gradients
``(1, 0)`` therefore leaves the per-example norms² in the gradient of the
initial accumulator, without a per-example gradient ever being formed.

In ``off`` mode every method is the plain op, so the same model code serves
SGD, DP-SGD(R)'s second pass and inference.

Every operand a site's norm rules consume (``save_operands``) is recorded
in ``saved`` in both modes, when a ``remat="sites"`` region passes one
down (``models/layers.py``): pass 1 (norm rules) and pass 2 (weight
gradients) both need those residuals, so the region keeps exactly them
and recomputes the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import sites
from repro_torch.core.sites import SiteSpec
from repro_torch.dist import runtime

__all__ = ["DPContext", "SiteSpec"]


@dataclasses.dataclass(frozen=True)
class DPContext:
    """``mode``: "off" (plain ops) or "norm" (the per-example norm pass).
    ``strategy`` names a norm rule resolved per site against the registry;
    ``use_kernels`` takes the sites' kernel routes; ``augmult`` is the
    number of views per example (rows B·K, accumulator (B,)).  ``pull``:
    a ``sites.Pull`` the sites' backwards read (None: both halves);
    ``saved``: the site-operand record of an enclosing ``remat="sites"``
    region (None outside one)."""
    acc: Optional[torch.Tensor] = None
    mode: str = "off"
    strategy: str = "auto"
    use_kernels: bool = False
    augmult: int = 1
    pull: Optional[sites.Pull] = None
    saved: Optional[dict] = None

    @staticmethod
    def off() -> "DPContext":
        return DPContext()

    @staticmethod
    def norm_mode(batch: int, strategy: str = "auto", use_kernels: bool = False,
                  augmult: int = 1, device=None,
                  pull: Optional[sites.Pull] = None) -> "DPContext":
        """A fresh accumulator of ``batch`` examples that requires grad."""
        acc = torch.zeros((batch,), dtype=torch.float32, device=device,
                          requires_grad=True)
        return DPContext(acc=acc, mode="norm", strategy=strategy,
                         use_kernels=use_kernels, augmult=augmult, pull=pull)

    def site(self, kind: str, *operands, meta: tuple = (),
             counted: bool = True) -> Tuple[torch.Tensor, "DPContext"]:
        """Run registered site ``kind`` on ``operands``: the plain op in
        ``off`` mode, ``sites.SiteCall`` in ``norm`` mode; ``counted`` as
        ``SiteSpec`` takes it."""
        spec = SiteSpec(kind=kind, strategy=self.strategy,
                        use_kernels=self.use_kernels, meta=tuple(meta),
                        augmult=self.augmult, counted=counted)
        site = sites.get_site(kind)        # raises with registered kinds
        sites.name_saved_operands(site, operands, self.saved)
        if self.mode == "off":
            return site.fwd(spec, *operands), self
        y, acc = sites.site_call(spec, self.pull, self.acc, *operands)
        return y, dataclasses.replace(self, acc=acc)

    def dense(self, x, w):
        """y = x @ w, w: (d_in, d_out), x: (..., d_in) with batch dim 0."""
        return self.site("dense", x, w)

    def moe_dense(self, x, w):
        """Per-expert dense: y[b, e] = x[b, e] @ w[e]; x: (B, E, C, d_in)
        dispatch buffers, w: (E, d_in, d_out)."""
        return self.site("moe_dense", x, w)

    def embed(self, ids, table):
        return self.site("embed", ids, table)

    def tap(self, p, nexp: int, batch: int):
        """Tap a small param: in norm mode (B, 1*nexp, *p.shape) so that
        broadcasting gives exact per-example grads; in off mode p itself.
        A tapped param is whole on every model rank of a tensor-parallel
        layout, and only the first adds its norm²
        (``dist.runtime.counts_replicated``)."""
        if self.mode == "off":
            return p, self
        return self.site("tap", p, meta=(nexp, batch),
                         counted=runtime.counts_replicated())

    def conv2d(self, x, w, stride: int = 1, padding: str = "SAME"):
        """y = conv2d(x, w) in NHWC/HWIO layout with JAX's padding rule;
        x: (B, H, W, Cin), w: (kh, kw, Cin, Cout)."""
        return self.site("conv2d", x, w, meta=(int(stride), str(padding)))

    def bias(self, x, b):
        """y = x + b, b: (d,) broadcast over every leading dim of x."""
        return self.site("bias", x, b)

    def attention(self, q, k, v, causal: bool = True):
        """Attention as a registered site: parameter-free (norm² exactly
        zero), carrying the flash backward route of norm_strategy="fused".
        q: (B,T,KV,rep,hd); k/v: (B,S,KV,hd)."""
        return self.site("attention", q, k, v, meta=(bool(causal),))
