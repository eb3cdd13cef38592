"""Vision transformer (``ArchConfig`` family ``"vit"``).  Counterpart of
``repro/models/vit.py``.

    patch embed: conv p x p, stride p (C -> d_model) + bias   [conv2d site]
    + learned position embedding (n_patches, d_model)         [tap site]
    per layer: x + attn(norm(x)); x + mlp(norm(x))            [dense sites]
    head: norm -> mean pool over patches -> dense -> bias     [dense site]

Attention is bidirectional (no causal mask, no rotary: positions come from
the embedding): under the fused norm pass it is the ``attention`` site,
non-causal, whose backward is the flash backward pair; elsewhere
``ops.flash_attention`` non-causal.  Normalisation is per-example RMSNorm
with tapped scales.  Each block runs under the model's remat policy.  The
param tree is the JAX package's (``patch``, ``pos``, ``blocks``,
``final_norm``, ``head``).

Batch contract: ``{"images": (B, S, S, C) float, "labels": (B,) int32}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.context import DPContext
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.cnn import image_xent
from repro_torch.models.layers import P
from repro_torch.models.transformer import ParamModel, init_spec


def model_spec(arch: ArchConfig) -> Dict[str, Any]:
    v, d, p = arch.vit, arch.d_model, arch.vit.patch_size
    block = {"ln1": P((d,), "ones"), "attn": L.attn_spec(arch),
             "ln2": P((d,), "ones"), "mlp": L.mlp_spec(arch, arch.d_ff)}
    return {
        "patch": {"w": P((p, p, v.in_channels, d)), "b": P((d,), "zeros")},
        # zero-init (the patch embedding breaks the symmetry); a tap site
        "pos": P((v.n_patches, d), "zeros"),
        "blocks": [dict(block) for _ in range(arch.n_layers)],
        "final_norm": P((d,), "ones"),
        "head": {"w": P((d, arch.n_classes)), "b": P((arch.n_classes,), "zeros")},
    }


def init_params(arch: ArchConfig, seed: int, dtype: torch.dtype,
                device: torch.device):
    return init_spec(model_spec(arch), seed, dtype, device)


class ViTModel(ParamModel):
    """The ViT of one ``ArchConfig`` of family ``"vit"`` (the
    ``ParamModel`` contract for params, types, device and remat)."""

    def __init__(self, arch: ArchConfig, params=None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: int = 0, remat: str = "block",
                 param_dtype: Optional[torch.dtype] = None):
        if arch.family != "vit":
            raise ValueError(f"{arch.name}: family {arch.family!r}, want 'vit'")
        super().__init__(arch, params, init_params, dtype=dtype, device=device,
                         seed=seed, remat=remat, param_dtype=param_dtype)

    def _attn(self, p, x, ctx: DPContext):
        arch = self.arch
        B, T, _ = x.shape
        H, KV, hd = arch.n_heads, arch.n_kv_heads, arch.hd
        q, ctx = ctx.dense(x, L.cast(p["wq"], x))
        k, ctx = ctx.dense(x, L.cast(p["wk"], x))
        v, ctx = ctx.dense(x, L.cast(p["wv"], x))
        q = q.reshape(B, T, H, hd)
        k = k.reshape(B, T, KV, hd)
        v = v.reshape(B, T, KV, hd)
        if arch.qk_norm:
            q, ctx = L.rmsnorm(q, p["q_norm"], ctx, arch.norm_eps)
            k, ctx = L.rmsnorm(k, p["k_norm"], ctx, arch.norm_eps)
        qg = q.reshape(B, T, KV, H // KV, hd)
        if ctx.mode == "norm" and ctx.strategy == "fused":
            o, ctx = ctx.attention(qg, k, v, causal=False)
        else:
            o = kops.flash_attention(qg, k, v, False)
        o = o.reshape(B, T, H * hd)
        return ctx.dense(o, L.cast(p["wo"], o))

    def _block_fn(self, bp, ctx: DPContext):
        """One block as ``fn(x, acc, saved=None) -> (x, acc)`` for
        ``layers.remat_wrap``."""
        def block(x, acc, saved=None):
            c = dataclasses.replace(ctx, acc=acc, saved=saved)
            h, c = L.rmsnorm(x, bp["ln1"], c, self.arch.norm_eps)
            h, c = self._attn(bp["attn"], h, c)
            x = x + h
            h, c = L.rmsnorm(x, bp["ln2"], c, self.arch.norm_eps)
            h, c = L.mlp_apply(bp["mlp"], h, c, self.arch)
            return x + h, c.acc
        return block

    def _forward(self, params, images, ctx: DPContext):
        v = self.arch.vit
        x = images.to(self.dtype)
        # stride = kernel = patch size divides the image: SAME pads nothing
        x, ctx = ctx.conv2d(x, L.cast(params["patch"]["w"], x),
                            stride=v.patch_size)
        x, ctx = ctx.bias(x, params["patch"]["b"])
        B = x.shape[0]
        x = x.reshape(B, v.n_patches, self.arch.d_model)
        pos, ctx = ctx.tap(params["pos"], 0, B)
        x = x + pos.to(x.dtype)
        for bp in params["blocks"]:
            run = L.remat_wrap(self._block_fn(bp, ctx), self.remat)
            x, acc = run(x, ctx.acc)
            ctx = dataclasses.replace(ctx, acc=acc)
        x, ctx = L.rmsnorm(x, params["final_norm"], ctx, self.arch.norm_eps)
        pooled = x.float().mean(dim=1).to(x.dtype)
        logits, ctx = ctx.dense(pooled, L.cast(params["head"]["w"], pooled))
        return ctx.bias(logits, params["head"]["b"])

    def loss_fn(self, params, batch, ctx: DPContext):
        """((B,) per-example cross-entropy, float32; ctx)."""
        logits, ctx = self._forward(params, batch["images"], ctx)
        return image_xent(logits, batch["labels"]), ctx
