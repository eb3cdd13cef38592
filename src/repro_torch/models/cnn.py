"""ResNet-style CNN (``ArchConfig`` family ``"cnn"``).  Counterpart of
``repro/models/cnn.py``.

Every parameterised op is a ``conv2d``, ``bias``, ``dense`` or ``tap`` site
(core/sites.py), so the DP core runs it with no CNN-specific code:

    stem conv k x k (in_channels -> stage_channels[0]) + bias
    per stage s: blocks_per_stage x [norm -> conv -> bias -> gelu -> norm ->
      conv -> bias, + skip]; the first block of stage s > 0 has stride 2
      and a 1 x 1 projection on the skip
    head: norm -> global mean pool -> dense -> bias -> (B, n_classes)

Normalisation is per-example channel RMSNorm with a tapped scale, never
BatchNorm, whose batch statistics couple examples.  Each block runs under
the model's remat policy (``layers.remat_wrap``).  The param tree is the
JAX package's (``stem``, ``stages[s][b]``, ``final_norm``, ``head``), so
``interop.params_from_numpy`` carries its params over unchanged.

Batch contract: ``{"images": (B, S, S, C) float, "labels": (B,) int32}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.context import DPContext
from repro_torch.models import layers as L
from repro_torch.models.layers import P
from repro_torch.models.transformer import (ParamModel, abstract_spec,
                                             init_spec, spec_axes)


def _block_spec(k: int, cin: int, cout: int, downsample: bool) -> Dict[str, Any]:
    spec: Dict[str, Any] = {
        "ln1": P((cin,), "ones"), "w1": P((k, k, cin, cout)),
        "b1": P((cout,), "zeros"),
        "ln2": P((cout,), "ones"), "w2": P((k, k, cout, cout)),
        "b2": P((cout,), "zeros"),
    }
    if downsample or cin != cout:
        spec["proj"] = P((1, 1, cin, cout))
    return spec


def model_spec(arch: ArchConfig) -> Dict[str, Any]:
    c = arch.cnn
    k = c.kernel
    spec: Dict[str, Any] = {
        "stem": {"w": P((k, k, c.in_channels, c.stage_channels[0])),
                 "b": P((c.stage_channels[0],), "zeros")},
        "stages": [],
    }
    cin = c.stage_channels[0]
    for s, cout in enumerate(c.stage_channels):
        blocks = []
        for b in range(c.blocks_per_stage):
            blocks.append(_block_spec(k, cin, cout, s > 0 and b == 0))
            cin = cout
        spec["stages"].append(blocks)
    spec["final_norm"] = P((cin,), "ones")
    spec["head"] = {"w": P((cin, arch.n_classes), axes=("embed", "vocab")),
                    "b": P((arch.n_classes,), "zeros")}
    return spec


def iter_conv_sites(arch: ArchConfig, batch: int = 1):
    """``(label, operand_shapes, gy_shape)`` of every conv2d site of the
    model at ``batch`` rows, mirroring ``model_spec`` and ``_forward`` (SAME
    padding; stride 2 and a 1 x 1 projection on the first block of every
    stage after the first)."""
    c = arch.cnn
    s, k = c.image_size, c.kernel
    cin, c0 = c.in_channels, c.stage_channels[0]
    yield "stem", ((batch, s, s, cin), (k, k, cin, c0)), (batch, s, s, c0)
    cin = c0
    for si, cout in enumerate(c.stage_channels):
        for b in range(c.blocks_per_stage):
            down = si > 0 and b == 0
            s_in = s
            if down:
                s = (s + 1) // 2                  # stride 2, SAME padding
            yield (f"s{si}b{b}_w1", ((batch, s_in, s_in, cin), (k, k, cin, cout)),
                   (batch, s, s, cout))
            yield (f"s{si}b{b}_w2", ((batch, s, s, cout), (k, k, cout, cout)),
                   (batch, s, s, cout))
            if down or cin != cout:
                yield (f"s{si}b{b}_proj",
                       ((batch, s_in, s_in, cin), (1, 1, cin, cout)),
                       (batch, s, s, cout))
            cin = cout


def init_params(arch: ArchConfig, seed: int, dtype: torch.dtype,
                device: torch.device):
    return init_spec(model_spec(arch), seed, dtype, device)


def abstract_params(arch: ArchConfig, dtype: torch.dtype = torch.bfloat16):
    """The params as meta tensors (nothing allocated)."""
    return abstract_spec(model_spec(arch), dtype)


def logical_axes(arch: ArchConfig):
    """Logical-axis tuples parallel to ``abstract_params``."""
    return spec_axes(model_spec(arch))


def image_xent(logits, labels):
    """(B, n_classes) logits, (B,) labels -> (B,) float32 cross-entropy."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]


class CNNModel(ParamModel):
    """The CNN of one ``ArchConfig`` of family ``"cnn"`` (the
    ``ParamModel`` contract for params, types, device and remat)."""

    def __init__(self, arch: ArchConfig, params=None, *,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: int = 0, remat: str = "block",
                 param_dtype: Optional[torch.dtype] = None):
        if arch.family != "cnn":
            raise ValueError(f"{arch.name}: family {arch.family!r}, want 'cnn'")
        super().__init__(arch, params, init_params, dtype=dtype, device=device,
                         seed=seed, remat=remat, param_dtype=param_dtype)

    def abstract_params(self):
        return abstract_params(self.arch, self.param_dtype)

    def logical_axes(self):
        return logical_axes(self.arch)

    def _block(self, bp, x, ctx: DPContext, stride: int):
        eps = self.arch.norm_eps
        h, ctx = L.rmsnorm(x, bp["ln1"], ctx, eps)
        h, ctx = ctx.conv2d(h, L.cast(bp["w1"], h), stride=stride)
        h, ctx = ctx.bias(h, bp["b1"])
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
        h, ctx = L.rmsnorm(h, bp["ln2"], ctx, eps)
        h, ctx = ctx.conv2d(h, L.cast(bp["w2"], h), stride=1)
        h, ctx = ctx.bias(h, bp["b2"])
        skip = x
        if "proj" in bp:
            skip, ctx = ctx.conv2d(x, L.cast(bp["proj"], x), stride=stride)
        return skip + h, ctx

    def _block_fn(self, bp, ctx: DPContext, stride: int):
        """One block as ``fn(x, acc, saved=None) -> (x, acc)`` for
        ``layers.remat_wrap``."""
        def block(x, acc, saved=None):
            c = dataclasses.replace(ctx, acc=acc, saved=saved)
            x, c = self._block(bp, x, c, stride)
            return x, c.acc
        return block

    def _forward(self, params, images, ctx: DPContext):
        x = images.to(self.dtype)
        x, ctx = ctx.conv2d(x, L.cast(params["stem"]["w"], x), stride=1)
        x, ctx = ctx.bias(x, params["stem"]["b"])
        for s, blocks in enumerate(params["stages"]):
            for b, bp in enumerate(blocks):
                stride = 2 if (s > 0 and b == 0) else 1
                run = L.remat_wrap(self._block_fn(bp, ctx, stride), self.remat)
                x, acc = run(x, ctx.acc)
                ctx = dataclasses.replace(ctx, acc=acc)
        x, ctx = L.rmsnorm(x, params["final_norm"], ctx, self.arch.norm_eps)
        pooled = x.float().mean(dim=(1, 2)).to(x.dtype)
        logits, ctx = ctx.dense(pooled, L.cast(params["head"]["w"], pooled))
        return ctx.bias(logits, params["head"]["b"])

    def loss_fn(self, params, batch, ctx: DPContext):
        """((B,) per-example cross-entropy, float32; ctx)."""
        logits, ctx = self._forward(params, batch["images"], ctx)
        return image_xent(logits, batch["labels"]), ctx
