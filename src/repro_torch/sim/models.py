"""Per-layer GEMM shape tables for the paper's benchmark models (paper §V:
VGG, ResNet-50/152, SqueezeNet, MobileNet on CIFAR-10-scale 32x32 inputs;
BERT-base/large and LSTM-small/large at sequence length 32).

GEMM mapping follows paper Fig. 6:
  MLP/attention (time-series):  fwd (B·L, I, O); per-batch wgrad (I, B·L, O);
                                per-example wgrad = B GEMMs of (I, L, O)
  conv (im2col):  fwd (B·P·Q, Cin·R·S, Cout); per-batch (Cin·R·S, B·P·Q,
                  Cout); per-example = B GEMMs of (Cin·R·S, P·Q, Cout)

Layer lists are the standard published architectures; CIFAR-10 spatial
dims halve at the usual stage boundaries.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class LayerGEMMs:
    """One weight-bearing layer, parameterized per paper Fig. 6."""
    i: int          # I (or Cin*R*S)
    o: int          # O (or Cout)
    t: int          # L (or P*Q): per-example contraction length
    w_elems: int = 0  # override for grouped/depthwise layers

    def fwd(self, batch: int) -> Tuple[int, int, int]:
        return (batch * self.t, self.i, self.o)

    def dgrad(self, batch: int) -> Tuple[int, int, int]:
        return (batch * self.t, self.o, self.i)

    def wgrad_batch(self, batch: int) -> Tuple[int, int, int]:
        return (self.i, batch * self.t, self.o)

    def wgrad_example(self) -> Tuple[int, int, int]:
        return (self.i, self.t, self.o)

    def weight_elems(self) -> int:
        return self.w_elems or self.i * self.o


def conv(cin: int, cout: int, rs: int, pq: int) -> LayerGEMMs:
    return LayerGEMMs(i=cin * rs, o=cout, t=pq)


def dense(i: int, o: int, t: int = 1) -> LayerGEMMs:
    return LayerGEMMs(i=i, o=o, t=t)


# ---------------------------------------------------------------------------
# CNNs (CIFAR-10: 32x32 input)
# ---------------------------------------------------------------------------

def vgg16() -> List[LayerGEMMs]:
    cfg = [(3, 64, 32), (64, 64, 32), (64, 128, 16), (128, 128, 16),
           (128, 256, 8), (256, 256, 8), (256, 256, 8),
           (256, 512, 4), (512, 512, 4), (512, 512, 4),
           (512, 512, 2), (512, 512, 2), (512, 512, 2)]
    layers = [conv(ci, co, 9, s * s) for ci, co, s in cfg]
    layers += [dense(512, 4096), dense(4096, 4096), dense(4096, 10)]
    return layers


def _bottleneck(cin, mid, cout, s) -> List[LayerGEMMs]:
    return [conv(cin, mid, 1, s * s), conv(mid, mid, 9, s * s),
            conv(mid, cout, 1, s * s)]


def resnet(depths: List[int]) -> List[LayerGEMMs]:
    layers = [conv(3, 64, 9, 32 * 32)]
    spatial = [32, 16, 8, 4]
    chans = [(64, 64, 256), (256, 128, 512), (512, 256, 1024),
             (1024, 512, 2048)]
    for stage, (n, s, (cin, mid, cout)) in enumerate(
            zip(depths, spatial, chans)):
        for b in range(n):
            ci = cin if b == 0 else cout
            layers += _bottleneck(ci, mid, cout, s)
        layers += [conv(cin, cout, 1, s * s)]      # projection shortcut
    layers += [dense(2048, 10)]
    return layers


def resnet50() -> List[LayerGEMMs]:
    return resnet([3, 4, 6, 3])


def resnet152() -> List[LayerGEMMs]:
    return resnet([3, 8, 36, 3])


def squeezenet() -> List[LayerGEMMs]:
    layers = [conv(3, 96, 49, 16 * 16)]
    fire = [(96, 16, 64), (128, 16, 64), (128, 32, 128),
            (256, 32, 128), (256, 48, 192), (384, 48, 192),
            (384, 64, 256), (512, 64, 256)]
    spatial = [16, 16, 8, 8, 8, 4, 4, 4]
    for (cin, sq, ex), s in zip(fire, spatial):
        layers += [conv(cin, sq, 1, s * s), conv(sq, ex, 1, s * s),
                   conv(sq, ex, 9, s * s)]
    layers += [conv(512, 10, 1, 4 * 4)]
    return layers


def mobilenet() -> List[LayerGEMMs]:
    layers = [conv(3, 32, 9, 16 * 16)]
    cfg = [(32, 64, 16), (64, 128, 8), (128, 128, 8), (128, 256, 4),
           (256, 256, 4), (256, 512, 2), (512, 512, 2), (512, 512, 2),
           (512, 512, 2), (512, 512, 2), (512, 512, 2), (512, 1024, 1),
           (1024, 1024, 1)]
    for cin, cout, s in cfg:
        # depthwise 3x3: cin independent (9, s^2, 1) GEMMs — modeled as one
        # grouped GEMM with K=9 (the pathological small-K shape)
        layers += [LayerGEMMs(i=9, o=1, t=s * s * cin, w_elems=9 * cin)]
        layers += [conv(cin, cout, 1, max(s * s, 1))]    # pointwise 1x1
    layers += [dense(1024, 10)]
    return layers


# ---------------------------------------------------------------------------
# Transformers / RNNs (paper baseline: sequence length 32)
# ---------------------------------------------------------------------------

def bert(n_layers: int, d: int, ff: int, seq: int = 32) -> List[LayerGEMMs]:
    out = []
    for _ in range(n_layers):
        out += [dense(d, 3 * d, seq), dense(d, d, seq),
                dense(d, ff, seq), dense(ff, d, seq)]
    return out


def bert_base(seq: int = 32) -> List[LayerGEMMs]:
    return bert(12, 768, 3072, seq)


def bert_large(seq: int = 32) -> List[LayerGEMMs]:
    return bert(24, 1024, 4096, seq)


def lstm(n_layers: int, d_in: int, d_h: int, seq: int = 32) -> List[LayerGEMMs]:
    out = []
    for i in range(n_layers):
        din = d_in if i == 0 else d_h
        out += [dense(din, 4 * d_h, seq), dense(d_h, 4 * d_h, seq)]
    out += [dense(d_h, 128, 1)]
    return out


def lstm_small(seq: int = 32) -> List[LayerGEMMs]:
    return lstm(1, 128, 256, seq)


def lstm_large(seq: int = 32) -> List[LayerGEMMs]:
    return lstm(2, 512, 1024, seq)


# ---------------------------------------------------------------------------
# ArchConfig adapter: per-layer GEMM tables for the repo's own presets
# ---------------------------------------------------------------------------

def layers_for_arch(arch, seq_len: int) -> List[LayerGEMMs]:
    """LayerGEMMs table for a ``repro.configs`` ArchConfig — the adapter
    that lets ``dp_training_time`` price the repo's presets with the same
    Fig. 6 GEMM mapping as the paper models above.  Weight-bearing GEMMs
    only (attention score/value products carry no weights); MoE layers
    count the active (top_k + shared) expert paths per token.
    """
    layers: List[LayerGEMMs] = []
    if arch.family == "cnn":
        from repro_torch.models.cnn import iter_conv_sites
        for _, op_shapes, gy_shape in iter_conv_sites(arch, batch=1):
            w = op_shapes[1]                  # (kh, kw, cin, cout)
            layers.append(conv(w[2], w[3], w[0] * w[1],
                               gy_shape[1] * gy_shape[2]))
        layers.append(dense(arch.cnn.stage_channels[-1], arch.n_classes))
        return layers
    d = arch.d_model
    if arch.family == "vit":
        v = arch.vit
        t = v.n_patches
        layers.append(conv(v.in_channels, d, v.patch_size * v.patch_size, t))
        for _ in range(arch.n_layers):
            layers += _attn_layers(arch, t) + _ffn_layers(arch, t,
                                                          arch.d_ff)
        layers.append(dense(d, arch.n_classes))
        return layers
    t = seq_len
    for i, kind in enumerate(arch.pattern()):
        if kind == "mamba":
            di = arch.mamba.d_inner(d)
            layers.append(dense(d, 2 * di, t))       # in-proj (x + z)
            layers.append(dense(di, d, t))           # out-proj
        else:
            layers += _attn_layers(arch, t)
        if arch.d_ff > 0:                 # FFN rides every layer kind
            if arch.is_moe_layer(i):
                m = arch.moe
                n_mats = 3 if arch.mlp_act == "swiglu" else 2
                active = m.top_k
                for _ in range(n_mats - 1):
                    layers.append(dense(d, m.d_expert, t * active))
                layers.append(dense(m.d_expert, d, t * active))
                if m.d_shared:
                    for _ in range(n_mats - 1):
                        layers.append(dense(d, m.d_shared, t))
                    layers.append(dense(m.d_shared, d, t))
            else:
                layers += _ffn_layers(arch, t, arch.ff_dense())
    # a tied embedding (mamba2-1.3b's) prices no head GEMM here, though the
    # decoder keeps its own head as the JAX transformer does
    if not arch.tie_embeddings and not arch.embed_stub:
        layers.append(dense(d, arch.vocab, t))       # LM head
    return layers


def _attn_layers(arch, t: int) -> List[LayerGEMMs]:
    if not arch.n_heads:
        return []
    d, hd = arch.d_model, arch.hd
    qkv = (arch.n_heads + 2 * arch.n_kv_heads) * hd
    return [dense(d, qkv, t), dense(arch.n_heads * hd, d, t)]


def _ffn_layers(arch, t: int, ff: int) -> List[LayerGEMMs]:
    d = arch.d_model
    n_up = 2 if arch.mlp_act == "swiglu" else 1
    return [dense(d, ff, t) for _ in range(n_up)] + [dense(ff, d, t)]


# max practical DP-SGD mini-batch per paper §III-A discussion
MODELS = {
    "vgg16": (vgg16, 32),
    "resnet50": (resnet50, 32),
    "resnet152": (resnet152, 32),
    "squeezenet": (squeezenet, 64),
    "mobilenet": (mobilenet, 64),
    "bert-base": (bert_base, 8),
    "bert-large": (bert_large, 8),
    "lstm-small": (lstm_small, 64),
    "lstm-large": (lstm_large, 32),
}
