"""Architecture config: the port's own copy of ``repro.configs.base``'s
``ArchConfig``, limited to the fields the serving path reads (and the MoE
layer placement, so a layer pattern reads the same as there)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

# Layer kinds used in ``layer_pattern``.
ATTN = "attn"
MAMBA = "mamba"


@dataclass(frozen=True)
class MoEConfig:
    """Which layers are MoE (the port raises on them; see transformer.py)."""
    num_experts: int = 0            # routed experts (0 = dense FFN)
    moe_period: int = 1
    moe_offset: int = 0
    moe_skip_first: int = 0         # first N layers stay dense
    d_ff_dense: int = 0             # dense-FFN width for non-MoE layers (0 -> d_ff)

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str             # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0         # partial rotary (stablelm 0.25, chatglm 0.5)
    qk_norm: bool = False
    mlp_act: str = "swiglu"         # swiglu | gelu
    layer_pattern: Optional[Tuple[str, ...]] = None
    moe: MoEConfig = field(default_factory=MoEConfig)
    embed_stub: bool = False
    norm_eps: float = 1e-5
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern is not None:
            per = self.layer_pattern
            if self.n_layers % len(per):
                raise ValueError(f"{self.name}: {self.n_layers} layers do "
                                 f"not tile the {len(per)}-layer pattern")
            return per * (self.n_layers // len(per))
        if self.family == "ssm":
            return (MAMBA,) * self.n_layers
        return (ATTN,) * self.n_layers

    def is_moe_layer(self, i: int) -> bool:
        m = self.moe
        return (m.enabled and i >= m.moe_skip_first
                and (i % m.moe_period == m.moe_offset))

    def ff_dense(self) -> int:
        return self.moe.d_ff_dense or self.d_ff
