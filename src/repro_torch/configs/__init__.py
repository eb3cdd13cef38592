"""Config registry of the port: ``get_arch(id)``, ``list_archs()``,
``reduced(arch)`` for the dense decoder family, the input ``SHAPES`` and the
``--set`` override helpers."""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List

from repro_torch.configs.base import (ATTN, MAMBA, SHAPES, ArchConfig,
                                      ShapeConfig, TrainConfig,
                                      apply_overrides, parse_set_args)
from repro_torch.configs.chatglm3_6b import ARCH as _chatglm3
from repro_torch.configs.phi3_mini_3_8b import ARCH as _phi3
from repro_torch.configs.stablelm_3b import ARCH as _stablelm
from repro_torch.configs.starcoder2_7b import ARCH as _starcoder2

ARCHS: Dict[str, ArchConfig] = {
    a.name: a for a in (_phi3, _stablelm, _starcoder2, _chatglm3)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def reduced(arch: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU tests: same layer pattern and
    feature set (GQA ratio, partial rotary, MLP flavour), small dims.
    Matches ``repro.configs.reduced`` for the dense family."""
    if arch.family != "dense":
        raise NotImplementedError(
            f"{arch.name}: the port covers the dense decoder family only")
    n_layers = len(arch.layer_pattern) if arch.layer_pattern else 2
    n_heads = 4
    ratio = max(arch.n_heads // max(arch.n_kv_heads, 1), 1)
    n_kv = max(n_heads // min(ratio, n_heads), 1)
    return replace(
        arch,
        name=arch.name + "-reduced",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128,
        vocab=256,
    )


__all__ = ["ARCHS", "ATTN", "MAMBA", "SHAPES", "ArchConfig", "ShapeConfig",
           "TrainConfig", "apply_overrides", "get_arch", "list_archs",
           "parse_set_args", "reduced"]
