"""Config registry of the port: ``get_arch(id)``, ``list_archs()``,
``reduced(arch)`` for the dense decoder and the two image families, the
input ``SHAPES`` and the ``--set`` override helpers."""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List

from repro_torch.configs.base import (ATTN, IMAGE_FAMILIES, MAMBA, SHAPES,
                                      ArchConfig, ShapeConfig, TrainConfig,
                                      apply_overrides, parse_set_args,
                                      shape_applicable)
from repro_torch.configs.chatglm3_6b import ARCH as _chatglm3
from repro_torch.configs.cnn_cifar10 import ARCH as _cnn_cifar10
from repro_torch.configs.phi3_mini_3_8b import ARCH as _phi3
from repro_torch.configs.stablelm_3b import ARCH as _stablelm
from repro_torch.configs.starcoder2_7b import ARCH as _starcoder2
from repro_torch.configs.vit_cifar10 import ARCH as _vit_cifar10

ARCHS: Dict[str, ArchConfig] = {
    a.name: a for a in (_phi3, _stablelm, _starcoder2, _chatglm3,
                        _cnn_cifar10, _vit_cifar10)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def reduced(arch: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU tests: same layer pattern and
    feature set (GQA ratio, partial rotary, MLP flavour), small dims; the
    CNN keeps its stage structure at small channel counts and image size.
    Matches ``repro.configs.reduced`` for the families the port runs."""
    if arch.family == "cnn":
        return replace(
            arch, name=arch.name + "-reduced",
            cnn=replace(arch.cnn, image_size=8, blocks_per_stage=1,
                        stage_channels=tuple(
                            8 * (i + 1) for i in
                            range(min(len(arch.cnn.stage_channels), 2)))))
    if arch.family == "vit":
        return replace(
            arch, name=arch.name + "-reduced", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
            vit=replace(arch.vit, image_size=8, patch_size=2))
    if arch.family != "dense":
        raise NotImplementedError(
            f"{arch.name}: the {arch.family} family is not ported yet "
            f"(ROADMAP queue 1)")
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


__all__ = ["ARCHS", "ATTN", "IMAGE_FAMILIES", "MAMBA", "SHAPES", "ArchConfig",
           "ShapeConfig", "TrainConfig", "apply_overrides", "get_arch",
           "list_archs", "parse_set_args", "reduced", "shape_applicable"]
