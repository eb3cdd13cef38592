"""Config registry of the port: ``get_arch(id)``, ``list_archs()``,
``reduced(arch)`` for every family (the decoders, the embedding-input
audio and VLM backbones and the two image families), the input ``SHAPES``
and the ``--set`` override helpers."""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List

from repro_torch.configs.base import (ATTN, IMAGE_FAMILIES, MAMBA, SHAPES,
                                      ArchConfig, MambaConfig, MemConfig,
                                      MeshConfig,
                                      ShapeConfig, TrainConfig,
                                      apply_overrides, parse_set_args,
                                      shape_applicable)
from repro_torch.configs.chameleon_34b import ARCH as _chameleon
from repro_torch.configs.chatglm3_6b import ARCH as _chatglm3
from repro_torch.configs.cnn_cifar10 import ARCH as _cnn_cifar10
from repro_torch.configs.deepseek_moe_16b import ARCH as _dsmoe
from repro_torch.configs.grok_1_314b import ARCH as _grok1
from repro_torch.configs.jamba_1_5_large_398b import ARCH as _jamba
from repro_torch.configs.mamba2_1_3b import ARCH as _mamba2
from repro_torch.configs.musicgen_medium import ARCH as _musicgen
from repro_torch.configs.phi3_mini_3_8b import ARCH as _phi3
from repro_torch.configs.stablelm_3b import ARCH as _stablelm
from repro_torch.configs.starcoder2_7b import ARCH as _starcoder2
from repro_torch.configs.vit_cifar10 import ARCH as _vit_cifar10

ARCHS: Dict[str, ArchConfig] = {
    a.name: a for a in (_phi3, _stablelm, _starcoder2, _chatglm3, _musicgen,
                        _mamba2, _chameleon, _grok1, _dsmoe, _jamba,
                        _cnn_cifar10, _vit_cifar10)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def reduced(arch: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU tests: same layer pattern and
    feature set (GQA ratio, partial rotary, MLP flavour, MoE topology, the
    hybrid interleave: one pattern period), small dims; the CNN keeps its
    stage structure at small channel counts and image size.  Matches
    ``repro.configs.reduced``, which also turns ``use_fsdp`` off."""
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
    n_layers = len(arch.layer_pattern) if arch.layer_pattern else 2
    n_heads = 4 if arch.n_heads else 0          # 0: attention-free
    ratio = max(arch.n_heads // max(arch.n_kv_heads, 1), 1) if arch.n_heads else 1
    n_kv = max(n_heads // min(ratio, n_heads), 1) if n_heads else 0
    moe = arch.moe
    if moe.enabled:
        moe = replace(moe, num_experts=4, top_k=min(moe.top_k, 2),
                      d_expert=64,
                      d_shared=32 * moe.num_shared_experts,
                      d_ff_dense=128 if moe.d_ff_dense else 0,
                      moe_skip_first=min(moe.moe_skip_first, 1))
    return replace(
        arch,
        name=arch.name + "-reduced",
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16 if arch.n_heads else 0,
        d_ff=128 if arch.d_ff else 0,
        vocab=256,
        moe=moe,
        mamba=replace(arch.mamba, d_state=16, head_dim=16, chunk=16),
        use_fsdp=False,
    )


__all__ = ["ARCHS", "ATTN", "IMAGE_FAMILIES", "MAMBA", "SHAPES", "ArchConfig",
           "MambaConfig", "MemConfig", "MeshConfig", "ShapeConfig", "TrainConfig",
           "apply_overrides", "get_arch", "list_archs", "parse_set_args",
           "reduced", "shape_applicable"]
