"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887]"""
from repro_torch.configs.base import ATTN, MAMBA, ArchConfig, MambaConfig, MoEConfig

ARCH = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    mlp_act="swiglu",
    # 8-layer period: attention at index 4, mamba elsewhere (1:7 ratio)
    layer_pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576,
                  capacity_factor=1.25, moe_period=2, moe_offset=1),
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=8,
                      chunk=128),
    use_fsdp=True,
    source="arXiv:2403.19887",
)
